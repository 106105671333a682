"""Grouped serving: ``clients`` closed-loop clients whose requests a
server groups by prompt length, one batch at a time through
``repro_torch.launch.serve.generate`` (prefill, then greedy decode
through the cache; ``gen`` tokens a request, the first from prefill).

The harness times each batch by the host clock: it starts when the batch
is handed to ``generate``, its first tokens exist when prefill's logits
are ready (the harness's wrapper of the model's ``prefill`` synchronises
there), it ends when ``generate`` returns (synchronised).  Set-up serves
one batch of each prompt length (every prefill and decode shape).  The window runs whole cycles of the
mix's lengths until ``seconds`` have passed; a traced run serves the
lengths at ``trace_quantiles`` once each.  The check runs the reference
over a sample of the finished requests, the longest among them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from benchlib import compare, spec, traffic
from benchlib import trace as trace_lib
from benchlib import weights
from benchlib.record import Context, Outcome, Run, peak_bytes, release, sync


def _instrument(model, device, traced: bool, marks: dict):
    def span(name):
        return (torch.profiler.record_function(name) if traced
                else contextlib.nullcontext())

    def prefill(params, batch, max_seq):
        with span("prefill"):
            out = model.prefill(params, batch, max_seq)
        sync(device)
        marks["first"] = time.perf_counter()
        return out

    def decode(params, token, cache):
        with span("decode"):
            return model.decode(params, token, cache)

    return dataclasses.replace(model, prefill=prefill, decode=decode)


def _window(ctx: Context, generate, served, params, schedule: list[int],
            cycle: int, marks: dict, alter=None):
    mix, batches = ctx.mix, []
    span = (torch.profiler.record_function("window") if ctx.trace
            else contextlib.nullcontext())
    sync(ctx.device)
    with span:
        w0 = time.perf_counter()
        while True:
            b = len(batches)
            length = schedule[b % len(schedule)]
            prompts = traffic.serve_prompts(ctx.cfg, mix, ctx.seed, b, length,
                                            ctx.device)
            sync(ctx.device)
            t0 = time.perf_counter()
            r = generate(served, params, {"tokens": prompts}, mix["gen"])
            t1 = time.perf_counter()
            tokens = r["tokens"] if alter is None else alter(r["tokens"])
            batches.append({"length": length, "t0": t0,
                            "t_first": marks["first"], "t1": t1,
                            "requests": mix["clients"], "gen": mix["gen"],
                            "tokens": tokens.cpu(),
                            "finite": bool(r["finite"])})
            if ctx.trace:
                if len(batches) == len(schedule):
                    break
            elif t1 - w0 >= ctx.seconds and len(batches) % cycle == 0:
                break
    return t1 - w0, batches


def sample(ctx: Context, batches: list[dict]) -> list[tuple[int, int]]:
    """(batch, row) of the requests the check compares: one of the longest
    prompt, and ``check_requests - 1`` others drawn from the seed."""
    rows = ctx.mix["clients"]
    every = [(b, j) for b in range(len(batches)) for j in range(rows)]
    longest = max(range(len(batches)), key=lambda b: batches[b]["length"])
    rest = [x for x in every if x != (longest, 0)]
    rng = np.random.default_rng(weights.derive(ctx.seed, "serve/check"))
    n = min(ctx.mix["check_requests"] - 1, len(rest))
    picks = rng.choice(len(rest), size=n, replace=False)
    return [(longest, 0)] + [rest[i] for i in sorted(picks)]


def requests_of(ctx: Context, batches: list[dict], picks) -> list[dict]:
    out = []
    for b, j in picks:
        prompts = traffic.serve_prompts(ctx.cfg, ctx.mix, ctx.seed, b,
                                        batches[b]["length"], ctx.device)
        out.append({"prompt": prompts[j].cpu(),
                    "served": batches[b]["tokens"][j]})
    return out


def program(ctx: Context, alter=None):
    """Set-up and the window: (setup_s, window_s, batches, trace,
    launches, peak bytes)."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate
    from repro_torch.models import get_model

    mix, arch = ctx.mix, spec.architecture(ctx.cfg)
    model = get_model(arch.port_config(ctx.cfg), device=ctx.device)
    params = weights.tree(arch.leaves(ctx.cfg), ctx.seed, ctx.device)
    marks: dict = {}
    served = _instrument(model, ctx.device, ctx.trace, marks)
    lengths = traffic.serve_lengths(mix)
    order = traffic.serve_order(mix, ctx.seed)
    if ctx.trace:
        traced = {lengths[i] for i in mix["trace_quantiles"]}
        order = [x for x in order if x in traced]
    for length in sorted(set(order)):       # warm-up: each shape once
        generate(served, params,
                 {"tokens": traffic.serve_prompts(ctx.cfg, mix, ctx.seed,
                                                  -length, length,
                                                  ctx.device)}, mix["gen"])
    setup_s = time.perf_counter() - ctx.t_start
    launches, tr = None, None
    if ctx.trace:
        ops.reset_launch_counts()
        (window_s, batches), tr = trace_lib.record(
            lambda: _window(ctx, generate, served, params, order, len(order),
                            marks, alter))
        launches = ops.launch_counts()
    else:
        window_s, batches = _window(ctx, generate, served, params, order,
                                    len(order), marks, alter)
    return setup_s, window_s, batches, tr, launches, peak_bytes(ctx.device)


def check(ctx: Context, batches: list[dict], lowp_too: str | None = None):
    """The numbers of the sampled requests' served tokens against the
    reference (``compare.serve_numbers``); with ``lowp_too`` also the
    control's (its own best token at each position of the same prompts
    and tokens), under ``control.``, and each position's gaps and the
    reference's narrowest router margin there, for the look."""
    reqs = requests_of(ctx, batches, sample(ctx, batches))
    sides = spec.architecture(ctx.cfg).serve_logits(ctx.cfg, ctx.seed, reqs,
                                                    ctx.device, lowp_too)
    ref = sides[0]
    gaps = [g for lg, r in zip(ref, reqs)
            for g in compare.logit_gaps(lg, r["served"])]
    out = compare.serve_numbers(gaps)
    if lowp_too:
        low = [g for lg, lo in zip(ref, sides[1])
               for g in compare.logit_gaps(lg, lo.argmax(-1))]
        out.update({f"control.{k}": v
                    for k, v in compare.serve_numbers(low).items()})
        out.update(gaps=gaps, control_gaps=low,
                   margins=[m for ms in sides[2] for m in ms])
    return out


def run(ctx: Context, alter=None) -> Outcome:
    """``alter(tokens)`` changes the served tokens where ``generate``
    produced them (the fault tests)."""
    setup_s, window_s, batches, tr, launches, peak = program(ctx, alter)
    release(ctx.device)
    numbers = check(ctx, batches)
    V = ctx.cfg["vocab_size"]
    failed = sum(b["requests"] for b in batches
                 if not b["finite"] or bool(((b["tokens"] < 0)
                                             | (b["tokens"] >= V)).any()))
    run_ = Run("serve", ctx.cfg, ctx.mix, setup_s, window_s, peak, batches,
               tr, launches)
    attempted = sum(b["requests"] for b in batches)
    return Outcome(run_, attempted, failed, numbers)

