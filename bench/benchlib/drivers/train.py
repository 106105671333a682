"""Training traffic: ``repro_torch.launch.train.setup``'s ``train_step``
on the harness's weights and batches.

Set-up builds the one train state (the harness's weights, AdamW's zero
moments), drives it through the first ``check_steps`` steps on the seed's
batches (the steps that the reference follows; they also warm every
kernel and shape), reads what the check needs, and hands the same state to
the window.  The window runs whole steps, each ending in a loss read,
until ``seconds`` have passed (a traced run: ``trace_steps`` steps).
"""

from __future__ import annotations

import contextlib
import math
import time

import torch

from benchlib import compare, spec, traffic, weights
from benchlib import trace as trace_lib
from benchlib.record import Context, Outcome, Run, peak_bytes, release, sync


def _diff_norm(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| in float32, a block of rows at a time."""
    if a.dim() == 0:
        return float((a.float() - b.float()).abs())
    rows = max(1, (1 << 24) // max(1, a[0].numel()))
    return math.sqrt(sum(float((x.float() - y.float()).square().sum())
                         for x, y in zip(a.split(rows), b.split(rows))))


def build(ctx: Context):
    """The trainer and its state on the harness's weights."""
    from repro_torch.launch.train import setup
    from repro_torch.train.state import TrainState

    mix, arch = ctx.mix, spec.architecture(ctx.cfg)
    t = setup(arch.port_config(ctx.cfg), steps=mix["schedule_steps"],
              batch=mix["batch"], seq=mix["seq"], lr=mix["lr"], seed=ctx.seed,
              device=ctx.device)
    params = weights.tree(arch.leaves(ctx.cfg), ctx.seed, ctx.device)
    return t, TrainState(step=0, params=params, opt=t.optimizer.init(params),
                         rng=ctx.seed + 1)


def checked_steps(ctx: Context, t, state):
    """The first ``check_steps`` steps: (state, readings) with each step's
    loss, the first gradient's norm per leaf as AdamW got it (its first
    moment after step 1 over 1 - b1) and each leaf's change after the
    last checked step."""
    from repro_torch.tree import leaves_with_path

    b1 = ctx.mix["adamw"]["b1"]
    losses, first = [], {}
    for i in range(ctx.mix["check_steps"]):
        batch = traffic.train_batch(ctx.cfg, ctx.mix, ctx.seed, i, ctx.device)
        state, m = t.train_step(state, batch)
        losses.append(float(m["loss"]))
        if i == 0:
            first = {path: float(mu.norm()) / (1 - b1)
                     for path, mu in leaves_with_path(state.opt.m)}
    change = {}
    with torch.no_grad():
        for leaf in spec.architecture(ctx.cfg).leaves(ctx.cfg):
            change[leaf.path] = _diff_norm(
                weights.get(state.params, leaf.path),
                weights.draw(leaf, ctx.seed, ctx.device))
    return state, {"losses": losses, "first_grad": first, "change": change}


def _span_optimizer(t) -> None:
    """Put AdamW's ``update`` under a ``record_function("optimizer")``
    span (the instance's attribute shadows the method; the step looks it
    up at every call)."""
    update = t.optimizer.update

    def spanned(*args, **kwargs):
        with torch.profiler.record_function("optimizer"):
            return update(*args, **kwargs)

    object.__setattr__(t.optimizer, "update", spanned)


def _window(ctx: Context, t, state):
    mix = ctx.mix
    steps, i = [], mix["check_steps"]
    span = (torch.profiler.record_function("window") if ctx.trace
            else contextlib.nullcontext())
    sync(ctx.device)
    with span:
        w0 = time.perf_counter()
        while True:
            batch = traffic.train_batch(ctx.cfg, mix, ctx.seed, i, ctx.device)
            state, m = t.train_step(state, batch)
            loss = float(m["loss"])
            t1 = time.perf_counter()
            steps.append({"t1": t1, "tokens": mix["batch"] * mix["seq"],
                          "loss": loss})
            i += 1
            if t1 - w0 >= ctx.seconds or (ctx.trace
                                          and len(steps) >= mix["trace_steps"]):
                break
    return state, t1 - w0, steps


def run(ctx: Context, step=None) -> Outcome:
    """``step(train_step)`` wraps the program's train step (the fault
    tests)."""
    from repro_torch.kernels import ops

    t, state = build(ctx)
    if step is not None:
        t = t._replace(train_step=step(t.train_step))
    state, prog = checked_steps(ctx, t, state)
    setup_s = time.perf_counter() - ctx.t_start
    launches, tr = None, None
    if ctx.trace:
        _span_optimizer(t)
        ops.reset_launch_counts()
        (state, window_s, steps), tr = trace_lib.record(
            lambda: _window(ctx, t, state))
        launches = ops.launch_counts()
    else:
        state, window_s, steps = _window(ctx, t, state)
    peak = peak_bytes(ctx.device)
    del state, t
    release(ctx.device)
    ref = spec.architecture(ctx.cfg).train_readings(
        ctx.cfg, ctx.mix, ctx.seed, ctx.device, steps=ctx.mix["check_steps"])
    failed = sum(not math.isfinite(s["loss"]) for s in steps)
    run_ = Run("train", ctx.cfg, ctx.mix, setup_s, window_s, peak, steps, tr,
               launches)
    return Outcome(run_, len(steps), failed, compare.train_numbers(prog, ref))
