"""The port's spans and counters (``repro_torch.spans``) on the CPU.

With no profiler running, ``span`` hands back one shared no-op context
and the MoE counters stay 0.  Under ``torch.profiler``, one ``train_step``
and one ``generate`` of a smoke mixtral, mamba2 and dense model record the
documented spans, each layer span inside the phase span that ran it (the
backward's recompute of each checkpointed unit inside
``rt.train.backward``; prefill's inside no ``rt.`` span), one
``rt.serve.decode_step`` a decode step; and
the traced run's loss, parameters, tokens and logits are bitwise those of
the untraced run.  The MoE counters equal a hand count of the pairs each
expert's capacity keeps, drops included.
"""

import contextlib
import dataclasses
import os
import subprocess
import sys
from collections import Counter
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import spans
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch import serve, train
from repro_torch.models import moe
from repro_torch.models.transformer import n_units, unit_layout
from repro_torch.tree import leaves

REPO = Path(__file__).resolve().parent.parent
ARCHS = ("mixtral-8x22b-smoke", "mamba2-370m-smoke", "qwen2-7b-smoke")
GEN = 4
PHASES = ("rt.train.forward", "rt.train.backward", "rt.serve.decode_step")
LAYER_SPANS = ("rt.attention", "rt.moe.route", "rt.moe.dispatch",
               "rt.moe.experts", "rt.moe.combine", "rt.mamba")
#: The benchmark harness's own span names, which no port span may take.
HARNESS_SPANS = ("window", "prefill", "decode", "optimizer")


def _run(arch: str, traced: bool):
    """One train step and one ``generate`` of ``GEN`` tokens from a fresh
    state: (loss, parameters after the step, generate's result, the
    profiler's events or None)."""
    cfg = get_config(arch)
    t = train.setup(cfg, steps=4, batch=2, seq=16, seed=3, device="cpu")
    state = t.init()
    batch = t.pipeline.batch_at(0)
    prompts = serve.prompt_batch(cfg, 2, 12, 5, "cpu")

    def go():
        s, m = t.train_step(state, batch)
        return m["loss"], s.params, serve.generate(t.model, s.params,
                                                   prompts, GEN)

    if not traced:
        return (*go(), None)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = go()
    return (*out, prof.events())


@pytest.fixture(scope="module", params=ARCHS)
def runs(request):
    return request.param, _run(request.param, False), _run(request.param,
                                                           True)


def _phase_of(event) -> str | None:
    """The nearest enclosing ``rt.`` span of a profiler event."""
    p = event.cpu_parent
    while p is not None and not p.name.startswith("rt."):
        p = p.cpu_parent
    return None if p is None else p.name


def _layers(arch: str) -> Counter:
    """Layer spans of one pass through the model: name -> count."""
    cfg = get_config(arch)
    per_unit = Counter()
    for sub in unit_layout(cfg):
        per_unit["rt.attention" if sub["mixer"] == "attn"
                 else "rt.mamba"] += 1
        if sub["ffn"] == "moe":
            for part in ("route", "dispatch", "experts", "combine"):
                per_unit[f"rt.moe.{part}"] += 1
    return Counter({k: v * n_units(cfg) for k, v in per_unit.items()})


def test_spans_nest_as_documented(runs):
    arch, _, (*_, events) = runs
    rt = [e for e in events if e.name.startswith("rt.")]
    assert {e.name for e in rt} <= set(PHASES + LAYER_SPANS)
    assert not {e.name for e in rt} & set(HARNESS_SPANS)
    phases = Counter(e.name for e in rt if e.name in PHASES)
    assert phases == {"rt.train.forward": 1, "rt.train.backward": 1,
                      "rt.serve.decode_step": GEN - 1}
    assert all(_phase_of(e) is None for e in rt if e.name in PHASES)
    # Each layer span inside the phase that ran it: the forward, the
    # backward's recompute, prefill (no phase span), and every decode step.
    got = Counter((e.name, _phase_of(e)) for e in rt
                  if e.name in LAYER_SPANS)
    one = _layers(arch)
    want = Counter()
    for name, n in one.items():
        want[name, "rt.train.forward"] = n
        want[name, "rt.train.backward"] = n
        want[name, None] = n
        want[name, "rt.serve.decode_step"] = n * (GEN - 1)
    assert got == want
    assert ("rt.moe.route" in one) == (arch == "mixtral-8x22b-smoke")
    assert ("rt.mamba" in one) == (arch == "mamba2-370m-smoke")


def test_traced_outputs_equal_untraced(runs):
    _, (loss, params, r, _), (tloss, tparams, tr, _) = runs
    assert torch.equal(loss, tloss)
    for a, b in zip(leaves(params), leaves(tparams), strict=True):
        assert torch.equal(a, b)
    assert torch.equal(r["tokens"], tr["tokens"])
    assert torch.equal(r["logits"], tr["logits"])
    assert bool(r["finite"]) and bool(tr["finite"])


def _moe_inputs(capacity_factor: float):
    cfg = dataclasses.replace(get_config("mixtral-8x22b-smoke"),
                              capacity_factor=capacity_factor)
    g = torch.Generator().manual_seed(0)
    p = moe.init_moe(g, cfg, torch.float32, "cpu")
    x = torch.randn(2, 16, cfg.d_model, generator=g)
    return cfg, p, x


def test_span_is_a_shared_noop_and_counters_stay_zero_without_profiler():
    assert spans.span("rt.a") is spans.span("rt.b")
    assert isinstance(spans.span("rt.a"), contextlib.nullcontext)
    assert not spans.active()
    cfg, p, x = _moe_inputs(0.5)
    ops.reset_launch_counts()
    moe.moe_ffn(p, x, cfg)
    counts = ops.launch_counts()
    assert counts["moe_pairs_kept"] == 0 and counts["moe_buffer_rows"] == 0
    with profile(activities=[ProfilerActivity.CPU]):
        assert spans.active()
        assert not isinstance(spans.span("rt.a"), contextlib.nullcontext)


@pytest.mark.parametrize("fold", [spans.FOLD, 2])
def test_moe_counters_equal_a_hand_count(fold, monkeypatch):
    """Five calls, their masks held or (``fold`` 2) folded into the device
    total every two calls: the same counts, and never more than ``fold``
    masks held."""
    monkeypatch.setattr(spans, "FOLD", fold)
    cfg, p, x = _moe_inputs(0.5)
    B, S, _ = x.shape
    E, k, C = cfg.n_experts, cfg.experts_per_token, moe.capacity(cfg, S)
    logits = x.float() @ p["router"]
    top, _ = moe.route_topk(logits, cfg)
    # Each expert of each row keeps at most C of the pairs that chose it.
    hand = sum(min(int((top[b] == e).sum()), C)
               for b in range(B) for e in range(E))
    assert int(moe.route(logits, cfg).keep.sum()) == hand
    assert hand < B * S * k                      # some pairs are dropped
    ops.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(5):
            moe.moe_ffn(p, x, cfg)
            assert len(spans._masks) < fold
    counts = ops.launch_counts()
    assert counts["moe_pairs_kept"] == 5 * hand
    assert counts["moe_buffer_rows"] == 5 * B * E * C
    ops.reset_launch_counts()
    assert ops.launch_counts()["moe_pairs_kept"] == 0
    assert ops.launch_counts()["moe_buffer_rows"] == 0


def test_model_and_kernel_layers_load_no_simulator():
    """The span helper is a leaf: the kernels, the models and the train and
    serve paths that record spans load neither the simulator's telemetry
    (``repro_torch.obs``) nor the simulator (``repro_torch.core``)."""
    code = ("import sys\n"
            "import repro_torch.kernels.ops, repro_torch.launch.serve\n"
            "import repro_torch.train.step\n"
            "print(sorted(m for m in sys.modules if m.split('.')[:2] in\n"
            "             (['repro_torch', 'obs'], ['repro_torch', 'core'])))")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300,
                       env={**os.environ, "PYTHONPATH": str(REPO / "src")})
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"
