"""``adamw_roofline.train`` on hand-made Chrome-trace events, in the style
of ``test_bench_spans.py``: the configuration's least AdamW bytes at the
memory rate over the device time launched in ``rt.train.optimizer``; and
nothing read, without raising, where the program records no such span (a
traced CPU run, or a program without the span)."""

import math

import pytest
from bench_tiny import MOE, SSM, TRAIN, ctx

from benchlib import counts, spec, weights
from benchlib.drivers import train
from benchlib.record import Run
from benchlib.trace import Trace

METRIC = "adamw_roofline.train"


def _event(cat, name, ts_us, dur_us, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts_us, "dur": dur_us}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _events(rt: bool = True):
    # Two steps; each: the harness's optimizer span, the port's span inside
    # it (when ``rt``) with the three kernels and the pointers' copy, and a
    # backward kernel before it that no optimizer span holds.
    ev = [_event("user_annotation", "window", 0, 2000)]
    corr = 0
    for step, t0 in enumerate((0, 1000)):
        ev += [_event("user_annotation", "optimizer", t0 + 500, 400)]
        if rt:
            ev += [_event("user_annotation", "rt.train.optimizer", t0 + 510,
                          380)]
        launches = [(t0 + 100, "flash_bwd_kernel", t0 + 120, 300),
                    (t0 + 520, "Memcpy HtoD (Pinned -> Device)", t0 + 530, 2),
                    (t0 + 530, "adamw_sumsq_kernel", t0 + 540, 30),
                    (t0 + 540, "adamw_finish_kernel", t0 + 575, 3),
                    (t0 + 550, "adamw_update_kernel", t0 + 580, 165)]
        for at, name, ts, dur in launches:
            corr += 1
            cat = "gpu_memcpy" if name.startswith("Memcpy") else "kernel"
            ev += [_event("cuda_runtime", "cudaLaunchKernel", at, 2, corr),
                   _event(cat, name, ts, dur, corr)]
    return ev


def _run(cfg, events, kind="train"):
    return Run(kind, cfg, TRAIN, 1.0, 2e-3, 0, steps=[{}, {}],
               trace=Trace(events))


def _read(run):
    return spec.reader(METRIC)(run)


@pytest.mark.parametrize("cfg", [MOE, SSM], ids=["moe", "ssm"])
def test_reads_the_least_bytes_over_the_device_time_in_the_span(cfg):
    # 200 us a step in the span: copy 2, sumsq 30, finish 3, update 165.
    n_bytes = sum(math.prod(leaf.shape) * (4 * 4 + 16)   # float32 leaves
                  for leaf in weights.leaves(cfg))
    want = 100 * 2 * n_bytes / counts.HBM_BYTES_PER_S / 400e-6
    assert _read(_run(cfg, _events())) == pytest.approx(want)


def test_counts_each_leaf_in_its_dtype():
    # mixtral's float32 router beside bf16 weights: 24 bytes a bf16
    # element, 32 a float32 one.
    cfg = {**MOE, "dtype": "bfloat16"}
    leaves = weights.leaves(cfg)
    assert {leaf.dtype for leaf in leaves} == {"bfloat16", "float32"}
    n_bytes = sum(math.prod(leaf.shape) * (24 if leaf.dtype == "bfloat16"
                                           else 32) for leaf in leaves)
    got = _read(_run(cfg, _events()))
    assert got == pytest.approx(100 * 2 * n_bytes / counts.HBM_BYTES_PER_S
                                / 400e-6)


def test_reads_nothing_without_the_span_or_a_train_trace():
    assert _read(_run(MOE, _events(rt=False))) is None
    assert _read(_run(MOE, _events(), kind="serve")) is None
    assert _read(Run("train", MOE, TRAIN, 1.0, 1e-3, 0, steps=[{}])) is None


def test_a_traced_cpu_run_reads_nothing():
    # The plain loop on the CPU records no span and launches no device
    # work; the metric reads nothing there and does not raise.
    out = train.run(ctx(SSM, TRAIN, trace=True))
    assert _read(out.run) is None
    assert out.run.launches["adamw"] == 0
