"""The metrics that read the port's own spans and counters (``rt.*``,
``repro_torch.spans``), on hand-made Chrome-trace events with hand
values, in the style of ``test_bench_trace.py``; each reads nothing, and
does not raise, on a trace without the port's spans (a program that has
none); and a traced CPU run of the tiny train and serve cells records the
spans and counters they read."""

import statistics

import pytest
from bench_tiny import MOE, SERVE, TRAIN, ctx

from benchlib import spec
from benchlib.drivers import serve_grouped, train
from benchlib.record import Run
from benchlib.trace import Trace

TRAIN_METRICS = ("forward_ms.train", "backward_ms.train",
                 "moe_route_ms.train", "moe_fill.train",
                 "mixer_other_ms.train")
SERVE_METRICS = ("decode_host_ms.serve", "decode_launches.serve",
                 "decode_idle_moe_ms.serve", "decode_idle_attention_ms.serve")


def _event(cat, name, ts_us, dur_us, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts_us, "dur": dur_us}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _span(name, ts, dur):
    return _event("user_annotation", name, ts, dur)


def _launch(corr, at):
    return _event("cuda_runtime", "cudaLaunchKernel", at, 2, corr=corr)


def _train_events(rt: bool = True):
    # Host (us): the forward over [0, 300] with the MoE's four parts and
    # the mixer inside it, the backward over [300, 700] with one recompute
    # of the routing, the optimizer over [700, 900].  Device: each kernel
    # after its launch, its length in brackets.
    ev = [_span("window", 0, 1000), _span("optimizer", 700, 200)]
    if rt:
        ev += [_span("rt.train.forward", 0, 300),
               _span("rt.moe.route", 50, 30), _span("rt.moe.dispatch", 80, 20),
               _span("rt.moe.experts", 100, 50),
               _span("rt.moe.combine", 150, 20), _span("rt.mamba", 180, 70),
               _span("rt.train.backward", 300, 400),
               _span("rt.moe.route", 400, 20)]
    kernels = [(1, 60, "sort_kernel", 100, 10),              # route
               (2, 90, "scatter_gather_kernel", 110, 20),    # dispatch
               (3, 120, "nvjet_tst_gemm", 130, 100),         # experts
               (4, 160, "elementwise_kernel", 230, 5),       # combine
               (5, 200, "elementwise_conv_kernel", 240, 50),  # mixer, other
               (6, 210, "nvjet_tst_gemm", 290, 10),          # mixer, matmul
               (7, 410, "sort_kernel", 420, 10),             # recompute
               (8, 500, "flash_bwd_kernel", 430, 200),       # backward
               (9, 750, "elementwise_kernel", 760, 140)]     # optimizer
    for corr, at, name, ts, dur in kernels:
        ev += [_launch(corr, at), _event("kernel", name, ts, dur, corr=corr)]
    return ev


def _serve_events(rt: bool = True):
    # Host (us): prefill over [0, 100] (an attention inside it), three
    # decode steps over [200, 300], [400, 520], [600, 680], layer spans in
    # the first two.
    ev = [_span("window", 0, 2000), _span("prefill", 0, 100),
          _span("decode", 200, 100), _span("decode", 400, 120),
          _span("decode", 600, 80)]
    if rt:
        ev += [_span("rt.attention", 10, 40),
               _span("rt.serve.decode_step", 200, 100),
               _span("rt.attention", 210, 30), _span("rt.moe.route", 250, 10),
               _span("rt.moe.experts", 260, 20),
               _span("rt.serve.decode_step", 400, 120),
               _span("rt.attention", 410, 40),
               _span("rt.moe.combine", 460, 40),
               _span("rt.serve.decode_step", 600, 80)]
    # (corr, launch, device start, length); the idle gap each event ends:
    device = [(1, 20, 100, 50),     # gap 0-100: prefill's attention
              (2, 220, 230, 10),    # gap 150-230 (80): step 1, attention
              (3, 225, 240, 10),    # none
              (4, 255, 300, 10),    # gap 250-300 (50): step 1, route
              (5, 270, 305, 95),    # none (overlaps)
              (6, 290, 420, 10),    # gap 400-420 (20): step 1, no layer
              (7, 420, 450, 10),    # gap 430-450 (20): step 2, attention
              (8, 470, 500, 20),    # gap 460-500 (40): step 2, combine
              (9, 650, 700, 10),    # gap 520-700 (180): step 3, no layer
              (10, 1500, 1900, 200)]  # gap 715-1900: after decode
    for corr, at, ts, dur in device:
        ev += [_launch(corr, at),
               _event("kernel", "nvjet_tst_gemv", ts, dur, corr=corr)]
    # A copy launched in step 3, right after kernel 9: no gap.
    ev += [_event("cuda_runtime", "cudaMemcpyAsync", 660, 2, corr=11),
           _event("gpu_memcpy", "Memcpy DtoD", 710, 5, corr=11)]
    return ev


def _run(kind, events, launches=None):
    return Run(kind, {}, {}, 1.0, 1e-3, 0, steps=[{}, {}],
               trace=Trace(events), launches=launches)


def _read(metric, run):
    return spec.reader(metric)(run)


def test_train_metrics_read_the_device_time_launched_in_their_spans():
    run = _run("train", _train_events(),
               {"moe_pairs_kept": 30, "moe_buffer_rows": 40})
    # Two steps: forward kernels 1-6 (195 us), backward 7-8 (210 us).
    assert _read("forward_ms.train", run) == pytest.approx(195e-3 / 2)
    assert _read("backward_ms.train", run) == pytest.approx(210e-3 / 2)
    # Route, dispatch and combine, the recompute's route too; not experts.
    assert _read("moe_route_ms.train", run) == pytest.approx(45e-3 / 2)
    # The mixer's `other` kernels, not its matrix product.
    assert _read("mixer_other_ms.train", run) == pytest.approx(50e-3 / 2)
    assert _read("moe_fill.train", run) == pytest.approx(75.0)
    # The harness's own spans read as before.
    assert _read("optimizer_ms.train", run) == pytest.approx(140e-3 / 2)


def test_moe_fill_reads_nothing_without_the_counters():
    for launches in (None, {}, {"flash_attention": 3},
                     {"moe_pairs_kept": 0, "moe_buffer_rows": 0}):
        assert _read("moe_fill.train", _run("train", _train_events(),
                                            launches)) is None


def test_decode_metrics_read_the_steps_spans_and_the_gaps_they_end():
    run = _run("serve", _serve_events())
    # Step durations 100, 120 and 80 us.
    assert _read("decode_host_ms.serve", run) == pytest.approx(0.1)
    # Events 2-6 (step 1), 7-8 (step 2), 9 and the copy (step 3).
    assert _read("decode_launches.serve", run) == pytest.approx(9 / 3)
    # Gaps ending at an event launched in a decode step and in a layer
    # span; prefill's attention gap (100 us) counts for neither.
    assert _read("decode_idle_attention_ms.serve", run) == pytest.approx(
        (80 + 20) * 1e-3 / 3)
    assert _read("decode_idle_moe_ms.serve", run) == pytest.approx(
        (50 + 40) * 1e-3 / 3)


def test_the_gaps_are_the_breakdowns():
    # The hand gaps above, with those of no layer (20, 180), prefill's
    # (100) and the last (715-1900), add up to the breakdown's idle time.
    tr = Trace(_serve_events())
    idle = sum(v for _, v in tr.breakdown()["idle_gaps"])
    assert idle == pytest.approx((100 + 80 + 50 + 20 + 20 + 40 + 180
                                  + 1185) * 1e-6)
    t0, t1 = tr.window()
    assert idle == pytest.approx(t1 - t0 - tr.busy_s(t0, t1))


@pytest.mark.parametrize("metric", TRAIN_METRICS + SERVE_METRICS)
def test_a_trace_without_the_ports_spans_reads_nothing(metric):
    kind = "train" if metric.endswith(".train") else "serve"
    events = _train_events(False) if kind == "train" else _serve_events(
        False)
    assert _read(metric, _run(kind, events, {"flash_attention": 1})) is None
    other = "serve" if kind == "train" else "train"
    assert _read(metric, _run(other, _train_events(), {})) is None


def test_a_traced_cpu_run_records_the_spans_and_counters():
    out = train.run(ctx(MOE, TRAIN, trace=True))
    spans, n = out.run.trace.spans, len(out.run.steps)
    for name in ("rt.train.forward", "rt.train.backward"):
        assert len(spans[name]) == n
    # The harness's spans are the harness's own: no port span shares a name.
    assert len(spans["optimizer"]) == n
    assert not {"rt.train.optimizer", "rt.serve.prefill"} & set(spans)
    # Each MoE layer's routing: forward and recompute.
    assert len(spans["rt.moe.route"]) == 2 * MOE["n_layers"] * n
    kept = out.run.launches["moe_pairs_kept"]
    rows = out.run.launches["moe_buffer_rows"]
    assert 0 < kept <= rows
    assert _read("moe_fill.train", out.run) == pytest.approx(100 * kept / rows)

    out = serve_grouped.run(ctx(MOE, SERVE, trace=True))
    steps = out.run.trace.spans["rt.serve.decode_step"]
    assert len(steps) == len(SERVE["trace_quantiles"]) * (SERVE["gen"] - 1)
    assert _read("decode_host_ms.serve", out.run) == pytest.approx(
        1e3 * statistics.median(e - s for s, e in steps))
