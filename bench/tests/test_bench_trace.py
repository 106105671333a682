"""The trace reduction on hand-made Chrome-trace events: busy time as the
union of device intervals, and busy time of the events launched inside a
span, which the prefill and decode shares divide by."""

import pytest

from benchlib.trace import Trace


def _event(cat, name, ts_us, dur_us, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts_us, "dur": dur_us}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _trace():
    # Host: a "prefill" span over [0, 100] us, a "decode" span over
    # [200, 260] us.  Each launch's kernel runs later on the device; the
    # kernels of corr 1 and 2 overlap.
    return Trace([
        _event("user_annotation", "window", 0, 1000),
        _event("user_annotation", "prefill", 0, 100),
        _event("user_annotation", "decode", 200, 60),
        _event("cuda_runtime", "cudaLaunchKernel", 10, 5, corr=1),
        _event("cuda_runtime", "cudaLaunchKernel", 20, 5, corr=2),
        _event("cuda_runtime", "cudaLaunchKernel", 210, 5, corr=3),
        _event("cuda_runtime", "cudaLaunchKernel", 150, 5, corr=4),
        _event("kernel", "nvjet_gemm", 100, 300, corr=1),
        _event("kernel", "flash_fwd_kernel", 300, 200, corr=2),
        _event("kernel", "elementwise", 600, 50, corr=3),
        _event("kernel", "copy", 700, 40, corr=4),
    ])


def test_busy_is_the_union_of_device_intervals():
    tr = _trace()
    assert tr.busy_s() == pytest.approx((400 + 50 + 40) * 1e-6)
    assert tr.busy_s(350e-6, 650e-6) == pytest.approx((150 + 50) * 1e-6)


def test_busy_of_a_span_counts_the_events_launched_inside_it():
    tr = _trace()
    # corr 1 and 2 launched inside "prefill": [100, 400] and [300, 500].
    assert tr.busy_s(span="prefill") == pytest.approx(400e-6)
    assert tr.busy_s(span="decode") == pytest.approx(50e-6)
    assert tr.busy_s(span="optimizer") == 0.0
    assert tr.device_s(lambda name, at: tr.in_span("prefill", at)) == (
        pytest.approx(500e-6))
