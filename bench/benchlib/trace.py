"""A ``torch.profiler`` trace, reduced: device intervals, busy time,
kernel groups, time under the harness's spans, and idle gaps.

``record`` profiles a call (CPU and CUDA activity) and reads the exported
Chrome trace.  Device events are kernels, copies and sets; each came from
a launch on the host (a runtime or driver call sharing its correlation id),
made inside whatever span and operator the host was running then.  The
busy union, the idle share and the kernel groups are frozen copies of
``repro_torch/launch/profile_serve.py``'s ``_summary`` and ``_group``.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict

# Kernel-name fragment -> group, first match wins (profile_serve's table):
# "flash_fwd" and "flash_bwd" cover the float32 and the bf16 kernels of
# each; "ssd_" the forward's kernels, after "ssd_bwd" has taken the
# backward's.
KERNEL_GROUPS = (("flash_fwd", "flash_attention"),
                 ("flash_bwd", "flash_attention_bwd"),
                 ("ssd_bwd", "ssd_scan_bwd"),
                 ("ssd_", "ssd_scan"),
                 ("rmsnorm_fwd", "rmsnorm"),
                 ("rmsnorm_bwd", "rmsnorm_bwd"),
                 ("ce_fwd", "fused_cross_entropy"),
                 ("ce_bwd", "fused_cross_entropy_bwd"))
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def group(name: str) -> str:
    for fragment, g in KERNEL_GROUPS:
        if fragment in name:
            return g
    low = name.lower()
    if any(s in low for s in ("gemm", "gemv", "xmma", "cutlass", "nvjet")):
        return "matmul"
    if "scatter_gather" in name:
        return "gather_scatter"
    if "sort" in low:
        return "sort"
    return "other"


class Trace:
    """Times in seconds on the trace's clock."""

    def __init__(self, events: list[dict]):
        self.kernels = []          # (start, end, name, correlation)
        launches = {}              # correlation -> host time of the launch
        self.spans = defaultdict(list)   # user annotation -> [(start, end)]
        ops = []                   # (start, end, name) host operators
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, ts = e.get("cat", ""), e.get("ts", 0.0) * 1e-6
            end = ts + e.get("dur", 0.0) * 1e-6
            corr = (e.get("args") or {}).get("correlation")
            if cat in DEVICE_CATS:
                self.kernels.append((ts, end, e.get("name", ""), corr))
            elif cat in LAUNCH_CATS and corr is not None:
                launches[corr] = ts
            elif cat == "user_annotation":
                self.spans[e.get("name", "")].append((ts, end))
            elif cat == "cpu_op":
                ops.append((ts, end, e.get("name", "")))
        self.kernels.sort()
        self.launch_at = [launches.get(c) for *_, c in self.kernels]
        ops.sort()
        self._ops = ops
        self._op_starts = [o[0] for o in ops]
        for v in self.spans.values():
            v.sort()

    # ------------------------------------------------------------ device
    def busy_s(self, t0: float | None = None, t1: float | None = None,
               span: str | None = None) -> float:
        """The union of the device intervals, clipped to [t0, t1]; with
        ``span``, of the events launched inside the spans of that name."""
        total, cur = 0.0, None
        for (s, e, *_), at in zip(self.kernels, self.launch_at):
            if span is not None and not self.in_span(span, at):
                continue
            if t0 is not None:
                s, e = max(s, t0), min(e, t1)
                if e <= s:
                    continue
            if cur is None or s > cur[1]:
                if cur is not None:
                    total += cur[1] - cur[0]
                cur = [s, e]
            else:
                cur[1] = max(cur[1], e)
        return total + (cur[1] - cur[0] if cur else 0.0)

    def window(self) -> tuple[float, float]:
        """The harness's ``window`` span."""
        return self.spans["window"][0]

    def device_s(self, pred) -> float:
        """Device seconds of the events for which ``pred(name, host time
        of the launch)`` holds."""
        return sum(e - s for (s, e, name, _), at in
                   zip(self.kernels, self.launch_at) if pred(name, at))

    def group_s(self, groups, inside: str | None = None,
                outside: str | None = None) -> float:
        """Device seconds of the kernel ``groups``, launched inside the
        spans named ``inside`` or outside those named ``outside``."""
        groups = set(groups)

        def pred(name, at):
            if group(name) not in groups:
                return False
            if inside is not None:
                return self.in_span(inside, at)
            if outside is not None:
                return not self.in_span(outside, at)
            return True
        return self.device_s(pred)

    def in_span(self, span: str, at: float | None) -> bool:
        if at is None:
            return False
        spans = self.spans.get(span, [])
        i = bisect.bisect_right(spans, (at, float("inf"))) - 1
        return i >= 0 and spans[i][0] <= at <= spans[i][1]

    # -------------------------------------------------------------- host
    def host_op_at(self, at: float | None) -> str:
        """The innermost host operator running at ``at``."""
        if at is None:
            return "(unknown)"
        i = bisect.bisect_right(self._op_starts, at) - 1
        for j in range(i, max(i - 400, -1), -1):
            s, e, name = self._ops[j]
            if s <= at <= e:
                return name
        return "(python)"

    def breakdown(self, n: int = 10) -> dict:
        """The device operations that took most time, and the idle gaps
        inside the window summed by what the host was doing when the
        device went back to work (the operator that launched the next
        event)."""
        by_name = defaultdict(float)
        for s, e, name, _ in self.kernels:
            by_name[name[:120]] += e - s
        t0, t1 = self.window()
        gaps = defaultdict(float)
        end = t0
        for (s, e, *_), at in zip(self.kernels, self.launch_at):
            if e <= t0 or s >= t1:
                continue
            if s > end:
                gaps[self.host_op_at(at)] += min(s, t1) - end
            end = max(end, e)
        if end < t1:
            gaps["(after the last device event)"] += t1 - end
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:n]
        return {"device_ops": [[k, v] for k, v in top],
                "idle_gaps": [[k, v] for k, v in idle]}


def record(fn):
    """Profile ``fn()`` and return (its result, the Trace).  The Chrome
    trace goes to a temporary file under TMPDIR, read and removed."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                           else [])
    with profile(activities=activities) as prof:
        out = fn()
        if cuda:
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return out, Trace(events)
