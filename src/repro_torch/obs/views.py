"""Derived views over a :class:`~repro_torch.obs.trace.MemoryTracer` trace.

Everything here is exact, not sampled: the simulator emits one
``SegmentEvent`` per piecewise-constant rate segment, and the segments
tile ``[0, makespan]``, so integrating load over them recovers the true
per-link byte counts and busy/idle fractions, and intersecting them
with the job lifecycle events recovers the paper's Fig. 1 time
decomposition (compute vs network-serviced vs network-blocked) per job.

``audit_link_seconds`` is the *independent* cross-check: it rebuilds
per-link busy seconds and bytes from ``repro_torch.analysis.sanitize``
``DecisionRecord`` snapshots alone — no trace segments involved — and
is compared against the trace-derived numbers in tests and in the
``python -m repro_torch.obs`` audit step.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass

import numpy as np

from repro_torch.core.metaflow import EPS
from repro_torch.obs.trace import (
    AuditEvent,
    FabricFaultEvent,
    FlowFinishEvent,
    JobEvent,
    MemoryTracer,
    MfEvent,
    NodeEvent,
    PerturbEvent,
    RerouteEvent,
    RetransmitEvent,
    SchedEvent,
    SegmentEvent,
)

_TINY = 1e-12


# --------------------------------------------------------------------------
# interval algebra (half-open [a, b) intervals, small lists)
# --------------------------------------------------------------------------


def _merge(intervals) -> list[tuple[float, float]]:
    """Union of intervals as a sorted, disjoint list."""
    ivs = sorted((a, b) for a, b in intervals if b > a + _TINY)
    out: list[list[float]] = []
    for a, b in ivs:
        if out and a <= out[-1][1] + _TINY:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _measure(ivs) -> float:
    return sum(b - a for a, b in ivs)


def _subtract(a_ivs, b_ivs) -> list[tuple[float, float]]:
    """A minus B; both must be merged (sorted, disjoint)."""
    out: list[tuple[float, float]] = []
    for a0, a1 in a_ivs:
        cur = a0
        for b0, b1 in b_ivs:
            if b1 <= cur:
                continue
            if b0 >= a1:
                break
            if b0 > cur:
                out.append((cur, min(b0, a1)))
            cur = max(cur, b1)
            if cur >= a1:
                break
        if cur < a1 - _TINY:
            out.append((cur, a1))
    return out


def _intersect(a_ivs, b_ivs) -> list[tuple[float, float]]:
    """A intersect B; both must be merged (sorted, disjoint)."""
    out: list[tuple[float, float]] = []
    for a0, a1 in a_ivs:
        for b0, b1 in b_ivs:
            lo, hi = max(a0, b0), min(a1, b1)
            if hi > lo + _TINY:
                out.append((lo, hi))
    return out


# --------------------------------------------------------------------------
# link utilization
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class LinkUsage:
    """Per-link aggregates over a whole trace (arrays of length n_links)."""

    names: list[str] | None
    cap: np.ndarray  # nominal capacity at run start
    busy_s: np.ndarray  # seconds with load > EPS
    bytes: np.ndarray  # integral of load dt
    util: np.ndarray  # bytes / (cap * span); 0 where cap or span is 0
    peak: np.ndarray  # max instantaneous load
    span: float  # makespan the fractions normalize against

    def name(self, link: int) -> str:
        if self.names is not None:
            return self.names[link]
        return f"link{link}"


def link_utilization(trace: MemoryTracer) -> LinkUsage:
    """Exact per-link busy seconds / bytes / utilization from segments."""
    n_links = trace.n_links
    busy = np.zeros(n_links)
    byts = np.zeros(n_links)
    peak = np.zeros(n_links)
    t_end = 0.0
    for seg in trace.segments():
        dt = seg.t1 - seg.t0
        if dt <= 0.0:
            continue
        busy += (seg.link_load > EPS) * dt
        byts += seg.link_load * dt
        np.maximum(peak, seg.link_load, out=peak)
        t_end = max(t_end, seg.t1)
    span = trace.makespan if trace.makespan is not None else t_end
    cap = trace.link_cap if trace.link_cap is not None else np.zeros(n_links)
    denom = cap * span
    util = np.divide(byts, denom, out=np.zeros(n_links), where=denom > 0.0)
    return LinkUsage(
        names=trace.link_names,
        cap=cap,
        busy_s=busy,
        bytes=byts,
        util=util,
        peak=peak,
        span=span,
    )


def link_timeline(trace: MemoryTracer, link: int) -> list[tuple[float, float, float]]:
    """One link's piecewise-constant load timeline as (t0, t1, load)."""
    return [
        (seg.t0, seg.t1, float(seg.link_load[link]))
        for seg in trace.segments()
        if seg.t1 > seg.t0
    ]


# --------------------------------------------------------------------------
# per-link downtime (hard failures)
# --------------------------------------------------------------------------


def downtime_windows(trace: MemoryTracer) -> dict[int, list[tuple[float, float]]]:
    """Per-link hard-down windows ``[fail_t, repair_t)`` from the fault
    events.  Host fail/repair events expand to the port's up/down link
    pair (the same links ``Fabric.fail_host`` zeroes); windows still
    open at the end of the trace close at the makespan."""
    open_at: dict[int, float] = {}
    out: dict[int, list[tuple[float, float]]] = defaultdict(list)
    for ev in trace.events:
        if type(ev) is not FabricFaultEvent:
            continue
        if ev.kind in ("fail_link", "repair_link"):
            links = (ev.target,)
        elif ev.kind in ("fail_host", "repair_host"):
            links = (ev.target, trace.n_ports + ev.target)
        else:
            continue
        if ev.kind.startswith("fail"):
            for link in links:
                open_at[link] = ev.t
        else:
            for link in links:
                t0 = open_at.pop(link, None)
                if t0 is not None:
                    out[link].append((t0, ev.t))
    if open_at:
        t_end = trace.makespan
        if t_end is None:
            t_end = max(open_at.values())
        for link, t0 in open_at.items():
            if t_end > t0:
                out[link].append((t0, t_end))
    return {link: _merge(ivs) for link, ivs in sorted(out.items())}


def link_downtime(trace: MemoryTracer) -> dict[int, float]:
    """Per-link total hard-down seconds (measure of the windows)."""
    return {link: _measure(ivs) for link, ivs in downtime_windows(trace).items()}


# --------------------------------------------------------------------------
# per-job phase decomposition (paper Fig. 1)
# --------------------------------------------------------------------------


def job_phases(trace: MemoryTracer) -> dict[str, dict[str, float]]:
    """Per-job time decomposition between arrival and completion.

    For each job the lifespan is split into disjoint buckets:

    * ``net_serviced_s`` — some metaflow of the job is active *and*
      receiving positive rate (network is working for the job).
    * ``net_blocked_s``  — some metaflow is active but every one of the
      job's active metaflows has zero rate (network is the bottleneck
      and the policy is servicing someone else).
    * ``compute_s``      — a compute task is running and no metaflow is
      active (pure compute).
    * ``idle_s``         — neither (waiting on DAG dependencies).

    ``overlap_s`` additionally reports time when compute and an active
    metaflow coexist (already counted in the net buckets).  The
    identity ``net_serviced + net_blocked + compute + idle == span``
    holds exactly and is asserted in tests.
    """
    arrive: dict[str, float] = {}
    done: dict[str, float] = {}
    compute: dict[str, list] = defaultdict(list)
    active: dict[str, list] = defaultdict(list)
    serviced: dict[str, list] = defaultdict(list)
    open_c: dict[tuple[str, str], float] = {}
    open_m: dict[tuple[str, str], float] = {}
    for ev in trace.events:
        if type(ev) is SegmentEvent:
            if ev.t1 <= ev.t0:
                continue
            for (job, _mf), rate in zip(ev.mf_pairs, ev.mf_rates):
                if rate > EPS:
                    serviced[job].append((ev.t0, ev.t1))
        elif type(ev) is JobEvent:
            (arrive if ev.kind == "arrive" else done)[ev.job] = ev.t
        elif type(ev) is NodeEvent:
            if ev.kind == "start":
                open_c[(ev.job, ev.node)] = ev.t
            else:
                t0 = open_c.pop((ev.job, ev.node), None)
                if t0 is not None:
                    compute[ev.job].append((t0, ev.t))
        elif type(ev) is MfEvent:
            if ev.kind == "activate":
                open_m[(ev.job, ev.mf)] = ev.t
            else:
                t0 = open_m.pop((ev.job, ev.mf), None)
                if t0 is not None:
                    active[ev.job].append((t0, ev.t))

    out: dict[str, dict[str, float]] = {}
    for job, t_arr in arrive.items():
        t_done = done.get(job, t_arr)
        c_ivs = _merge(compute.get(job, ()))
        a_ivs = _merge(active.get(job, ()))
        # Guard against float edges: serviced time is network time by
        # definition, so clip it to the active windows.
        s_ivs = _intersect(_merge(serviced.get(job, ())), a_ivs)
        span = t_done - t_arr
        net = _measure(s_ivs)
        blocked = _measure(_subtract(a_ivs, s_ivs))
        comp = _measure(_subtract(c_ivs, a_ivs))
        overlap = _measure(_intersect(c_ivs, a_ivs))
        busy = _measure(_merge(list(a_ivs) + list(c_ivs)))
        out[job] = {
            "span_s": span,
            "net_serviced_s": net,
            "net_blocked_s": blocked,
            "compute_s": comp,
            "overlap_s": overlap,
            "idle_s": max(0.0, span - busy),
        }
    return out


# --------------------------------------------------------------------------
# scheduler / run counters
# --------------------------------------------------------------------------


def scheduler_counters(trace: MemoryTracer) -> dict:
    """JSON-ready per-run counter summary.

    Counts are deterministic; the ``sched_wall_*`` entries are host
    wall-clock time spent inside the policy and vary run to run.
    """
    full = refresh = 0
    wall_full = wall_refresh = 0.0
    reasons: dict[str, int] = {}
    n_pert = n_flow_ev = n_segments = audits = findings = 0
    n_fault = n_reroute = n_retrans = 0
    retrans_bytes = 0.0
    for ev in trace.events:
        kind = type(ev)
        if kind is SegmentEvent:
            n_segments += 1
        elif kind is SchedEvent:
            if ev.kind == "full":
                full += 1
                wall_full += ev.wall_s
                reasons[ev.reason] = reasons.get(ev.reason, 0) + 1
            else:
                refresh += 1
                wall_refresh += ev.wall_s
        elif kind is FlowFinishEvent:
            n_flow_ev += 1
        elif kind is PerturbEvent:
            n_pert += 1
        elif kind is FabricFaultEvent:
            n_fault += 1
        elif kind is RerouteEvent:
            n_reroute += 1
        elif kind is RetransmitEvent:
            n_retrans += 1
            retrans_bytes += ev.bytes
        elif kind is AuditEvent:
            audits += 1
            findings += ev.findings
    decisions = full + refresh
    return {
        "sched_full": full,
        "sched_refresh": refresh,
        "cache_hit_ratio": round(refresh / decisions, 4) if decisions else 0.0,
        "full_reasons": dict(sorted(reasons.items())),
        "sched_wall_s": round(wall_full + wall_refresh, 6),
        "sched_wall_full_s": round(wall_full, 6),
        "sched_wall_refresh_s": round(wall_refresh, 6),
        "n_segments": n_segments,
        "n_flow_finish_events": n_flow_ev,
        "n_perturbations": n_pert,
        "n_fault_events": n_fault,
        "n_reroutes": n_reroute,
        "n_retransmit_events": n_retrans,
        "retransmitted_bytes": retrans_bytes,
        "sanitizer_audits": audits,
        "sanitizer_findings": findings,
        "n_trace_events": len(trace.events),
    }


# --------------------------------------------------------------------------
# independent audit from DecisionRecord snapshots
# --------------------------------------------------------------------------


def audit_link_seconds(records, n_links: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-link (busy_seconds, bytes) from DecisionRecords alone.

    Records (``repro_torch.analysis.sanitize.DecisionRecord``) exist only
    while the active set is non-empty, so consecutive records can
    bracket an idle-network gap (compute-only or inter-arrival
    periods).  Each record's rates therefore apply for

        ``dt_k = min(t_{k+1} - t_k, D_k)``

    where ``D_k = max(rem / rate)`` over the record's flows with
    positive rate and positive remaining bytes (the drain horizon; the
    last record uses ``D_k`` alone).  This is exact, not an
    approximation: between consecutive decisions the simulator advances
    at most to the earliest drain time (``t_{k+1} - t_k <= min <= D_k``),
    and a gap can only follow a record whose live flows all drain
    together at ``D_k`` (otherwise an undrained active metaflow would
    have kept the active set non-empty).
    """
    busy = np.zeros(n_links)
    byts = np.zeros(n_links)
    for k, rec in enumerate(records):
        flowing = (rec.rates > EPS) & (rec.rem > EPS)
        if flowing.any():
            horizon = float((rec.rem[flowing] / rec.rates[flowing]).max())
        else:
            horizon = 0.0
        if k + 1 < len(records):
            dt = min(records[k + 1].t - rec.t, horizon)
        else:
            dt = horizon
        if dt <= 0.0:
            continue
        load = rec.link_load()
        busy += (load > EPS) * dt
        byts += load * dt
    return busy, byts
