"""Structured per-run summaries: ``RunResult`` (the port's copy of
``repro.core.results``).

Every benchmark and experiment harness used to distill ``SimResult``
into its own ad-hoc dict (perf rows, harness rows, sweep cells), each
picking slightly different fields and rounding.  ``RunResult`` is the
one JSON-stable summary of a single ``simulate`` run: the scalar
aggregates every consumer reports, plus the per-job JCT/CCT maps the
experiment aggregator needs for normalized-slowdown CDFs.

All fields except ``wall_s`` are fully determined by (jobs, scheduler,
fabric) — ``wall_s`` is the only machine-dependent value, so aggregate
fingerprints and determinism tests must exclude exactly that field
(see ``repro_torch.experiments.aggregate``).
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.simulator import SimResult


@dataclass(frozen=True)
class RunResult:
    """JSON-stable summary of one simulation run."""

    n_jobs: int
    avg_jct: float
    avg_cct: float
    makespan: float
    events: int
    sched_full: int
    sched_refresh: int
    jct: dict[str, float]     # per-job completion time since arrival
    cct: dict[str, float]     # per-job last-flow completion since arrival
    wall_s: float = 0.0       # host wall clock; the only nondeterministic field
    # LP-free per-job lower bounds (repro_torch.analysis.bounds), carried only
    # by analyze-mode runs: serialization omits them when None so default
    # artifacts (and their fingerprints) are byte-identical to before.
    jct_bound: dict[str, float] | None = None
    cct_bound: dict[str, float] | None = None
    # Certified batch-level makespan lower bound (repro_torch.analysis.
    # contention) — the cross-job load+chain composition; analyze-mode
    # only, omitted when None like the per-job bounds above.
    makespan_bound: float | None = None
    # Applied fabric degrade/restore events.  Previously invisible in any
    # output; serialization omits the default 0 (perturbation-free runs —
    # all pinned artifacts — stay byte-identical).
    n_perturbations: int = 0
    # repro_torch.obs scheduler-counter summary, carried only by traced runs
    # (includes nondeterministic policy wall times); omitted when None.
    trace_counters: dict | None = None
    # Resilience accounting (repro_torch.faults): hard fault events applied,
    # in-flight bytes re-added by the retransmission policy, seconds at
    # least one live flow was stalled on a hard-down link (union and
    # flow-weighted integral), and time from the last repair to the end
    # of the run.  All omitted at the fault-free default of 0, so every
    # pinned fault-free artifact stays byte-identical.
    n_faults: int = 0
    retransmitted_bytes: float = 0.0
    stall_s: float = 0.0
    flow_stall_s: float = 0.0
    recovery_lag_s: float = 0.0

    @classmethod
    def from_sim(cls, res: SimResult, wall_s: float = 0.0,
                 jct_bound: dict[str, float] | None = None,
                 cct_bound: dict[str, float] | None = None,
                 makespan_bound: float | None = None,
                 trace_counters: dict | None = None) -> RunResult:
        return cls(n_jobs=len(res.jct), avg_jct=res.avg_jct,
                   avg_cct=res.avg_cct, makespan=res.makespan,
                   events=res.events, sched_full=res.sched_full,
                   sched_refresh=res.sched_refresh, jct=dict(res.jct),
                   cct=dict(res.cct), wall_s=wall_s,
                   jct_bound=dict(jct_bound) if jct_bound else None,
                   cct_bound=dict(cct_bound) if cct_bound else None,
                   makespan_bound=makespan_bound,
                   n_perturbations=res.n_perturbations,
                   trace_counters=dict(trace_counters)
                   if trace_counters else None,
                   n_faults=res.n_faults,
                   retransmitted_bytes=res.retransmitted_bytes,
                   stall_s=res.stall_s,
                   flow_stall_s=res.flow_stall_s,
                   recovery_lag_s=res.recovery_lag_s)

    def to_json(self) -> dict:
        doc = {"n_jobs": self.n_jobs, "avg_jct": self.avg_jct,
               "avg_cct": self.avg_cct, "makespan": self.makespan,
               "events": self.events, "sched_full": self.sched_full,
               "sched_refresh": self.sched_refresh, "jct": dict(self.jct),
               "cct": dict(self.cct), "wall_s": self.wall_s}
        if self.jct_bound is not None:
            doc["jct_bound"] = dict(self.jct_bound)
        if self.cct_bound is not None:
            doc["cct_bound"] = dict(self.cct_bound)
        if self.makespan_bound is not None:
            doc["makespan_bound"] = self.makespan_bound
        if self.n_perturbations:
            doc["n_perturbations"] = self.n_perturbations
        if self.trace_counters is not None:
            doc["trace_counters"] = dict(self.trace_counters)
        if self.n_faults:
            doc["n_faults"] = self.n_faults
        if self.retransmitted_bytes:
            doc["retransmitted_bytes"] = self.retransmitted_bytes
        if self.stall_s:
            doc["stall_s"] = self.stall_s
        if self.flow_stall_s:
            doc["flow_stall_s"] = self.flow_stall_s
        if self.recovery_lag_s:
            doc["recovery_lag_s"] = self.recovery_lag_s
        return doc

    @classmethod
    def from_json(cls, doc: dict) -> RunResult:
        return cls(n_jobs=doc["n_jobs"], avg_jct=doc["avg_jct"],
                   avg_cct=doc["avg_cct"], makespan=doc["makespan"],
                   events=doc["events"], sched_full=doc["sched_full"],
                   sched_refresh=doc["sched_refresh"], jct=dict(doc["jct"]),
                   cct=dict(doc["cct"]), wall_s=doc["wall_s"],
                   jct_bound=doc.get("jct_bound"),
                   cct_bound=doc.get("cct_bound"),
                   makespan_bound=doc.get("makespan_bound"),
                   n_perturbations=doc.get("n_perturbations", 0),
                   trace_counters=doc.get("trace_counters"),
                   n_faults=doc.get("n_faults", 0),
                   retransmitted_bytes=doc.get("retransmitted_bytes", 0.0),
                   stall_s=doc.get("stall_s", 0.0),
                   flow_stall_s=doc.get("flow_stall_s", 0.0),
                   recovery_lag_s=doc.get("recovery_lag_s", 0.0))

    def perf_row(self) -> dict:
        """The scalar row shape of the perf trajectories
        (``BENCH_sim_core.json``): wall rounded for stable diffs,
        events/sec derived from the raw wall."""
        return {"wall_s": round(self.wall_s, 3), "events": self.events,
                "events_per_s": round(self.events / self.wall_s, 1)
                if self.wall_s > 0 else 0.0,
                "sched_full": self.sched_full,
                "sched_refresh": self.sched_refresh,
                "avg_jct": self.avg_jct}
