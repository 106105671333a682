"""Trace exporters: Chrome ``trace_event`` JSON and compact JSONL.

The Chrome export is loadable in Perfetto (ui.perfetto.dev) or
chrome://tracing and lays the run out as three processes:

* pid 1 "links"     — one counter track per link that ever carries
  load (name = the topology's link name, value = instantaneous load),
  plus instant markers for perturbations.
* pid 2 "jobs"      — one thread per job (arrival order): complete
  ("X") slices for every compute task (cat "compute") and every active
  metaflow window (cat "metaflow"), with arrive/done instants.
* pid 3 "scheduler" — one instant per scheduler invocation
  ("full:<reason>" or "refresh") carrying the policy wall time and
  active-set size in args.

All timestamps are simulation time in microseconds; events are sorted
by ``ts`` so every track is monotone (asserted in tests and by
``python -m repro_torch.obs --verify``).

The JSONL export is a line-per-event stream of the full taxonomy (one
``meta`` header line, segments with sparse non-zero loads) for ad-hoc
``jq``/pandas processing without loading a whole trace in memory.
"""

from __future__ import annotations

import json

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
from repro_torch.obs.views import downtime_windows

_US = 1e6  # trace_event timestamps are microseconds


def _link_name(trace: MemoryTracer, link: int) -> str:
    if trace.link_names is not None:
        return trace.link_names[link]
    return f"link{link}"


def chrome_trace(trace: MemoryTracer) -> dict:
    """Render a trace as a Chrome ``trace_event`` JSON document."""
    meta: list[dict] = [
        {
            "ph": "M",
            "pid": pid,
            "tid": 0,
            "name": "process_name",
            "args": {"name": name},
        }
        for pid, name in ((1, "links"), (2, "jobs"), (3, "scheduler"))
    ]
    events: list[dict] = []

    # --- link counter tracks (pid 1): emit on change only -----------------
    n_links = trace.n_links
    prev = np.zeros(n_links)
    seen = np.zeros(n_links, dtype=bool)
    t_last = 0.0
    for seg in trace.segments():
        if seg.t1 <= seg.t0:
            continue
        load = seg.link_load
        for link in np.nonzero(load != prev)[0]:
            value = float(load[link])
            if value <= EPS and not seen[link]:
                continue
            seen[link] = True
            events.append(
                {
                    "ph": "C",
                    "pid": 1,
                    "tid": 0,
                    "name": _link_name(trace, int(link)),
                    "ts": seg.t0 * _US,
                    "args": {"load": value},
                }
            )
        prev = load
        t_last = seg.t1
    makespan = trace.makespan if trace.makespan is not None else t_last
    for link in np.nonzero(seen & (prev > EPS))[0]:
        events.append(
            {
                "ph": "C",
                "pid": 1,
                "tid": 0,
                "name": _link_name(trace, int(link)),
                "ts": makespan * _US,
                "args": {"load": 0.0},
            }
        )

    # --- job tracks (pid 2) ----------------------------------------------
    tids: dict[str, int] = {}
    open_slices: dict[tuple[str, str, str], float] = {}

    def tid_of(job: str) -> int:
        if job not in tids:
            tids[job] = len(tids) + 1
            meta.append(
                {
                    "ph": "M",
                    "pid": 2,
                    "tid": tids[job],
                    "name": "thread_name",
                    "args": {"name": job},
                }
            )
        return tids[job]

    for ev in trace.events:
        kind = type(ev)
        if kind is JobEvent:
            events.append(
                {
                    "ph": "i",
                    "s": "t",
                    "pid": 2,
                    "tid": tid_of(ev.job),
                    "ts": ev.t * _US,
                    "name": ev.kind,
                }
            )
        elif kind is NodeEvent or kind is MfEvent:
            cat = "compute" if kind is NodeEvent else "metaflow"
            name = ev.node if kind is NodeEvent else ev.mf
            key = (cat, ev.job, name)
            if ev.kind in ("start", "activate"):
                open_slices[key] = ev.t
            else:
                t0 = open_slices.pop(key, None)
                if t0 is not None:
                    events.append(
                        {
                            "ph": "X",
                            "pid": 2,
                            "tid": tid_of(ev.job),
                            "ts": t0 * _US,
                            "dur": (ev.t - t0) * _US,
                            "name": name,
                            "cat": cat,
                        }
                    )
        elif kind is SchedEvent:
            name = f"full:{ev.reason}" if ev.kind == "full" else "refresh"
            events.append(
                {
                    "ph": "i",
                    "s": "t",
                    "pid": 3,
                    "tid": 1,
                    "ts": ev.t * _US,
                    "name": name,
                    "args": {
                        "wall_us": round(ev.wall_s * _US, 3),
                        "n_active": ev.n_active,
                    },
                }
            )
        elif kind is PerturbEvent:
            if ev.factor is None:
                name = f"restore[{ev.port}]"
            else:
                name = f"degrade[{ev.port}]x{ev.factor:g}"
            events.append(
                {
                    "ph": "i",
                    "s": "g",
                    "pid": 1,
                    "tid": 0,
                    "ts": ev.t * _US,
                    "name": name,
                }
            )
        elif kind is FabricFaultEvent:
            events.append(
                {
                    "ph": "i",
                    "s": "g",
                    "pid": 1,
                    "tid": 0,
                    "ts": ev.t * _US,
                    "name": f"{ev.kind}[{ev.target}]",
                    "cat": "fault",
                }
            )
        elif kind is RerouteEvent:
            events.append(
                {
                    "ph": "i",
                    "s": "g",
                    "pid": 1,
                    "tid": 0,
                    "ts": ev.t * _US,
                    "name": f"reroute({ev.n_flows} flows)",
                    "cat": "fault",
                }
            )
        elif kind is RetransmitEvent:
            events.append(
                {
                    "ph": "i",
                    "s": "g",
                    "pid": 1,
                    "tid": 0,
                    "ts": ev.t * _US,
                    "name": f"retransmit {ev.bytes:g}B",
                    "cat": "fault",
                    "args": {"bytes": ev.bytes, "n_flows": ev.n_flows},
                }
            )

    # --- hard-down windows (pid 1): one complete slice per failure ------
    for link, windows in downtime_windows(trace).items():
        for t0, t1 in windows:
            events.append(
                {
                    "ph": "X",
                    "pid": 1,
                    "tid": 0,
                    "ts": t0 * _US,
                    "dur": (t1 - t0) * _US,
                    "name": f"down:{_link_name(trace, link)}",
                    "cat": "fault",
                }
            )

    events.sort(key=lambda e: e["ts"])
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def write_chrome_trace(trace: MemoryTracer, path) -> dict:
    """Write the Chrome trace JSON to ``path``; returns the document."""
    doc = chrome_trace(trace)
    with open(path, "w") as fh:
        json.dump(doc, fh)
        fh.write("\n")
    return doc


# --------------------------------------------------------------------------
# JSONL
# --------------------------------------------------------------------------


def jsonl_events(trace: MemoryTracer):
    """Yield one JSON-ready dict per trace event (plus a meta header)."""
    yield {
        "ev": "meta",
        "n_ports": trace.n_ports,
        "n_links": trace.n_links,
        "link_names": trace.link_names,
        "link_cap": None if trace.link_cap is None else trace.link_cap.tolist(),
        "makespan": trace.makespan,
    }
    for ev in trace.events:
        kind = type(ev)
        if kind is SegmentEvent:
            nz = np.nonzero(ev.link_load > EPS)[0]
            yield {
                "ev": "seg",
                "t0": ev.t0,
                "t1": ev.t1,
                "load": [[int(li), float(ev.link_load[li])] for li in nz],
                "mf": [
                    [job, mf, float(rate)]
                    for (job, mf), rate in zip(ev.mf_pairs, ev.mf_rates)
                ],
            }
        elif kind is JobEvent:
            yield {"ev": "job", "kind": ev.kind, "t": ev.t, "job": ev.job}
        elif kind is NodeEvent:
            yield {
                "ev": "node",
                "kind": ev.kind,
                "t": ev.t,
                "job": ev.job,
                "node": ev.node,
            }
        elif kind is MfEvent:
            yield {
                "ev": "mf",
                "kind": ev.kind,
                "t": ev.t,
                "job": ev.job,
                "mf": ev.mf,
            }
        elif kind is FlowFinishEvent:
            yield {
                "ev": "flow_finish",
                "t": ev.t,
                "job": ev.job,
                "mf": ev.mf,
                "count": ev.count,
            }
        elif kind is SchedEvent:
            yield {
                "ev": "sched",
                "kind": ev.kind,
                "t": ev.t,
                "wall_s": ev.wall_s,
                "reason": ev.reason,
                "n_active": ev.n_active,
            }
        elif kind is AuditEvent:
            yield {"ev": "audit", "t": ev.t, "findings": ev.findings}
        elif kind is PerturbEvent:
            yield {
                "ev": "pert",
                "t": ev.t,
                "port": ev.port,
                "factor": ev.factor,
            }
        elif kind is FabricFaultEvent:
            yield {
                "ev": "fault",
                "t": ev.t,
                "kind": ev.kind,
                "target": ev.target,
            }
        elif kind is RerouteEvent:
            yield {"ev": "reroute", "t": ev.t, "n_flows": ev.n_flows}
        elif kind is RetransmitEvent:
            yield {
                "ev": "retransmit",
                "t": ev.t,
                "bytes": ev.bytes,
                "n_flows": ev.n_flows,
            }


def write_jsonl(trace: MemoryTracer, path) -> int:
    """Write the JSONL stream to ``path``; returns the line count."""
    n = 0
    with open(path, "w") as fh:
        for rec in jsonl_events(trace):
            fh.write(json.dumps(rec))
            fh.write("\n")
            n += 1
    return n
