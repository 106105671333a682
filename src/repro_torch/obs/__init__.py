"""repro_torch.obs — structured simulation telemetry (DESIGN.md §14); the
port's copy of ``repro.obs``.

Event tracing for the fluid simulator (zero overhead when off), exact
derived views (per-link utilization timelines, the paper's Fig. 1
per-job phase decomposition, scheduler counters), and exporters
(Chrome ``trace_event`` JSON for Perfetto, compact JSONL).

Quickstart::

    PYTHONPATH=src python -m repro_torch.obs --scenario mixed --policy msa \\
        -o trace.json

or programmatically::

    from repro_torch.core import simulate
    from repro_torch.obs import MemoryTracer, link_utilization

    tr = MemoryTracer()
    res = simulate(jobs, scheduler, fabric=fabric, tracer=tr)
    usage = link_utilization(tr)
"""

from repro_torch.obs.export import (
    chrome_trace,
    jsonl_events,
    write_chrome_trace,
    write_jsonl,
)
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
    Tracer,
)
from repro_torch.obs.views import (
    LinkUsage,
    audit_link_seconds,
    downtime_windows,
    job_phases,
    link_downtime,
    link_timeline,
    link_utilization,
    scheduler_counters,
)

__all__ = [
    "AuditEvent",
    "FabricFaultEvent",
    "FlowFinishEvent",
    "JobEvent",
    "LinkUsage",
    "MemoryTracer",
    "MfEvent",
    "NodeEvent",
    "PerturbEvent",
    "RerouteEvent",
    "RetransmitEvent",
    "SchedEvent",
    "SegmentEvent",
    "Tracer",
    "audit_link_seconds",
    "chrome_trace",
    "downtime_windows",
    "job_phases",
    "jsonl_events",
    "link_downtime",
    "link_timeline",
    "link_utilization",
    "scheduler_counters",
    "write_chrome_trace",
    "write_jsonl",
]
