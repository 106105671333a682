"""Typed simulation telemetry: the ``Tracer`` protocol and its sinks.

The simulator's results were endpoint aggregates only (final JCT/CCT on
``SimResult``); everything about *how* a run got there — which link
saturated when, how long a job sat network-blocked, how often the
decision cache actually hit — was thrown away.  This module defines the
event taxonomy (DESIGN.md §14) and the tracer contract the simulator
emits it through:

* ``Tracer`` — the no-op base protocol.  Every hook site in
  ``Simulator.run`` is guarded by one ``if tracer is not None`` check,
  so a ``tracer=None`` run (the default) pays no tracing cost at all:
  no event objects, no per-link bincounts, no wall-clock reads.  The
  overhead contract is tracked as ``tracer_overhead`` in
  ``BENCH_sim_core.json``.
* ``MemoryTracer`` — the standard sink: appends typed event objects in
  simulation order.  Derived views (``repro_torch.obs.views``) and exporters
  (``repro_torch.obs.export``) consume it.

Tracing is observational by construction: no hook mutates simulator
state, so traced runs are bit-identical to untraced ones (asserted for
every registered policy in tests/test_obs.py and by the
``python -m repro_torch.obs --verify`` CI smoke).

Event taxonomy (all times are simulation time):

* ``JobEvent``       — job admitted ("arrive") / retired ("done").
* ``NodeEvent``      — compute task started / finished.
* ``MfEvent``        — metaflow activated (producers done, flows
  schedulable) / finished (last flow drained).
* ``FlowFinishEvent``— flows of one metaflow drained this event without
  finishing it (batched: one event per (event, metaflow) with a count).
* ``SchedEvent``     — one scheduler invocation: ``full`` (structure
  rebuild) vs ``refresh`` (cached-structure fast path), the policy's
  wall time, and the structural-event *reason* that dirtied the cache
  (first cause since the last full schedule).
* ``AuditEvent``     — one ``debug_checks`` sanitizer pass
  (``repro_torch.analysis.sanitize``) and its finding count.
* ``PerturbEvent``   — an applied fabric perturbation (``factor=None``
  is a restore); previously invisible in any output.
* ``FaultEvent``     — an applied hard/soft fabric fault beyond port
  perturbations: ``fail_link`` / ``repair_link`` / ``fail_host`` /
  ``repair_host`` / ``degrade_link`` / ``restore_link``.
* ``RerouteEvent``   — a fault-time re-hash of routes around the
  hard-down set (count of active flows whose route changed).
* ``RetransmitEvent``— in-flight bytes re-added by the retransmission
  policy when a link hard-failed.
* ``SegmentEvent``   — one piecewise-constant rate segment
  ``[t0, t1)``: the dense per-link load vector plus per-active-metaflow
  rate sums.  Segments tile the run exactly (the fluid model holds
  rates constant between events), so integrals over them — per-link
  busy seconds, bytes, per-job service time — are exact, not sampled.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:  # pragma: no cover - import cycle guard, types only
    from repro_torch.core.fabric import Fabric


@dataclass(slots=True)
class JobEvent:
    t: float
    kind: str  # "arrive" | "done"
    job: str


@dataclass(slots=True)
class NodeEvent:
    t: float
    kind: str  # "start" | "finish"
    job: str
    node: str


@dataclass(slots=True)
class MfEvent:
    t: float
    kind: str  # "activate" | "finish"
    job: str
    mf: str


@dataclass(slots=True)
class FlowFinishEvent:
    t: float
    job: str
    mf: str
    count: int  # flows of this metaflow drained at this event


@dataclass(slots=True)
class SchedEvent:
    t: float
    kind: str  # "full" | "refresh"
    wall_s: float  # host wall time inside the policy (nondeterministic)
    reason: str  # structural-event reason for a full schedule; "" on refresh
    n_active: int  # active metaflows the decision covered


@dataclass(slots=True)
class AuditEvent:
    t: float
    findings: int  # sanitizer findings (0 on a clean decision)


@dataclass(slots=True)
class PerturbEvent:
    t: float
    port: int
    factor: float | None  # None = restore to nominal capacity


@dataclass(slots=True)
class FabricFaultEvent:
    """A fault event other than a port perturbation (see module doc).
    ``target`` is a link id for ``*_link`` kinds, a port for ``*_host``."""

    t: float
    kind: str  # fail_link|repair_link|fail_host|repair_host|degrade_link|restore_link
    target: int


@dataclass(slots=True)
class RerouteEvent:
    t: float
    n_flows: int  # active flows whose route changed


@dataclass(slots=True)
class RetransmitEvent:
    t: float
    bytes: float  # total in-flight bytes re-added
    n_flows: int  # flows that lost bytes


@dataclass(slots=True)
class SegmentEvent:
    t0: float
    t1: float
    link_load: np.ndarray  # float64 [n_links] — summed rate per link
    mf_pairs: tuple[tuple[str, str], ...]  # active (job, metaflow) pairs
    mf_rates: np.ndarray  # float64 [len(mf_pairs)] — rate sum per metaflow


class Tracer:
    """No-op base tracer: subclass and override the hooks you need.

    The simulator calls these at its ~10 lifecycle sites; every call
    site is behind one ``if tracer is not None`` check, so the disabled
    path never reaches this class at all.
    """

    def run_begin(self, fabric: "Fabric") -> None:
        """Called once before the event loop with the bound fabric."""

    def run_end(self, makespan: float) -> None:
        """Called once after the last event."""

    def job_arrive(self, t: float, job: str) -> None:
        pass

    def job_done(self, t: float, job: str) -> None:
        pass

    def compute_start(self, t: float, job: str, node: str) -> None:
        pass

    def compute_finish(self, t: float, job: str, node: str) -> None:
        pass

    def mf_activate(self, t: float, job: str, mf: str) -> None:
        pass

    def mf_finish(self, t: float, job: str, mf: str) -> None:
        pass

    def flow_finish(self, t: float, job: str, mf: str, count: int) -> None:
        pass

    def sched(
        self, t: float, kind: str, wall_s: float, reason: str, n_active: int
    ) -> None:
        pass

    def audit(self, t: float, findings: int) -> None:
        pass

    def perturbation(self, t: float, port: int, factor: float | None) -> None:
        pass

    def fault(self, t: float, kind: str, target: int) -> None:
        pass

    def reroute(self, t: float, n_flows: int) -> None:
        pass

    def retransmit(self, t: float, total_bytes: float, n_flows: int) -> None:
        pass

    def segment(
        self,
        t0: float,
        t1: float,
        link_load: np.ndarray,
        mf_pairs: tuple[tuple[str, str], ...],
        mf_rates: np.ndarray,
    ) -> None:
        pass


class MemoryTracer(Tracer):
    """Append-only in-memory sink of typed events, in simulation order.

    Also captures the run's static context at ``run_begin`` (link names
    and nominal capacities — what utilization views normalize against)
    and the makespan at ``run_end``.
    """

    def __init__(self) -> None:
        self.events: list = []
        self.n_ports: int = 0
        self.n_links: int = 0
        self.link_names: list[str] | None = None
        self.link_cap: np.ndarray | None = None  # capacities at run start
        self.makespan: float | None = None

    # ------------------------------------------------------------ context
    def run_begin(self, fabric: "Fabric") -> None:
        self.events.clear()
        self.makespan = None
        self.n_ports = fabric.n_ports
        self.n_links = fabric.n_links
        names = fabric.topology.link_names
        self.link_names = list(names) if names else None
        self.link_cap = fabric.cap.copy()

    def run_end(self, makespan: float) -> None:
        self.makespan = makespan

    # ------------------------------------------------------------- events
    def job_arrive(self, t: float, job: str) -> None:
        self.events.append(JobEvent(t, "arrive", job))

    def job_done(self, t: float, job: str) -> None:
        self.events.append(JobEvent(t, "done", job))

    def compute_start(self, t: float, job: str, node: str) -> None:
        self.events.append(NodeEvent(t, "start", job, node))

    def compute_finish(self, t: float, job: str, node: str) -> None:
        self.events.append(NodeEvent(t, "finish", job, node))

    def mf_activate(self, t: float, job: str, mf: str) -> None:
        self.events.append(MfEvent(t, "activate", job, mf))

    def mf_finish(self, t: float, job: str, mf: str) -> None:
        self.events.append(MfEvent(t, "finish", job, mf))

    def flow_finish(self, t: float, job: str, mf: str, count: int) -> None:
        self.events.append(FlowFinishEvent(t, job, mf, count))

    def sched(
        self, t: float, kind: str, wall_s: float, reason: str, n_active: int
    ) -> None:
        self.events.append(SchedEvent(t, kind, wall_s, reason, n_active))

    def audit(self, t: float, findings: int) -> None:
        self.events.append(AuditEvent(t, findings))

    def perturbation(self, t: float, port: int, factor: float | None) -> None:
        self.events.append(PerturbEvent(t, port, factor))

    def fault(self, t: float, kind: str, target: int) -> None:
        self.events.append(FabricFaultEvent(t, kind, target))

    def reroute(self, t: float, n_flows: int) -> None:
        self.events.append(RerouteEvent(t, n_flows))

    def retransmit(self, t: float, total_bytes: float, n_flows: int) -> None:
        self.events.append(RetransmitEvent(t, total_bytes, n_flows))

    def segment(
        self,
        t0: float,
        t1: float,
        link_load: np.ndarray,
        mf_pairs: tuple[tuple[str, str], ...],
        mf_rates: np.ndarray,
    ) -> None:
        self.events.append(SegmentEvent(t0, t1, link_load, mf_pairs, mf_rates))

    # ------------------------------------------------------------ helpers
    def of(self, cls) -> list:
        """Events of one type, in simulation order."""
        return [ev for ev in self.events if type(ev) is cls]

    def segments(self) -> list[SegmentEvent]:
        return self.of(SegmentEvent)
