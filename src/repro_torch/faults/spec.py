"""Declarative, seeded fault injection: the ``FaultSpec`` DSL.

The simulator core (``repro_torch.core.simulator``) executes *streams* of
:class:`~repro_torch.core.simulator.FaultEvent` — this layer is where those
streams come from.  A :class:`FaultSpec` declares

* **scheduled hard failures** — :class:`LinkFailure` / :class:`HostFailure`
  windows (fail at ``at``, repair at ``repair_at``);
* **seeded renewal processes** — :class:`FlakyLinks` (correlated degrade
  storms over a link set) and :class:`StragglerBurst` (transient port
  slowdowns), which expand deterministically from the spec's seed; and
* a **retransmission policy** applied when links hard-fail,

and ``compile()``-s into one event stream sorted under the simulator's
documented tie-break (``fault_key``), strict-linted by default
(``repro_torch.analysis.lint.lint_faults`` — the ``build_scenario`` strict-mode
analog for fault streams).

Determinism discipline mirrors ``repro_torch.appdag.mixer``: every stochastic
process draws from ``random.Random`` seeded by the spec seed plus the
named :data:`FAULT_STREAM` offset plus the process's index, so streams
are bit-reproducible across runs, machines, and worker counts, and
adding a process never re-rolls the draws of the ones before it.

``chaos_spec`` is the chaos scenario family used by the resilience
sweep: one deterministic fault mix per (workload, intensity, seed) —
hard link failures, flaky-link storms, and straggler bursts, scaled by
``intensity``, over disjoint target sets so soft and hard windows never
collide on one link.
"""

from __future__ import annotations

import random
from dataclasses import dataclass

from repro_torch.core.fabric import Fabric, Topology
from repro_torch.core.metaflow import JobDAG
from repro_torch.core.simulator import FaultEvent, RetransmitPolicy, fault_key

#: Named seed-stream offset (mixer discipline: FB_TEMPLATE_STREAM=1,
#: FB_WIDE_STREAM=101).  Frozen — changing it re-rolls every committed
#: chaos artifact.
FAULT_STREAM = 211


@dataclass(frozen=True)
class LinkFailure:
    """One scheduled hard link failure window ``[at, repair_at)``."""

    link: int
    at: float
    repair_at: float

    def events(self) -> tuple[FaultEvent, ...]:
        return (FaultEvent(self.at, "fail_link", self.link),
                FaultEvent(self.repair_at, "repair_link", self.link))


@dataclass(frozen=True)
class HostFailure:
    """One scheduled hard host (NIC/node) failure window."""

    port: int
    at: float
    repair_at: float

    def events(self) -> tuple[FaultEvent, ...]:
        return (FaultEvent(self.at, "fail_host", self.port),
                FaultEvent(self.repair_at, "repair_host", self.port))


@dataclass(frozen=True)
class FlakyLinks:
    """Correlated degrade storms over a link set (seeded renewal process).

    Storm start gaps and durations are exponential (rates ``storm_rate``
    and ``1/mean_duration``); each storm degrades a correlated random
    subset (``hit_fraction`` of the set, at least one link) by
    ``factor`` and restores it when the storm ends.  Storms are
    serialized (next gap starts after the previous storm ends), so no
    link is ever double-degraded by one process."""

    links: tuple[int, ...]
    storm_rate: float          # mean storms per unit time
    mean_duration: float
    factor: float = 0.25
    hit_fraction: float = 1.0  # correlated fraction of the set per storm

    def events(self, rng: random.Random,
               horizon: float) -> list[FaultEvent]:
        if not self.links:
            return []
        out: list[FaultEvent] = []
        t = rng.expovariate(self.storm_rate)
        k = max(1, round(self.hit_fraction * len(self.links)))
        while t < horizon:
            hit = rng.sample(sorted(self.links), k)
            dur = rng.expovariate(1.0 / self.mean_duration)
            for link in hit:
                out.append(FaultEvent(t, "degrade_link", link, self.factor))
                out.append(FaultEvent(t + dur, "restore_link", link))
            t += dur + rng.expovariate(self.storm_rate)
        return out


@dataclass(frozen=True)
class StragglerBurst:
    """Transient straggler bursts: one port per burst degrades by
    ``factor`` for an exponential duration (seeded renewal process,
    serialized like :class:`FlakyLinks`)."""

    ports: tuple[int, ...]
    burst_rate: float
    mean_duration: float
    factor: float = 0.5

    def events(self, rng: random.Random,
               horizon: float) -> list[FaultEvent]:
        if not self.ports:
            return []
        out: list[FaultEvent] = []
        t = rng.expovariate(self.burst_rate)
        while t < horizon:
            port = rng.choice(sorted(self.ports))
            dur = rng.expovariate(1.0 / self.mean_duration)
            out.append(FaultEvent(t, "degrade_port", port, self.factor))
            out.append(FaultEvent(t + dur, "restore_port", port))
            t += dur + rng.expovariate(self.burst_rate)
        return out


@dataclass(frozen=True)
class FaultSpec:
    """A declarative fault scenario: scheduled failures + seeded
    processes + the retransmission policy, compiling to one
    deterministic event stream."""

    horizon: float
    seed: int = 0
    failures: tuple[LinkFailure | HostFailure, ...] = ()
    processes: tuple[FlakyLinks | StragglerBurst, ...] = ()
    retransmit: RetransmitPolicy | None = None

    def process_rng(self, index: int) -> random.Random:
        """The named, per-process seed stream (see module docstring)."""
        return random.Random((self.seed + FAULT_STREAM) * 1_000_003 + index)

    def compile(self, topology: Topology | None = None,
                lint: bool = True) -> list[FaultEvent]:
        """Expand to the sorted event stream.  ``lint=True`` (default)
        strict-lints it — error findings raise ``LintError``; pass the
        topology so target-range checks see the real link/port counts."""
        events: list[FaultEvent] = []
        for f in self.failures:
            events.extend(f.events())
        for i, proc in enumerate(self.processes):
            events.extend(proc.events(self.process_rng(i), self.horizon))
        events.sort(key=fault_key)
        if lint:
            # Deferred import: repro_torch.analysis builds on repro_torch.core and
            # imports this package back for the CLI fault-lint mode.
            from repro_torch.analysis.lint import lint_faults, strict

            strict(lint_faults(events, topology))
        return events


# --------------------------------------------------------------------------
# the chaos scenario family
# --------------------------------------------------------------------------


def workload_horizon(jobs: list[JobDAG], fabric: Fabric) -> float:
    """Deterministic drain-time estimate the chaos processes run over:
    last arrival plus twice the aggregate-egress serialization time of
    all bytes (generous — faults landing past the real makespan are
    simply never applied)."""
    total = sum(j.total_size() for j in jobs)
    last = max((j.arrival for j in jobs), default=0.0)
    up_cap = float(fabric.cap[:fabric.n_ports].sum()) or 1.0
    return last + 2.0 * total / up_cap + 1.0


def mean_flow_size(jobs: list[JobDAG]) -> float:
    sizes = [f.size
             for j in jobs
             for mf in j.metaflows.values()
             for f in mf.flows
             if f.size > 0]
    if not sizes:
        return 0.0
    return sum(sizes) / len(sizes)


def chaos_spec(fabric: Fabric, jobs: list[JobDAG], intensity: float,
               seed: int = 0) -> FaultSpec:
    """The chaos family: one fault mix per (workload, intensity, seed).

    ``intensity`` scales everything; 0 is the fault-free baseline
    (empty spec).  At intensity ``x``: ``round(x)`` hard link-failure
    windows (each ~5-15% of the horizon, serialized per link), a
    flaky-link process over ``~2x`` links, and a straggler-burst
    process over ``~x`` ports — hard, flaky, and straggler target sets
    kept disjoint so soft windows never land on a hard-down link.
    Retransmission is ``window`` mode sized at a quarter of the mean
    flow size."""
    if intensity < 0:
        raise ValueError(f"fault intensity must be >= 0, got {intensity}")
    horizon = workload_horizon(jobs, fabric)
    if intensity == 0:
        return FaultSpec(horizon=horizon, seed=seed)
    rng = random.Random((seed + FAULT_STREAM) * 1_000_003 + 999)
    n_links = fabric.n_links
    n_ports = fabric.n_ports

    # Hard link failures over distinct links, biased toward host links
    # that actually carry traffic: those have no alternate path, so the
    # failure exercises stall/retransmit semantics instead of landing on
    # an idle link the sweep never notices.
    active_ports = sorted({p for j in jobs
                           for mf in j.metaflows.values()
                           for f in mf.flows
                           for p in (f.src, f.dst)})
    candidates = ([p for p in active_ports]
                  + [n_ports + p for p in active_ports]) or list(range(n_links))
    n_fail = max(1, round(intensity))
    fail_links = sorted(rng.sample(candidates, min(n_fail, len(candidates))))
    failures: list[LinkFailure | HostFailure] = []
    for link in fail_links:
        at = rng.uniform(0.05, 0.45) * horizon
        dur = rng.uniform(0.10, 0.25) * horizon
        failures.append(LinkFailure(link, at, at + dur))

    # Flaky storms over links never hard-failed.
    pool = [link for link in range(n_links) if link not in set(fail_links)]
    n_flaky = min(len(pool), max(2, round(2 * intensity)))
    flaky_links = tuple(sorted(rng.sample(pool, n_flaky))) if n_flaky else ()
    processes: list[FlakyLinks | StragglerBurst] = []
    if flaky_links:
        processes.append(FlakyLinks(
            links=flaky_links,
            storm_rate=2.0 * intensity / horizon,
            mean_duration=0.05 * horizon,
            factor=0.25,
            hit_fraction=0.5,
        ))

    # Straggler bursts over ports whose host links are untouched above.
    taken = set(fail_links) | set(flaky_links)
    free_ports = [p for p in range(n_ports)
                  if p not in taken and (n_ports + p) not in taken]
    n_strag = min(len(free_ports), max(1, round(intensity)))
    if n_strag:
        ports = tuple(sorted(rng.sample(free_ports, n_strag)))
        processes.append(StragglerBurst(
            ports=ports,
            burst_rate=intensity / horizon,
            mean_duration=0.1 * horizon,
            factor=0.5,
        ))

    window = 0.25 * mean_flow_size(jobs)
    retransmit = (RetransmitPolicy("window", window=window)
                  if window > 0 else None)
    return FaultSpec(horizon=horizon, seed=seed,
                     failures=tuple(failures), processes=tuple(processes),
                     retransmit=retransmit)
