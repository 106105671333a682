"""Cross-job contention graph + certified batch bounds (DESIGN.md §16).

:mod:`repro_torch.analysis.bounds` bounds each job *in isolation* — valid for
any feasible schedule precisely because an adversarial schedule may run
one job at full speed while starving the rest, so no per-job bound may
charge a job for other jobs' bytes.  What cross-job contention *does*
certify is the batch level: every byte of every job must cross its
links, and a byte of job ``j`` cannot move before ``j`` arrives.  This
module aggregates, per link, the total bytes all jobs push through it
(the *contention graph*) and derives the two batch-level load+chain
bounds, the shape of Shafiee & Ghaderi's "Scheduling Coflows with
Dependency Graph":

* **load bound** (release-date-aware) — for link ``l`` and any arrival
  instant ``a``, the jobs arriving at or after ``a`` push their
  ``bytes_l`` through ``l`` no earlier than ``a``, so the batch cannot
  end before ``a + sum(bytes_l | arrival >= a) / cap_l``.  Maximized
  over links and over the arrival suffixes of each link's job set —
  with simultaneous arrivals this is exactly the classic
  ``max_l(sum_jobs bytes_l / cap_l)``, and release dates only raise it.
* **chain bound** — job ``j`` cannot finish before ``arrival_j +
  jct_lb_j`` (the per-job critical-path/load bound), so the batch
  cannot end before the max over jobs.

``makespan_lb = max(load, chain)`` lower-bounds the simulator's
``SimResult.makespan`` (absolute end of the run) for any feasible
schedule; ``batch_cct_lb`` is the same composition over CCT bounds and
lower-bounds ``max_j(arrival_j + cct_j)`` (the instant the last flow of
the batch drains).  Both dominate the chain-only per-job bounds by
construction: the chain term alone is the max of the per-job bounds
offset by their arrivals, and the load term only adds to the max —
``tests/test_analysis.py`` pins the dominance exactly, per scenario and
policy.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.analysis.bounds import flow_link_bytes, scenario_lower_bounds
from repro_torch.core.fabric import Topology
from repro_torch.core.metaflow import JobDAG


@dataclass(frozen=True)
class LinkContention:
    """One link's cross-job aggregate: who pushes how much through it."""

    link: int
    name: str
    cap: float
    bytes: float               # total bytes across all jobs
    n_jobs: int                # jobs routing >= 1 byte through this link
    seconds: float             # bytes / cap (inf-free: 0 when cap <= 0)

    def to_json(self) -> dict[str, object]:
        return {"link": self.link, "name": self.name, "cap": self.cap,
                "bytes": self.bytes, "n_jobs": self.n_jobs,
                "seconds": self.seconds}


def contention_graph(jobs: list[JobDAG],
                     topology: Topology) -> list[LinkContention]:
    """Per-link cross-job aggregates, busiest (most seconds) first.
    Links no job touches are omitted."""
    link_bytes: dict[int, float] = {}
    link_jobs: dict[int, int] = {}
    for j in jobs:
        per_job = flow_link_bytes(
            (f for mf in j.metaflows.values() for f in mf.flows), topology)
        for link, b in per_job.items():
            link_bytes[link] = link_bytes.get(link, 0.0) + b
            link_jobs[link] = link_jobs.get(link, 0) + 1
    out = []
    for link, b in link_bytes.items():
        cap = float(topology.cap[link])
        out.append(LinkContention(
            link=link,
            name=topology.link_names[link] if topology.link_names
            else str(link),
            cap=cap, bytes=b, n_jobs=link_jobs[link],
            seconds=b / cap if cap > 0 else 0.0))
    out.sort(key=lambda c: (-c.seconds, c.link))
    return out


def link_load_bound(jobs: list[JobDAG], topology: Topology) -> float:
    """The release-date-aware load bound (module docstring): the max
    over links and arrival suffixes of ``arrival + suffix_bytes / cap``.
    An absolute instant (not measured from any arrival)."""
    per_link: dict[int, list[tuple[float, float]]] = {}
    for j in jobs:
        jb = flow_link_bytes(
            (f for mf in j.metaflows.values() for f in mf.flows), topology)
        for link, b in jb.items():
            per_link.setdefault(link, []).append((j.arrival, b))
    best = 0.0
    for link, entries in per_link.items():
        cap = float(topology.cap[link])
        if cap <= 0:
            continue
        entries.sort(key=lambda ab: -ab[0])    # latest arrival first
        suffix = 0.0
        for arrival, b in entries:
            suffix += b
            best = max(best, arrival + suffix / cap)
    return best


@dataclass(frozen=True)
class BatchBounds:
    """Certified batch-level lower bounds (absolute instants)."""

    makespan_lb: float         # no feasible schedule ends the batch earlier
    batch_cct_lb: float        # ... or drains the last flow earlier
    load_lb: float             # the cross-job link-load term
    chain_lb: float            # max_j arrival_j + jct_lb_j
    chain_cct_lb: float        # max_j arrival_j + cct_lb_j
    bottleneck: str | None     # busiest link's name (None: no flows)

    def to_json(self) -> dict[str, object]:
        return {"makespan_lb": self.makespan_lb,
                "batch_cct_lb": self.batch_cct_lb,
                "load_lb": self.load_lb, "chain_lb": self.chain_lb,
                "chain_cct_lb": self.chain_cct_lb,
                "bottleneck": self.bottleneck}


def batch_bounds(jobs: list[JobDAG], topology: Topology,
                 machine_speed: float = 1.0,
                 tight: bool = True) -> BatchBounds:
    """The load+chain batch bounds for one scenario (module docstring).

    ``tight`` selects the per-job composition the chain terms build on
    (see :func:`repro_torch.analysis.bounds.job_lower_bounds`); the load term
    is unaffected."""
    jct_b, cct_b = scenario_lower_bounds(jobs, topology,
                                         machine_speed=machine_speed,
                                         tight=tight)
    arrival = {j.name: j.arrival for j in jobs}
    chain = max((arrival[n] + b for n, b in jct_b.items()), default=0.0)
    chain_cct = max((arrival[n] + b for n, b in cct_b.items()), default=0.0)
    load = link_load_bound(jobs, topology)
    graph = contention_graph(jobs, topology)
    return BatchBounds(
        makespan_lb=max(load, chain),
        batch_cct_lb=max(load, chain_cct),
        load_lb=load, chain_lb=chain, chain_cct_lb=chain_cct,
        bottleneck=graph[0].name if graph else None)


def assert_batch_bounds_hold(bounds: BatchBounds, makespan: float,
                             cct: dict[str, float],
                             arrivals: dict[str, float], what: str,
                             rel_tol: float = 1e-6) -> None:
    """Sanity gate, the batch-level twin of ``assert_bounds_hold``: an
    achieved makespan (or last-flow drain) beating its certified bound
    is a bug in the bound or the simulator, never the workload."""
    slack = 1.0 - rel_tol
    if makespan < bounds.makespan_lb * slack - 1e-9:
        raise AssertionError(
            f"{what}: makespan bound violated: {bounds.makespan_lb:.17g} "
            f"> achieved {makespan:.17g}")
    last_drain = max((arrivals[n] + t for n, t in cct.items()), default=0.0)
    if last_drain < bounds.batch_cct_lb * slack - 1e-9:
        raise AssertionError(
            f"{what}: batch CCT bound violated: {bounds.batch_cct_lb:.17g} "
            f"> achieved {last_drain:.17g}")
