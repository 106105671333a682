"""LP-free lower bounds on CCT/JCT — the optimality-gap denominator.

"Experimental Analysis of Algorithms for Coflow Scheduling" evaluates
every heuristic against a computable lower bound instead of only against
other heuristics; this module gives the repo the same axis without an LP
solver, from two relaxations that hold for *any* feasible schedule on an
unperturbed fabric:

* **link bound** — a set of flows routed via ``Topology.path`` pushes
  ``sum(size)`` bytes through every link its members cross; a link of
  capacity ``c`` moves at most ``c`` bytes per unit time even with the
  rest of the fabric idle, so the set needs at least
  ``max_link(bytes_on_link / cap)`` time units.  Applied per metaflow
  (its CCT bound) and to a whole job's flow set (all flows must be done
  by the job's CCT and JCT).
* **critical-path bound** — dependencies serialize: node ``n`` cannot
  finish before ``weight(n) + max over deps d of finish(d)``, with
  ``weight(task) = load / machine_speed`` (compute is uncontended, unit
  speed is its best case) and ``weight(metaflow) =`` its link bound.
  One topological DP per job; the max over metaflow nodes lower-bounds
  the CCT, the max over all nodes the JCT.

The default (``tight=True``) composes the two per *node* — the
load+chain shape of Shafiee & Ghaderi's "Scheduling Coflows with
Dependency Graph": every metaflow in a node's transitive dependency
closure must finish before the node does, and those metaflows' flows
all share the fabric, so

    ``finish(n) >= link_seconds(flows of mf-ancestors(n))``
    (``+ load(n)`` for a compute node: its work runs strictly after)

joins the DP as an extra ``max`` term per node.  Every term of the
chain-only bound (``tight=False``) is retained, so the tight bound dominates
it by construction — ``tests/test_analysis.py`` checks the dominance
exactly on randomized workloads — while remaining schedule-free: the
load term never assumes serialization between incomparable metaflows,
only that their bytes cross capacitated links.

Both relaxations ignore cross-job contention (see
:mod:`repro_torch.analysis.contention` for the batch-level load+chain bounds
that do account for it), so ``bound <= achieved`` for every policy —
the achieved/bound ratio is the per-job *optimality gap* (>= 1, smaller
is better) that ``run_cell(analyze=True)`` attaches to every
:class:`~repro_torch.core.results.RunResult` and
``repro_torch.experiments.aggregate`` summarizes per policy.

The bounds read template state only (``Flow.size``, ``ComputeTask.
load``, the DAG edges — never ``remaining``/``finish_time``), so they
may be computed before or after the simulation mutates the jobs.
Perturbed (degraded) fabrics only *lose* capacity, so bounds computed on
the nominal topology remain valid there too.
"""

from __future__ import annotations

from collections.abc import Iterable

from repro_torch.core.fabric import Topology
from repro_torch.core.metaflow import Flow, JobDAG, Metaflow


def flow_link_bytes(flows: Iterable[Flow],
                    topology: Topology) -> dict[int, float]:
    """Per-link byte totals of one flow set, routed via
    ``Topology.path`` (degenerate flows — zero bytes, self-flows — push
    nothing)."""
    link_bytes: dict[int, float] = {}
    for f in flows:
        if f.size <= 0 or f.src == f.dst:
            continue
        for link in topology.path(f.src, f.dst):
            link_bytes[link] = link_bytes.get(link, 0.0) + f.size
    return link_bytes


def _seconds(link_bytes: dict[int, float], topology: Topology) -> float:
    return max((b / float(topology.cap[link])
                for link, b in link_bytes.items()
                if topology.cap[link] > 0), default=0.0)


def link_seconds(flows: Iterable[Flow], topology: Topology) -> float:
    """Link bound for one flow set: ``max_link(bytes / cap)`` with every
    flow routed via ``Topology.path`` (0.0 for an empty set)."""
    return _seconds(flow_link_bytes(flows, topology), topology)


def mf_cct_lower_bound(mf: Metaflow, topology: Topology) -> float:
    """Per-metaflow CCT lower bound: its flows' link bound."""
    return link_seconds(mf.flows, topology)


def _mf_ancestors(job: JobDAG, names: list[str],
                  order: list[str]) -> dict[str, frozenset[str]]:
    """Static transitive metaflow closure per node: every metaflow that
    must *finish* before the node finishes (a metaflow contains itself).
    Unlike ``JobDAG.unfinished_mf_requirements`` this never consults
    ``done`` flags, so it reads identically pre- and post-simulation."""
    req: dict[str, frozenset[str]] = {}
    for n in order:                      # Kahn order: deps already solved
        acc: set[str] = set()
        if n in job.metaflows:
            acc.add(n)
        for d in job.node(n).deps:
            acc |= req[d]
        req[n] = frozenset(acc)
    return req


def _kahn_order(job: JobDAG, names: list[str]) -> list[str]:
    """Topological order (independent of ``JobDAG.validate`` so a
    linted-but-unvalidated DAG can't loop us); raises on a cycle."""
    indeg = {n: len(job.node(n).deps) for n in names}
    out: dict[str, list[str]] = {n: [] for n in names}
    for n in names:
        for d in job.node(n).deps:
            out[d].append(n)
    frontier = [n for n in names if indeg[n] == 0]
    order: list[str] = []
    while frontier:
        n = frontier.pop()
        order.append(n)
        for m in out[n]:
            indeg[m] -= 1
            if indeg[m] == 0:
                frontier.append(m)
    if len(order) != len(names):
        raise ValueError(f"job {job.name!r} has a dependency cycle; "
                         "lint it before bounding")
    return order


def job_lower_bounds(job: JobDAG, topology: Topology,
                     machine_speed: float = 1.0,
                     tight: bool = True) -> tuple[float, float]:
    """``(jct_lb, cct_lb)`` for one job, both measured from its arrival
    (matching ``SimResult.jct`` / ``.cct`` semantics).

    ``tight=True`` (default) adds the per-node load+chain terms (module
    docstring); ``tight=False`` is the chain-only bound, kept so
    the dominance of the tight composition stays exactly testable."""
    names = list(job.tasks) + list(job.metaflows)
    order = _kahn_order(job, names)

    weight: dict[str, float] = {}
    mf_bytes: dict[str, dict[int, float]] = {}
    for n, t in job.tasks.items():
        weight[n] = t.load / machine_speed
    for n, mf in job.metaflows.items():
        mf_bytes[n] = flow_link_bytes(mf.flows, topology)
        weight[n] = _seconds(mf_bytes[n], topology)

    req = _mf_ancestors(job, names, order) if tight else {}
    # Load term per distinct closure (many nodes share one): the bytes
    # of every required metaflow, summed per link, then max_l bytes/cap.
    closure_seconds: dict[frozenset[str], float] = {}

    def load_term(mfs: frozenset[str]) -> float:
        hit = closure_seconds.get(mfs)
        if hit is None:
            acc: dict[int, float] = {}
            for m in mfs:
                for link, b in mf_bytes[m].items():
                    acc[link] = acc.get(link, 0.0) + b
            hit = closure_seconds[mfs] = _seconds(acc, topology)
        return hit

    # Longest path to each node's completion, with the per-node load
    # floor folded in so it propagates down every downstream chain.
    dist: dict[str, float] = {}
    for n in order:
        d = weight[n] + max((dist[p] for p in job.node(n).deps),
                            default=0.0)
        if tight:
            floor = load_term(req[n])
            if n in job.tasks:
                floor += weight[n]       # compute strictly after its mfs
            d = max(d, floor)
        dist[n] = d

    # All of a job's flows (across metaflows) share the fabric too.
    whole = link_seconds((f for mf in job.metaflows.values()
                          for f in mf.flows), topology)
    cct_lb = max(max((dist[n] for n in job.metaflows), default=0.0), whole)
    jct_lb = max(max(dist.values(), default=0.0), whole)
    return jct_lb, cct_lb


def scenario_lower_bounds(jobs: list[JobDAG], topology: Topology,
                          machine_speed: float = 1.0, tight: bool = True
                          ) -> tuple[dict[str, float], dict[str, float]]:
    """Per-job ``(jct_bound, cct_bound)`` maps for a whole batch."""
    jct_b: dict[str, float] = {}
    cct_b: dict[str, float] = {}
    for j in jobs:
        jct_b[j.name], cct_b[j.name] = job_lower_bounds(
            j, topology, machine_speed=machine_speed, tight=tight)
    return jct_b, cct_b


def mean_gap(achieved: dict[str, float],
             bounds: dict[str, float]) -> float | None:
    """Mean per-job achieved/bound ratio over jobs with a positive bound
    (``None`` when no job has one — e.g. compute-only batches)."""
    ratios = [achieved[j] / b for j, b in bounds.items()
              if b > 0 and j in achieved]
    if not ratios:
        return None
    return sum(ratios) / len(ratios)


def assert_bounds_hold(achieved: dict[str, float],
                       bounds: dict[str, float], what: str,
                       rel_tol: float = 1e-6) -> None:
    """Sanity gate: a bound exceeding its achieved value is a bug in the
    bound (or the simulator), never a property of the workload."""
    for j, b in bounds.items():
        got = achieved.get(j)
        if got is not None and got < b * (1.0 - rel_tol) - 1e-9:
            raise AssertionError(
                f"{what} lower bound violated for job {j!r}: "
                f"bound {b:.17g} > achieved {got:.17g}")
