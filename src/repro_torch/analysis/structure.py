"""Static workload characterizer: the flow↔metaflow↔coflow spectrum.

The paper's core claim is that *where a workload sits between the flow
and coflow extremes* determines how much a structure-aware scheduler
(MSA) can win; MXDAG makes the same point for compute/network
dependency structure.  This module measures that position statically —
no simulation, template state only — so every benchmark number can be
audited against the structure that supposedly explains it.

Per job (:func:`job_structure`):

* **depth / mf_depth / width** — longest path in nodes, max metaflows
  on any path (pipelining depth), and max nodes sharing a longest-path
  level (available parallelism).
* **fan_out** — mean flows per metaflow: 1.0 is the flow extreme, a
  shuffle's reducer fan-in pushes it up.
* **coflow_skew** — mean over metaflows of ``max flow size / mean flow
  size``; 1.0 means uniform shards, higher means stragglers that
  size-based orderings (SEBF) misjudge.
* **barrier_density / mean_barrier_width** — an ``mf → consumer`` edge
  is a *hard barrier* when the metaflow gathers flows from more than
  one distinct source host: the consumer synchronizes several
  producers, the defining coflow trait.  A single-source metaflow edge
  is *pipelined* — a point-to-point handoff MSA can overlap.  Density
  is the barrier fraction of mf→consumer edges; width is the mean
  source count over barrier metaflows (8-wide allreduce vs 2-wide
  shuffle).
* **join_density** — fraction of mf→consumer edges whose consumer
  waits on >1 metaflow *directly* (multi-metaflow joins: an even
  harder synchronization than one wide barrier).
* **comm_fraction** — ``comm / (comm + compute)`` with comm the job's
  whole-flow-set link bound and compute the summed task loads; how much
  of the job the network scheduler can influence at all.

Classification: ``flow`` (no barriers, ~1 flow per metaflow),
``coflow`` (barrier-dominated and shallow — the classic shuffle), else
``metaflow`` (a genuine DAG of metaflows — the paper's middle ground).
A scenario takes the majority job class when it's a ≥ 2/3 majority,
otherwise ``mixed``.

The **predicted MSA advantage score** composes the three ways a
workload can defeat structure-aware scheduling::

    score = comm_fraction                      # nothing to schedule
            * (1 - barrier_density * (1 - 1/mean_barrier_width))
                                               # wide barriers: any
                                               # policy must drain them
            * (1 - join_density)               # multi-mf joins: ditto

Higher means more pipelined, schedulable structure.  The score is a
*prediction*, deliberately simple and fully static;
``repro_torch.experiments.aggregate`` compares its ranking against the
measured per-scenario MSA-vs-varys speedups and reports the Kendall
rank agreement (:func:`rank_agreement`) rather than asserting it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING

from repro_torch.analysis.bounds import _kahn_order, link_seconds

if TYPE_CHECKING:
    from collections.abc import Iterable, Mapping

    from repro_torch.core.fabric import Topology
    from repro_torch.core.metaflow import JobDAG

#: Spectrum classes, flow-most first.
SPECTRUM = ("flow", "metaflow", "coflow")


@dataclass(frozen=True)
class JobStructure:
    """Static structure metrics for one job template."""

    job: str
    n_tasks: int
    n_metaflows: int
    n_flows: int
    depth: int                 # longest path, in nodes
    mf_depth: int              # max metaflows on any path
    width: int                 # max nodes sharing a longest-path level
    fan_out: float             # mean flows per metaflow
    coflow_skew: float         # mean max/mean flow size per metaflow
    barrier_density: float     # hard-barrier fraction of mf->task edges
    mean_barrier_width: float  # mean sources per barrier metaflow
    join_density: float        # multi-mf-join fraction of mf->task edges
    comm_seconds: float        # whole-job link bound
    compute_seconds: float     # summed task loads / machine speed
    comm_fraction: float       # comm / (comm + compute)
    classification: str        # one of SPECTRUM
    msa_advantage_score: float

    def to_json(self) -> dict[str, object]:
        return {
            "job": self.job, "n_tasks": self.n_tasks,
            "n_metaflows": self.n_metaflows, "n_flows": self.n_flows,
            "depth": self.depth, "mf_depth": self.mf_depth,
            "width": self.width, "fan_out": self.fan_out,
            "coflow_skew": self.coflow_skew,
            "barrier_density": self.barrier_density,
            "mean_barrier_width": self.mean_barrier_width,
            "join_density": self.join_density,
            "comm_seconds": self.comm_seconds,
            "compute_seconds": self.compute_seconds,
            "comm_fraction": self.comm_fraction,
            "classification": self.classification,
            "msa_advantage_score": self.msa_advantage_score,
        }


def _classify(barrier_density: float, fan_out: float,
              mf_depth: int) -> str:
    """Place one job on the spectrum (module docstring)."""
    if barrier_density < 0.5 and fan_out <= 1.5:
        return "flow"
    if barrier_density >= 0.5 and mf_depth <= 2:
        return "coflow"
    return "metaflow"


def _score(comm_fraction: float, barrier_density: float,
           mean_barrier_width: float, join_density: float) -> float:
    """The predicted-MSA-advantage composition (module docstring)."""
    width_term = 1.0
    if mean_barrier_width > 1.0:
        width_term = 1.0 - barrier_density * (1.0 - 1.0 / mean_barrier_width)
    return comm_fraction * width_term * (1.0 - join_density)


def job_structure(job: JobDAG, topology: Topology,
                  machine_speed: float = 1.0) -> JobStructure:
    """Measure one job template (pre- or post-simulation: only
    ``size``/``load``/edges are read, never progress state)."""
    names = list(job.tasks) + list(job.metaflows)
    order = _kahn_order(job, names)

    dist: dict[str, int] = {}
    mf_dist: dict[str, int] = {}
    for n in order:
        deps = job.node(n).deps
        dist[n] = 1 + max((dist[d] for d in deps), default=0)
        mf_dist[n] = ((1 if n in job.metaflows else 0)
                      + max((mf_dist[d] for d in deps), default=0))
    level_counts: dict[int, int] = {}
    for n in order:
        level_counts[dist[n]] = level_counts.get(dist[n], 0) + 1

    n_flows = 0
    fan = 0.0
    skews: list[float] = []
    src_width: dict[str, int] = {}
    for name, mf in job.metaflows.items():
        n_flows += len(mf.flows)
        fan += len(mf.flows)
        sizes = [f.size for f in mf.flows if f.size > 0 and f.src != f.dst]
        if sizes:
            skews.append(max(sizes) * len(sizes) / sum(sizes))
        src_width[name] = len({f.src for f in mf.flows
                               if f.size > 0 and f.src != f.dst})

    # mf -> consumer edges: barrier (multi-source mf) vs pipelined,
    # and multi-metaflow joins.
    edges = 0
    barrier_edges = 0
    join_edges = 0
    barrier_widths: list[int] = []
    for n in names:
        mf_deps = [d for d in job.node(n).deps if d in job.metaflows]
        edges += len(mf_deps)
        if len(mf_deps) > 1:
            join_edges += len(mf_deps)
        for d in mf_deps:
            if src_width[d] > 1:
                barrier_edges += 1
                barrier_widths.append(src_width[d])

    comm = link_seconds((f for mf in job.metaflows.values()
                         for f in mf.flows), topology)
    compute = sum(t.load for t in job.tasks.values()) / machine_speed
    total = comm + compute
    comm_fraction = comm / total if total > 0 else 0.0
    barrier_density = barrier_edges / edges if edges else 0.0
    join_density = join_edges / edges if edges else 0.0
    mean_barrier_width = (sum(barrier_widths) / len(barrier_widths)
                          if barrier_widths else 1.0)
    fan_out = fan / len(job.metaflows) if job.metaflows else 0.0
    mf_depth = max(mf_dist.values(), default=0)

    return JobStructure(
        job=job.name, n_tasks=len(job.tasks),
        n_metaflows=len(job.metaflows), n_flows=n_flows,
        depth=max(dist.values(), default=0), mf_depth=mf_depth,
        width=max(level_counts.values(), default=0),
        fan_out=fan_out,
        coflow_skew=(sum(skews) / len(skews) if skews else 1.0),
        barrier_density=barrier_density,
        mean_barrier_width=mean_barrier_width,
        join_density=join_density,
        comm_seconds=comm, compute_seconds=compute,
        comm_fraction=comm_fraction,
        classification=_classify(barrier_density, fan_out, mf_depth),
        msa_advantage_score=_score(comm_fraction, barrier_density,
                                   mean_barrier_width, join_density),
    )


@dataclass(frozen=True)
class ScenarioStructure:
    """One scenario's aggregate position on the spectrum."""

    scenario: str
    n_jobs: int
    jobs: tuple[JobStructure, ...]
    classification: str        # majority class, or "mixed"
    class_counts: tuple[tuple[str, int], ...]   # (class, n), SPECTRUM order
    msa_advantage_score: float                  # unweighted job mean
    barrier_density: float                      # job means below
    join_density: float
    comm_fraction: float
    fan_out: float
    coflow_skew: float
    mf_depth: float

    def to_json(self) -> dict[str, object]:
        return {
            "scenario": self.scenario, "n_jobs": self.n_jobs,
            "classification": self.classification,
            "class_counts": dict(self.class_counts),
            "msa_advantage_score": self.msa_advantage_score,
            "barrier_density": self.barrier_density,
            "join_density": self.join_density,
            "comm_fraction": self.comm_fraction,
            "fan_out": self.fan_out,
            "coflow_skew": self.coflow_skew,
            "mf_depth": self.mf_depth,
            "jobs": [j.to_json() for j in self.jobs],
        }


def scenario_structure(name: str, jobs: list[JobDAG], topology: Topology,
                       machine_speed: float = 1.0) -> ScenarioStructure:
    """Aggregate :func:`job_structure` over a scenario's batch."""
    js = tuple(job_structure(j, topology, machine_speed=machine_speed)
               for j in jobs)
    n = len(js)

    def mean(vals: Iterable[float]) -> float:
        vs = list(vals)
        return sum(vs) / len(vs) if vs else 0.0

    counts = {c: 0 for c in SPECTRUM}
    for j in js:
        counts[j.classification] += 1
    label = "mixed"
    for c in SPECTRUM:
        if n and counts[c] * 3 >= n * 2:       # a >= 2/3 majority
            label = c
            break
    return ScenarioStructure(
        scenario=name, n_jobs=n, jobs=js, classification=label,
        class_counts=tuple((c, counts[c]) for c in SPECTRUM),
        msa_advantage_score=mean(j.msa_advantage_score for j in js),
        barrier_density=mean(j.barrier_density for j in js),
        join_density=mean(j.join_density for j in js),
        comm_fraction=mean(j.comm_fraction for j in js),
        fan_out=mean(j.fan_out for j in js),
        coflow_skew=mean(j.coflow_skew for j in js),
        mf_depth=mean(float(j.mf_depth) for j in js),
    )


def predicted_ranking(structures: Iterable[ScenarioStructure]) -> list[str]:
    """Scenario names, highest predicted MSA advantage first (name
    breaks ties deterministically)."""
    return [s.scenario for s in
            sorted(structures,
                   key=lambda s: (-s.msa_advantage_score, s.scenario))]


def rank_agreement(predicted: Mapping[str, float],
                   measured: Mapping[str, float]) -> float | None:
    """Kendall rank correlation between two score maps over their
    common keys: +1 perfect agreement, -1 perfect inversion, ties in
    either map drop the pair.  ``None`` with < 2 common keys."""
    common = sorted(set(predicted) & set(measured))
    if len(common) < 2:
        return None
    concordant = 0
    discordant = 0
    for i, a in enumerate(common):
        for b in common[i + 1:]:
            dp = predicted[a] - predicted[b]
            dm = measured[a] - measured[b]
            if dp == 0.0 or dm == 0.0:
                continue
            if (dp > 0) == (dm > 0):
                concordant += 1
            else:
                discordant += 1
    n_pairs = len(common) * (len(common) - 1) // 2
    return (concordant - discordant) / n_pairs
