"""Arrival-process mixer: job templates -> mixed-cluster scenarios.

Composes the appdag plan extractors with the FB MapReduce synth
(``core/workload.py``) into multi-job scenarios sharing one fabric: each
template DAG is built once at ``port_base=0`` and stamped out via
``JobDAG.instantiate`` with a Poisson arrival time and a random contiguous
port placement (the port-numbering convention of DESIGN.md §9: a job
occupies ``[offset, offset + span)``).

``SCENARIOS`` registers the canonical scenarios (dense-DP training, MoE
EP training, pipelined serving, the mixed cluster where all three share
the fabric with MapReduce, the same mix on a 3:1-oversubscribed
leaf-spine, and a pure FB-shaped MapReduce shuffle control);
``build_scenario(name, seed, quick)`` returns ``(fabric, jobs)`` with
fresh job and fabric objects every call (simulation mutates both), and
strict-lints the compiled batch through ``repro_torch.analysis.lint``
unless called with ``lint=False``.  Each scenario carries a default
network topology in ``SCENARIO_TOPOLOGY`` (big-switch unless stated); the
``topology`` argument overrides it with any ``make_topology`` spec.

This is the port's copy of ``repro.appdag.mixer``
(``tests/test_torch_scenarios.py`` holds every scenario equal to the
reference's).

Seed discipline (DESIGN.md §12): ``build_scenario(name, seed=s, ...)``
is a pure function of its arguments: rebuilding a cell from the same
``(name, seed, quick, topology)`` gives the bit-identical workload.
Scenario builders that need more than one random stream derive them from
the base seed by the *named* offsets below — never by an inline magic
number — so the derivation is explicit and stable across refactors.
"""

from __future__ import annotations

import random
from dataclasses import dataclass

from repro_torch.appdag.plans import (PlanAxes, dense_train_dag,
                                      moe_train_dag, pipeline_serve_dag)
from repro_torch.configs import get_config
from repro_torch.configs.base import LM_SHAPES
from repro_torch.core.fabric import Fabric, make_topology
from repro_torch.core.metaflow import JobDAG
from repro_torch.core.workload import build_job, synth_fb_coflow


# Named seed-stream offsets (see the module docstring).  The values are
# frozen: changing one silently regenerates every scenario.
FB_TEMPLATE_STREAM = 1    # mixed_templates: MapReduce template sampling


@dataclass(frozen=True)
class JobTemplate:
    """One job species in a mix: a template DAG plus its sampling weight."""

    name: str
    dag: JobDAG
    weight: float = 1.0

    @property
    def span(self) -> int:
        """Contiguous port block the template occupies, counting both flow
        endpoints and compute-task machines (a compute-only job — e.g. a
        dp=1 plan — still lives *on* its device's port)."""
        top = max(self.dag.ports_used(), default=-1)
        for t in self.dag.tasks.values():
            top = max(top, t.machine)
        return top + 1


def poisson_mix(templates: list[JobTemplate], n_jobs: int, n_ports: int,
                mean_interarrival: float, seed: int = 0) -> list[JobDAG]:
    """Sample ``n_jobs`` arrivals: template by weight, Poisson spacing,
    uniform-random contiguous placement on the fabric.  Pure in
    ``seed``: the same arguments always produce the same job list."""
    if n_jobs < 1:
        raise ValueError(f"n_jobs must be >= 1, got {n_jobs}")
    if mean_interarrival <= 0:
        raise ValueError("mean_interarrival must be > 0, got "
                         f"{mean_interarrival}")
    rng = random.Random(seed)
    weights = [t.weight for t in templates]
    for t in templates:
        if t.span > n_ports:
            raise ValueError(f"template {t.name!r} needs {t.span} ports, "
                             f"fabric has {n_ports}")
    jobs: list[JobDAG] = []
    t_now = 0.0
    for i in range(n_jobs):
        tpl = rng.choices(templates, weights=weights)[0]
        offset = rng.randrange(0, n_ports - tpl.span + 1)
        jobs.append(tpl.dag.instantiate(name=f"{tpl.name}#{i}",
                                        arrival=t_now, port_offset=offset,
                                        n_ports=n_ports))
        t_now += rng.expovariate(1.0 / mean_interarrival)
    return jobs


def comm_balanced(job: JobDAG, ratio: float = 1.0) -> JobDAG:
    """Rescale a template's comm into the balanced regime (DESIGN.md §8.3
    applied to plan-extracted DAGs, §9): at pod-scale world sizes the TPU
    fabric makes per-step collectives a few ms against seconds of compute,
    so the network is idle and *no* scheduler can matter — the same
    degenerate regime ``workload.py`` normalizes out of the FB trace.
    Scale flow sizes so the job's port-bottleneck transfer time is
    ``ratio`` x its total compute; the lowered round *structure* and
    relative byte proportions are untouched.
    """
    port_bytes: dict[tuple[str, int], float] = {}
    for m in job.metaflows.values():
        for f in m.flows:
            port_bytes[("out", f.src)] = (port_bytes.get(("out", f.src), 0.0)
                                          + f.size)
            port_bytes[("in", f.dst)] = (port_bytes.get(("in", f.dst), 0.0)
                                         + f.size)
    gamma = max(port_bytes.values(), default=0.0)
    if gamma <= 0 or job.total_load() <= 0:
        return job
    return job.instantiate(comm_scale=ratio * job.total_load() / gamma)


def _fb_templates(rng: random.Random, n: int, max_span: int,
                  target_size: float) -> list[JobTemplate]:
    """MapReduce templates from the FB synth, comm-normalized so an
    average job moves ~``target_size`` total (matching the training jobs'
    scale so the mix actually contends)."""
    out = []
    while len(out) < n:
        m, r, sizes = synth_fb_coflow(rng, f"fb{len(out)}")
        if r < 2 or m + r > max_span:
            continue
        job = build_job(f"fb{len(out)}", m, r, sizes, "partial_order", rng,
                        compute_ratio=1.0, compute_mode="balanced")
        scale = target_size / max(job.total_size(), 1e-12)
        out.append(JobTemplate(
            name=f"fb{len(out)}",
            dag=job.instantiate(comm_scale=scale, compute_scale=scale)))
    return out


# ------------------------------------------------------------- scenarios
def scenario_dense_dp(seed: int = 0, quick: bool = False):
    """Dense-transformer DP training: steps of an FSDP job queue up on an
    8-port pod (ring gradient all-reduce per unit)."""
    cfg = get_config("qwen2-7b")
    plan = PlanAxes(dp=8)
    step = comm_balanced(
        dense_train_dag(cfg, LM_SHAPES["train_4k"], plan, max_units=4))
    n_jobs = 3 if quick else 5
    jobs = poisson_mix([JobTemplate("train", step)], n_jobs, plan.world,
                       mean_interarrival=0.5 * step.total_load(), seed=seed)
    return plan.world, jobs


def scenario_moe_ep(seed: int = 0, quick: bool = False):
    """MoE EP training: all-to-all dispatch/combine grads + split
    dense/expert gradient sync on an 8-port pod."""
    cfg = get_config("mixtral-8x22b")
    plan = PlanAxes(dp=8, ep=4)
    step = comm_balanced(
        moe_train_dag(cfg, LM_SHAPES["train_4k"], plan, max_units=3))
    n_jobs = 2 if quick else 4
    jobs = poisson_mix([JobTemplate("moe", step)], n_jobs, plan.world,
                       mean_interarrival=0.5 * step.total_load(), seed=seed)
    return plan.world, jobs


def scenario_pipe_serve(seed: int = 0, quick: bool = False):
    """Pipelined serving: prefill requests stream through a 4-stage
    pipeline; activation p2p hops are the contended metaflows."""
    cfg = get_config("llama3-405b")
    plan = PlanAxes(pp=4)
    req = comm_balanced(pipeline_serve_dag(cfg, plan, n_microbatches=6,
                                           tokens_per_mb=4096), ratio=0.8)
    n_jobs = 4 if quick else 8
    jobs = poisson_mix([JobTemplate("serve", req)], n_jobs, plan.world,
                       mean_interarrival=0.4 * req.total_load(), seed=seed)
    return plan.world, jobs


def mixed_templates(seed: int = 0) -> list[JobTemplate]:
    """The mixed-cluster species list — dense-DP training, pipelined
    serving, and two comm-normalized MapReduce templates."""
    train = comm_balanced(
        dense_train_dag(get_config("qwen2-7b"), LM_SHAPES["train_4k"],
                        PlanAxes(dp=4), max_units=4))
    serve = comm_balanced(
        pipeline_serve_dag(get_config("llama3-405b"), PlanAxes(pp=4),
                           n_microbatches=4, tokens_per_mb=4096), ratio=0.8)
    rng = random.Random(seed + FB_TEMPLATE_STREAM)
    fb = _fb_templates(rng, 2, max_span=12, target_size=train.total_size())
    return [JobTemplate("train", train, weight=1.0),
            JobTemplate("serve", serve, weight=1.5)] + fb


def scenario_mixed(seed: int = 0, quick: bool = False):
    """The mixed cluster: training + serving + MapReduce sharing one
    24-port fabric with random placement — the scenario the paper's
    abstraction exists for."""
    n_ports = 24
    templates = mixed_templates(seed)
    train = templates[0].dag
    n_jobs = 5 if quick else 10
    jobs = poisson_mix(templates, n_jobs, n_ports,
                       mean_interarrival=0.3 * train.total_load(), seed=seed)
    return n_ports, jobs


def scenario_mixed_oversub(seed: int = 0, quick: bool = False):
    """The mixed cluster under core contention: the *identical*
    FB+appdag species and arrival process as ``mixed`` (delegated, so
    the two can never drift apart), but scheduled through a
    3:1-oversubscribed leaf-spine (``SCENARIO_TOPOLOGY``) — random
    contiguous placement makes most training/shuffle spans straddle
    leaves, so the leaf uplinks, not the NICs, become the contended
    resource."""
    return scenario_mixed(seed=seed, quick=quick)


def scenario_fb_shuffle(seed: int = 0, quick: bool = False):
    """Pure MapReduce shuffle mix on a 16-port fabric: FB-trace-shaped
    coflows only — the coflow literature's home turf, where DAGs are
    shallow (map -> shuffle -> reduce) and metaflow gains come almost
    entirely from the direct class.  The control scenario the training
    mixes are compared against."""
    n_ports = 16
    rng = random.Random(seed + FB_TEMPLATE_STREAM)
    templates = _fb_templates(rng, 3, max_span=12, target_size=100.0)
    mean_load = sum(t.dag.total_load() for t in templates) / len(templates)
    n_jobs = 4 if quick else 8
    jobs = poisson_mix(templates, n_jobs, n_ports,
                       mean_interarrival=0.5 * mean_load, seed=seed)
    return n_ports, jobs


SCENARIOS = {
    "dense_dp": scenario_dense_dp,
    "moe_ep": scenario_moe_ep,
    "pipe_serve": scenario_pipe_serve,
    "mixed": scenario_mixed,
    "mixed_oversub_3to1": scenario_mixed_oversub,
    "fb_shuffle": scenario_fb_shuffle,
}

# Default network topology per scenario (big_switch when absent); any
# ``make_topology`` spec.
SCENARIO_TOPOLOGY = {
    "mixed_oversub_3to1": "leaf_spine_3to1",
}


def build_scenario(name: str, seed: int = 0, quick: bool = False,
                   topology: str | None = None, lint: bool = True
                   ) -> tuple[Fabric, list[JobDAG]]:
    """(fresh fabric, fresh jobs) for one registered scenario.

    ``topology`` overrides the scenario's registered default spec.

    Every compile is linted in strict mode (``repro_torch.analysis.lint``):
    error-severity findings — cycles, self-flows, out-of-range ports —
    raise ``LintError`` here instead of failing deep in the simulator.
    ``lint=False`` skips it (the linter itself compiles scenarios this
    way, and perf harnesses may opt out of the O(flows) pass)."""
    if name not in SCENARIOS:
        raise KeyError(f"unknown scenario {name!r}; known: "
                       f"{sorted(SCENARIOS)}")
    n_ports, jobs = SCENARIOS[name](seed=seed, quick=quick)
    spec = topology or SCENARIO_TOPOLOGY.get(name, "big_switch")
    fabric = Fabric(topology=make_topology(spec, n_ports))
    if lint:
        from repro_torch.analysis.lint import lint_jobs, strict
        strict(lint_jobs(jobs, fabric.topology))
    return fabric, jobs
