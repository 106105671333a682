"""Workload synthesis: Facebook-like coflows and the paper's DAG topologies.

The port's copy of ``repro.core.workload``.  The paper replays coflows
from the public Facebook trace (coflow-benchmark ``FB2010-1Hr-150-0.txt``)
and, because the trace carries no DAG information, synthesizes a DAG per
job in three topologies (Fig. 3a): *total order* (chain), *partial order*
(tree-like) and *disorder* (hard barrier).

``synth_fb_coflow`` samples coflows from the published shape of the FB
trace (most coflows are narrow and small; a heavy tail of wide, large
coflows carries most bytes); ``synth_fb_jobs`` turns them into the
paper's single-job scenarios, drawing from one ``random.Random`` in the
reference's order, so the same seed gives the same jobs.
``load_fb_trace`` parses the real coflow-benchmark format when a file is
available.  ``tests/test_torch_simref.py`` holds all three equal to the
reference's.
"""

from __future__ import annotations

import random

from repro_torch.core.metaflow import JobDAG


def _fb_width(rng: random.Random) -> tuple[int, int]:
    """(mappers, reducers) -- heavy-tailed like FB2010 (most narrow, few
    wide), mapper and reducer counts sampled independently."""
    def width(u: float) -> int:
        if u < 0.52:
            return 1
        if u < 0.85:
            return rng.randint(2, 8)
        if u < 0.97:
            return rng.randint(9, 30)
        return rng.randint(31, 100)

    return max(1, width(rng.random())), width(rng.random())


def _fb_flow_size(rng: random.Random) -> float:
    """Per-flow MB -- log-normal body with a heavy tail (trace-shaped)."""
    if rng.random() < 0.9:
        return max(0.1, rng.lognormvariate(1.0, 1.2))       # ~ a few MB
    return max(1.0, rng.lognormvariate(4.0, 1.0))            # tail: 100s of MB


def synth_fb_coflow(rng: random.Random, name: str) -> tuple[int, int, list[list[float]]]:
    """Returns (n_mappers, n_reducers, sizes[m][r]).

    Per-reducer partition skew (log-normal multiplier, sigma ~ 1.3) mirrors
    the reducer skew of production MapReduce workloads and of the FB trace:
    within a job, some metaflows are an order of magnitude smaller than
    others.
    """
    m, r = _fb_width(rng)
    red_skew = [rng.lognormvariate(0.0, 1.3) for _ in range(r)]
    sizes = [[_fb_flow_size(rng) * red_skew[j] for j in range(r)]
             for _ in range(m)]
    return m, r, sizes


def load_fb_trace(path: str, limit: int | None = None
                  ) -> list[tuple[int, int, list[list[float]]]]:
    """Parse the public coflow-benchmark trace format.

    Line format: ``<id> <arrival_ms> <#mappers> <mapper locs...> <#reducers>
    <reducer:MB ...>``; header line: ``<num_ports> <num_coflows>``.
    Per-reducer bytes are split evenly across mappers (the benchmark's own
    convention for simulators without mapper-level detail).
    """
    coflows = []
    with open(path) as fh:
        header = fh.readline().split()
        _ = header
        for line in fh:
            parts = line.split()
            if not parts:
                continue
            k = 2
            n_map = int(parts[k]); k += 1
            k += n_map  # mapper locations (unused: we re-map ports per job)
            n_red = int(parts[k]); k += 1
            red_sizes = []
            for i in range(n_red):
                _, mb = parts[k + i].split(":")
                red_sizes.append(float(mb))
            sizes = [[red_sizes[r] / n_map for r in range(n_red)]
                     for _ in range(n_map)]
            coflows.append((n_map, n_red, sizes))
            if limit and len(coflows) >= limit:
                break
    return coflows


# DAG topologies (paper Fig. 3a).  One metaflow per reducer task; compute
# loads proportional to the reducer's input bytes.
TOPOLOGIES = ("total_order", "partial_order", "disorder")


def build_job(name: str, n_map: int, n_red: int, sizes: list[list[float]],
              topology: str, rng: random.Random,
              compute_ratio: float = 1.0, compute_mode: str = "balanced",
              arrival: float = 0.0, port_base: int = 0) -> JobDAG:
    """Build a JobDAG for one coflow under the given DAG topology.

    Metaflow MF_i = all flows into reducer i.  Compute task c_i always
    depends on MF_i, plus:
      total_order:   c_i depends on c_{i-1}              (chain)
      partial_order: c_i depends on c_{i-w}, w random in 2..4 per job
      disorder:      c_i depends on ALL metaflows        (hard barrier)

    compute_mode='balanced' (default): loads proportional to reducer input
    bytes, normalized so the job's total compute equals compute_ratio x
    its network bottleneck time Gamma.  compute_mode='proportional':
    load_i = compute_ratio * bytes into reducer i.
    """
    if topology not in TOPOLOGIES:
        raise ValueError(f"unknown topology {topology!r}")
    po_width = rng.randint(2, 4)   # partial-order parallelism (per job)
    job = JobDAG(name=name, arrival=arrival)
    mf_names = []
    for r in range(n_red):
        flows = [(port_base + m, port_base + n_map + r, sizes[m][r])
                 for m in range(n_map) if sizes[m][r] > 0]
        mf = f"MF{r}"
        job.add_metaflow(mf, flows=flows)
        mf_names.append(mf)
    total_bytes = sum(sum(row) for row in sizes)
    if compute_mode == "balanced":
        # Gamma on unit ports: max over mapper egress / reducer ingress load.
        gamma = max(
            max((sum(sizes[m][r] for r in range(n_red)) for m in range(n_map)),
                default=0.0),
            max((sum(sizes[m][r] for m in range(n_map)) for r in range(n_red)),
                default=0.0))
        scale = compute_ratio * gamma / total_bytes if total_bytes > 0 else 0.0
    elif compute_mode == "proportional":
        scale = compute_ratio
    else:
        raise ValueError(f"unknown compute_mode {compute_mode!r}")
    for r in range(n_red):
        bytes_in = sum(sizes[m][r] for m in range(n_map))
        load = scale * bytes_in
        if topology == "total_order":
            deps = [mf_names[r]] + ([f"c{r - 1}"] if r > 0 else [])
        elif topology == "partial_order":
            deps = [mf_names[r]]
            if r >= po_width:
                deps.append(f"c{r - po_width}")
        else:  # disorder: hard barrier on every metaflow
            deps = list(mf_names)
        job.add_task(f"c{r}", load=load, machine=port_base + n_map + r,
                     deps=deps)
    job.validate()
    return job


def synth_fb_jobs(n_jobs: int, topology: str, seed: int = 0,
                  compute_ratio: float = 1.0, compute_mode: str = "balanced",
                  min_reducers: int = 2,
                  coflows: list[tuple[int, int, list[list[float]]]] | None = None
                  ) -> list[JobDAG]:
    """``n_jobs`` independent single-job scenarios (the paper's evaluation
    randomly selects 50 jobs and averages their single-job JCTs).

    ``min_reducers`` defaults to 2: single-reducer jobs have a single
    metaflow = a single coflow, so every scheduler is identical on them by
    construction; the paper's DAG generation presupposes multi-task jobs.
    Set to 1 to include them (dilutes all ratios toward 1.0 uniformly).
    """
    rng = random.Random(seed)
    jobs = []
    while len(jobs) < n_jobs:
        i = len(jobs)
        if coflows is not None:
            m, r, sizes = coflows[i % len(coflows)]
        else:
            m, r, sizes = synth_fb_coflow(rng, f"job{i}")
            if r < min_reducers:
                continue
        jobs.append(build_job(f"job{i}", m, r, sizes, topology, rng,
                              compute_ratio=compute_ratio,
                              compute_mode=compute_mode))
    return jobs


def synth_shared_batch(n_jobs: int = 50, seed: int = 11, n_ports: int = 32
                       ) -> list[JobDAG]:
    """``n_jobs`` FB-shaped coflows sharing one ``n_ports`` fabric: the DAG
    topologies in turn, random contiguous placement, staggered arrivals
    (exponential gaps, mean 30).  Enough contention that priorities,
    backfill and the blocked backlog are all exercised.  The defaults give
    the randomized batch of the reference's ``tests/test_sim_core_equiv.py``,
    on which the frozen and the live cores are held equal."""
    rng = random.Random(seed)
    jobs = []
    arrival = 0.0
    while len(jobs) < n_jobs:
        m, r, sizes = synth_fb_coflow(rng, "")
        if r < 2 or m + r > n_ports // 2:
            continue
        base = rng.randrange(0, n_ports - (m + r) + 1)
        jobs.append(build_job(f"j{len(jobs)}", m, r, sizes,
                              TOPOLOGIES[len(jobs) % 3], rng,
                              arrival=arrival, port_base=base))
        arrival += rng.expovariate(1.0 / 30.0)
    return jobs
