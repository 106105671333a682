"""Workload synthesis: Facebook-like coflows and the paper's DAG topologies.

The port's copy of what the scenario builder takes from
``repro.core.workload``: the FB2010-shaped coflow sampler and
``build_job``.  The reference's trace reader is left out (it reads a file
the repo does not hold).

``synth_fb_coflow`` samples coflows from the published shape of the FB
trace (most coflows are narrow and small; a heavy tail of wide, large
coflows carries most bytes).
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
