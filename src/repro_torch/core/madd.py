"""MADD — Minimum Allocation for Desired Duration (Varys, SIGCOMM'14).

The port's copy of ``repro.core.madd``: only the imports differ.
``tests/test_torch_simref.py`` holds ``madd_rates`` equal to the
reference's and to ``SchedView.madd``'s vector and scalar paths.

Given a set of flows that should all finish *simultaneously* (because the
downstream consumer needs every one of them — the JCT of a stage is the max
over its reducers), MADD computes the slowest bottleneck over the link
resources the flows cross

    gamma = max over links of (link demand / link residual capacity)

and allocates each flow rate = remaining / gamma.  Any rate profile that
finishes some flow earlier wastes bandwidth that other coflows/metaflows
could use; MADD is the minimal allocation achieving the bottleneck time.

On the paper's big-switch fabric the links are exactly the egress and
ingress ports (every flow crosses two), which recovers the textbook
per-port form; on leaf-spine / fat-tree topologies the same max runs
over every link of each flow's deterministic route, so an oversubscribed
core leg correctly dominates the bottleneck.

The paper's MSA adopts MADD verbatim for the per-metaflow bandwidth
assignment step (Algorithm 1, line 11).

This module is the *object-level reference implementation* (readable
``Flow``/``Residual`` arithmetic).  The simulator's hot path runs the
array forms on the compacted flow->links incidence instead —
``SchedView.madd`` (with a scalar small-group variant) in
``core/simulator.py``, DESIGN.md §10/§11 — and
tests/test_sim_core_equiv.py (the reference) and tests/test_torch_simref.py
(the port) cross-check both against this one on randomized groups."""

from __future__ import annotations

from repro_torch.core.fabric import Residual
from repro_torch.core.metaflow import EPS, Flow


def madd_rates(flows: list[Flow], residual: Residual) -> dict[int, float]:
    """Rates finishing all ``flows`` simultaneously within ``residual``.

    Returns {} (all-zero) when any required link has no residual capacity —
    the metaflow waits for this slot; work-conserving backfill may still
    advance individual flows afterwards.  Deducts granted rates from
    ``residual`` in place.
    """
    live = [f for f in flows if not f.done]
    if not live:
        return {}

    dem: dict[int, float] = {}
    for f in live:
        for link in residual.links(f):
            dem[link] = dem.get(link, 0.0) + f.remaining

    gamma = 0.0
    for link, d in dem.items():
        cap = residual.cap[link]
        if cap <= EPS:
            return {}
        g = d / cap
        if g > gamma:
            gamma = g
    if gamma <= EPS:
        return {}

    rates: dict[int, float] = {}
    for f in live:
        r = f.remaining / gamma
        if r <= EPS:
            continue
        r = min(r, residual.headroom(f))  # numeric safety
        if r <= EPS:
            continue
        residual.take(f, r)
        rates[f.id] = r
    return rates


def bottleneck_time(flows: list[Flow], residual: Residual) -> float:
    """Effective-bottleneck completion time on the given (full) link
    capacities — Varys' SEBF key, generalized to any routed topology.

    ``residual`` supplies the capacity vector and routing; it is read,
    never deducted.
    """
    dem: dict[int, float] = {}
    for f in flows:
        if not f.done:
            for link in residual.links(f):
                dem[link] = dem.get(link, 0.0) + f.remaining
    gamma = 0.0
    for link, d in dem.items():
        cap = residual.cap[link]
        gamma = max(gamma, d / cap if cap > EPS else float("inf"))
    return gamma
