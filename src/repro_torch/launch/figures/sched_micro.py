"""Scheduler decision latency + decision-caching microbenchmark.

The port of the reference's ``benchmarks/sched_micro.py``: the same rows
and ``check()``, on the port's numpy simulator and policies (host only).
Its latencies and ``wall_speedup`` read the host's clock.

Two measurements per policy (resolved through the ``repro_torch.core.sched``
registry, so ``--policy`` works for anything registered):

* ``latency``  — one full ``schedule()`` call vs active flow count (MSA
  re-sorts on every metaflow event; at datacenter scale the decision cost
  matters — the paper's ongoing-work section targets online deployment).
* ``caching``  — a 50-job Facebook-trace workload (total-order DAGs, the
  paper's headline topology) run twice through the simulator: with
  event-driven decision caching (lifecycle hooks + ``refresh``) and with
  ``cache_decisions=False`` (full ``schedule()`` every event).  Reports
  the full-invocation reduction and event-loop wall-clock, and fails if a
  cacheable policy saves < 1.5x invocations or if caching changes any
  JCT/CCT (it must be bit-exact by the Scheduler contract).
"""

from __future__ import annotations

import random
import time

import numpy as np

from repro_torch.core import Fabric, Simulator, make_scheduler, simulate
from repro_torch.core.workload import build_job, synth_fb_jobs

DEFAULT_POLICIES = ("msa", "varys", "fifo", "fair", "cpath")
# Per-flow fairness redistributes on every byte drained: no cacheable
# structure, exempt from the invocation-reduction check.
UNCACHEABLE = ("fair",)


def _one_call_us(n_map: int, n_red: int, sched) -> float:
    rng = random.Random(0)
    sizes = [[1.0 + rng.random() for _ in range(n_red)]
             for _ in range(n_map)]
    job = build_job("j", n_map, n_red, sizes, "total_order", rng)
    sim = Simulator(Fabric(n_ports=n_map + n_red), [job], sched)
    from repro_torch.core.simulator import SchedView
    recs = list(sim._mfs)
    for rec in recs:
        rec.view_ix = rec.flow_ix   # hand-built full-table view
    view = SchedView(
        t=0.0, n_ports=sim.fabric.n_ports, src=sim._src, dst=sim._dst,
        rem=sim._rem, egress=np.asarray(sim.fabric.egress, dtype=np.float64),
        ingress=np.asarray(sim.fabric.ingress, dtype=np.float64), active=recs,
        jobs=[job], mf_records={job.name: recs})
    sched.schedule(view)   # warm caches
    n = 20
    t0 = time.perf_counter()
    for _ in range(n):
        job.mark_dirty()
        sched.on_job_arrival(job)   # invalidate versioned structure caches
        sched.schedule(view)
    return (time.perf_counter() - t0) / n * 1e6


def _caching_run(policy: str, n_jobs: int, cache: bool):
    """(full_calls, events, wall_seconds, result_signature).

    Only the event loops are timed — workload synthesis and scheduler
    construction happen outside the measured region, so ``wall_speedup``
    really is the event-loop comparison the check cares about."""
    jobs = synth_fb_jobs(n_jobs, "total_order", seed=0)
    scheds = [make_scheduler(policy) for _ in jobs]
    full = events = 0
    sig: list[float] = []
    wall = 0.0
    for j, sched in zip(jobs, scheds):
        t0 = time.perf_counter()
        res = simulate([j], sched, cache_decisions=cache)
        wall += time.perf_counter() - t0
        full += res.sched_full
        events += res.events
        sig.append(res.avg_jct)
        sig.append(res.avg_cct)
    return full, events, wall, tuple(sig)


def run(quick: bool = False, policies=None) -> list[tuple]:
    policies = tuple(policies) if policies else DEFAULT_POLICIES
    rows = []
    sizes = [(4, 8), (16, 32)] if quick else [(4, 8), (16, 32), (50, 100)]
    for n_map, n_red in sizes:
        for pname in policies:
            us = _one_call_us(n_map, n_red, make_scheduler(pname))
            rows.append((f"sched_micro/latency/{pname}/{n_map}x{n_red}", us,
                         f"flows={n_map * n_red}"))
    n_jobs = 12 if quick else 50
    for pname in policies:
        full_c, events, wall_c, sig_c = _caching_run(pname, n_jobs, True)
        full_u, _, wall_u, sig_u = _caching_run(pname, n_jobs, False)
        rows.append((
            f"sched_micro/caching/{pname}", wall_c * 1e6,
            f"events={events};full_cached={full_c};full_uncached={full_u};"
            f"inv_ratio={full_u / max(full_c, 1):.2f};"
            f"wall_speedup={wall_u / max(wall_c, 1e-9):.2f};"
            f"identical={int(sig_c == sig_u)}"))
    return rows


def check(rows) -> list[str]:
    errs = []
    for name, us, derived in rows:
        if "/latency/" in name:
            # Decision latency must stay far below fabric RTT budgets (~ms).
            if us > 100_000:
                errs.append(f"{name}: {us:.0f}us decision latency too slow")
            continue
        parts = dict(kv.split("=") for kv in derived.split(";"))
        pname = name.rsplit("/", 1)[1]
        if parts["identical"] != "1":
            errs.append(f"{name}: decision caching changed JCT/CCT results")
        if pname not in UNCACHEABLE and float(parts["inv_ratio"]) < 1.5:
            errs.append(f"{name}: only {parts['inv_ratio']}x fewer full "
                        f"scheduler invocations from caching (< 1.5x)")
    return errs
