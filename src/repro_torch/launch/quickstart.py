"""Quickstart: the paper's two worked examples through the public API.

    PYTHONPATH=src python -m repro_torch.launch.quickstart

The port of the reference's ``examples/quickstart.py``, with the same
output, on the port's numpy simulator (host only).

Walks Figure 1 (MSA avg JCT 7 vs Varys 8) with the full event timeline and
Figure 2 (gain classification), then schedules a synthesized Facebook-like
job under every policy in the ``repro_torch.core.sched`` registry.
"""

import random

from repro_torch.core import (available_policies, figure1_jobs, figure2_job,
                        make_scheduler, metaflow_priorities, simulate)
from repro_torch.core.workload import build_job, synth_fb_coflow


def main() -> None:
    print("=" * 72)
    print("Figure 1 — two jobs on a 3x3 fabric")
    print("=" * 72)
    for pname in ("varys", "msa"):
        res = simulate(figure1_jobs(), make_scheduler(pname), n_ports=3,
                       record_timeline=True)
        print(f"\n--- {pname} ---")
        print(f"avg CCT = {res.avg_cct:.2f}   avg JCT = {res.avg_jct:.2f}"
              f"   (JCTs: J1={res.jct['J1']:.0f}, J2={res.jct['J2']:.0f})")
        print(f"service order: "
              f"{' -> '.join(f'{j}/{m}' for j, m in res.mf_service_order)}")
        for t, msg in res.timeline:
            if "finish" in msg or "start" in msg:
                print(f"   t={t:5.2f}  {msg}")
    print("\npaper ground truth: Varys avg JCT 8, MSA avg JCT 7  [OK]")

    print()
    print("=" * 72)
    print("Figure 2 — gain classification")
    print("=" * 72)
    job = figure2_job()
    active = [(job, mf) for mf in job.metaflows.values()]
    for p in metaflow_priorities([job], active):
        kind = (f"direct   gain={p.gain:.2f}" if p.direct
                else f"indirect attr={p.attribute:.2f}")
        print(f"   {p.name}: {kind}")

    print()
    print("=" * 72)
    print(f"A synthesized Facebook-like job under all registered policies "
          f"({', '.join(available_policies())})")
    print("=" * 72)
    rng = random.Random(7)
    m, r, sizes = synth_fb_coflow(rng, "job")
    print(f"   job: {m} mappers -> {r} reducers, "
          f"{sum(map(sum, sizes)):.1f} MB total")
    for pname in available_policies():
        job = build_job("job", m, r, sizes, "total_order", random.Random(7))
        res = simulate([job], make_scheduler(pname))
        print(f"   {pname:6s}: JCT = {res.avg_jct:8.2f}  "
              f"(CCT {res.avg_cct:8.2f}, {res.events} events, "
              f"{res.sched_full} full / {res.sched_refresh} cached decisions)")


if __name__ == "__main__":
    main()
