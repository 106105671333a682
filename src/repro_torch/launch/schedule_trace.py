"""Schedule a coflow workload (synthesized or real trace file) under a set
of registry policies and report per-topology JCT ratios — the paper's
evaluation as a CLI.

    PYTHONPATH=src python -m repro_torch.launch.schedule_trace --jobs 20
    PYTHONPATH=src python -m repro_torch.launch.schedule_trace \
        --policy msa --policy cpath
    PYTHONPATH=src python -m repro_torch.launch.schedule_trace \
        --trace FB2010-1Hr-150-0.txt

The port of the reference's ``examples/schedule_trace.py``, with the same
flags and output, on the port's numpy simulator (host only).
"""

import argparse

from repro_torch.core import available_policies, make_scheduler, simulate
from repro_torch.core.workload import TOPOLOGIES, load_fb_trace, synth_fb_jobs

DEFAULT_POLICIES = ("msa", "varys", "fair")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--jobs", type=int, default=20)
    ap.add_argument("--trace", default=None,
                    help="coflow-benchmark trace file (optional)")
    ap.add_argument("--policy", action="append", default=None,
                    choices=available_policies(), metavar="NAME",
                    help="policy to evaluate (repeatable; default: "
                         f"{', '.join(DEFAULT_POLICIES)})")
    ap.add_argument("--compute-ratio", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args()
    policies = tuple(args.policy) if args.policy else DEFAULT_POLICIES

    coflows = load_fb_trace(args.trace, limit=args.jobs) if args.trace else None
    header = " ".join(f"{p:>10s}" for p in policies)
    ratio_col = f"{'varys/msa':>10s}" if {"msa", "varys"} <= set(policies) else ""
    print(f"{'topology':16s} {header} {ratio_col}")
    for topo in TOPOLOGIES:
        avg = {}
        for pname in policies:
            sched = make_scheduler(pname)
            jobs = synth_fb_jobs(args.jobs, topo, seed=args.seed,
                                 compute_ratio=args.compute_ratio,
                                 coflows=coflows)
            avg[pname] = sum(simulate([j], sched).avg_jct
                             for j in jobs) / args.jobs
        cells = " ".join(f"{avg[p]:10.2f}" for p in policies)
        ratio = (f" {avg['varys'] / avg['msa']:10.3f}"
                 if {"msa", "varys"} <= set(policies) else "")
        print(f"{topo:16s} {cells}{ratio}")


if __name__ == "__main__":
    main()
