"""Walk the appdag pipeline end to end: parallelism plan -> collective
lowering -> JobDAG -> scheduler comparison on a mixed ML cluster.

    PYTHONPATH=src python -m repro_torch.launch.ml_cluster
    PYTHONPATH=src python -m repro_torch.launch.ml_cluster --arch mixtral-8x22b --ep 4
    PYTHONPATH=src python -m repro_torch.launch.ml_cluster --algorithm halving_doubling

The port of the reference's ``examples/ml_cluster.py``, with the same flags
and output, on the port's appdag copy and numpy simulator (host only).
"""

import argparse

from repro_torch.appdag import (PlanAxes, build_scenario, dense_train_dag,
                          lower_collective, moe_train_dag)
from repro_torch.configs import get_config
from repro_torch.configs.base import LM_SHAPES
from repro_torch.core import available_policies, make_scheduler, simulate

DEFAULT_POLICIES = ("msa", "varys", "fifo", "fair")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--dp", type=int, default=8)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--pp", type=int, default=1)
    ap.add_argument("--ep", type=int, default=1)
    ap.add_argument("--algorithm", default="ring",
                    choices=("ring", "halving_doubling", "direct"))
    ap.add_argument("--max-units", type=int, default=4)
    ap.add_argument("--policy", action="append", default=None,
                    choices=available_policies(), metavar="NAME")
    args = ap.parse_args()
    policies = tuple(args.policy) if args.policy else DEFAULT_POLICIES

    cfg = get_config(args.arch)
    plan = PlanAxes(dp=args.dp, tp=args.tp, pp=args.pp, ep=args.ep)

    # 1. What one lowered collective looks like.
    lc = lower_collective("all_reduce", range(args.dp), 1.0, args.algorithm)
    print(f"all_reduce over {args.dp} ranks via {args.algorithm}: "
          f"{len(lc.rounds)} rounds, {lc.n_flows} flows, "
          f"{lc.total_bytes:.2f}x the buffer on the wire "
          f"(exact: 2(P-1) = {2 * (args.dp - 1)})")

    # 2. The whole training step as a JobDAG.
    build = moe_train_dag if (cfg.is_moe and args.ep > 1) else dense_train_dag
    step = build(cfg, LM_SHAPES["train_4k"], plan, algorithm=args.algorithm,
                 max_units=args.max_units)
    print(f"\n{cfg.name} step DAG under dp={args.dp} tp={args.tp} "
          f"pp={args.pp} ep={args.ep}: {len(step.tasks)} compute tasks, "
          f"{len(step.metaflows)} metaflows, "
          f"{sum(len(m.flows) for m in step.metaflows.values())} flows "
          f"on {plan.world} ports")

    # 3. Policies head-to-head on the canonical mixed cluster.
    print("\nmixed cluster (training + serving + MapReduce, one fabric):")
    print(f"  {'policy':<8} {'avg JCT':>10} {'avg CCT':>10}")
    for pname in policies:
        fabric, jobs = build_scenario("mixed", seed=0)
        res = simulate(jobs, make_scheduler(pname), fabric=fabric)
        print(f"  {pname:<8} {res.avg_jct:>10.3f} {res.avg_cct:>10.3f}")


if __name__ == "__main__":
    main()
