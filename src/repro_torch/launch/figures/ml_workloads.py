"""ML-parallelism workloads: every registered policy x appdag scenarios.

The port of the reference's ``benchmarks/ml_workloads.py``: the same rows,
``check()`` and standalone ``main``, on the port's numpy simulator (host
only).

The bridge benchmark the appdag subsystem exists for: real parallelism
plans (dense-DP training, MoE EP training, pipelined serving, the mixed
cluster sharing one fabric with MapReduce, and the same mix through a
3:1-oversubscribed leaf-spine) compiled into JobDAGs and swept across
scheduling policies, reporting per-policy average JCT / CCT per scenario.

Harness rows (``python -m repro_torch.launch.figures``): one row per scenario,
``derived = "<policy>=<jct>/<cct>;..."`` plus ``fifo_over_msa`` /
``fair_over_msa`` ratios when those policies ran.  ``--topology SPEC``
overrides every scenario's network (any ``repro_torch.core.make_topology``
spec, e.g. ``leaf_spine_3to1``, ``fat_tree``); overridden rows are named
``ml/<scenario>@<spec>`` so they never collide with the default
trajectory.

Standalone (runs with per-link ``debug_checks`` — every decision is
verified to never oversubscribe any link of the routed topology):
  PYTHONPATH=src python -m repro_torch.launch.figures.ml_workloads
      [--policy NAME ...]
      [--scenario NAME ...] [--topology SPEC] [--seed N] [--quick]
"""

from __future__ import annotations

from repro_torch.appdag import SCENARIOS
from repro_torch.core import available_policies
from repro_torch.experiments import scenario_rows, topology_arg

DEFAULT_POLICIES = ("msa", "varys", "fifo", "fair", "cpath")


def run(quick: bool = False, policies=None, seed: int = 0,
        topology: str | None = None, analyze: bool = False,
        trace_dir: str | None = None) -> list[tuple]:
    if topology == "big_switch":
        topology = None   # explicit default: same rows/gates as no flag
    policies = tuple(policies) if policies else DEFAULT_POLICIES
    # Row emission is the shared, seed-threaded helper the experiment
    # harness also builds on — one definition of what a cell measures.
    # ``analyze`` adds LP-free lower bounds + per-policy optimality gaps
    # to each row's extra dict (``repro_torch.analysis.bounds``);
    # ``trace_dir`` writes one repro_torch.obs Chrome trace per cell into it
    # (rows and derived strings are unchanged — tracing is observational).
    return scenario_rows(tuple(SCENARIOS), policies, seed=seed,
                         quick=quick, topology=topology, analyze=analyze,
                         trace_dir=trace_dir)


def check(rows) -> list[str]:
    """Sanity gates: every policy completes every scenario with finite
    positive JCTs; where the default set ran, MSA (DAG-aware) beats
    per-flow fairness everywhere and beats DAG-blind FIFO on the mixed
    cluster — the scenario the paper's abstraction exists for."""
    errs = []
    for name, _, derived, *extras in rows:
        parts = dict(kv.split("=", 1) for kv in derived.split(";"))
        ratios = {k: float(v) for k, v in parts.items()
                  if k.endswith("_over_msa")}
        extra = extras[0] if extras else {}
        for pol, gap in extra.get("optimality_gap", {}).items():
            # An achieved mean JCT below its LP-free lower bound means
            # the bound (or the simulator) is broken, not the policy.
            if gap < 1.0 - 1e-6:
                errs.append(f"{name}: {pol} mean JCT beat its lower "
                            f"bound (gap {gap:.4f} < 1)")
        for p, v in parts.items():
            if p.endswith("_over_msa") or p == "gap":
                continue
            jct, cct = (float(x) for x in v.split("/"))
            if not (0 < jct < float("inf")) or not (0 <= cct <= jct + 1e-9):
                errs.append(f"{name}: degenerate {p} jct/cct {v}")
        if "@" in name:
            continue   # routed topology: the paper ratios don't apply
        if "fair_over_msa" in ratios and ratios["fair_over_msa"] < 1.0:
            errs.append(f"{name}: MSA loses to per-flow fairness "
                        f"({ratios['fair_over_msa']:.3f})")
        if name == "ml/mixed" and "fifo_over_msa" in ratios \
                and ratios["fifo_over_msa"] < 1.05:
            errs.append(f"mixed cluster: DAG-awareness shows no win over "
                        f"FIFO ({ratios['fifo_over_msa']:.3f})")
    return errs


def main() -> None:
    import argparse

    from repro_torch.appdag import build_scenario
    from repro_torch.experiments import Cell, resolve_topology, run_cell

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--policy", action="append", default=None,
                    choices=available_policies(), metavar="NAME",
                    help="policy to run (repeatable; default: "
                         f"{', '.join(DEFAULT_POLICIES)})")
    ap.add_argument("--scenario", action="append", default=None,
                    choices=sorted(SCENARIOS), metavar="NAME",
                    help="scenario to run (repeatable; default: all)")
    ap.add_argument("--topology", default=None, metavar="SPEC",
                    type=topology_arg,
                    help="network topology override (big_switch, "
                         "leaf_spine_<R>to1, fat_tree; default: each "
                         "scenario's registered topology)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--analyze", action="store_true",
                    help="compute LP-free lower bounds; print the mean "
                         "JCT optimality gap per policy")
    args = ap.parse_args()
    policies = tuple(args.policy) if args.policy else DEFAULT_POLICIES
    scenarios = tuple(args.scenario) if args.scenario else tuple(SCENARIOS)

    for scen in scenarios:
        fabric, jobs = build_scenario(scen, seed=args.seed, quick=args.quick,
                                      topology=args.topology)
        print(f"\n== {scen}  ({fabric.topology.describe()}, {len(jobs)} "
              f"jobs, {sum(len(j.metaflows) for j in jobs)} metaflows) ==")
        gap_hdr = f" {'JCT gap':>9}" if args.analyze else ""
        print(f"  {'policy':<8} {'avg JCT':>12} {'avg CCT':>12}{gap_hdr}")
        for pname in policies:
            rec = run_cell(Cell(scenario=scen, policy=pname,
                                topology=resolve_topology(scen,
                                                          args.topology),
                                seed=args.seed),
                           quick=args.quick, debug_checks=True,
                           analyze=args.analyze)
            r = rec["result"]
            gap_col = ""
            if args.analyze and r.get("jct_bound"):
                from repro_torch.analysis.bounds import mean_gap
                gap = mean_gap(r["jct"], r["jct_bound"])
                gap_col = f" {gap:>8.3f}x" if gap is not None else ""
            print(f"  {pname:<8} {r['avg_jct']:>12.3f} "
                  f"{r['avg_cct']:>12.3f}{gap_col}")


if __name__ == "__main__":
    main()
