"""Figure harness — one module per paper table/figure + framework
integration tables.  Prints ``name,us_per_call,derived`` CSV rows and
fails (exit 1) if any figure's check() finds a regression.

The port of the reference's ``benchmarks/run.py``, with the same flags,
rows and checks:

  fig1_motivation  — paper Fig 1 exact arithmetic (MSA 7 vs Varys 8)
  fig3_topologies  — paper Fig 3b topology sweep, two workload regimes
  comm_overlap     — MSA on our own training-step DAG (all archs)
  ml_workloads     — every policy x the appdag scenarios
  sched_micro      — scheduler decision latency + decision caching
  roofline_table   — §Roofline summary from the port's dry-run cells

Every figure runs the port's numpy simulator on the host; nothing here
touches a device.  Scheduling policies resolve through the
``repro_torch.core.sched`` registry; ``--policy NAME`` (repeatable)
overrides the policy set for the figures that take one.

``--json PATH`` additionally writes the rows (and any check failures) as
a machine-readable JSON document, to PATH and nowhere else.

Usage: python -m repro_torch.launch.figures [--quick] [--only NAME]
       [--policy NAME ...] [--json PATH] [--seed N] [--topology SPEC]
       [--analyze] [--trace DIR]

``--analyze`` threads through every figure whose ``run`` takes it
(currently ``ml_workloads``): each cell additionally computes LP-free
per-job JCT/CCT lower bounds (``repro_torch.analysis.bounds``), asserts
the achieved times never beat them, and JSON rows gain
``jct_lower_bound`` and per-policy ``optimality_gap`` fields.

``--seed`` threads through every figure whose ``run`` takes one
(scenario construction is pure in the seed); unknown ``--policy`` /
``--topology`` values fail fast with the list of valid choices.
"""

from __future__ import annotations

import argparse
import inspect
import json
import sys

from repro_torch.core.sched import available_policies
from repro_torch.experiments import topology_arg
from repro_torch.launch.figures import (comm_overlap, fig1_motivation,
                                        fig3_topologies, ml_workloads,
                                        roofline_table, sched_micro)

BENCHES = {
    "fig1_motivation": fig1_motivation,
    "fig3_topologies": fig3_topologies,
    "comm_overlap": comm_overlap,
    "ml_workloads": ml_workloads,
    "sched_micro": sched_micro,
    "roofline_table": roofline_table,
}


def main(argv: list[str] | None = None) -> int:
    """Run the figures; returns the exit code (1 when a check failed)."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.figures")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--only", choices=sorted(BENCHES))
    ap.add_argument("--policy", action="append", default=None,
                    choices=available_policies(), metavar="NAME",
                    help="scheduling policy to run (repeatable; "
                         f"available: {', '.join(available_policies())})")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="also write rows + check failures as JSON")
    ap.add_argument("--topology", metavar="SPEC", default=None,
                    type=topology_arg,
                    help="network topology override for the figures that "
                         "take one (big_switch, leaf_spine_<R>to1, "
                         "fat_tree); JSON rows are tagged per topology")
    ap.add_argument("--seed", type=int, default=0,
                    help="workload seed for the figures that take one "
                         "(scenario construction is pure in the seed; "
                         "seed 0 is the pinned gate trajectory)")
    ap.add_argument("--analyze", action="store_true",
                    help="for the figures that take it: compute LP-free "
                         "JCT/CCT lower bounds per job, assert achieved "
                         "times never beat them, and add "
                         "jct_lower_bound / optimality_gap to JSON rows")
    ap.add_argument("--trace", metavar="DIR", default=None,
                    help="for the figures that take it: trace every cell "
                         "with repro_torch.obs and write one Chrome trace "
                         "JSON per cell into DIR (results stay "
                         "bit-identical)")
    args = ap.parse_args(argv)

    print("name,us_per_call,derived")
    failures: list[str] = []
    json_rows: list[dict] = []
    for name, mod in BENCHES.items():
        if args.only and name != args.only:
            continue
        kwargs = {"quick": args.quick}
        params = inspect.signature(mod.run).parameters
        if args.policy and "policies" in params:
            kwargs["policies"] = args.policy
        if "seed" in params:
            kwargs["seed"] = args.seed
        if args.topology and "topology" in params:
            kwargs["topology"] = args.topology
        if args.analyze and "analyze" in params:
            kwargs["analyze"] = True
        if args.trace and "trace_dir" in params:
            kwargs["trace_dir"] = args.trace
        rows = mod.run(**kwargs)
        for r in rows:
            print(f"{r[0]},{r[1]:.1f},{r[2]}")
            # Topology-aware figures suffix non-big-switch rows with
            # "@spec" (scenario defaults included); the tag reads it per
            # row so e.g. ml/mixed_oversub_3to1 is never mislabeled.
            topo_tag = r[0].split("@", 1)[1] if "@" in r[0] \
                else "big_switch"
            row = {"bench": name, "name": r[0],
                   "us_per_call": r[1], "derived": r[2],
                   "topology": topo_tag}
            # Analyze-mode rows carry an extra dict (jct_lower_bound,
            # per-policy optimality_gap), merged flat.
            if len(r) > 3 and r[3]:
                row.update(r[3])
            json_rows.append(row)
        errs = mod.check(rows)
        for e in errs:
            print(f"CHECK-FAIL[{name}]: {e}", file=sys.stderr)
        failures.extend(errs)

    if args.json:
        with open(args.json, "w") as fh:
            json.dump({"bench": "harness", "quick": args.quick,
                       "rows": json_rows, "failures": failures},
                      fh, indent=1, sort_keys=True)
            fh.write("\n")

    if args.only is None or args.only == "roofline_table":
        print()
        print("== Roofline (single-pod) ==")
        print(roofline_table.table("single"))
        print()
        print("== Roofline (multi-pod) ==")
        print(roofline_table.table("multi"))

    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
