"""Monte-Carlo experiment sweep — the paper's MSA-vs-Varys runner on the port.

The port of the reference's ``benchmarks/sweep.py``, with the same flags
and profiles.  Compiles a declarative ``repro_torch.experiments.SweepSpec``
(scenarios x policies x topologies x N seeds) into shards, executes them
process-parallel with resumable per-shard JSON outputs (a killed sweep
re-run with the same spec recomputes only the missing shards), and
aggregates mean/95%-CI avg-JCT and avg-CCT, normalized-slowdown CDF
quantiles, and the paper's headline metaflow-vs-coflow ratio (MSA vs
varys/SEBF avg-JCT on the mixed cluster), with its fingerprint.  Every
cell runs the port's numpy simulator on the CPU: the fingerprint of the
default sweep equals that of the reference's committed
``BENCH_experiments.json``.  Outputs go under ``experiments/sweep_torch/``
(git-ignored), never over the reference's artifacts.

Profiles:
  (default)  all scenarios x all policies x 20 seeds (500 cells) ->
             ``experiments/sweep_torch/experiments.json``.
  --smoke    CI profile: mixed scenario, msa/varys/fair, 3 quick seeds,
             then validates the aggregate and gates MSA >= varys
             (exit 1 on any check failure) ->
             ``experiments/sweep_torch/experiments_smoke.json``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.sweep [--smoke] [--analyze]
      [--scenario NAME ...] [--policy NAME ...] [--topology SPEC ...]
      [--seeds N] [--seed0 N] [--quick] [--cells-per-shard K]
      [--workers N] [--shard-dir DIR] [--no-resume]
      [--stop-after-shards K] [--out PATH] [--trace DIR] [--verbose]

``--analyze`` makes every cell also carry its LP-free per-job JCT/CCT
lower bounds (``repro_torch.analysis.bounds``, tight load+chain
composition) and the certified cross-job batch makespan bound
(``repro_torch.analysis.contention``); achieved times are asserted to
never beat them, and the aggregate reports the mean optimality/makespan
gaps per (scenario, policy) plus the static ``structure`` block
(``repro_torch.analysis.structure``: spectrum classification and the
predicted-vs-measured MSA-advantage ranking).  Analyze is a runner
knob, not part of the spec — ``spec_hash`` and plain-sweep fingerprints
are unchanged.

Unknown ``--scenario`` / ``--policy`` / ``--topology`` values fail fast
with the list of valid choices.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from repro_torch.appdag import SCENARIOS
from repro_torch.core import available_policies
from repro_torch.experiments import SweepSpec, aggregate, check, run_sweep
from repro_torch.experiments.spec import DEFAULT_TOPOLOGY, validate_topology_spec

OUT_DIR = Path("experiments/sweep_torch")
FULL_SEEDS = 20
SMOKE = {
    "scenarios": ("mixed",),
    "policies": ("msa", "varys", "fair"),
    "n_seeds": 3,
    "quick": True,
    "cells_per_shard": 3,
}


def _topology_list_arg(spec: str) -> str:
    """Like ``repro_torch.experiments.topology_arg`` but also accepting the
    ``default`` sentinel (= each scenario's registered topology)."""
    try:
        return validate_topology_spec(spec, allow_default=True)
    except ValueError as e:
        raise argparse.ArgumentTypeError(str(e)) from None


def build_spec(args) -> SweepSpec:
    if args.smoke:
        base = dict(SMOKE)
    else:
        base = {
            "scenarios": tuple(SCENARIOS),
            "policies": available_policies(),
            "n_seeds": FULL_SEEDS,
            "quick": args.quick,
            "cells_per_shard": 10,
        }
    if args.scenario:
        base["scenarios"] = tuple(args.scenario)
    if args.policy:
        base["policies"] = tuple(args.policy)
    if args.seeds is not None:
        base["n_seeds"] = args.seeds
    if args.quick:
        base["quick"] = True
    if args.cells_per_shard is not None:
        base["cells_per_shard"] = args.cells_per_shard
    topologies = tuple(args.topology or (DEFAULT_TOPOLOGY,))
    return SweepSpec(topologies=topologies, seed0=args.seed0, **base)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--smoke",
        action="store_true",
        help="CI profile: tiny quick sweep, validated, gated on MSA >= varys",
    )
    ap.add_argument(
        "--scenario",
        action="append",
        default=None,
        choices=sorted(SCENARIOS),
        metavar="NAME",
        help="scenario (repeatable; default: the profile's set)",
    )
    ap.add_argument(
        "--policy",
        action="append",
        default=None,
        choices=available_policies(),
        metavar="NAME",
        help="policy (repeatable; default: the profile's set)",
    )
    ap.add_argument(
        "--topology",
        action="append",
        default=None,
        metavar="SPEC",
        type=_topology_list_arg,
        help="topology (repeatable; 'default' = each scenario's registered "
        "one; also big_switch, leaf_spine_<R>to1, fat_tree)",
    )
    ap.add_argument(
        "--seeds",
        type=int,
        default=None,
        metavar="N",
        help=f"seeds per cell (default {FULL_SEEDS}, smoke {SMOKE['n_seeds']})",
    )
    ap.add_argument(
        "--seed0",
        type=int,
        default=0,
        help="first seed (cells use seed0..seed0+N-1)",
    )
    ap.add_argument(
        "--quick",
        action="store_true",
        help="quick scenario sizes (fewer jobs per cell)",
    )
    ap.add_argument("--cells-per-shard", type=int, default=None)
    ap.add_argument(
        "--workers",
        type=int,
        default=None,
        help="worker processes (default: cpu count; 1 = in-process)",
    )
    ap.add_argument(
        "--shard-dir",
        default=None,
        metavar="DIR",
        help=f"resumable per-shard outputs (default {OUT_DIR}/shards/"
        "<spec_hash> — hash-scoped, so a changed spec never resumes stale "
        "shards)",
    )
    ap.add_argument(
        "--no-resume",
        action="store_true",
        help="recompute every shard even if its file exists",
    )
    ap.add_argument(
        "--stop-after-shards",
        type=int,
        default=None,
        metavar="K",
        help="stop after K newly-computed shards land (simulates a killed "
        "run; re-invoke without this flag to finish and aggregate)",
    )
    ap.add_argument(
        "--out",
        default=None,
        metavar="PATH",
        help=f"aggregate JSON (default {OUT_DIR}/experiments.json; smoke "
        "writes experiments_smoke.json beside it)",
    )
    ap.add_argument(
        "--analyze",
        action="store_true",
        help="carry LP-free lower bounds per cell; aggregate reports the "
        "mean JCT optimality gap per (scenario, policy)",
    )
    ap.add_argument(
        "--trace",
        default=None,
        metavar="DIR",
        help="trace every cell with repro_torch.obs: write one Chrome trace "
        "JSON per cell into DIR and carry trace_counters on results "
        "(results stay bit-identical)",
    )
    ap.add_argument(
        "--verbose",
        action="store_true",
        help="per-cell worker heartbeats (shard id, cells done, elapsed)",
    )
    return ap.parse_args(argv)


def run(argv=None) -> tuple[dict | None, list[str]]:
    """Run the sweep ``argv`` asks for; returns ``(aggregate doc, check
    failures)``, the doc ``None`` when ``--stop-after-shards`` stopped
    the sweep early."""
    args = parse_args(argv)
    spec = build_spec(args)
    name = "experiments_smoke.json" if args.smoke else "experiments.json"
    out = Path(args.out or OUT_DIR / name)
    out.parent.mkdir(parents=True, exist_ok=True)
    shard_dir = args.shard_dir or OUT_DIR / "shards" / spec.spec_hash()
    shards = spec.shards()
    n_cells = len(spec.cells())
    print(f"sweep {spec.spec_hash()}: {n_cells} cells in {len(shards)} shards")
    print(f"shard dir: {shard_dir}")

    t0 = time.perf_counter()
    docs = run_sweep(
        spec,
        shard_dir,
        workers=args.workers,
        resume=not args.no_resume,
        stop_after=args.stop_after_shards,
        progress=lambda m: print(f"  {m}", flush=True),
        analyze=args.analyze,
        trace_dir=args.trace,
        verbose=args.verbose,
    )
    wall = time.perf_counter() - t0
    if len(docs) < len(shards):
        print(f"stopped with {len(docs)}/{len(shards)} shards on disk ({wall:.1f}s)")
        print("re-run the same command to finish the sweep")
        return None, []

    doc = aggregate(spec, docs)
    with open(out, "w") as fh:
        json.dump(doc, fh, indent=1, sort_keys=True, allow_nan=False)
        fh.write("\n")
    print(f"wrote {out} ({doc['n_cells']} cells, {wall:.1f}s wall)")

    head = doc["headline"]
    if head is not None:
        r = head["ratio"]
        ci = "n/a (1 seed)" if r["ci95"] is None else f"+/- {r['ci95']:.3f}"
        msg = (
            f"headline {head['policy']}-vs-{head['baseline']} avg-JCT ratio "
            f"on {head['scenario']}: {r['mean']:.3f} {ci} "
            f"(95% CI, {r['n']} seeds)"
        )
        print(msg)

    if args.analyze:
        gap_rows = [
            (k, e["optimality_gap"]["mean"], e.get("makespan_gap", {}).get("mean"))
            for k, e in doc["results"].items()
            if "optimality_gap" in e
        ]
        for k, g, mg in sorted(gap_rows):
            batch = f", makespan {mg:.3f}x over batch bound" if mg else ""
            print(f"  optimality gap {k}: {g:.3f}x over LP-free bound{batch}")
        if not gap_rows:
            print(
                "  no optimality gaps in aggregate: resumed shards "
                "lack bounds (re-run with --no-resume)",
                file=sys.stderr,
            )
        struct = doc.get("structure")
        if struct:
            for scen, s in sorted(struct["scenarios"].items()):
                print(
                    f"  structure {scen}: {s['classification']} "
                    f"(score {s['msa_advantage_score']:.3f}, barrier "
                    f"density {s['barrier_density']:.2f}, comm fraction "
                    f"{s['comm_fraction']:.2f})"
                )
            ranking = " > ".join(struct["predicted_ranking"])
            print(f"  predicted MSA advantage: {ranking}")
            agree = struct.get("rank_agreement")
            if struct["measured_ranking"]:
                measured = " > ".join(struct["measured_ranking"])
                tail = f"  (rank agreement {agree:.2f})" if agree is not None else ""
                print(f"  measured msa-vs-varys:   {measured}{tail}")

    print(f"fingerprint {doc['fingerprint']}")

    with open(out) as fh:  # validate what actually landed on disk
        errs = check(json.load(fh))
    for e in errs:
        print(f"CHECK-FAIL[experiments]: {e}", file=sys.stderr)
    return doc, errs


def main(argv=None) -> int:
    _, errs = run(argv)
    return 1 if errs else 0


if __name__ == "__main__":
    sys.exit(main())
