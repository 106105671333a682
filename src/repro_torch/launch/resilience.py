"""Resilience sweep — policy-vs-fault-intensity curves under chaos, on the port.

The port of the reference's ``benchmarks/resilience.py``, with the same
flags and profiles.  Runs the ``repro_torch.experiments.resilience``
sweep: every cell is one simulation of the mixed cluster under the
seeded chaos fault family (``repro_torch.faults.chaos_spec`` — hard link
failures with scheduled repair, flaky-link degrade storms, straggler
bursts, windowed retransmission) at one fault intensity, sharded and
resumable exactly like ``repro_torch.launch.sweep``.  The aggregate
pins, per policy and intensity, mean/95%-CI avg JCT, the paired
JCT-degradation-vs-fault-free ratio, stall/retransmit/recovery
accounting, and the headline MSA-vs-varys ratio at every intensity
level — does the metaflow win survive chaos?  Outputs go under
``experiments/sweep_torch/`` (git-ignored).

Profiles:
  (default)  5 policies x 4 intensities (0, 0.5, 1, 2) x 5 seeds on the
             mixed cluster -> ``experiments/sweep_torch/resilience.json``
             (its fingerprint equals the reference's committed
             ``BENCH_resilience.json``).
  --smoke    CI chaos-smoke profile: msa/varys, 3 intensities, 2 quick
             seeds, validated by ``check_resilience`` (exit 1 on any
             failure) -> ``experiments/sweep_torch/resilience_smoke.json``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.resilience [--smoke]
      [--analyze] [--seeds N] [--seed0 N] [--workers N] [--shard-dir DIR]
      [--no-resume] [--out PATH] [--verbose]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from repro_torch.experiments import (
    aggregate_resilience,
    check_resilience,
    resilience_spec,
    run_sweep,
)

OUT_DIR = Path("experiments/sweep_torch")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--smoke",
        action="store_true",
        help="CI chaos-smoke profile: msa/varys, 2 quick seeds, "
        "3 intensities, validated",
    )
    ap.add_argument(
        "--seeds",
        type=int,
        default=None,
        metavar="N",
        help="seeds per (policy, intensity) cell (default: profile's)",
    )
    ap.add_argument(
        "--seed0",
        type=int,
        default=0,
        help="first seed (cells use seed0..seed0+N-1)",
    )
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
        "<spec_hash>)",
    )
    ap.add_argument(
        "--no-resume",
        action="store_true",
        help="recompute every shard even if its file exists",
    )
    ap.add_argument(
        "--out",
        default=None,
        metavar="PATH",
        help=f"aggregate JSON (default {OUT_DIR}/resilience.json; smoke "
        "writes resilience_smoke.json beside it)",
    )
    ap.add_argument(
        "--analyze",
        action="store_true",
        help="carry LP-free lower bounds per cell (asserted to hold even "
        "under faults — chaos only slows jobs down)",
    )
    ap.add_argument(
        "--verbose",
        action="store_true",
        help="per-cell worker heartbeats",
    )
    return ap.parse_args(argv)


def run(argv=None) -> tuple[dict, list[str]]:
    """Run the resilience sweep ``argv`` asks for; returns ``(aggregate
    doc, check failures)``."""
    args = parse_args(argv)
    spec = resilience_spec(smoke=args.smoke, seeds=args.seeds,
                           seed0=args.seed0)
    name = "resilience_smoke.json" if args.smoke else "resilience.json"
    out = Path(args.out or OUT_DIR / name)
    out.parent.mkdir(parents=True, exist_ok=True)
    shard_dir = args.shard_dir or OUT_DIR / "shards" / spec.spec_hash()
    n_cells = len(spec.cells())
    print(
        f"resilience sweep {spec.spec_hash()}: {n_cells} cells "
        f"({len(spec.policies)} policies x "
        f"{len(spec.fault_intensities)} intensities x {spec.n_seeds} seeds)"
    )
    print(f"shard dir: {shard_dir}")

    t0 = time.perf_counter()
    docs = run_sweep(
        spec,
        shard_dir,
        workers=args.workers,
        resume=not args.no_resume,
        progress=lambda m: print(f"  {m}", flush=True),
        analyze=args.analyze,
        verbose=args.verbose,
    )
    wall = time.perf_counter() - t0

    doc = aggregate_resilience(spec, docs)
    with open(out, "w") as fh:
        json.dump(doc, fh, indent=1, sort_keys=True, allow_nan=False)
        fh.write("\n")
    print(f"wrote {out} ({doc['n_cells']} cells, {wall:.1f}s wall)")

    curve = doc.get("headline_curve") or {}
    for k in sorted(curve, key=lambda k: curve[k]["fault_intensity"]):
        pt = curve[k]
        r = pt["ratio"]
        ci = "n/a (1 seed)" if r["ci95"] is None else f"+/- {r['ci95']:.3f}"
        print(
            f"  intensity {pt['fault_intensity']:g}: "
            f"{pt['policy']}-vs-{pt['baseline']} avg-JCT ratio "
            f"{r['mean']:.3f} {ci}"
        )

    print(f"fingerprint {doc['fingerprint']}")

    with open(out) as fh:  # validate what actually landed on disk
        errs = check_resilience(json.load(fh))
    for e in errs:
        print(f"CHECK-FAIL[resilience]: {e}", file=sys.stderr)
    return doc, errs


def main(argv=None) -> int:
    _, errs = run(argv)
    return 1 if errs else 0


if __name__ == "__main__":
    sys.exit(main())
