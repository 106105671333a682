"""``python -m repro_torch.analysis`` — lint + structure-check registered scenarios.

One gate, three outputs:

* default — per-scenario lint lines (``ok``/``FAIL`` + finding counts),
  plus, with ``--structure``, a spectrum/bounds table and the predicted
  MSA-advantage ranking.
* ``--json`` — the same content as one machine-readable document on
  stdout (findings, structure metrics, batch bounds, ranking); human
  tables are suppressed.
* exit code — 1 iff any *error*-severity finding surfaced; warnings
  never fail the gate.

``--structure`` also runs the self-consistency checks that make the CI
step meaningful beyond "it didn't crash": the tight per-job bound must
dominate the chain-only bound for every job, and the batch chain
term must dominate every per-job bound.  A violation is reported as an
error-severity ``structure`` finding (it means the bound math regressed,
which would silently corrupt every optimality-gap number downstream).
"""

from __future__ import annotations

import argparse
import json
from dataclasses import asdict
from typing import TYPE_CHECKING

from repro_torch.analysis.bounds import scenario_lower_bounds
from repro_torch.analysis.contention import batch_bounds
from repro_torch.analysis.lint import Finding, lint_faults, lint_scenario
from repro_torch.analysis.structure import predicted_ranking, scenario_structure

if TYPE_CHECKING:
    from repro_torch.analysis.contention import BatchBounds
    from repro_torch.analysis.structure import ScenarioStructure


def _structure_findings(name: str, seed: int, quick: bool
                        ) -> tuple[list[Finding], ScenarioStructure | None,
                                   BatchBounds | None]:
    """Structure + bounds for one scenario, with self-consistency
    violations (or a crash) folded in as error findings."""
    from repro_torch.appdag.mixer import build_scenario
    try:
        fabric, jobs = build_scenario(name, seed=seed, quick=quick,
                                      lint=False)
        struct = scenario_structure(name, jobs, fabric.topology)
        bb = batch_bounds(jobs, fabric.topology)
        loose, _ = scenario_lower_bounds(jobs, fabric.topology, tight=False)
        tight, _ = scenario_lower_bounds(jobs, fabric.topology, tight=True)
    except Exception as e:  # noqa: BLE001 - reported, not swallowed
        return [Finding(check="structure", severity="error",
                        message=f"structure pass crashed: {e!r}")], None, None
    findings = [
        Finding(check="structure", severity="error", job=j,
                message=f"tight bound {tight[j]:.17g} < chain-only "
                        f"bound {loose[j]:.17g} (dominance regressed)")
        for j in loose if tight[j] < loose[j] - 1e-9]
    arrival = {j.name: j.arrival for j in jobs}
    findings += [
        Finding(check="structure", severity="error", job=j,
                message=f"batch chain bound {bb.chain_lb:.17g} < "
                        f"arrival + per-job bound "
                        f"{arrival[j] + tight[j]:.17g}")
        for j in tight if bb.chain_lb < arrival[j] + tight[j] - 1e-9]
    return findings, struct, bb


def main(argv: list[str] | None = None) -> int:
    from repro_torch.appdag.mixer import SCENARIOS
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Lint (and optionally structure-check) registered "
                    "scenarios; exit 1 on any error-severity finding "
                    "(the CI analyze gate).")
    ap.add_argument("--scenario", action="append", choices=sorted(SCENARIOS),
                    help="scenario to analyze (repeatable; default: all)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quick", action="store_true",
                    help="quick workload profile (CI)")
    ap.add_argument("--fault-intensity", type=float, default=0.0,
                    help="also compile each scenario's chaos fault stream "
                         "at this intensity and lint it (0 = skip)")
    ap.add_argument("--structure", action="store_true",
                    help="also run the structure/contention pass: spectrum "
                         "metrics, certified batch bounds, bound "
                         "self-consistency checks, predicted MSA ranking")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit one JSON document instead of tables")
    ap.add_argument("--verbose", action="store_true",
                    help="print every warning (errors always print)")
    args = ap.parse_args(argv)
    scenarios = args.scenario or sorted(SCENARIOS)

    doc: dict[str, object] = {"scenarios": {}}
    per_scen: dict[str, dict[str, object]] = {}
    structs: list[ScenarioStructure] = []
    n_err = 0
    for scen in scenarios:
        findings = lint_scenario(scen, seed=args.seed, quick=args.quick)
        if args.fault_intensity:
            from repro_torch.appdag.mixer import build_scenario
            from repro_torch.faults import chaos_spec
            fabric, jobs = build_scenario(scen, seed=args.seed,
                                          quick=args.quick, lint=False)
            spec = chaos_spec(fabric, jobs, args.fault_intensity,
                              seed=args.seed)
            findings += lint_faults(spec.compile(lint=False),
                                    fabric.topology)
        entry: dict[str, object] = {}
        struct = bb = None
        if args.structure:
            extra, struct, bb = _structure_findings(scen, args.seed,
                                                    args.quick)
            findings += extra
            if struct is not None:
                structs.append(struct)
                entry["structure"] = struct.to_json()
            if bb is not None:
                entry["batch_bounds"] = bb.to_json()
        errs = [f for f in findings if f.severity == "error"]
        warns = [f for f in findings if f.severity == "warning"]
        n_err += len(errs)
        entry.update(findings=[asdict(f) for f in findings],
                     n_errors=len(errs), n_warnings=len(warns))
        per_scen[scen] = entry
        if args.as_json:
            continue
        status = "FAIL" if errs else "ok"
        print(f"{scen:<24} {status}  ({len(errs)} error(s), "
              f"{len(warns)} warning(s))")
        shown = findings if args.verbose else errs
        for f in shown:
            print(f"  {f}")
        if not args.verbose and warns:
            by_check: dict[str, int] = {}
            for f in warns:
                by_check[f.check] = by_check.get(f.check, 0) + 1
            summary = ", ".join(f"{k} x{v}"
                                for k, v in sorted(by_check.items()))
            print(f"  warnings: {summary}")

    doc["scenarios"] = per_scen
    doc["n_errors"] = n_err
    if args.structure and structs:
        ranking = predicted_ranking(structs)
        doc["predicted_ranking"] = ranking
        if not args.as_json:
            print()
            print(f"{'scenario':<20} {'class':<9} {'score':>6} {'bd':>5} "
                  f"{'comm':>5} {'mfdep':>6} {'makespan_lb':>12} bottleneck")
            by_name = {s.scenario: s for s in structs}
            bbs = {scen: per_scen[scen].get("batch_bounds")
                   for scen in per_scen}
            for s in structs:
                b = bbs.get(s.scenario)
                mk = f"{b['makespan_lb']:12.4f}" if isinstance(b, dict) \
                    else f"{'-':>12}"
                bn = b.get("bottleneck") if isinstance(b, dict) else None
                print(f"{s.scenario:<20} {s.classification:<9} "
                      f"{s.msa_advantage_score:6.3f} "
                      f"{s.barrier_density:5.2f} {s.comm_fraction:5.2f} "
                      f"{s.mf_depth:6.1f} {mk} {bn or '-'}")
            print("predicted MSA advantage (desc): " + " > ".join(
                f"{n} ({by_name[n].msa_advantage_score:.3f})"
                for n in ranking))
    if args.as_json:
        print(json.dumps(doc, indent=2, sort_keys=True))
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
