"""Shard outputs -> the sweep's aggregate doc.

The port's copy of ``repro.experiments.aggregate``: the reference's
committed ``BENCH_experiments.json`` is this doc for the default spec,
and the port's fingerprint of a sweep equals the reference's.

Per (scenario, policy, topology) cell: mean / sample-std / 95%-CI of
avg-JCT and avg-CCT over seeds, the paired per-seed speedup over the
baseline policy, and the pooled per-job normalized-slowdown CDF
(quantiles of ``jct_policy[job] / jct_baseline[job]`` over every job of
every seed — policies of one seed share a bit-identical workload, so
the ratio is paired per job).  The headline block pins the paper's
metric of interest: the MSA-vs-varys (metaflow vs coflow/SEBF) avg-JCT
ratio on the mixed cluster, with its 95% CI.

Everything here is a pure, deterministic function of the shard cell
*results minus wall clocks*: ``fingerprint`` hashes exactly the
deterministic payload (spec + results + headline), and the aggregate
doc keeps all machine-dependent numbers under the separate ``timing``
key — the determinism and shard-resume tests compare docs with
``timing`` stripped, and must get bit-equal JSON.

95% CIs use Student's t on the per-seed sample (two-tailed, df = n-1;
df > 30 falls back to the normal 1.96 — a < 0.5% understatement).
"""

from __future__ import annotations

import hashlib
import json
import math

from repro_torch.analysis.bounds import mean_gap
from repro_torch.experiments.spec import SweepSpec, resolve_topology

# Two-tailed Student-t critical values at 95%, df = 1..30.
_T95_VALUES = [12.706, 4.303, 3.182, 2.776, 2.571, 2.447, 2.365, 2.306, 2.262]
_T95_VALUES += [2.228, 2.201, 2.179, 2.160, 2.145, 2.131, 2.120, 2.110, 2.101]
_T95_VALUES += [2.093, 2.086, 2.080, 2.074, 2.069, 2.064, 2.060, 2.056, 2.052]
_T95_VALUES += [2.048, 2.045, 2.042]
_T95 = {df + 1: t for df, t in enumerate(_T95_VALUES)}

QUANTILES = (0.10, 0.25, 0.50, 0.75, 0.90, 0.99)


def t_crit95(df: int) -> float:
    return _T95.get(df, 1.96) if df >= 1 else float("inf")


def mean_ci95(xs: list[float]) -> dict:
    """Sample mean with two-sided 95% CI half-width (t-distribution).

    ``ci95`` is ``None`` for a single sample: the half-width is
    undefined there, and ``float("inf")`` would serialize as the
    non-RFC-8259 token ``Infinity`` and corrupt the aggregate JSON."""
    n = len(xs)
    mean = sum(xs) / n
    if n > 1:
        var = sum((x - mean) ** 2 for x in xs) / (n - 1)
        std = math.sqrt(var)
        ci95 = t_crit95(n - 1) * std / math.sqrt(n)
    else:
        std = 0.0
        ci95 = None
    return {
        "n": n,
        "mean": mean,
        "std": std,
        "ci95": ci95,
        "min": min(xs),
        "max": max(xs),
    }


def quantiles(xs: list[float], qs=QUANTILES) -> dict:
    """Linear-interpolation quantiles (numpy's default method), pure
    Python so the aggregate is bit-stable across numpy versions."""
    s = sorted(xs)
    n = len(s)
    out = {}
    for q in qs:
        pos = q * (n - 1)
        lo = int(math.floor(pos))
        hi = min(lo + 1, n - 1)
        out[f"p{int(q * 100):02d}"] = s[lo] + (pos - lo) * (s[hi] - s[lo])
    return out


def fingerprint(payload: dict) -> str:
    canon = json.dumps(payload, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(canon.encode()).hexdigest()


def _flatten(spec: SweepSpec, shard_docs: list[dict]) -> dict:
    """(scenario, policy, topology, seed) -> result json; raises on
    duplicate, unexpected, or missing cells (a partial sweep must never
    aggregate silently)."""
    got: dict[tuple, dict] = {}
    for doc in shard_docs:
        for cell in doc["cells"]:
            key = (cell["scenario"], cell["policy"], cell["topology"], cell["seed"])
            if key in got:
                raise ValueError(f"duplicate cell {key} across shards")
            got[key] = cell["result"]
    expected = {(c.scenario, c.policy, c.topology, c.seed) for c in spec.cells()}
    missing = expected - set(got)
    extra = set(got) - expected
    if missing or extra:
        msg = (
            f"sweep incomplete or stale: {len(missing)} cells missing, "
            f"{len(extra)} unexpected (first missing: {sorted(missing)[:3]})"
        )
        raise ValueError(msg)
    return got


def _structure_block(spec: SweepSpec, got: dict, seeds: list[int]) -> dict:
    """The aggregate's ``structure`` block: a pure function of the spec
    (scenario rebuilds are deterministic in (name, seed, quick,
    topology)) plus the wall-clock-free cell results, so it fingerprints
    deterministically like everything else in the payload."""
    from repro_torch.analysis.structure import (
        predicted_ranking,
        rank_agreement,
        scenario_structure,
    )
    from repro_torch.appdag.mixer import build_scenario

    structs = []
    for scen in spec.scenarios:
        concrete = resolve_topology(scen, spec.topologies[0])
        fabric, jobs = build_scenario(
            scen, seed=spec.seed0, quick=spec.quick, topology=concrete, lint=False
        )
        structs.append(scenario_structure(scen, jobs, fabric.topology))
    pred = {s.scenario: s.msa_advantage_score for s in structs}
    measured: dict[str, float] = {}
    if "msa" in spec.policies and "varys" in spec.policies:
        for scen in spec.scenarios:
            concrete = resolve_topology(scen, spec.topologies[0])
            ratios = [
                got[(scen, "varys", concrete, s)]["avg_jct"]
                / got[(scen, "msa", concrete, s)]["avg_jct"]
                for s in seeds
                if got[(scen, "msa", concrete, s)]["avg_jct"] > 0
            ]
            if ratios:
                measured[scen] = sum(ratios) / len(ratios)
    per_scen = {}
    for s in structs:
        sj = s.to_json()
        del sj["jobs"]  # per-job detail stays in the CLI/report
        per_scen[s.scenario] = sj
    return {
        "scenarios": per_scen,
        "predicted_ranking": predicted_ranking(structs),
        "measured_msa_over_varys": dict(sorted(measured.items())),
        "measured_ranking": sorted(measured, key=lambda k: (-measured[k], k)),
        "rank_agreement": rank_agreement(pred, measured),
    }


def aggregate(spec: SweepSpec, shard_docs: list[dict]) -> dict:
    """The full aggregate document (see module docstring)."""
    if spec.fault_intensities != (0.0,):
        raise ValueError(
            "aggregate() keys cells without the fault axis; use "
            "repro_torch.experiments.resilience.aggregate_resilience for a "
            "sweep with fault_intensities"
        )
    got = _flatten(spec, shard_docs)
    seeds = [spec.seed0 + k for k in range(spec.n_seeds)]
    results: dict[str, dict] = {}
    for scen in spec.scenarios:
        for topo in spec.topologies:
            concrete = resolve_topology(scen, topo)
            series = {}
            for pol in spec.policies:
                series[pol] = [got[(scen, pol, concrete, s)] for s in seeds]
            base = series.get(spec.baseline)
            for pol in spec.policies:
                runs = series[pol]
                entry = {
                    "scenario": scen,
                    "policy": pol,
                    "topology": concrete,
                    "n_seeds": spec.n_seeds,
                    "avg_jct": mean_ci95([r["avg_jct"] for r in runs]),
                    "avg_cct": mean_ci95([r["avg_cct"] for r in runs]),
                }
                # Analyze-mode sweeps carry LP-free per-job lower bounds;
                # surface the per-seed mean optimality gap (achieved JCT /
                # bound).  Added only when every seed has bounds, so plain
                # sweeps produce a byte-identical payload + fingerprint.
                if all(r.get("jct_bound") for r in runs):
                    gaps = [mean_gap(r["jct"], r["jct_bound"]) for r in runs]
                    gaps = [g for g in gaps if g is not None]
                    if gaps:
                        entry["optimality_gap"] = mean_ci95(gaps)
                # Batch-level gap vs the certified cross-job makespan
                # bound (repro_torch.analysis.contention) — same analyze-only
                # byte-identity discipline as optimality_gap.
                if all(r.get("makespan_bound") for r in runs):
                    entry["makespan_gap"] = mean_ci95(
                        [r["makespan"] / r["makespan_bound"] for r in runs]
                    )
                if base is not None and pol != spec.baseline:
                    ratios = [b["avg_jct"] / r["avg_jct"] for b, r in zip(base, runs)]
                    entry[f"speedup_over_{spec.baseline}"] = mean_ci95(ratios)
                    slow = []
                    for b, r in zip(base, runs):
                        for job in sorted(r["jct"]):
                            denom = b["jct"][job]
                            if denom > 0:
                                slow.append(r["jct"][job] / denom)
                    if slow:
                        entry[f"slowdown_vs_{spec.baseline}"] = {
                            "n_samples": len(slow),
                            "mean": sum(slow) / len(slow),
                            **quantiles(slow),
                        }
                results[f"{scen}|{pol}|{concrete}"] = entry

    h_scen, h_pol, h_base = spec.headline
    h_topo = resolve_topology(h_scen, spec.topologies[0])
    headline = None
    have_scen = h_scen in spec.scenarios
    have_pols = h_pol in spec.policies and h_base in spec.policies
    if have_scen and have_pols:
        pol_runs = [got[(h_scen, h_pol, h_topo, s)] for s in seeds]
        base_runs = [got[(h_scen, h_base, h_topo, s)] for s in seeds]
        ratios = [b["avg_jct"] / r["avg_jct"] for b, r in zip(base_runs, pol_runs)]
        headline = {
            "scenario": h_scen,
            "topology": h_topo,
            "metric": "avg_jct",
            "policy": h_pol,
            "baseline": h_base,
            "n_seeds": spec.n_seeds,
            "ratio": mean_ci95(ratios),
            "per_seed_ratios": ratios,
        }

    payload = {"spec": spec.to_json(), "results": results, "headline": headline}
    # Analyze-mode sweeps additionally carry the static structure block:
    # spectrum metrics per scenario, the predicted MSA-advantage ranking,
    # and its Kendall agreement with the measured MSA-vs-varys speedups.
    # Keyed off the same all-cells-carry-bounds condition as the gap
    # entries, so plain sweeps keep a byte-identical payload.
    if got and all(r.get("jct_bound") for r in got.values()):
        payload["structure"] = _structure_block(spec, got, seeds)
    total_wall = sum(got[k]["wall_s"] for k in sorted(got))
    return {
        "bench": "experiments",
        "spec_hash": spec.spec_hash(),
        "n_cells": len(got),
        **payload,
        "timing": {"total_wall_s": round(total_wall, 3)},
        "fingerprint": fingerprint(payload),
    }


def check(doc: dict) -> list[str]:
    """Validity gates on an aggregate doc (the sweep CLI and CI smoke
    run these).  The headline gate is the smoke-size assertion that MSA
    beats the coflow baseline on the mixed cluster."""
    errs = []
    if not doc.get("results"):
        errs.append("no result cells")
    for key, entry in doc.get("results", {}).items():
        m = entry["avg_jct"]["mean"]
        if not (0 < m < float("inf")):
            errs.append(f"{key}: degenerate avg_jct mean {m}")
        c = entry["avg_cct"]["mean"]
        if not (0 <= c < float("inf")):
            errs.append(f"{key}: degenerate avg_cct mean {c}")
        gap = entry.get("optimality_gap")
        if gap is not None and not (gap["mean"] >= 1.0 - 1e-6):
            errs.append(
                f"{key}: mean optimality gap {gap['mean']:.4f} < 1 "
                "(achieved JCT beat its lower bound)"
            )
        mgap = entry.get("makespan_gap")
        if mgap is not None and not (mgap["mean"] >= 1.0 - 1e-6):
            errs.append(
                f"{key}: mean makespan gap {mgap['mean']:.4f} < 1 "
                "(achieved makespan beat the certified batch bound)"
            )
    head = doc.get("headline")
    if head is not None:
        r = head["ratio"]["mean"]
        if not (r >= 1.0):
            msg = (
                f"headline: {head['policy']} does not beat {head['baseline']} "
                f"on {head['scenario']} (avg-JCT ratio {r:.3f} < 1.0)"
            )
            errs.append(msg)
    return errs
