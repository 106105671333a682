"""Resilience sweep: policy behavior as a function of fault intensity.

The port's copy of ``repro.experiments.resilience``.

The fault-free sweep (``repro_torch.experiments.aggregate``) answers "which
policy wins on a healthy fabric"; this module answers "does the win
survive chaos".  It reuses the same shard machinery — a ``SweepSpec``
with a ``fault_intensities`` axis, executed by ``run_sweep`` — and
aggregates per (scenario, policy, topology, intensity):

* mean/95%-CI ``avg_jct`` plus the resilience accounting the simulator
  emits under faults (retransmitted bytes, stall seconds, recovery lag);
* **JCT degradation** — the per-seed, paired ratio of a cell's avg JCT
  over the *same policy's fault-free* avg JCT at the same seed (so it is
  exactly 1.0 at intensity 0, a pairing-correctness gate ``check``
  enforces); and
* the **headline-vs-intensity curve** — the MSA-vs-baseline avg-JCT
  ratio (same orientation as the fault-free headline: >= 1 means MSA
  still wins) at every intensity level, with 95% CIs.

``repro_torch.launch.resilience`` drives this (as the reference's
``benchmarks/resilience.py`` does into the committed
``BENCH_resilience.json``); the ``timing``/``fingerprint`` split follows
``aggregate``: host wall time is quarantined outside the fingerprint so
the artifact is bit-reproducible.
"""

from __future__ import annotations

from repro_torch.experiments.aggregate import fingerprint, mean_ci95
from repro_torch.experiments.spec import SweepSpec, resolve_topology

#: The committed curve's intensity levels (0 = the paired baseline).
RESILIENCE_INTENSITIES = (0.0, 0.5, 1.0, 2.0)

#: Resilience accounting carried per cell (omitted-at-0 in records).
FAULT_FIELDS = (
    "n_faults",
    "n_perturbations",
    "retransmitted_bytes",
    "stall_s",
    "flow_stall_s",
    "recovery_lag_s",
)


def resilience_spec(
    smoke: bool = False, seeds: int | None = None, seed0: int = 0
) -> SweepSpec:
    """The resilience sweep spec.  Full profile: every policy on the
    mixed cluster, 5 seeds x 4 intensities.  Smoke (CI): msa/varys,
    2 quick seeds, 3 intensities."""
    if smoke:
        return SweepSpec(
            scenarios=("mixed",),
            policies=("msa", "varys"),
            n_seeds=seeds or 2,
            seed0=seed0,
            quick=True,
            cells_per_shard=4,
            fault_intensities=(0.0, 1.0, 2.0),
        )
    return SweepSpec(
        scenarios=("mixed",),
        policies=("msa", "varys", "fifo", "fair", "cpath"),
        n_seeds=seeds or 5,
        seed0=seed0,
        quick=False,
        cells_per_shard=5,
        fault_intensities=RESILIENCE_INTENSITIES,
    )


def _flatten_chaos(spec: SweepSpec, shard_docs: list[dict]) -> dict:
    """(scenario, policy, topology, seed, intensity) -> result json;
    raises on duplicate, missing, or unexpected cells (the fault-axis
    twin of ``aggregate._flatten``)."""
    got: dict[tuple, dict] = {}
    for doc in shard_docs:
        for cell in doc["cells"]:
            key = (
                cell["scenario"],
                cell["policy"],
                cell["topology"],
                cell["seed"],
                cell.get("fault_intensity", 0.0),
            )
            if key in got:
                raise ValueError(f"duplicate cell {key} across shards")
            got[key] = cell["result"]
    expected = {
        (c.scenario, c.policy, c.topology, c.seed, c.fault_intensity)
        for c in spec.cells()
    }
    missing = expected - set(got)
    extra = set(got) - expected
    if missing or extra:
        raise ValueError(
            f"resilience sweep incomplete or stale: {len(missing)} cells "
            f"missing, {len(extra)} unexpected "
            f"(first missing: {sorted(missing)[:3]})"
        )
    return got


def aggregate_resilience(spec: SweepSpec, shard_docs: list[dict]) -> dict:
    """The resilience aggregate document (see module docstring)."""
    if 0.0 not in spec.fault_intensities:
        raise ValueError(
            "resilience aggregation needs intensity 0.0 in the sweep: "
            "JCT degradation is paired against the fault-free run"
        )
    got = _flatten_chaos(spec, shard_docs)
    seeds = [spec.seed0 + k for k in range(spec.n_seeds)]
    intensities = sorted(spec.fault_intensities)

    results: dict[str, dict] = {}
    curves: dict[str, dict] = {}
    for scen in spec.scenarios:
        for topo in spec.topologies:
            concrete = resolve_topology(scen, topo)
            for pol in spec.policies:
                for inten in intensities:
                    runs = [got[(scen, pol, concrete, s, inten)] for s in seeds]
                    base = [got[(scen, pol, concrete, s, 0.0)] for s in seeds]
                    degr = [r["avg_jct"] / b["avg_jct"] for r, b in zip(runs, base)]
                    entry = {
                        "scenario": scen,
                        "policy": pol,
                        "topology": concrete,
                        "fault_intensity": inten,
                        "n_seeds": spec.n_seeds,
                        "avg_jct": mean_ci95([r["avg_jct"] for r in runs]),
                        "jct_degradation": mean_ci95(degr),
                    }
                    for f in FAULT_FIELDS:
                        vals = [r.get(f, 0) for r in runs]
                        if any(vals):
                            entry[f] = mean_ci95([float(v) for v in vals])
                    results[f"{scen}|{pol}|{concrete}|i{inten:g}"] = entry

    # Headline-vs-intensity: does MSA's win over the coflow baseline
    # survive as chaos ramps up?  Same orientation as the fault-free
    # headline: baseline avg JCT over policy avg JCT, paired per seed.
    h_scen, h_pol, h_base = spec.headline
    have_scen = h_scen in spec.scenarios
    have_pols = h_pol in spec.policies and h_base in spec.policies
    if have_scen and have_pols:
        h_topo = resolve_topology(h_scen, spec.topologies[0])
        for inten in intensities:
            pol_runs = [got[(h_scen, h_pol, h_topo, s, inten)] for s in seeds]
            base_runs = [got[(h_scen, h_base, h_topo, s, inten)] for s in seeds]
            ratios = [b["avg_jct"] / r["avg_jct"] for b, r in zip(base_runs, pol_runs)]
            curves[f"i{inten:g}"] = {
                "fault_intensity": inten,
                "policy": h_pol,
                "baseline": h_base,
                "scenario": h_scen,
                "topology": h_topo,
                "metric": "avg_jct",
                "ratio": mean_ci95(ratios),
                "per_seed_ratios": ratios,
            }

    payload = {
        "spec": spec.to_json(),
        "results": results,
        "headline_curve": curves or None,
    }
    total_wall = sum(got[k]["wall_s"] for k in sorted(got))
    return {
        "bench": "resilience",
        "spec_hash": spec.spec_hash(),
        "n_cells": len(got),
        **payload,
        "timing": {"total_wall_s": round(total_wall, 3)},
        "fingerprint": fingerprint(payload),
    }


def check_resilience(doc: dict) -> list[str]:
    """Validity gates on a resilience aggregate (CLI + CI chaos-smoke):
    structural sanity, the intensity-0 pairing identity, fault-free
    cells truly fault-free, and degradation never far below 1 (faults
    can nudge a heuristic policy onto a luckier schedule, but a large
    speedup means the pairing compared two different workloads)."""
    errs = []
    results = doc.get("results", {})
    if not results:
        errs.append("no result cells")
    for key, entry in results.items():
        m = entry["avg_jct"]["mean"]
        if not (0 < m < float("inf")):
            errs.append(f"{key}: degenerate avg_jct mean {m}")
        d = entry["jct_degradation"]["mean"]
        if entry["fault_intensity"] == 0.0:
            if d != 1.0:
                errs.append(
                    f"{key}: intensity-0 degradation {d!r} != 1.0 "
                    "(pairing against the wrong baseline cell)"
                )
            if "n_faults" in entry:
                errs.append(f"{key}: fault-free cell reports faults")
        elif d < 0.9:
            errs.append(
                f"{key}: degradation {d:.6f} far below 1 — the pairing "
                "compared against the wrong fault-free baseline"
            )
        elif "n_faults" not in entry or entry["n_faults"]["mean"] <= 0:
            errs.append(f"{key}: chaos cell applied no hard faults")
    curve = doc.get("headline_curve")
    if curve is not None:
        for k, pt in curve.items():
            r = pt["ratio"]["mean"]
            if not (r > 0):
                errs.append(f"headline_curve {k}: degenerate ratio {r}")
    return errs
