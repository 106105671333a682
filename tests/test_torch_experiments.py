"""The port's evaluation harness (``repro_torch.experiments``, its entry
points ``repro_torch.launch.sweep`` and ``launch.resilience``) against the
JAX package's ``repro.experiments``, on the CPU.

Every comparison drops exactly the fields that read the host's clock
(``wall_s``, the aggregates' ``timing`` block, the policy wall times of a
traced cell's counters and trace) and nothing else; the rest of each
record, shard and aggregate must be equal, and the fingerprints bit-equal.
The sizes are the harness's quick smoke profiles.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro import experiments as rexp
from repro.core import RunResult as RRunResult
from repro_torch import experiments as texp
from repro_torch.core import RunResult
from repro_torch.launch import resilience as tresilience
from repro_torch.launch import sweep as tsweep

REPO = Path(__file__).resolve().parent.parent
SRC = str(REPO / "src")
TOL = 1e-6   # batched fifo records against the numpy core's
WALL_KEYS = {"wall_s", "wall_us", "sched_wall_s", "sched_wall_full_s",
             "sched_wall_refresh_s"}
SMOKE = dict(scenarios=("mixed",), policies=("msa", "varys", "fair"),
             n_seeds=3, quick=True, cells_per_shard=3)


def no_wall(x):
    """``x`` without the fields that read the host's clock."""
    if isinstance(x, dict):
        return {k: no_wall(v) for k, v in x.items() if k not in WALL_KEYS}
    if isinstance(x, list):
        return [no_wall(v) for v in x]
    return x


def no_timing(doc: dict) -> dict:
    return {k: v for k, v in doc.items() if k != "timing"}


def _both_specs(**kw):
    return texp.SweepSpec(**kw), rexp.SweepSpec(**kw)


def test_spec_hash_cells_and_shards_match_reference():
    for kw in (SMOKE, dict(SMOKE, topologies=("default", "fat_tree")),
               dict(scenarios=("mixed",), policies=("msa", "varys"),
                    n_seeds=2, quick=True, fault_intensities=(0.0, 1.0))):
        t, r = _both_specs(**kw)
        assert t.spec_hash() == r.spec_hash()
        assert t.to_json() == r.to_json()
        assert [dataclasses.astuple(c) for c in t.cells()] == [
            dataclasses.astuple(c) for c in r.cells()]
        assert [len(s) for s in t.shards()] == [len(s) for s in r.shards()]
    assert texp.resolve_topology("mixed_oversub_3to1", "default") == \
        rexp.resolve_topology("mixed_oversub_3to1", "default")
    assert texp.topology_arg("leaf_spine_3to1") == \
        rexp.topology_arg("leaf_spine_3to1")
    with pytest.raises(ValueError, match="unknown scenario"):
        texp.SweepSpec(scenarios=("nope",), policies=("msa",), n_seeds=1)


def test_run_result_matches_reference():
    doc = {"n_jobs": 2, "avg_jct": 1.5, "avg_cct": 1.0, "makespan": 3.0,
           "events": 7, "sched_full": 2, "sched_refresh": 3,
           "jct": {"a": 1.0, "b": 2.0}, "cct": {"a": 0.5, "b": 1.5},
           "wall_s": 0.25, "makespan_bound": 2.0, "n_faults": 1,
           "stall_s": 0.5}
    got, want = RunResult.from_json(doc), RRunResult.from_json(doc)
    assert json.dumps(got.to_json()) == json.dumps(want.to_json())
    assert got.perf_row() == want.perf_row()


CELLS = [  # (cell fields, run_cell keywords)
    (("mixed", "msa", "big_switch", 1), {}),
    (("mixed", "varys", "big_switch", 0, 1.0), {}),          # chaos
    (("pipe_serve", "fair", "big_switch", 2), {"analyze": True}),
    (("mixed", "cpath", "fat_tree", 0), {"trace": True}),
]


@pytest.mark.parametrize("fields,kw", CELLS,
                         ids=["plain", "chaos", "analyze", "trace"])
def test_run_cell_matches_reference(fields, kw, tmp_path):
    kw = dict(kw)
    traced = kw.pop("trace", False)
    got = texp.run_cell(texp.Cell(*fields), quick=True,
                        trace_dir=tmp_path / "t" if traced else None, **kw)
    want = rexp.run_cell(rexp.Cell(*fields), quick=True,
                         trace_dir=tmp_path / "r" if traced else None, **kw)
    # Byte-equal once the wall times go: keys, key order and floats.
    assert json.dumps(no_wall(got)) == json.dumps(no_wall(want))
    assert ("fault_intensity" in got) == (len(fields) == 5)
    if kw.get("analyze"):
        assert "jct_bound" in got["result"] and "makespan_bound" in got["result"]
    if traced:
        counters = got["result"]["trace_counters"]
        assert counters["sched_full"] + counters["sched_refresh"] > 0
        (t_file,) = (tmp_path / "t").iterdir()
        (r_file,) = (tmp_path / "r").iterdir()
        assert t_file.name == r_file.name
        assert no_wall(json.loads(t_file.read_text())) == \
            no_wall(json.loads(r_file.read_text()))


def _sweep(pkg, spec, shard_dir, **kw):
    return pkg.run_sweep(spec, shard_dir, workers=1, **kw)


def test_smoke_sweep_matches_reference_and_resumes(tmp_path):
    t_spec, r_spec = _both_specs(**SMOKE)
    partial = _sweep(texp, t_spec, tmp_path / "t", stop_after=1)
    assert len(partial) == 1 < len(t_spec.shards())
    t_docs = _sweep(texp, t_spec, tmp_path / "t")      # the resumed run
    once = _sweep(texp, t_spec, tmp_path / "once", resume=False)
    r_docs = _sweep(rexp, r_spec, tmp_path / "r")
    assert [no_wall(d) for d in t_docs] == [no_wall(d) for d in r_docs]
    t_agg = texp.aggregate(t_spec, t_docs)
    r_agg = rexp.aggregate(r_spec, r_docs)
    assert t_agg["fingerprint"] == r_agg["fingerprint"]
    assert texp.aggregate(t_spec, once)["fingerprint"] == t_agg["fingerprint"]
    assert json.dumps(no_timing(t_agg), sort_keys=True) == \
        json.dumps(no_timing(r_agg), sort_keys=True)
    assert t_agg["headline"] == r_agg["headline"]
    assert t_agg["headline"]["ratio"]["mean"] >= 1.0
    # chip_smoke.py holds the card host's --smoke sweep to this fingerprint.
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.SMOKE_FINGERPRINT == t_agg["fingerprint"]
    assert texp.check(t_agg) == rexp.check(r_agg) == []
    # A shard from another spec is stale: recomputed, never mixed in.
    other, _ = _both_specs(**dict(SMOKE, n_seeds=2))
    assert texp.load_shard(tmp_path / "t", 0, other) is None
    assert texp.load_shard(tmp_path / "t", 0, t_spec) == t_docs[0]


def test_smoke_sweep_analyze_matches_reference(tmp_path):
    kw = dict(SMOKE, n_seeds=2, cells_per_shard=6)
    t_spec, r_spec = _both_specs(**kw)
    t_agg = texp.aggregate(t_spec, _sweep(texp, t_spec, tmp_path / "t",
                                          analyze=True))
    r_agg = rexp.aggregate(r_spec, _sweep(rexp, r_spec, tmp_path / "r",
                                          analyze=True))
    assert "structure" in t_agg
    assert json.dumps(no_timing(t_agg), sort_keys=True) == \
        json.dumps(no_timing(r_agg), sort_keys=True)


def test_resilience_smoke_matches_reference(tmp_path):
    t_spec = texp.resilience_spec(smoke=True)
    r_spec = rexp.resilience_spec(smoke=True)
    assert t_spec.spec_hash() == r_spec.spec_hash()
    t_agg = texp.aggregate_resilience(t_spec, _sweep(texp, t_spec,
                                                     tmp_path / "t"))
    r_agg = rexp.aggregate_resilience(r_spec, _sweep(rexp, r_spec,
                                                     tmp_path / "r"))
    assert t_agg["fingerprint"] == r_agg["fingerprint"]
    assert json.dumps(no_timing(t_agg), sort_keys=True) == \
        json.dumps(no_timing(r_agg), sort_keys=True)
    assert texp.check_resilience(t_agg) == []
    assert texp.RESILIENCE_INTENSITIES == rexp.RESILIENCE_INTENSITIES


def test_scenario_rows_match_reference():
    kw = dict(seed=1, quick=True, analyze=True)
    got = texp.scenario_rows(["pipe_serve", "mixed_oversub_3to1"],
                             ["fifo", "msa", "fair"], **kw)
    want = rexp.scenario_rows(["pipe_serve", "mixed_oversub_3to1"],
                              ["fifo", "msa", "fair"], **kw)
    # (name, us, derived, extra): all but the host time.
    assert [(n, d, e) for n, _, d, e in got] == \
        [(n, d, e) for n, _, d, e in want]


def test_run_cells_batched_mixed_cells_without_fallback():
    """Fifo cells on the engine (``device="cpu"``), every other cell
    (ordered-rate policies, a chaos fifo cell) through the port's own
    ``run_cell``, in input order; against the reference's router."""
    Cell = texp.Cell
    cells = [Cell("pipe_serve", "fifo", "big_switch", 1),
             Cell("mixed", "msa", "big_switch", 0),
             Cell("pipe_serve", "fifo", "big_switch", 0),
             Cell("mixed", "fifo", "big_switch", 0, 0.5),
             Cell("mixed", "varys", "fat_tree", 2),
             Cell("mixed", "fifo", "fat_tree", 2)]
    recs = texp.run_cells_batched(cells, quick=True, workers=1, device="cpu")
    assert [r.get("engine") for r in recs] == [
        "simtorch", None, "simtorch", None, None, "simtorch"]
    for cell, rec in zip(cells, recs):
        if not texp.batchable(cell):
            ref = rexp.run_cell(rexp.Cell(*dataclasses.astuple(cell)),
                                quick=True)
            assert json.dumps(no_wall(rec)) == json.dumps(no_wall(ref))
            continue
        # The reference's batched record shape, with the port's engine.
        assert list(rec) == ["scenario", "policy", "topology", "seed",
                             "engine", "result"]
        own = texp.run_cell(cell, quick=True)["result"]
        assert list(rec["result"]) == list(own)
        assert (rec["result"]["sched_full"], rec["result"]["sched_refresh"]) \
            == (0, 0)
        for key in ("jct", "cct"):
            assert rec["result"][key].keys() == own[key].keys()
            for name, val in own[key].items():
                assert rec["result"][key][name] == pytest.approx(val, abs=TOL)
        assert rec["result"]["makespan"] == pytest.approx(own["makespan"],
                                                          abs=TOL)


def _run(args, cwd, timeout=120):
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, timeout=timeout, cwd=cwd,
                          env={**os.environ, "PYTHONPATH": SRC})


def test_sweep_cli_smoke(tmp_path):
    r = _run(["-m", "repro_torch.launch.sweep", "--smoke", "--workers", "1"],
             tmp_path)
    assert r.returncode == 0, r.stderr
    out = tmp_path / "experiments" / "sweep_torch" / "experiments_smoke.json"
    doc = json.loads(out.read_text())
    assert f"fingerprint {doc['fingerprint']}" in r.stdout
    assert "headline msa-vs-varys avg-JCT ratio on mixed" in r.stdout
    # Resume: every shard is on disk, so a rerun computes nothing new.
    again = _run(["-m", "repro_torch.launch.sweep", "--smoke", "--workers",
                  "1"], tmp_path)
    assert again.returncode == 0 and "shard 0 done" not in again.stdout
    assert f"fingerprint {doc['fingerprint']}" in again.stdout


def test_sweep_run_stops_and_finishes(tmp_path):
    argv = ["--smoke", "--workers", "1", "--shard-dir", str(tmp_path / "s"),
            "--out", str(tmp_path / "a.json")]
    assert tsweep.run(argv + ["--stop-after-shards", "1"]) == (None, [])
    doc, errs = tsweep.run(argv)
    assert errs == [] and doc["n_cells"] == 9


def test_resilience_cli_smoke(tmp_path):
    r = _run(["-m", "repro_torch.launch.resilience", "--smoke", "--workers",
              "1"], tmp_path)
    assert r.returncode == 0, r.stderr
    assert "intensity 0: msa-vs-varys avg-JCT ratio" in r.stdout
    out = tmp_path / "experiments" / "sweep_torch" / "resilience_smoke.json"
    doc = json.loads(out.read_text())
    assert f"fingerprint {doc['fingerprint']}" in r.stdout
    # The function behind the CLI, on the shards the CLI left: resumed.
    again, errs = tresilience.run(["--smoke", "--workers", "1", "--out",
                                   str(tmp_path / "r.json"), "--shard-dir",
                                   str(out.parent / "shards"
                                       / doc["spec_hash"])])
    assert errs == [] and again["fingerprint"] == doc["fingerprint"]


def test_import_stays_off_torch():
    """Spawned sweep workers import only the numpy stack."""
    code = ("import sys, repro_torch.experiments, repro_torch.launch.sweep, "
            "repro_torch.analysis, repro_torch.obs, repro_torch.faults; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'repro')))")
    r = _run(["-c", code], REPO)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"
