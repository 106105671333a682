"""The harness on the CPU: cells found by name from their own files, a
metric added as a file, the traffic's seeds, the last line's keys, and
``BENCHMARK.json`` within the benchmark's contract."""

import json
import re
import shutil

import pytest
import torch
from bench_tiny import CPU, MOE, SERVE, TRAIN, ctx

from benchlib import cli, spec, traffic, weights
from benchlib.drivers import serve_grouped, train

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE_KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


def test_every_cell_finds_its_files_by_name():
    bench = spec.benchmark()
    for w in bench["workloads"]:
        cfg, mix = spec.config(w["config"]), spec.traffic(w["traffic"])
        assert cfg["name"] == w["config"]
        assert (spec.BENCH / "benchlib" / "drivers" / f"{mix['kind']}.py").exists()
        assert set(spec.limits(w["name"])), w["name"]
        for m in (spec.metrics_for(bench, w["name"], False)
                  + spec.metrics_for(bench, w["name"], True)):
            assert callable(spec.reader(m["name"]))


def test_a_new_metric_config_and_mix_are_files_and_entries(tmp_path,
                                                           monkeypatch):
    """A copy of ``bench/`` and ``BENCHMARK.json`` with a metric, a
    configuration, a mix and a cell added as new files and new entries,
    no file that was there edited: the harness finds all four."""
    copy = tmp_path / "bench"
    shutil.copytree(spec.BENCH, copy, ignore=shutil.ignore_patterns(
        "__pycache__", ".cache"))
    before = {p: p.read_bytes() for p in copy.rglob("*") if p.is_file()}
    bench = spec.benchmark()
    (copy / "metrics" / "steps_done.py").write_text(
        "def read(run):\n    return float(len(run.steps))\n")
    (copy / "configs" / "tiny-moe.json").write_text(json.dumps(MOE))
    (copy / "traffic" / "tiny-train.json").write_text(json.dumps(TRAIN))
    (copy / "limits" / "tiny-moe.tiny-train.json").write_text(json.dumps(
        {"grad_gap.median_leaf": 1e-3, "change_gap.worst_leaf": 1e-3}))
    bench["configs"].append({"name": "tiny-moe", "source": "test",
                             "file": "bench/configs/tiny-moe.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny-moe.tiny-train",
                               "config": "tiny-moe", "traffic": "tiny-train",
                               "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "steps_done", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "test", "moves": "setup_s",
                               "workloads": ["tiny-moe.tiny-train"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(spec, "BENCH", copy)
    monkeypatch.setattr(spec, "ROOT", tmp_path)
    line = cli.run_cell(spec.benchmark(), "tiny-moe.tiny-train", 5, 60.0,
                        True, CPU, 0.0)
    assert line["metrics"]["steps_done"]["value"] == TRAIN["trace_steps"]
    assert line["correct"] is True
    assert all(p.read_bytes() == b for p, b in before.items())


def test_traffic_is_the_same_for_the_same_seed():
    seed = 2 ** 31 + 12345
    a = traffic.train_batch(MOE, TRAIN, seed, 3, CPU)
    b = traffic.train_batch(MOE, TRAIN, seed, 3, CPU)
    c = traffic.train_batch(MOE, TRAIN, seed + 1, 3, CPU)
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], c["tokens"])
    assert torch.equal(a["labels"][:, :-1], a["tokens"][:, 1:])
    assert len({tuple(r) for r in a["tokens"].tolist()}) == TRAIN["batch"]
    assert torch.equal(traffic.serve_prompts(MOE, SERVE, seed, 2, 9, CPU),
                       traffic.serve_prompts(MOE, SERVE, seed, 2, 9, CPU))


def test_every_seed_sends_the_same_lengths_in_its_own_order():
    mix = spec.traffic("serve-grouped")
    lengths = traffic.serve_lengths(mix)
    assert lengths == sorted(lengths) and len(set(lengths)) == 8
    assert lengths[0] >= mix["prompt_min"] and lengths[-1] <= mix["prompt_max"]
    orders = {tuple(traffic.serve_order(mix, s)) for s in range(20)}
    assert all(sorted(o) == lengths for o in orders) and len(orders) > 1
    assert traffic.serve_order(mix, 7) == traffic.serve_order(mix, 7)


def test_weights_draw_again_bit_equal_leaf_by_leaf():
    full = weights.tree(MOE, 99, CPU)
    for leaf in weights.layer_leaves(MOE, 1):
        assert torch.equal(weights.get(full, leaf.path),
                           weights.draw(leaf, 99, CPU))
    other = weights.tree(MOE, 100, CPU)
    assert not torch.equal(full["embed"], other["embed"])


@pytest.mark.parametrize("trace", [False, True])
def test_the_last_line_has_the_contracts_keys(trace):
    out = train.run(ctx(MOE, TRAIN, trace=trace))
    bench = spec.benchmark()
    entry = spec.workload(bench, "mixtral-8x22b.train-8k")
    line = cli.result(bench, entry, out, trace, {"loss_gap.step1": 1.0}, CPU)
    want = LINE_KEYS | ({"breakdown"} if trace else set())
    assert set(line) == want and list(line)[-1] == "checks"
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert line["checks"]["loss_gap.step1"]["limit"] == 1.0
    json.dumps(line)


def test_a_serve_run_counts_requests_and_whole_cycles():
    c = ctx(MOE, SERVE, seconds=0.01)
    out = serve_grouped.run(c)
    cycle = SERVE["lengths_per_cycle"]
    assert len(out.run.steps) % cycle == 0
    assert out.attempted == len(out.run.steps) * SERVE["clients"]
    assert out.failed == 0
    assert sorted(b["length"] for b in out.run.steps[:cycle]) == (
        traffic.serve_lengths(SERVE))


def test_benchmark_json_keeps_to_the_contract():
    bench = spec.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    names = [c["name"] for c in bench["configs"]]
    cells = [w["name"] for w in bench["workloads"]]
    metrics = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    for group in (names, cells, metrics):
        assert len(group) == len(set(group))
        assert all(NAME.match(n) for n in group)
    used = {w["config"] for w in bench["workloads"]}
    assert used == set(names)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert spec.ROOT.joinpath(c["file"]).exists()
        assert c["file"].startswith("bench/configs/")
        cfg = spec.config(c["name"])
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        for w in m["workloads"]:
            reported = {e["name"] for e in spec.metrics_for(bench, w, False)}
            assert m["moves"] in reported, (m["name"], w)
    for w in cells:
        assert len(spec.metrics_for(bench, w, False)) >= 2
        assert spec.metrics_for(bench, w, True)
    assert len(json.dumps(bench)) < 64 * 1024
