"""The port's figure scripts and examples against the reference's.

``repro_torch.launch.figures`` holds one module per figure script of
the reference's ``benchmarks/run.py`` and the harness behind ``python -m
repro_torch.launch.figures``; ``repro_torch.launch.{quickstart,ml_cluster,
schedule_trace}`` are the reference's three JAX-free examples.  Here the
reference's figure scripts are loaded by path (``importlib.util``) and its
harness and examples run as subprocesses from the repository root, as a
user runs them.  Rows, ``check()`` lists, JSON documents and printed
output must be equal, but for the fields that read the host's clock:
every row's ``us_per_call`` and ``sched_micro``'s ``wall_speedup``.
Quick sizes throughout; the full-size Figure 3b runs in ``chip_smoke.py``.
"""

import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.launch.figures import (comm_overlap, fig1_motivation,
                                        fig3_topologies, ml_workloads,
                                        roofline_table, sched_micro)
from repro_torch.launch.figures import run as harness

REPO = Path(__file__).resolve().parent.parent
PORT = {"fig1_motivation": fig1_motivation, "fig3_topologies": fig3_topologies,
        "comm_overlap": comm_overlap, "ml_workloads": ml_workloads,
        "sched_micro": sched_micro, "roofline_table": roofline_table}
ENV = {**os.environ, "PYTHONPATH": str(REPO / "src"), "JAX_PLATFORMS": "cpu"}


def _reference(name: str):
    path = REPO / "benchmarks" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"reference_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = {name: _reference(name) for name in PORT}


def _no_clock(row) -> tuple:
    """A row without the fields that read the host's clock."""
    name, _us, derived, *extra = row
    derived = ";".join(kv for kv in derived.split(";")
                       if not kv.startswith("wall_speedup="))
    return (name, derived, *extra)


def _doc_no_clock(doc: dict) -> dict:
    rows = []
    for r in doc["rows"]:
        r = dict(r)
        r.pop("us_per_call")
        r["derived"] = _no_clock((r["name"], 0.0, r["derived"]))[1]
        rows.append(r)
    return {**doc, "rows": rows}


# The reference's harness, run from the repository root with its
# ``roofline_table`` pointed at DIR (argv[1]); argv[2:] are its flags.
_REF_HARNESS = """
import sys
from pathlib import Path
import benchmarks.roofline_table as rt
rt.DRYRUN_DIR = Path(sys.argv[1])
{patch}
from benchmarks import run
sys.argv = ["run"] + sys.argv[2:]
run.main()
"""


def _start_reference_harness(tmp: Path, flags: list[str], patch: str = ""
                             ) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-c", _REF_HARNESS.format(patch=patch), str(tmp),
         *flags], cwd=REPO, env=ENV, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def _finish(proc: subprocess.Popen) -> tuple[int, str, str]:
    out, err = proc.communicate(timeout=300)
    return proc.returncode, out, err


def _run_port_harness(tmp: Path, flags: list[str]) -> tuple[int, str, str]:
    out, err = io.StringIO(), io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(roofline_table, "DRYRUN_DIR", tmp)
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = harness.main(flags)
    return rc, out.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def quick_docs(tmp_path_factory):
    """Both harnesses' ``--quick --json`` runs, side by side: (exit code,
    stdout, JSON document) of the reference, then of the port."""
    tmp = tmp_path_factory.mktemp("figures")
    empty = tmp / "dryrun"
    empty.mkdir()
    ref = _start_reference_harness(empty, ["--quick", "--json",
                                           str(tmp / "ref.json")])
    rc, out, _ = _run_port_harness(empty, ["--quick", "--json",
                                           str(tmp / "port.json")])
    ref_rc, ref_out, ref_err = _finish(ref)
    assert ref_rc == 0, ref_err
    docs = [json.loads((tmp / f"{n}.json").read_text())
            for n in ("ref", "port")]
    return (ref_rc, ref_out, docs[0]), (rc, out, docs[1])


# ------------------------------------------------------------ the harness

def test_quick_harness_json_equals_reference(quick_docs):
    (ref_rc, _, ref_doc), (rc, _, doc) = quick_docs
    assert rc == ref_rc == 0
    assert doc["failures"] == ref_doc["failures"] == []
    assert _doc_no_clock(doc) == _doc_no_clock(ref_doc)
    assert {r["bench"] for r in doc["rows"]} == set(PORT)


def test_quick_harness_csv_equals_reference(quick_docs):
    """The printed CSV and roofline section line by line, but for the
    clock fields and the dry run each names."""
    (_, ref_out, _), (_, out, _) = quick_docs

    def lines(text, dryrun):
        got = []
        for line in text.splitlines():
            parts = line.split(",", 2)
            if len(parts) == 3 and parts[0] != "name":
                line = ",".join(_no_clock((parts[0], 0.0, parts[2]))[::2])
            got.append(line.replace(dryrun, "DRYRUN"))
        return got

    assert lines(out, "repro_torch.launch.dryrun") == \
        lines(ref_out, "repro.launch.dryrun")
    assert out.splitlines()[0] == "name,us_per_call,derived"


def test_figure1_gives_the_papers_numbers(quick_docs):
    _, (_, _, doc) = quick_docs
    rows = {r["name"]: r["derived"] for r in doc["rows"]}
    assert rows["fig1/msa"].startswith("avg_jct=7.000;")
    assert rows["fig1/varys"].startswith("avg_jct=8.000;")


@pytest.mark.parametrize("bench", sorted(PORT))
def test_figure_rows_and_checks_equal_reference(quick_docs, bench):
    """Each figure's ``run(quick=True, ...)`` rows, as the harness calls
    it, and both ``check()``s on the port's rows."""
    (_, _, ref_doc), (_, _, doc) = quick_docs

    def rows(d):
        return [(r["name"], r["us_per_call"], r["derived"])
                for r in d["rows"] if r["bench"] == bench]

    got, want = rows(doc), rows(ref_doc)
    assert got and [_no_clock(r) for r in got] == [_no_clock(r) for r in want]
    assert PORT[bench].check(got) == REF[bench].check(got) == []


@pytest.mark.parametrize("bench,kwargs", [
    ("fig1_motivation", {"policies": ("msa", "varys", "fifo", "fair",
                                      "cpath")}),
    ("fig3_topologies", {"policies": ("msa",),
                         "topology": "leaf_spine_3to1"}),
    ("fig3_topologies", {"policies": ("fair",), "topology": "big_switch"}),
    ("ml_workloads", {"policies": ("msa", "fifo"), "analyze": True}),
    ("ml_workloads", {"policies": ("msa", "fair"), "seed": 3,
                      "topology": "fat_tree"}),
    ("sched_micro", {"policies": ("fifo",)}),
])
def test_figure_options_equal_reference(bench, kwargs):
    got = PORT[bench].run(quick=True, **kwargs)
    want = REF[bench].run(quick=True, **kwargs)
    assert [_no_clock(r) for r in got] == [_no_clock(r) for r in want]
    assert PORT[bench].check(got) == REF[bench].check(got)


def test_comm_overlap_plans_the_reference_device():
    """The table plans the reference's device: ``REFERENCE_CHIP`` is the
    reference's roofline constants, not the port's H100 default."""
    from repro.roofline import analysis as rroofline
    from repro_torch.roofline.hw import H100

    chip = comm_overlap.REFERENCE_CHIP
    assert (chip.peak_flops, chip.hbm_bw, chip.link_bw) == (
        rroofline.PEAK_FLOPS, rroofline.HBM_BW, rroofline.LINK_BW)
    assert chip != H100


def _set(derived: str, key: str, value: str) -> str:
    return ";".join(f"{key}={value}" if kv.split("=", 1)[0] == key else kv
                    for kv in derived.split(";"))


def _plant(rows, name_part: str, key: str, value: str) -> list:
    out = []
    for r in rows:
        if name_part in r[0]:
            r = (r[0], r[1], _set(r[2], key, value), *r[3:])
        out.append(r)
    return out


PLANTED = {  # bench -> rows of the quick harness -> rows with a failure
    "fig1_msa": ("fig1_motivation",
                 lambda rows: _plant(rows, "fig1/msa", "avg_jct", "7.500")),
    "fig1_varys": ("fig1_motivation",
                   lambda rows: _plant(rows, "fig1/varys", "avg_jct",
                                       "7.000")),
    "fig3_disorder": ("fig3_topologies",
                      lambda rows: _plant(rows, "trace/disorder",
                                          "varys_over_msa", "1.200")),
    "fig3_total": ("fig3_topologies",
                   lambda rows: _plant(rows, "fanout/total_order",
                                       "varys_over_msa", "1.010")),
    "comm_flat": ("comm_overlap",
                  lambda rows: _plant(rows, "mixtral", "msa_s", "99.0")),
    "ml_fair": ("ml_workloads",
                lambda rows: _plant(rows, "ml/mixed", "fair_over_msa",
                                    "0.900")),
    "ml_fifo": ("ml_workloads",
                lambda rows: _plant(rows, "ml/mixed", "fifo_over_msa",
                                    "1.010")),
    "ml_degenerate": ("ml_workloads",
                      lambda rows: _plant(rows, "ml/dense_dp", "msa",
                                          "5.0/9.0")),
    "ml_bound": ("ml_workloads",
                 lambda rows: [(*rows[0][:3], {"optimality_gap":
                                               {"msa": 0.5}})] + rows[1:]),
    "sched_identical": ("sched_micro",
                        lambda rows: _plant(rows, "caching/msa",
                                            "identical", "0")),
    "sched_inv_ratio": ("sched_micro",
                        lambda rows: _plant(rows, "caching/cpath",
                                            "inv_ratio", "1.20")),
    "sched_latency": ("sched_micro",
                      lambda rows: [(rows[0][0], 250_000.0, *rows[0][2:])]
                      + rows[1:]),
}


@pytest.mark.parametrize("case", sorted(PLANTED))
def test_checks_equal_reference_on_planted_failures(quick_docs, case):
    bench, plant = PLANTED[case]
    _, (_, _, doc) = quick_docs
    rows = [(r["name"], r["us_per_call"], r["derived"])
            for r in doc["rows"] if r["bench"] == bench]
    bad = plant(rows)
    assert bad != rows
    errs = PORT[bench].check(bad)
    assert errs and errs == REF[bench].check(bad)


def test_harness_exits_one_with_the_failures_in_json(tmp_path):
    """A planted Figure 1 regression: the port's harness and the
    reference's print the same CHECK-FAIL line, write the same failures
    and exit 1."""
    bad = ("fig1/msa", 1.0, "avg_jct=7.500;avg_cct=4.000;jct_J1=7.0;"
           "jct_J2=8.0")
    flags = ["--only", "fig1_motivation", "--json"]
    ref = _start_reference_harness(
        tmp_path, flags + [str(tmp_path / "ref.json")],
        patch=f"import benchmarks.fig1_motivation as f\n"
              f"f.run = lambda **kw: [{bad!r}]")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fig1_motivation, "run", lambda **kw: [bad])
        rc, out, err = _run_port_harness(
            tmp_path, flags + [str(tmp_path / "port.json")])
    ref_rc, ref_out, ref_err = _finish(ref)
    assert rc == ref_rc == 1
    assert err == ref_err and "CHECK-FAIL[fig1_motivation]" in err
    assert out == ref_out
    docs = [json.loads((tmp_path / f"{n}.json").read_text())
            for n in ("ref", "port")]
    assert docs[0] == docs[1] and docs[1]["failures"]


def test_module_entry_point_runs(tmp_path):
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.figures", "--only",
         "fig1_motivation", "--policy", "msa", "--policy", "varys"],
        cwd=tmp_path, env=ENV, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    lines = r.stdout.splitlines()
    assert lines[0] == "name,us_per_call,derived"
    assert [line.split(",")[0] for line in lines[1:]] == ["fig1/msa",
                                                          "fig1/varys"]
    assert list(tmp_path.iterdir()) == []      # writes nothing unasked


def test_harness_refuses_unknown_policy_and_topology():
    for flags in (["--policy", "nope"], ["--topology", "torus"]):
        with pytest.raises(SystemExit) as e, \
                contextlib.redirect_stderr(io.StringIO()):
            harness.main(flags)
        assert e.value.code == 2



def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_constants_are_the_figures_rows():
    """``chip_smoke.py`` holds the card host's full-size rows to recorded
    constants: the framework-integration table (every arch) equals both
    packages' rows here; the Figure 3b rows (29 s a package at full size,
    so not rerun here) name the figure's rows and pass both checks."""
    smoke = _chip_smoke()
    got = {r[0]: r[2] for r in comm_overlap.run()}
    want = {r[0]: r[2] for r in REF["comm_overlap"].run()}
    assert got == want == smoke.COMM_OVERLAP_DERIVED
    rows = [(n, 0.0, d) for n, d in smoke.FIG3_DERIVED.items()]
    assert [r[0] for r in rows] == [
        f"fig3/{regime}/{topo}" for regime in fig3_topologies.REGIMES
        for topo in ("total_order", "partial_order", "disorder")]
    assert fig3_topologies.check(rows) == REF["fig3_topologies"].check(
        rows) == []
    assert [o for o, _ in smoke.FIGURE_RUNS] == [
        b for b in PORT if b != "roofline_table"]

# ---------------------------------------------------------------- roofline

def test_roofline_table_renders_a_port_dry_run_cell(tmp_path, monkeypatch):
    """One production cell written by the port's dry run (whisper-base
    ``decode_32k`` on the fake (32, 8) mesh) into a temporary directory,
    then read back by the table, the markdown and the harness row."""
    from repro_torch.launch import dryrun

    assert roofline_table.DRYRUN_DIR == dryrun.OUT_DIR
    monkeypatch.setattr(sys, "argv", [
        "dryrun", "--arch", "whisper-base", "--shape", "decode_32k",
        "--out-dir", str(tmp_path)])
    with pytest.raises(SystemExit) as e:
        dryrun.main()
    assert e.value.code == 0
    cell = json.loads(
        (tmp_path / "whisper-base__decode_32k__single.json").read_text())
    dom = cell["roofline"]["dominant"]
    monkeypatch.setattr(roofline_table, "DRYRUN_DIR", tmp_path)
    assert roofline_table.run() == [
        ("roofline/single", 0.0, f"cells=1;{dom}_bound=1"),
        ("roofline/multi", 0.0, "cells=0;")]
    text = roofline_table.table("single").splitlines()
    assert len(text) == 3 and text[2].split()[:2] == ["whisper-base",
                                                       "decode_32k"]
    peak = cell["memory"]["peak_bytes_per_device"] / 1e9
    assert text[2].split()[-1] == f"{peak:.2f}"
    md = roofline_table.markdown("single").splitlines()
    assert md[2].startswith("| whisper-base | decode_32k |")
    assert roofline_table.lever(cell) in md[2]
    assert "repro_torch.launch.dryrun --all" in roofline_table.table("multi")


# ---------------------------------------------------------------- examples

FB_FIXTURE = """\
150 3
1 0 2 10 20 2 5:6.0 6:2.0
2 100 1 3 3 7:1.5 8:4.5 9:3.0
3 250 4 1 2 3 4 1 5:8.0

"""


@pytest.mark.parametrize("example,flags", [
    ("quickstart", []),
    ("ml_cluster", []),
    ("ml_cluster", ["--arch", "mixtral-8x22b", "--ep", "4", "--policy",
                    "msa", "--policy", "varys"]),
    ("schedule_trace", ["--jobs", "6"]),
    ("schedule_trace", ["--jobs", "4", "--policy", "msa", "--policy",
                        "cpath", "--compute-ratio", "0.5", "--seed", "3"]),
    ("schedule_trace", ["--jobs", "3", "--trace", "FIXTURE"]),
])
def test_example_stdout_equals_reference(tmp_path, example, flags):
    (tmp_path / "fb.txt").write_text(FB_FIXTURE)
    flags = [str(tmp_path / "fb.txt") if f == "FIXTURE" else f for f in flags]
    ref = subprocess.run([sys.executable, f"examples/{example}.py", *flags],
                         cwd=REPO, env=ENV, capture_output=True, text=True,
                         timeout=300)
    got = subprocess.run(
        [sys.executable, "-m", f"repro_torch.launch.{example}", *flags],
        cwd=REPO, env=ENV, capture_output=True, text=True, timeout=300)
    assert ref.returncode == got.returncode == 0, got.stderr
    assert got.stdout and got.stdout == ref.stdout
