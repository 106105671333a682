"""The port's static analysis (``repro_torch.analysis``: lint, bounds,
contention, structure, the decision sanitizer and the CLI) and the strict
lint of its scenario builder against the JAX package's ``repro.analysis``,
on the CPU, at the quick scenario sizes.

Findings, bounds and structure blocks must be equal to the reference's on
every registered scenario, exactly; the simulator under ``debug_checks``
must give the reference's JCTs and raise the reference's violations.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro import analysis as ran
from repro.appdag import lowering as rlow
from repro.appdag.mixer import build_scenario as rbuild
from repro.core import FaultEvent as RFaultEvent
from repro.core import JobDAG as RJobDAG
from repro.core import make_scheduler as rmake
from repro.core import simulate as rsimulate
from repro.core.sched import Decision as RDecision
from repro.core.sched import Scheduler as RScheduler
from repro.faults import chaos_spec as rchaos
from repro_torch import analysis as tan
from repro_torch.appdag import SCENARIOS
from repro_torch.appdag import lowering as tlow
from repro_torch.appdag import mixer as tmixer
from repro_torch.core import Fabric, FaultEvent, JobDAG, Simulator
from repro_torch.core import make_scheduler, make_topology, simulate
from repro_torch.core.sched import Decision, Scheduler
from repro_torch.faults import chaos_spec

REPO = Path(__file__).resolve().parent.parent


def _findings(fs) -> list[tuple]:
    return [dataclasses.astuple(f) for f in fs]


def _both(name, seed=0, topology=None):
    return (tmixer.build_scenario(name, seed=seed, quick=True,
                                  topology=topology, lint=False),
            rbuild(name, seed=seed, quick=True, topology=topology, lint=False))


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_analysis_matches_reference_on_every_scenario(name):
    (tf, tj), (rf, rj) = _both(name)
    assert _findings(tan.lint_jobs(tj, tf.topology)) == \
        _findings(ran.lint_jobs(rj, rf.topology))
    assert _findings(tan.lint_scenario(name, quick=True)) == \
        _findings(ran.lint_scenario(name, quick=True))
    for tight in (True, False):
        assert tan.scenario_lower_bounds(tj, tf.topology, tight=tight) == \
            ran.scenario_lower_bounds(rj, rf.topology, tight=tight)
    assert tan.batch_bounds(tj, tf.topology).to_json() == \
        ran.batch_bounds(rj, rf.topology).to_json()
    assert tan.link_load_bound(tj, tf.topology) == \
        ran.link_load_bound(rj, rf.topology)
    assert [dataclasses.astuple(c) for c in
            tan.contention_graph(tj, tf.topology)] == \
        [dataclasses.astuple(c) for c in ran.contention_graph(rj, rf.topology)]
    assert tan.scenario_structure(name, tj, tf.topology).to_json() == \
        ran.scenario_structure(name, rj, rf.topology).to_json()
    for intensity in (0.5, 2.0):
        t_spec = chaos_spec(tf, tj, intensity, seed=3)
        r_spec = rchaos(rf, rj, intensity, seed=3)
        t_ev = t_spec.compile(tf.topology)       # strict-linted
        r_ev = r_spec.compile(rf.topology)
        assert [dataclasses.astuple(e) for e in t_ev] == \
            [dataclasses.astuple(e) for e in r_ev]
        assert dataclasses.astuple(t_spec.retransmit) == \
            dataclasses.astuple(r_spec.retransmit)
        assert _findings(tan.lint_faults(t_ev, tf.topology)) == \
            _findings(ran.lint_faults(r_ev, rf.topology))


def test_registries_and_ranking_match_reference():
    assert tan.available_checks() == ran.available_checks()
    assert tan.available_invariants() == ran.available_invariants()
    assert tan.SPECTRUM == ran.SPECTRUM
    t_structs, r_structs = [], []
    for name in sorted(SCENARIOS):
        (tf, tj), (rf, rj) = _both(name)
        t_structs.append(tan.scenario_structure(name, tj, tf.topology))
        r_structs.append(ran.scenario_structure(name, rj, rf.topology))
    ranking = tan.predicted_ranking(t_structs)
    assert ranking == ran.predicted_ranking(r_structs)
    measured = {n: 1.0 + 0.1 * i for i, n in enumerate(sorted(SCENARIOS))}
    pred = {s.scenario: s.msa_advantage_score for s in t_structs}
    assert tan.rank_agreement(pred, measured) == \
        ran.rank_agreement(pred, measured)


def test_lint_faults_findings_match_reference_on_planted_faults():
    topo = make_topology("big_switch", 4)
    bad = [(1.0, "fail_link", 99, None), (2.0, "repair_link", 1, None),
           (0.5, "degrade_link", 0, 0.5), (3.0, "fail_host", 7, None),
           (4.0, "restore_link", 0, None), (5.0, "fail_link", 2, None)]
    got = tan.lint_faults([FaultEvent(*e) for e in bad], topo)
    want = ran.lint_faults([RFaultEvent(*e) for e in bad],
                           make_topology("big_switch", 4))
    assert _findings(got) == _findings(want) and got
    with pytest.raises(tan.LintError):
        tan.strict(got)


def test_lint_lowered_matches_reference():
    for kind in tlow.COLLECTIVES:
        for alg in tlow.ALGORITHMS:
            ranks = (3, 7) if kind == "p2p" else (3, 7, 11, 19)
            try:
                t_lc = tlow.lower_collective(kind, ranks, 5.0, alg)
            except ValueError:
                with pytest.raises(ValueError):
                    rlow.lower_collective(kind, ranks, 5.0, alg)
                continue
            r_lc = rlow.lower_collective(kind, ranks, 5.0, alg)
            assert tan.lint_lowered(t_lc) == []
            broken = dataclasses.replace(t_lc, rounds=t_lc.rounds[:-1])
            assert _findings(tan.lint_lowered(broken)) == _findings(
                ran.lint_lowered(dataclasses.replace(
                    r_lc, rounds=r_lc.rounds[:-1])))
            assert tan.expected_wire_bytes(kind, 4, 3.0) == \
                ran.expected_wire_bytes(kind, 4, 3.0)


def test_build_scenario_lints_by_default(monkeypatch):
    import repro_torch.analysis.lint as lint_mod

    calls = []
    real = lint_mod.strict
    monkeypatch.setattr(lint_mod, "strict",
                        lambda fs: calls.append(1) or real(fs))
    tmixer.build_scenario("dense_dp", seed=0, quick=True)
    assert calls == [1]
    tmixer.build_scenario("dense_dp", seed=0, quick=True, lint=False)
    assert calls == [1]

    def self_flow(seed, quick):
        job = JobDAG(name="bad")
        job.add_metaflow("m", flows=[(1, 1, 4.0)])
        return 2, [job]

    monkeypatch.setitem(tmixer.SCENARIOS, "bad", self_flow)
    with pytest.raises(tan.LintError, match="self"):
        tmixer.build_scenario("bad")
    assert len(tmixer.build_scenario("bad", lint=False)[1]) == 1


@pytest.mark.parametrize("policy", ["msa", "varys", "fair", "fifo", "cpath"])
def test_debug_checks_run_the_invariant_engine(policy):
    """``debug_checks=True`` audits every decision and changes nothing: the
    port's run equals its unchecked run and the reference's checked run."""
    for name in ("mixed", "mixed_oversub_3to1", "moe_ep"):
        (tf, tj), (rf, rj) = _both(name, seed=1)
        checked = simulate(tj, make_scheduler(policy), fabric=tf,
                           debug_checks=True)
        plain_f, plain_j = tmixer.build_scenario(name, seed=1, quick=True)
        plain = simulate(plain_j, make_scheduler(policy), fabric=plain_f)
        want = rsimulate(rj, rmake(policy), fabric=rf, debug_checks=True)
        assert checked.jct == plain.jct == want.jct
        assert checked.cct == want.cct
        assert checked.events == want.events


def _bogus(base):
    class Bogus(base):
        name = "bogus"

        def schedule(self, view):
            decision = Decision if base is Scheduler else RDecision
            return decision(rates=np.full_like(view.rem, 10.0))
    return Bogus()


def _one_job(cls):
    j = cls(name="j")
    j.add_metaflow("m", flows=[(0, 1, 4.0)])
    j.add_task("c", load=1.0, deps=["m"])
    return j


def test_debug_checks_raise_the_reference_violation():
    from repro.core import Fabric as RFabric
    from repro.core import Simulator as RSimulator

    with pytest.raises(tan.InvariantViolation) as got:
        Simulator(Fabric(n_ports=2), [_one_job(JobDAG)], _bogus(Scheduler),
                  debug_checks=True).run()
    with pytest.raises(ran.InvariantViolation) as want:
        RSimulator(RFabric(n_ports=2), [_one_job(RJobDAG)],
                   _bogus(RScheduler), debug_checks=True).run()
    assert str(got.value) == str(want.value) and "oversubscribed" in str(
        got.value)
    assert _findings(got.value.findings) == _findings(want.value.findings)
    assert {f.check for f in got.value.findings} == {"link_capacity"}
    assert issubclass(tan.InvariantViolation, AssertionError)


def test_recorded_trace_audits_match_reference():
    (tf, tj), (rf, rj) = _both("pipe_serve", seed=2)
    t_sched = tan.RecordingScheduler(make_scheduler("msa"))
    r_sched = ran.RecordingScheduler(rmake("msa"))
    simulate(tj, t_sched, fabric=tf)
    rsimulate(rj, r_sched, fabric=rf)
    assert len(t_sched.records) == len(r_sched.records) > 0
    assert tan.audit_trace(t_sched.records) == []
    pick = next(i for i, r in enumerate(t_sched.records)
                if (r.rem > 1e-9).any())
    t_bad = dataclasses.replace(t_sched.records[pick],
                                rates=t_sched.records[pick].rates * 50.0)
    r_bad = dataclasses.replace(r_sched.records[pick],
                                rates=r_sched.records[pick].rates * 50.0)
    got = tan.audit_trace([*t_sched.records, t_bad])
    assert _findings(got) == _findings(ran.audit_trace([*r_sched.records,
                                                        r_bad]))
    assert any(f.check == "link_capacity" for f in got)


def test_cli_json_matches_reference(capsys):
    from repro.analysis.cli import main as rmain
    from repro_torch.analysis.cli import main as tmain

    argv = ["--quick", "--structure", "--fault-intensity", "1.0", "--json"]
    assert tmain(argv) == 0
    got = json.loads(capsys.readouterr().out)
    assert rmain(argv) == 0
    want = json.loads(capsys.readouterr().out)
    assert got == want and got["n_errors"] == 0
    assert set(got["scenarios"]) == set(SCENARIOS)


@pytest.mark.parametrize("argv", [["--quick"], ["--quick", "--structure"]])
def test_cli_module_exits_zero(argv):
    r = subprocess.run([sys.executable, "-m", "repro_torch.analysis", *argv],
                       capture_output=True, text=True, timeout=120, cwd=REPO,
                       env={"PYTHONPATH": str(REPO / "src"),
                            "PATH": "/usr/bin:/bin"})
    assert r.returncode == 0, r.stderr
    assert all(f"{name}" in r.stdout for name in SCENARIOS)
