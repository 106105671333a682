"""The port's fault injection (``repro_torch.faults``) and telemetry
(``repro_torch.obs``: the tracer, its views and exporters, and the CLI)
against the JAX package's ``repro.faults`` and ``repro.obs``, on the CPU,
at the quick scenario sizes.

Compiled fault streams, faulted simulations and every traced event must be
equal to the reference's; the only fields left out are the policy wall
times (``wall_s`` of a scheduling event and what is derived from it),
which read the host's clock.
"""

from __future__ import annotations

import dataclasses
import doctest
import importlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro import obs as robs
from repro.appdag.mixer import build_scenario as rbuild
from repro.core import make_scheduler as rmake
from repro.core import simulate as rsimulate
from repro import faults as rfaults
from repro_torch import faults as tfaults
from repro_torch import obs as tobs
from repro_torch.appdag import SCENARIOS, build_scenario
from repro_torch.core import make_scheduler, make_topology, simulate

REPO = Path(__file__).resolve().parent.parent
WALL_KEYS = {"wall_s", "wall_us", "sched_wall_s", "sched_wall_full_s",
             "sched_wall_refresh_s"}


def no_wall(x):
    if isinstance(x, dict):
        return {k: no_wall(v) for k, v in x.items() if k not in WALL_KEYS}
    if isinstance(x, list):
        return [no_wall(v) for v in x]
    return x


def _event(ev) -> tuple:
    """A traced event as (type, fields) without its wall time; arrays as
    lists."""
    fields = {f.name: getattr(ev, f.name) for f in dataclasses.fields(ev)
              if f.name != "wall_s"}
    return type(ev).__name__, {k: v.tolist() if isinstance(v, np.ndarray)
                               else v for k, v in fields.items()}


def _spec(pkg, topo_links: int):
    """One spec of every kind of fault: a degrade storm process and a
    straggler process over the horizon, then a scheduled link and host
    failure after it (soft events inside a failure window do not lint)."""
    return pkg.FaultSpec(
        horizon=40.0, seed=5,
        failures=(pkg.LinkFailure(link=1, at=50.0, repair_at=54.0),
                  pkg.HostFailure(port=6, at=56.0, repair_at=58.5)),
        processes=(pkg.FlakyLinks(links=tuple(range(topo_links)),
                                  storm_rate=0.3, mean_duration=2.0,
                                  factor=0.25, hit_fraction=0.5),
                   pkg.StragglerBurst(ports=(0, 1, 2), burst_rate=0.2,
                                      mean_duration=1.5)))


def test_fault_spec_compiles_as_the_reference():
    topo = make_topology("leaf_spine_3to1", 8)
    got = _spec(tfaults, topo.n_links).compile(topo)
    want = _spec(rfaults, topo.n_links).compile(topo)
    assert [dataclasses.astuple(e) for e in got] == \
        [dataclasses.astuple(e) for e in want]
    kinds = {e.kind for e in got}
    assert {"fail_link", "fail_host", "degrade_link", "degrade_port"} <= kinds
    assert tfaults.FAULT_STREAM == rfaults.FAULT_STREAM


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_chaos_runs_match_reference(name):
    """The chaos family's workload scales and the faulted simulation:
    JCTs and the resilience accounting equal to the reference's."""
    fabric, jobs = build_scenario(name, seed=2, quick=True)
    r_fabric, r_jobs = rbuild(name, seed=2, quick=True)
    assert tfaults.workload_horizon(jobs, fabric) == \
        rfaults.workload_horizon(r_jobs, r_fabric)
    assert tfaults.mean_flow_size(jobs) == rfaults.mean_flow_size(r_jobs)
    spec = tfaults.chaos_spec(fabric, jobs, 1.0, seed=2)
    r_spec = rfaults.chaos_spec(r_fabric, r_jobs, 1.0, seed=2)
    got = simulate(jobs, make_scheduler("msa"), fabric=fabric,
                   faults=spec.compile(fabric.topology),
                   retransmit=spec.retransmit)
    want = rsimulate(r_jobs, rmake("msa"), fabric=r_fabric,
                     faults=r_spec.compile(r_fabric.topology),
                     retransmit=r_spec.retransmit)
    assert got.jct == want.jct and got.cct == want.cct
    assert (got.n_faults, got.retransmitted_bytes, got.stall_s,
            got.flow_stall_s, got.recovery_lag_s) == (
        want.n_faults, want.retransmitted_bytes, want.stall_s,
        want.flow_stall_s, want.recovery_lag_s)


def _traced(pkg_obs, build, make, sim, policy):
    fabric, jobs = build("mixed", seed=1, quick=True)
    faults_pkg = tfaults if pkg_obs is tobs else rfaults
    spec = faults_pkg.chaos_spec(fabric, jobs, 1.0, seed=1)
    tr = pkg_obs.MemoryTracer()
    res = sim(jobs, make(policy), fabric=fabric, tracer=tr,
              faults=spec.compile(fabric.topology),
              retransmit=spec.retransmit)
    return tr, res


@pytest.mark.parametrize("policy", ["msa", "fair"])
def test_traces_and_views_match_reference(policy, tmp_path):
    tr, res = _traced(tobs, build_scenario, make_scheduler, simulate, policy)
    rtr, rres = _traced(robs, rbuild, rmake, rsimulate, policy)
    assert res.jct == rres.jct
    assert [_event(e) for e in tr.events] == [_event(e) for e in rtr.events]
    kinds = {type(e).__name__ for e in tr.events}
    assert {"SegmentEvent", "SchedEvent", "FabricFaultEvent"} <= kinds
    assert (tr.n_ports, tr.n_links, tr.link_names, tr.makespan) == (
        rtr.n_ports, rtr.n_links, rtr.link_names, rtr.makespan)
    usage, r_usage = tobs.link_utilization(tr), robs.link_utilization(rtr)
    for f in dataclasses.fields(usage):
        np.testing.assert_array_equal(getattr(usage, f.name),
                                      getattr(r_usage, f.name))
    assert tobs.job_phases(tr) == robs.job_phases(rtr)
    assert tobs.link_downtime(tr) == robs.link_downtime(rtr)
    assert tobs.downtime_windows(tr) == robs.downtime_windows(rtr)
    busiest = int(np.argmax(usage.bytes))
    assert tobs.link_timeline(tr, busiest) == robs.link_timeline(rtr, busiest)
    assert no_wall(tobs.scheduler_counters(tr)) == \
        no_wall(robs.scheduler_counters(rtr))
    assert no_wall(tobs.chrome_trace(tr)) == no_wall(robs.chrome_trace(rtr))
    assert [no_wall(e) for e in tobs.jsonl_events(tr)] == \
        [no_wall(e) for e in robs.jsonl_events(rtr)]
    n = tobs.write_jsonl(tr, tmp_path / "t.jsonl")
    assert n == robs.write_jsonl(rtr, tmp_path / "r.jsonl") > 0


@pytest.mark.parametrize("module", ["repro_torch.faults",
                                    "repro_torch.analysis",
                                    "repro_torch.experiments.spec",
                                    "repro_torch.obs"])
def test_docstring_examples(module):
    res = doctest.testmod(importlib.import_module(module), verbose=False)
    assert res.failed == 0


def test_obs_cli_matches_reference(tmp_path):
    args = ["--scenario", "mixed", "--policy", "msa", "--quick", "--verify"]
    outs = {}
    for pkg in ("repro_torch.obs", "repro.obs"):
        path = tmp_path / f"{pkg}.json"
        r = subprocess.run([sys.executable, "-m", pkg, *args, "-o", str(path),
                            "--jsonl", str(tmp_path / f"{pkg}.jsonl")],
                           capture_output=True, text=True, timeout=120,
                           cwd=REPO, env={"PYTHONPATH": str(REPO / "src"),
                                          "PATH": "/usr/bin:/bin"})
        assert r.returncode == 0, r.stderr
        outs[pkg] = no_wall(json.loads(path.read_text()))
    assert outs["repro_torch.obs"] == outs["repro.obs"]
    lines = [(tmp_path / f"{p}.jsonl").read_text().splitlines()
             for p in ("repro_torch.obs", "repro.obs")]
    assert [no_wall(json.loads(x)) for x in lines[0]] == \
        [no_wall(json.loads(x)) for x in lines[1]]
