"""The port's lockstep engine (``repro_torch.core.simtorch``) and its sweep
router (``repro_torch.experiments``) against the JAX package, on the CPU.

Mirrors ``tests/test_simjax.py``:
  1. per-lane JCT/CCT and makespan within ``TOL`` of both the numpy
     ``simulate`` and ``repro.core.simjax.run_fifo_batch``, and lockstep
     events equal to simjax's, on every registered scenario x 5 seeds;
  2. padding/masking: heterogeneous lanes batched together behave as if
     each ran alone (pinned cases, randomized specs, hypothesis);
  3. the raises (deadlock, ``max_events``, no card), the docstring
     example, and the router's order and records (the cells the engine
     does not take through the port's ``run_cell``).
``TOL`` is the reference's: not bit-exact, because torch's and XLA's
cumsums and reductions associate float sums differently.
"""

from __future__ import annotations

import doctest
import random

import pytest
import torch

from repro.appdag.mixer import SCENARIOS, build_scenario
from repro.core import Fabric as RFabric
from repro.core import JobDAG as RJobDAG
from repro.core import make_scheduler, simulate, simjax
from repro.experiments import Cell, run_cell
from repro.experiments import run_cells_batched as ref_run_cells_batched
from repro_torch.appdag import build_scenario as tbuild
from repro_torch.core import Fabric, JobDAG, simtorch
from repro_torch.core.simtorch import pack_instance, run_fifo_batch
from repro_torch.experiments import batchable, run_cells_batched

TOL = 1e-6
N_SEEDS = 5
CPU = "cpu"


def _max_diff(lane, ref) -> float:
    assert set(lane.jct) == set(ref.jct)
    diff = max(abs(lane.jct[n] - ref.jct[n]) for n in ref.jct)
    return max(diff, max(abs(lane.cct[n] - ref.cct[n]) for n in ref.cct))


def _no_wall(rec: dict) -> dict:
    """A record without its one machine-dependent field."""
    return {**rec, "result": {k: v for k, v in rec["result"].items()
                              if k != "wall_s"}}


def _lanes(scenario: str, seeds=range(N_SEEDS), quick=True):
    return [pack_instance(*tbuild(scenario, seed=s, quick=quick))
            for s in seeds]


class TestEquivalence:
    @pytest.mark.parametrize("scenario", sorted(SCENARIOS))
    def test_matches_numpy_and_simjax_per_lane(self, scenario):
        lanes = _lanes(scenario)
        results = run_fifo_batch(lanes, device=CPU)
        jax_results = simjax.run_fifo_batch(lanes)
        for seed, (lane, jlane) in enumerate(zip(results, jax_results)):
            fabric, jobs = build_scenario(scenario, seed=seed, quick=True,
                                          lint=False)
            ref = simulate(jobs, make_scheduler("fifo"), fabric=fabric)
            what = f"{scenario}/seed{seed}"
            assert _max_diff(lane, ref) < TOL, what
            assert lane.makespan == pytest.approx(ref.makespan, abs=TOL)
            assert _max_diff(lane, jlane) < TOL, what
            assert lane.makespan == pytest.approx(jlane.makespan, abs=TOL)
            assert lane.events == jlane.events, what

    @pytest.mark.parametrize("scenario,topology", [
        *((name, None) for name in sorted(SCENARIOS)), ("mixed", "fat_tree")])
    def test_full_size_lane_matches_numpy_and_simjax(self, scenario,
                                                     topology):
        """The card phase's full-size lanes (up to 2,240 flows, ~200
        events, six-link ``fat_tree`` paths), seed 0, held to the
        reference here as the quick ones are above."""
        lane = pack_instance(*tbuild(scenario, seed=0, quick=False,
                                     topology=topology))
        got = run_fifo_batch([lane], device=CPU)[0]
        jlane = simjax.run_fifo_batch([lane])[0]
        fabric, jobs = build_scenario(scenario, seed=0, quick=False,
                                      topology=topology, lint=False)
        ref = simulate(jobs, make_scheduler("fifo"), fabric=fabric)
        assert _max_diff(got, ref) < TOL
        assert got.makespan == pytest.approx(ref.makespan, abs=TOL)
        assert got.events == jlane.events

    def test_figure1(self):
        from repro_torch.core.metaflow import figure1_jobs
        lane = pack_instance(Fabric(n_ports=3), figure1_jobs())
        got = run_fifo_batch([lane], device=CPU)[0]
        want = simjax.run_fifo_batch([lane])[0]
        assert _max_diff(got, want) < TOL and got.events == want.events


class TestPaddingMask:
    """result(batch)[i] == result([lane_i])[0]: padding never leaks."""

    def test_heterogeneous_lanes_independent(self):
        lanes = [pack_instance(*tbuild(s, seed=i, quick=True))
                 for i, s in enumerate(("pipe_serve", "dense_dp", "moe_ep",
                                        "mixed_oversub_3to1"))]
        assert len({p.flow_node.size for p in lanes}) > 1
        assert len({p.flow_links.shape[1] for p in lanes}) > 1
        together = run_fifo_batch(lanes, device=CPU)
        for lane, result in zip(lanes, together):
            alone = run_fifo_batch([lane], device=CPU)[0]
            assert result.jct == pytest.approx(alone.jct, abs=TOL)
            assert result.cct == pytest.approx(alone.cct, abs=TOL)
            assert result.events == alone.events

    def test_single_flow_lanes(self):
        def lane(size, arrival=0.0):
            job = JobDAG("j0", arrival=arrival)
            job.add_metaflow("m0", [(0, 1, size)])
            return pack_instance(Fabric(n_ports=2), [job])

        res = run_fifo_batch([lane(10.0), lane(30.0), lane(5.0, 2.0)],
                             device=CPU)
        assert [r.jct["j0"] for r in res] == [10.0, 30.0, 5.0]
        assert res[2].makespan == 7.0

    @staticmethod
    def draw_specs(rng):
        """Lane specs: (n_ports, [(arrival, [metaflow flow lists])]) --
        plain data, so oracle and lane build independent JobDAGs."""
        specs = []
        for _ in range(rng.randint(1, 3)):
            n_ports = rng.choice((2, 4, 8))
            job_specs = []
            for _ in range(rng.randint(1, 3)):
                mfs = []
                for _ in range(rng.randint(1, 3)):
                    flows = [(rng.randrange(n_ports), rng.randrange(n_ports),
                              round(rng.uniform(0.5, 8.0), 3))
                             for _ in range(rng.randint(1, 4))]
                    flows = [(s, d, z) for s, d, z in flows if s != d]
                    if flows:
                        mfs.append(flows)
                if mfs:
                    job_specs.append((round(rng.uniform(0, 3), 3), mfs))
            if job_specs:
                specs.append((n_ports, job_specs))
        return specs

    @staticmethod
    def build_jobs(job_specs, cls):
        jobs = []
        for ji, (arrival, mfs) in enumerate(job_specs):
            job = cls(f"j{ji}", arrival=arrival)
            for mi, flows in enumerate(mfs):
                job.add_metaflow(f"m{mi}", flows)
            job.validate()
            jobs.append(job)
        return jobs

    def check_specs(self, seed: int) -> None:
        specs = self.draw_specs(random.Random(seed))
        if not specs:
            return
        lanes = [pack_instance(Fabric(n_ports=n), self.build_jobs(js, JobDAG))
                 for n, js in specs]
        refs = [simulate(self.build_jobs(js, RJobDAG), make_scheduler("fifo"),
                         n_ports=n) for n, js in specs]
        for lane, ref in zip(run_fifo_batch(lanes, device=CPU), refs):
            assert _max_diff(lane, ref) < TOL

    @pytest.mark.parametrize("seed", range(8))
    def test_random_padding_invariants(self, seed):
        self.check_specs(seed)

    def test_hypothesis_padding_invariants(self):
        pytest.importorskip(
            "hypothesis", reason="randomized padding invariants need "
                                 "hypothesis; pinned cases above still run")
        from hypothesis import given, settings
        from hypothesis import strategies as st

        @settings(max_examples=10, deadline=None)
        @given(st.integers(0, 2 ** 16))
        def run(seed):
            self.check_specs(seed)

        run()


class TestEngine:
    def test_docstring_example(self):
        out = doctest.testmod(simtorch, raise_on_error=False)
        assert out.attempted >= 4 and out.failed == 0

    def test_deadlock_raises_like_simjax(self):
        def lane(cls_fab, cls_job):
            job = cls_job("j0")
            job.add_metaflow("m0", [(0, 1, 4.0)])
            # A dead egress port: the flow can never move.
            return pack_instance(cls_fab(n_ports=2, egress=[0.0, 1.0]),
                                 [job])

        ok = pack_instance(Fabric(n_ports=2), [JobDAG("j0")])
        with pytest.raises(RuntimeError, match=r"deadlock: .* lanes \[1\]"):
            run_fifo_batch([ok, lane(Fabric, JobDAG)], device=CPU)
        with pytest.raises(RuntimeError, match=r"deadlock: .* lanes \[1\]"):
            simjax.run_fifo_batch([ok, lane(RFabric, RJobDAG)])

    def test_max_events_raises(self):
        job = JobDAG("j0")
        job.add_metaflow("m0", [(0, 1, 1.0)])
        job.add_metaflow("m1", [(0, 1, 1.0)], deps=["m0"])
        lane = pack_instance(Fabric(n_ports=2), [job])
        with pytest.raises(RuntimeError, match="max_events"):
            run_fifo_batch([lane], device=CPU, steps_per_sync=1,
                           max_events=0)
        res = run_fifo_batch([lane], device=CPU, steps_per_sync=1)
        assert res[0].jct["j0"] == 2.0 and res[0].events == 2

    def test_default_device_is_the_card(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        lane = _lanes("pipe_serve", seeds=[0])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_fifo_batch(lane)

    def test_settle_is_idempotent(self):
        pk = simtorch._pack_batch(_lanes("mixed"), torch.device(CPU))
        s = simtorch._init_state(pk)
        for _ in range(20):
            s = simtorch._step(pk, s)
            again = simtorch._settle(pk, s)
            for a, b in zip(s, again):
                assert torch.equal(a, b)

    def test_done_lanes_stay_frozen(self):
        lanes = [pack_instance(*tbuild("pipe_serve", seed=0, quick=True)),
                 pack_instance(*tbuild("mixed", seed=1, quick=True))]
        pk = simtorch._pack_batch(lanes, torch.device(CPU))
        s = simtorch._settle(pk, simtorch._init_state(pk))
        while not bool(s.done[0]):
            s = simtorch._step(pk, s)
        frozen = [x[0].clone() for x in s]
        s = simtorch._multi_step(pk, s, 5)
        assert not bool(s.done[1])
        for a, b in zip(frozen, s):
            assert torch.equal(a, b[0])

    def test_host_reads_are_counted(self):
        lanes = _lanes("pipe_serve", seeds=[0, 1])

        def reads(steps_per_sync):
            before = simtorch.sync_count()
            res = run_fifo_batch(lanes, device=CPU,
                                 steps_per_sync=steps_per_sync)
            return simtorch.sync_count() - before, max(r.events for r in res)

        base, events = reads(1)
        assert reads(1) == (base, events) and base > 2 * events
        for sps in (16, 64):
            windows = -(-events // sps)
            # A step past the last event still tests the cascade and the
            # waves once each; the done flags are read once per window,
            # plus once before the first.
            extra = 2 * (windows * sps - events) + (windows + 1) - (events + 1)
            assert reads(sps) == (base + extra, events)


class TestRunnerIntegration:
    def test_batchable(self):
        assert batchable(Cell("mixed", "fifo", "big_switch", 0))
        assert not batchable(Cell("mixed", "msa", "big_switch", 0))
        assert not batchable(Cell("mixed", "fifo", "big_switch", 0, 0.5))

    def test_run_cells_batched_order_and_fallback(self):
        cells = [Cell("pipe_serve", "fifo", "big_switch", s) for s in (1, 0)]
        cells.append(Cell("pipe_serve", "msa", "big_switch", 0))
        cells.append(Cell("mixed", "fifo", "fat_tree", 2))
        recs = run_cells_batched(cells, quick=True, workers=1, device=CPU)
        assert [r["seed"] for r in recs] == [1, 0, 0, 2]
        assert [r.get("engine") for r in recs] == [
            "simtorch", "simtorch", None, "simtorch"]
        assert _no_wall(recs[2]) == _no_wall(run_cell(cells[2], quick=True))
        refs = ref_run_cells_batched(cells, quick=True, workers=1)
        for rec, ref in zip(recs, refs):
            assert set(rec) == set(ref)
            assert set(rec["result"]) == set(ref["result"])
            for key in ("scenario", "policy", "topology", "seed"):
                assert rec[key] == ref[key]
            for key in ("avg_jct", "avg_cct", "makespan"):
                assert rec["result"][key] == pytest.approx(
                    ref["result"][key], abs=TOL)
            if "engine" in rec:
                assert rec["result"]["events"] == ref["result"]["events"]
                assert rec["result"]["sched_full"] == 0
        direct = run_cell(cells[0], quick=True)
        for key in ("jct", "cct"):
            for name, val in direct["result"][key].items():
                assert recs[0]["result"][key][name] == pytest.approx(
                    val, abs=TOL)

    def test_non_batchable_without_fallback_raises(self):
        """The name predates the port's own ``run_cell``: a cell the engine
        does not take now runs through it, with no fallback, and gives the
        reference's record."""
        cells = [Cell("pipe_serve", "varys", "big_switch", 0)]
        (rec,) = run_cells_batched(cells, quick=True, workers=1, device=CPU)
        assert _no_wall(rec) == _no_wall(run_cell(cells[0], quick=True))
