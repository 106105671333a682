"""The port's frozen simulator, MADD and FB workload against the reference.

``repro_torch.core.simref``, ``core.madd`` and ``core.workload``'s
``synth_fb_jobs`` and ``load_fb_trace`` are copies of the reference's
modules with the port's imports.  Each copy is held to its original on the
same inputs: the frozen core's JCT, CCT and realized service order equal
the reference's frozen core and the port's live ``Simulator`` exactly, on
the randomized 50-job batch of ``tests/test_sim_core_equiv.py`` (seed 11,
32 ports); MADD's rates equal the reference's and ``SchedView.madd``'s
vector and scalar paths; the synthesized jobs equal the reference's
field by field.  Numbers compare exactly unless a tolerance is stated.
"""

import inspect
import random

import numpy as np
import pytest

from repro.core import Fabric as RFabric
from repro.core import Perturbation as RPerturbation
from repro.core import ReferenceSimulator as RReferenceSimulator
from repro.core import make_scheduler as rmake
from repro.core import simulate_reference as rsimulate_reference
from repro.core.fabric import Residual as RResidual
from repro.core.madd import bottleneck_time as rbottleneck_time
from repro.core.madd import madd_rates as rmadd_rates
from repro.core.metaflow import Flow as RFlow
from repro.core import workload as rworkload
from repro_torch import core
from repro_torch.core import (Fabric, JobDAG, Perturbation,
                              ReferenceSimulator, Simulator,
                              UnsupportedTopologyError, leaf_spine,
                              make_scheduler, simulate, simulate_reference)
from repro_torch.core import workload
from repro_torch.core.fabric import Residual
from repro_torch.core.madd import bottleneck_time, madd_rates
from repro_torch.core.metaflow import Flow
from repro_torch.core.simulator import SchedView
from test_sim_core_equiv import _random_batch as _reference_batch

ALL_POLICIES = ("msa", "varys", "fifo", "fair", "cpath")
TOPOLOGIES = ("total_order", "partial_order", "disorder")


def _random_batch(side: str, n_jobs: int = 50, seed: int = 11,
                  n_ports: int = 32):
    """The randomized shared-fabric batch: the reference's from its
    equivalence test's builder, the port's from ``synth_shared_batch``."""
    if side == "reference":
        return _reference_batch(n_jobs=n_jobs, seed=seed, n_ports=n_ports)
    return n_ports, workload.synth_shared_batch(n_jobs, seed, n_ports)


def _assert_results_equal(got, want, what: str) -> None:
    assert got.jct == want.jct, what
    assert got.cct == want.cct, what
    assert got.mf_service_order == want.mf_service_order, what
    assert got.mf_finish == want.mf_finish, what
    assert got.events == want.events, what


# ------------------------------------------------------------- the frozen core

@pytest.mark.parametrize("pname", ALL_POLICIES)
def test_frozen_core_equals_reference_and_live_core(pname):
    n_ports, rjobs = _random_batch("reference")
    want = rsimulate_reference(rjobs, rmake(pname), n_ports=n_ports)
    _, jobs = _random_batch("port")
    got = simulate_reference(jobs, make_scheduler(pname), n_ports=n_ports)
    _assert_results_equal(got, want, f"{pname}: port's simref vs reference's")
    assert (got.sched_full, got.sched_refresh) == (want.sched_full,
                                                   want.sched_refresh)
    _, jobs = _random_batch("port")
    live = simulate(jobs, make_scheduler(pname), n_ports=n_ports)
    _assert_results_equal(live, got, f"{pname}: live core vs port's simref")


@pytest.mark.parametrize("pname", ("msa", "fair"))
def test_frozen_core_with_perturbations_equals_reference(pname):
    """A degrade then a restore (``factor=None``) of one port: the frozen
    core's perturbation path against the reference's and the live core."""
    def perts(cls):
        return [cls(time=40.0, port=3, factor=0.25),
                cls(time=120.0, port=3, factor=None)]

    n_ports, rjobs = _random_batch("reference", n_jobs=12, seed=5)
    want = RReferenceSimulator(RFabric(n_ports=n_ports), rjobs, rmake(pname),
                               perturbations=perts(RPerturbation)).run()
    _, jobs = _random_batch("port", n_jobs=12, seed=5)
    got = ReferenceSimulator(Fabric(n_ports=n_ports), jobs,
                             make_scheduler(pname),
                             perturbations=perts(Perturbation)).run()
    _assert_results_equal(got, want, pname)
    _, jobs = _random_batch("port", n_jobs=12, seed=5)
    live = Simulator(Fabric(n_ports=n_ports), jobs, make_scheduler(pname),
                     perturbations=perts(Perturbation)).run()
    assert (live.jct, live.cct, live.mf_service_order) == (
        got.jct, got.cct, got.mf_service_order)


def test_frozen_core_timeline_equals_reference():
    n_ports, rjobs = _random_batch("reference", n_jobs=6, seed=3)
    want = rsimulate_reference(rjobs, rmake("msa"), n_ports=n_ports,
                               record_timeline=True)
    _, jobs = _random_batch("port", n_jobs=6, seed=3)
    got = simulate_reference(jobs, make_scheduler("msa"), n_ports=n_ports,
                             record_timeline=True)
    assert got.timeline and got.timeline == want.timeline
    assert (got.makespan, got.task_finish) == (want.makespan,
                                               want.task_finish)


def test_routed_topology_is_refused_with_a_typed_error():
    assert issubclass(UnsupportedTopologyError, ValueError)
    _, jobs = _random_batch("port", n_jobs=2, seed=9)
    fab = Fabric(topology=leaf_spine(4, 8, oversubscription=3.0))
    with pytest.raises(UnsupportedTopologyError, match="big-switch"):
        ReferenceSimulator(fab, jobs, make_scheduler("msa"))
    with pytest.raises(ValueError, match="big-switch"):
        simulate_reference(jobs, make_scheduler("msa"), fabric=fab)


def test_frozen_core_keeps_the_residual_leak():
    """Two disjoint flows whose sizes differ by < EPS: the frozen core
    leaves the sub-EPS residue in its flow table, as the reference's
    does; the live core zeroes it."""
    def residue_job():
        j = JobDAG(name="j")
        j.add_metaflow("m", flows=[(0, 1, 1.0), (2, 3, 1.0 + 5e-10)])
        j.add_metaflow("m2", flows=[(0, 1, 1.0)], deps=["m"])
        j.add_task("c", load=1.0, deps=["m2"])
        return j

    old = ReferenceSimulator(Fabric(n_ports=4), [residue_job()],
                             make_scheduler("fair"))
    old.run()
    assert old._rem.max() > 0.0
    new = Simulator(Fabric(n_ports=4), [residue_job()],
                    make_scheduler("fair"))
    new.run()
    assert np.all(new._rem == 0.0)


@pytest.mark.parametrize("cls", ["port", "reference"])
def test_reference_simulator_constructor_claim(cls):
    """``tests/test_docs.py``'s pin, for the port's two signatures (and
    the reference's, side by side): the shared parameters in the same
    order, and every live-core-only parameter named in the docstring."""
    if cls == "port":
        sim_cls, ref_cls = Simulator, ReferenceSimulator
    else:
        from repro.core import Simulator as RSimulator
        sim_cls, ref_cls = RSimulator, RReferenceSimulator
    sim = list(inspect.signature(sim_cls.__init__).parameters)
    ref = list(inspect.signature(ref_cls.__init__).parameters)
    assert [p for p in sim if p in set(ref)] == ref
    doc = inspect.getdoc(ref_cls)
    extras = set(sim) - set(ref)
    assert extras == {"debug_checks", "faults", "retransmit", "tracer"}
    for extra in extras:
        assert f"``{extra}``" in doc, extra


def test_port_signatures_equal_the_reference():
    from repro.core import Simulator as RSimulator
    for port, ref in ((Simulator, RSimulator),
                      (ReferenceSimulator, RReferenceSimulator),
                      (simulate_reference, rsimulate_reference)):
        fn = port.__init__ if isinstance(port, type) else port
        rfn = ref.__init__ if isinstance(ref, type) else ref
        assert (list(inspect.signature(fn).parameters)
                == list(inspect.signature(rfn).parameters)), port


def test_core_exports_the_reference_names():
    import repro.core as rcore
    assert set(rcore.__all__) <= set(core.__all__)
    for name in core.__all__:
        assert hasattr(core, name), name


# ------------------------------------------------------------------- MADD

def _madd_case(n_flows: int):
    rng = random.Random(n_flows)
    n_ports = 10
    spec = [(rng.randrange(5), 5 + rng.randrange(5), rng.uniform(0.0, 4.0))
            for _ in range(n_flows)]
    eg = [rng.uniform(0.5, 2.0) for _ in range(n_ports)]
    ing = [rng.uniform(0.5, 2.0) for _ in range(n_ports)]
    return n_ports, spec, eg, ing


def _route(n_ports: int):
    return lambda s, d: (s, n_ports + d)


@pytest.mark.parametrize("n_flows", [3, 9, 40])
def test_madd_rates_equal_reference_both_residual_forms(n_flows):
    n_ports, spec, eg, ing = _madd_case(n_flows)
    rflows = [RFlow(src=s, dst=d, size=z) for s, d, z in spec]
    flows = [Flow(src=s, dst=d, size=z) for s, d, z in spec]
    rres = RResidual(eg=list(eg), ing=list(ing))
    want = rmadd_rates(rflows, rres)
    want = [want.get(f.id, 0.0) for f in rflows]
    assert any(r > 0 for r in want)
    for res in (Residual(eg=list(eg), ing=list(ing)),
                Residual(cap=eg + ing, route=_route(n_ports))):
        got = madd_rates(flows, res)
        assert [got.get(f.id, 0.0) for f in flows] == want
        assert res.cap == rres.cap         # the same grants deducted
    assert bottleneck_time(flows, Residual(eg=list(eg), ing=list(ing))) \
        == rbottleneck_time(rflows, RResidual(eg=list(eg), ing=list(ing)))


@pytest.mark.parametrize("n_flows", [3, 9, 40])
def test_madd_rates_equal_schedview_paths(n_flows):
    """``SchedView.madd``'s scalar path (a contiguous group of at most 16
    flows) and vector path (a strided index over a table with dead
    duplicates) against the object-level MADD, as the reference's
    ``TestMaddPaths`` holds them (1e-12)."""
    n_ports, spec, eg, ing = _madd_case(n_flows)
    flows = [Flow(src=s, dst=d, size=z) for s, d, z in spec]
    ref = madd_rates(flows, Residual(eg=list(eg), ing=list(ing)))
    src = np.array([f.src for f in flows], dtype=np.int32)
    dst = np.array([f.dst for f in flows], dtype=np.int32)
    rem = np.array([f.remaining for f in flows])
    view = SchedView(t=0.0, n_ports=n_ports, src=src, dst=dst, rem=rem,
                     egress=np.array(eg), ingress=np.array(ing),
                     active=[], jobs=[], mf_records={})
    rates = np.zeros(n_flows)
    view.madd(np.arange(n_flows), np.concatenate([eg, ing]), rates)
    wide = np.zeros(2 * n_flows)
    view2 = SchedView(t=0.0, n_ports=n_ports, src=np.repeat(src, 2),
                      dst=np.repeat(dst, 2), rem=np.repeat(rem, 2),
                      egress=np.array(eg), ingress=np.array(ing),
                      active=[], jobs=[], mf_records={})
    view2.rem[1::2] = 0.0
    view2.madd(np.arange(0, 2 * n_flows, 2), np.concatenate([eg, ing]), wide)
    for k, f in enumerate(flows):
        assert rates[k] == pytest.approx(ref.get(f.id, 0.0), abs=1e-12)
        assert wide[2 * k] == pytest.approx(ref.get(f.id, 0.0), abs=1e-12)


def test_madd_refuses_a_saturated_link():
    flows = [Flow(src=0, dst=1, size=1.0)]
    assert madd_rates(flows, Residual(eg=[0.0, 1.0], ing=[1.0, 1.0])) == {}
    assert madd_rates([], Residual(eg=[1.0], ing=[1.0])) == {}


# ---------------------------------------------------------------- workload

def _job_fields(job) -> tuple:
    """Every field a simulation reads: metaflows (flows and deps), tasks
    (load, machine, deps), in insertion order, and the arrival."""
    mfs = [(name, [(f.src, f.dst, f.size, f.remaining) for f in mf.flows],
            list(mf.deps))
           for name, mf in job.metaflows.items()]
    tasks = [(name, t.load, t.machine, list(t.deps))
             for name, t in job.tasks.items()]
    return job.name, job.arrival, mfs, tasks


@pytest.mark.parametrize("topology", TOPOLOGIES)
@pytest.mark.parametrize("seed", [0, 7, 42])
def test_synth_fb_jobs_equal_reference(topology, seed):
    want = [_job_fields(j) for j in rworkload.synth_fb_jobs(12, topology,
                                                            seed=seed)]
    got = [_job_fields(j) for j in workload.synth_fb_jobs(12, topology,
                                                          seed=seed)]
    assert got == want


@pytest.mark.parametrize("n_jobs,seed,n_ports", [(50, 11, 32), (12, 5, 32),
                                                  (20, 3, 48)])
def test_synth_shared_batch_equals_the_equivalence_batch(n_jobs, seed,
                                                         n_ports):
    _, want = _reference_batch(n_jobs=n_jobs, seed=seed, n_ports=n_ports)
    got = workload.synth_shared_batch(n_jobs, seed, n_ports)
    assert len(got) == n_jobs
    assert [_job_fields(j) for j in got] == [_job_fields(j) for j in want]


@pytest.mark.parametrize("kw", [
    {"compute_ratio": 0.5, "compute_mode": "proportional"},
    {"min_reducers": 1},
    {"coflows": [(2, 3, [[1.0, 2.0, 0.0], [0.5, 4.0, 3.0]]),
                 (1, 2, [[6.0, 1.5]])]},
])
def test_synth_fb_jobs_options_equal_reference(kw):
    for topology in TOPOLOGIES:
        want = rworkload.synth_fb_jobs(7, topology, seed=3, **kw)
        got = workload.synth_fb_jobs(7, topology, seed=3, **kw)
        assert [_job_fields(j) for j in got] == [_job_fields(j) for j in want]


# Sum of avg JCT / avg CCT over synth_fb_jobs(12, topo, seed=7) for all
# three topologies, single-job simulations: ``tests/test_sched_api.py``'s
# SEED_FB, pinned from the reference's seed simulator.
SEED_FB = {
    "msa":   (45614.06362336948, 28580.76573343463),
    "varys": (48643.064157036024, 28346.528183672315),
    "fifo":  (48643.064157036024, 28346.528183672315),
    "fair":  (46620.4053644527, 28631.952264396892),
}


@pytest.mark.parametrize("pname", list(SEED_FB))
def test_synth_fb_jobs_reproduce_the_pinned_sums(pname):
    sum_jct = sum_cct = 0.0
    for topology in TOPOLOGIES:
        for j in workload.synth_fb_jobs(12, topology, seed=7):
            r = simulate([j], make_scheduler(pname))
            sum_jct += r.avg_jct
            sum_cct += r.avg_cct
    assert (sum_jct, sum_cct) == SEED_FB[pname]


FIXTURE = """\
150 3
1 0 2 10 20 2 5:6.0 6:2.0
2 100 1 3 3 7:1.5 8:4.5 9:3.0
3 250 4 1 2 3 4 1 5:8.0

"""


@pytest.mark.parametrize("limit", [None, 1, 2, 3, 5])
def test_load_fb_trace_equals_reference(tmp_path, limit):
    path = tmp_path / "FB-fixture.txt"
    path.write_text(FIXTURE)
    got = workload.load_fb_trace(str(path), limit=limit)
    assert got == rworkload.load_fb_trace(str(path), limit=limit)
    assert len(got) == min(limit or 3, 3)
    assert got[0] == (2, 2, [[3.0, 1.0], [3.0, 1.0]])


def test_traced_coflows_build_equal_jobs(tmp_path):
    path = tmp_path / "FB-fixture.txt"
    path.write_text(FIXTURE)
    coflows = workload.load_fb_trace(str(path))
    rcoflows = rworkload.load_fb_trace(str(path))
    for topology in TOPOLOGIES:
        got = workload.synth_fb_jobs(5, topology, seed=1, coflows=coflows)
        want = rworkload.synth_fb_jobs(5, topology, seed=1, coflows=rcoflows)
        assert [_job_fields(j) for j in got] == [_job_fields(j) for j in want]
