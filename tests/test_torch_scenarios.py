"""The port's copy of the scenario builder against the JAX package's.

``repro_torch.appdag.build_scenario`` with ``repro_torch.core`` (metaflow,
fabric, workload) is a copy of ``repro.appdag.build_scenario`` with
``repro.core``.  For every registered scenario, seeds 0-4, both sizes and
four topologies, the port's ``pack_instance`` on the port's scenario must
equal ``repro.core.simjax.pack_instance`` on the reference's scenario
(``lint=False``: the lint only checks jobs), exactly and field by field.
The port's packer also takes the reference's objects (duck typing).
"""

import dataclasses

import numpy as np
import pytest

from repro.appdag import mixer as rmixer
from repro.core import Fabric as RFabric
from repro.core import metaflow as rmetaflow
from repro.core import simjax
from repro.roofline import analysis as rroofline
from repro_torch.appdag import mixer, plans
from repro_torch.core import Fabric, metaflow, simtorch

SEEDS = range(5)
TOPOLOGIES = (None, "big_switch", "leaf_spine_3to1", "fat_tree")


def _assert_packs_equal(got: simtorch.PackedInstance,
                        want: simjax.PackedInstance, what: str) -> None:
    names = [f.name for f in dataclasses.fields(want)]
    assert [f.name for f in dataclasses.fields(got)] == names
    for name in names:
        a, b = getattr(got, name), getattr(want, name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, (what, name)
            assert np.array_equal(a, b), (what, name)
        else:
            assert type(a) is type(b) and a == b, (what, name)


def test_registry_matches_reference():
    assert list(mixer.SCENARIOS) == list(rmixer.SCENARIOS)
    assert mixer.SCENARIO_TOPOLOGY == rmixer.SCENARIO_TOPOLOGY
    assert mixer.FB_TEMPLATE_STREAM == rmixer.FB_TEMPLATE_STREAM


def test_constants_match_reference():
    assert metaflow.EPS == rmetaflow.EPS
    assert (plans.PEAK_FLOPS, plans.HBM_BW, plans.LINK_BW) == (
        rroofline.PEAK_FLOPS, rroofline.HBM_BW, rroofline.LINK_BW)


@pytest.mark.parametrize("quick", [True, False], ids=["quick", "full"])
@pytest.mark.parametrize("topology", TOPOLOGIES,
                         ids=lambda t: t or "registered")
@pytest.mark.parametrize("scenario", list(rmixer.SCENARIOS))
def test_packed_scenarios_match_reference(scenario, topology, quick):
    for seed in SEEDS:
        what = f"{scenario}/{topology}/seed{seed}/quick={quick}"
        rfab, rjobs = rmixer.build_scenario(scenario, seed=seed, quick=quick,
                                            topology=topology, lint=False)
        want = simjax.pack_instance(rfab, rjobs)
        fab, jobs = mixer.build_scenario(scenario, seed=seed, quick=quick,
                                         topology=topology)
        assert type(fab.topology).__name__ == type(rfab.topology).__name__
        _assert_packs_equal(simtorch.pack_instance(fab, jobs), want, what)
        _assert_packs_equal(simtorch.pack_instance(rfab, rjobs), want,
                            what + " (reference objects)")


@pytest.mark.parametrize("speed", [1.0, 2.5])
def test_figure1_packs_equal(speed):
    _assert_packs_equal(
        simtorch.pack_instance(Fabric(n_ports=3), metaflow.figure1_jobs(),
                               machine_speed=speed),
        simjax.pack_instance(RFabric(n_ports=3), rmetaflow.figure1_jobs(),
                             machine_speed=speed), "figure1")


def test_figure2_packs_equal():
    _assert_packs_equal(
        simtorch.pack_instance(Fabric(n_ports=6), [metaflow.figure2_job()]),
        simjax.pack_instance(RFabric(n_ports=6), [rmetaflow.figure2_job()]),
        "figure2")


def test_builder_rejects_what_the_reference_rejects():
    with pytest.raises(KeyError, match="unknown scenario"):
        mixer.build_scenario("nope")
    with pytest.raises(ValueError, match="unknown topology spec"):
        mixer.build_scenario("pipe_serve", topology="torus")
    job = metaflow.JobDAG("j")
    job.add_task("a", 1.0, deps=["b"])
    job.add_task("b", 1.0, deps=["a"])
    with pytest.raises(ValueError, match="cycle"):
        job.validate()
    with pytest.raises(ValueError, match="job names must be unique"):
        simtorch.pack_instance(Fabric(n_ports=2), [metaflow.JobDAG("x"),
                                                    metaflow.JobDAG("x")])
