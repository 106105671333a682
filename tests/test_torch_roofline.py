"""The port's roofline terms against the reference's, and its counters by
hand.

``roofline.analysis`` keeps the reference's arithmetic (``RooflineTerms``,
``extrapolate``, ``model_flops_per_step``) on the H100's constants; given
the reference's TPU constants it must give the reference's terms exactly.
``CollectiveCounter`` replaces the reference's HLO parser: on a fake
(data=2, model=2) world (made and destroyed inside each test that needs
it), hand-built redistributions and explicit collectives count the operand
bytes worked out here, and a DTensor product counts its local FLOPs, the
same on a first and a second call (DTensor's cached sharding propagation
is not counted).  ``launch.dryrun.LiveBytes`` keeps the peak of live
storages, held to a hand count.
"""

import re

import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import shapes_for as jshapes_for
from repro.roofline import analysis as janalysis
from repro_torch.configs import ARCH_NAMES, get_config, shapes_for
from repro_torch.launch.dryrun import LiveBytes, fake_world
from repro_torch.roofline import analysis
from repro_torch.roofline.hw import H100, Chip

TPU = Chip(peak_flops=197e12, hbm_bw=819e9, link_bw=50e9)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_model_flops_per_step_is_the_references(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert list(shapes_for(cfg)) == list(jshapes_for(jcfg))
    for name, shape in shapes_for(cfg).items():
        assert analysis.model_flops_per_step(cfg, shape) == \
            janalysis.model_flops_per_step(jcfg, jshapes_for(jcfg)[name])


@pytest.mark.parametrize("case", [
    (2, 16.0, 4, 22.0, 10),          # tests/test_optim.py: f(U) = 10 + 3U
    (2, 5.0, 4, 3.0, 10),            # falling: clamped at 0
    (3, 7.5, 3, 9.0, 8),             # one depth: its value
    (2, 1.25e12, 4, 2.5e12, 126),
])
def test_extrapolate_is_the_references(case):
    assert analysis.extrapolate(*case) == janalysis.extrapolate(*case)
    if case[0] == 2 and case[1] == 16.0:
        assert analysis.extrapolate(*case) == pytest.approx(40.0)


@pytest.mark.parametrize("terms", [
    (3.2e18, 4.1e15, 7.7e13, 256),
    (1.0e15, 9.0e14, 1.0e10, 512),
    (5.0e12, 1.0e9, 2.0e13, 1),
])
def test_roofline_terms_under_the_tpu_constants_are_the_references(terms):
    got = analysis.RooflineTerms(*terms, chip=TPU)
    want = janalysis.RooflineTerms(*terms)
    assert got.as_dict() == want.as_dict()
    for name in ("compute_s", "memory_s", "collective_s", "dominant",
                 "bound_s"):
        assert getattr(got, name) == getattr(want, name), name


def test_roofline_terms_take_the_h100_by_default():
    t = analysis.RooflineTerms(989e12, 3.35e12, 450e9, 1)
    assert t.chip == H100
    assert t.compute_s == t.memory_s == t.collective_s == 1.0
    assert t.bound_s == 1.0
    assert analysis.total_collective_bytes({"all-gather": 3,
                                            "all-reduce": 4}) == 7


def _mesh():
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))


def test_collective_counter_counts_operand_bytes_by_hand():
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    with fake_world(4):
        mesh = _mesh()
        x = DTensor.from_local(torch.ones(3, 8), mesh, (Shard(0), Replicate()),
                               run_check=False)
        p = DTensor.from_local(torch.ones(5, 6), mesh,
                               (Replicate(), Partial()), run_check=False)
        c = analysis.CollectiveCounter()
        with c:
            x.redistribute(mesh, (Replicate(), Replicate()))   # 3*8*4 B
            p.redistribute(mesh, (Replicate(), Replicate()))   # 5*6*4 B
            p.redistribute(mesh, (Replicate(), Shard(1)))      # 5*6*4 B
            dist.all_reduce(torch.ones(7, dtype=torch.float64))  # 7*8 B
    assert c.collective == {"all-gather": 96, "all-reduce": 120 + 56,
                            "reduce-scatter": 120, "all-to-all": 0,
                            "collective-permute": 0}
    assert c.flops == 0


def test_collective_counter_counts_local_flops_once_per_call():
    """A DTensor product [6, 22] (rows over data) x [22, 14] (columns
    over model) runs [3, 22] x [22, 7] on each rank: 2 * 3 * 22 * 7 FLOPs,
    on the first call (when DTensor propagates the shapes on global-shaped
    fake tensors) and the second alike."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    with fake_world(4):
        mesh = _mesh()
        a = DTensor.from_local(torch.ones(3, 22), mesh,
                               (Shard(0), Replicate()), run_check=False)
        b = DTensor.from_local(torch.ones(22, 7), mesh,
                               (Replicate(), Shard(1)), run_check=False)
        counts = []
        for _ in range(2):
            c = analysis.CollectiveCounter()
            with c:
                out = a @ b
            counts.append((c.flops, dict(c.collective)))
    assert out.to_local().shape == (3, 7)
    assert counts[0] == counts[1]
    assert counts[0][0] == 2 * 3 * 22 * 7
    assert sum(counts[0][1].values()) == 0


def test_counter_outside_a_mesh_counts_plain_products():
    c = analysis.CollectiveCounter()
    with c:
        torch.ones(4, 5) @ torch.ones(5, 6)
        torch.einsum("bij,bjk->bik", torch.ones(2, 3, 4), torch.ones(2, 4, 5))
    assert c.flops == 2 * 4 * 5 * 6 + 2 * 2 * 3 * 4 * 5


def test_rank_ops_pins_a_propagation_method_this_torch_has():
    """``RankOps`` wraps a private method of DTensor's
    ``ShardingPropagator``; this torch must have one of the names it
    knows, and leaving the mode puts the original back."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    name = analysis.propagation_method(ShardingPropagator)
    assert name in analysis.PROPAGATION_METHODS
    orig = vars(ShardingPropagator)[name]
    with analysis.CollectiveCounter():
        assert vars(ShardingPropagator)[name] is not orig
    assert vars(ShardingPropagator)[name] is orig


def test_rank_ops_restores_the_method_when_entering_fails(monkeypatch):
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.utils._python_dispatch import TorchDispatchMode

    name = analysis.propagation_method(ShardingPropagator)
    orig = vars(ShardingPropagator)[name]

    def refuse(self):
        raise RuntimeError("planted")

    monkeypatch.setattr(TorchDispatchMode, "__enter__", refuse)
    with pytest.raises(RuntimeError, match="planted"):
        with analysis.CollectiveCounter():
            pass
    assert vars(ShardingPropagator)[name] is orig


def test_rank_ops_names_torch_where_no_method_is_known():
    class Bare:
        pass

    with pytest.raises(RuntimeError, match=re.escape(torch.__version__)):
        analysis.propagation_method(Bare)


def test_fake_process_group_is_the_private_modules():
    """The dry run's world comes from the private
    ``torch.testing._internal.distributed.fake_pg``; pin that it gives a
    ``fake`` backend of the asked size, and that leaving it destroys it."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    assert callable(FakeStore)
    with fake_world(256):
        assert dist.get_backend() == "fake"
        assert dist.get_world_size() == 256 and dist.get_rank() == 0
    assert not dist.is_initialized()


def test_live_bytes_peak_is_the_hand_count():
    """An argument of 4000 bytes; 8000 made; a view of them (no new
    storage) that outlives its base; 2000 made from the view; the view
    dropped (its 8000 freed); 4000 made: live bytes 4000 -> 12000 -> 14000
    -> 6000 -> 10000, peak 14000."""
    arg = torch.zeros(1000)
    live = LiveBytes((arg,))
    assert live.now == live.peak == 4000
    with live:
        a = torch.ones(2000)            # + 8000
        b = a[:500]                     # a view
        del a                           # b keeps a's storage alive
        c = b * 2                       # + 2000
        del b                           # - 8000
        d = torch.ones(1000)            # + 4000
    assert live.peak == 4000 + 8000 + 2000
    assert live.now == 4000 + 2000 + 4000
    del c, d
    assert live.now == 4000
    np.testing.assert_equal(arg.numpy(), 0)
