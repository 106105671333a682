"""The port's mesh shapes, spec functions and zero-allocation specs against
the JAX package's, for every architecture at full size.

The reference side is ``jax.eval_shape`` of each model's init (and of its
state, caches and prefill): no allocation.  The port's side is the same
trees as meta tensors (``launch.specs``).  The JAX tree stacks a unit's
leaves over units ([U, ...]) where the port keeps a list of per-unit dicts,
so a port leaf under ``units`` (``enc_layers``, ``dec_layers``) is held to
the reference's spec without its leading entry, and a cache leaf to the
reference's without its leading (unit, sub-layer) entries.

Meshes: the reference's (16, 16) and (2, 16, 16) pod shapes, a (4, 2)
test shape, and the port's own production shape (32, 8), each as a
``FakeMesh`` with ``axis_names``/``axis_sizes``, with the MoE
expert-parallel rules off and on, and the caches with and without context
parallelism.
"""

import functools

import jax
import numpy as np
import pytest

from repro.configs import ARCH_NAMES as REF_ARCH_NAMES
from repro.configs import get_config as ref_config
from repro.configs import shapes_for as ref_shapes_for
from repro.launch import specs as ref_specs
from repro.models import get_model as ref_model
from repro.optim.adamw import AdamW as RefAdamW
from repro.parallel import sharding as ref_sharding
from repro.train.state import state_struct as ref_state_struct
from repro_torch.configs import ARCH_NAMES, get_config, shapes_for
from repro_torch.launch import mesh as port_mesh
from repro_torch.launch import specs
from repro_torch.parallel import axes as ax
from repro_torch.parallel import sharding
from repro_torch.tree import leaves_with_path


class FakeMesh:
    """What the spec functions read of a mesh."""

    def __init__(self, names, sizes):
        self.axis_names = tuple(names)
        self.axis_sizes = tuple(sizes)

    def __repr__(self):
        return f"FakeMesh{dict(zip(self.axis_names, self.axis_sizes))}"


MESHES = {
    "16x16": FakeMesh(("data", "model"), (16, 16)),
    "2x16x16": FakeMesh(("pod", "data", "model"), (2, 16, 16)),
    "4x2": FakeMesh(("data", "model"), (4, 2)),
    "32x8": FakeMesh(port_mesh.SINGLE_POD_AXES, port_mesh.SINGLE_POD_SHAPE),
}
STACKED = set(sharding.STACKED)


def _key(entry):
    for attr in ("key", "name", "idx"):
        if hasattr(entry, attr):
            return getattr(entry, attr)
    return entry


def _ref_flat(tree) -> dict:
    """JAX leaves by path (dict keys, field names, indices)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: x is None)
    return {tuple(_key(e) for e in path): leaf for path, leaf in flat
            if leaf is not None}


def _port_key(path: tuple) -> tuple:
    """A port path as the reference's: the list index after a stacked
    subtree dropped."""
    out, skip = [], False
    for e in path:
        if skip:
            skip = False
            continue
        out.append(e)
        skip = e in STACKED
    return tuple(out)


def _cache_key(path: tuple) -> tuple:
    """A port cache path as the reference's: the unit index and each
    sub-layer or layer index dropped (the reference stacks over both)."""
    path = path[1:] if isinstance(path[0], int) else path
    out, skip = [], False
    for e in path:
        if skip:
            skip = False
            continue
        out.append(e)
        skip = e in ("kv", "ssm", "cross")
    return tuple(out)


def _spec(s) -> tuple:
    return tuple(s)


@functools.lru_cache(maxsize=None)
def _port_params(arch: str):
    return specs.params_struct(get_config(arch))


@functools.lru_cache(maxsize=None)
def _port_state(arch: str):
    return specs.state_struct(get_config(arch))


@functools.lru_cache(maxsize=None)
def _ref_params(arch: str):
    return jax.eval_shape(ref_model(ref_config(arch)).init,
                          jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _ref_state(arch: str):
    return ref_state_struct(ref_model(ref_config(arch)), RefAdamW())


def _check_tree(port_specs, ref_specs_tree, port_tree, lead: int = 1,
                key=_port_key):
    """Every tensor leaf of the port's spec tree equal to the reference's
    spec of the same leaf (without ``lead`` leading entries where the
    reference stacks it; every cache leaf is stacked)."""
    ref = _ref_flat(ref_specs_tree)
    shapes = dict(leaves_with_path(port_tree))
    n = 0
    for path, spec in leaves_with_path(port_specs):
        if not hasattr(shapes[path], "shape"):
            assert _spec(spec) == (), path      # host ints: replicated
            continue
        want = ref[key(path)]
        stacked = key is _cache_key or any(
            e in STACKED for e in path if isinstance(e, str))
        if stacked and len(want):
            want = tuple(want)[lead:]
        assert _spec(spec) == tuple(want), (path, spec, want)
        n += 1
    assert n == sum(1 for p, x in leaves_with_path(port_tree)
                    if hasattr(x, "shape"))
    return n


def test_archs_are_the_references():
    assert ARCH_NAMES == REF_ARCH_NAMES


def test_production_mesh_shapes():
    assert port_mesh.production_shape() == port_mesh.MeshShape(
        ("data", "model"), (32, 8))
    assert port_mesh.production_shape(multi_pod=True) == port_mesh.MeshShape(
        ("pod", "data", "model"), (2, 32, 8))
    # the reference's chip counts: 256 and 512
    assert port_mesh.mesh_device_count(port_mesh.production_shape()) == 256
    assert port_mesh.mesh_device_count(
        port_mesh.production_shape(multi_pod=True)) == 512
    assert port_mesh.mesh_device_count(MESHES["2x16x16"]) == 512


@pytest.mark.parametrize("ep", [False, True], ids=["tp", "ep"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_and_state_specs_equal_the_reference(arch, mesh, ep):
    m = MESHES[mesh]
    port_params, port_state = _port_params(arch), _port_state(arch)
    with sharding.use_moe_ep(ep), ref_sharding.use_moe_ep(ep):
        _check_tree(sharding.param_specs(port_params),
                    ref_sharding.param_specs(_ref_params(arch)), port_params)
        _check_tree(sharding.param_specs(port_params, m),
                    ref_sharding.param_specs(_ref_params(arch), m),
                    port_params)
        _check_tree(sharding.serving_param_specs(port_params, m),
                    ref_sharding.serving_param_specs(_ref_params(arch), m),
                    port_params)
        n = _check_tree(sharding.state_specs(port_state, m),
                        ref_sharding.state_specs(_ref_state(arch), m),
                        port_state)
    assert n == 3 * len([x for _, x in leaves_with_path(port_params)])


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_cache_and_batch_specs_equal_the_reference(arch, mesh):
    m = MESHES[mesh]
    cfg, rcfg = get_config(arch), ref_config(arch)
    for name, shape in shapes_for(cfg).items():
        rshape = ref_shapes_for(rcfg)[name]
        if shape.kind == "decode":
            token, cache = specs.decode_specs(cfg, shape)
            rtoken, rcache = ref_specs.decode_specs(rcfg, rshape,
                                                    ref_model(rcfg))
            lead = 1 if cfg.family == "encdec" else 2
            for cp in (False, True):
                _check_tree(sharding.cache_specs(cache, m, cp),
                            ref_sharding.cache_specs(rcache, m, cp), cache,
                            lead=lead, key=_cache_key)
            batch, rbatch = {"token": token}, {"token": rtoken}
        elif shape.kind == "prefill":
            batch = specs.prefill_specs(cfg, shape)
            rbatch = ref_specs.prefill_specs(rcfg, rshape)
        else:
            batch = specs.train_specs(cfg, shape)
            rbatch = ref_specs.train_specs(rcfg, rshape)
        got = sharding.batch_specs(batch, m)
        want = ref_sharding.batch_specs(rbatch, m)
        assert {k: _spec(v) for k, v in got.items()} == \
            {k: _spec(v) for k, v in want.items()}, (name, got, want)


def _same_struct(port, ref, lead: int, key=_port_key):
    """Port meta tensors and reference ShapeDtypeStructs: equal shapes
    (the reference's stacked leaves without ``lead`` entries) and dtypes."""
    ref_flat = _ref_flat(ref)
    n = 0
    for path, x in leaves_with_path(port):
        if not hasattr(x, "shape"):
            continue
        want = ref_flat[key(path)]
        stacked = key is _cache_key or any(
            e in STACKED for e in path if isinstance(e, str))
        shape = tuple(want.shape)[lead if stacked else 0:]
        assert tuple(x.shape) == shape, (path, x.shape, want.shape)
        assert str(x.dtype).split(".")[-1] == str(np.dtype(want.dtype)), \
            (path, x.dtype, want.dtype)
        assert x.device.type == "meta"
        n += 1
    return n


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_input_specs_equal_the_reference(arch):
    cfg, rcfg = get_config(arch), ref_config(arch)
    for name, shape in shapes_for(cfg).items():
        rshape = ref_shapes_for(rcfg)[name]
        got = {"train": specs.train_specs, "prefill": specs.prefill_specs}
        if shape.kind in got:
            port = got[shape.kind](cfg, shape)
            ref = {"train": ref_specs.train_specs,
                   "prefill": ref_specs.prefill_specs}[shape.kind](rcfg,
                                                                    rshape)
            assert sorted(port) == sorted(ref)
            assert _same_struct(port, ref, 0) == len(ref)
            continue
        token, cache = specs.decode_specs(cfg, shape)
        rtoken, rcache = ref_specs.decode_specs(rcfg, rshape,
                                                ref_model(rcfg))
        assert _same_struct({"t": token}, {"t": rtoken}, 0) == 1
        lead = 1 if cfg.family == "encdec" else 2
        assert _same_struct(cache, rcache, lead, _cache_key) > 0


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_struct_equals_the_reference(arch):
    port = specs.params_struct(get_config(arch))
    assert _same_struct(port, _ref_params(arch), 1) > 0
    assert {_port_key(p) for p, _ in leaves_with_path(port)} == \
        set(_ref_flat(_ref_params(arch)))


def test_sanitize_on_the_references_cases():
    P = ax.P
    mesh = FakeMesh(("data", "model"), (2, 2))
    assert sharding.sanitize(P("model", "data"), (51865, 512), mesh) == \
        P(None, "data")
    assert sharding.sanitize(P(("data",), None), (1, 5), mesh) == P(None, None)

    class K:
        def __init__(self, key):
            self.key = key

    class FakeLeaf:
        def __init__(self, ndim):
            self.ndim = ndim
            self.shape = (16,) * ndim

    # The reference's right-alignment cases (test_optim.py): a stacked
    # unit leaf loses its unit entry in the port's per-unit tree.
    assert sharding.spec_for(("units", 0, "sub0", "attn", "wq"),
                             FakeLeaf(2)) == P("data", "model")
    assert sharding.spec_for(("moe", "w_down"), FakeLeaf(3)) == \
        P(None, "model", "data")
    assert sharding.spec_for(("embed",), FakeLeaf(2)) == P("model", "data")
    assert sharding.spec_for(("mixer_norm",), FakeLeaf(1)) == P()


def test_placements():
    from torch.distributed.tensor import Replicate, Shard

    P = ax.P
    mesh = FakeMesh(("pod", "data", "model"), (2, 2, 2))
    assert ax.placements(P(("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert ax.placements(P(None, "data"), mesh) == (
        Replicate(), Shard(1), Replicate())
    assert ax.placements(P(), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError):
        ax.placements(P(("data", "pod")), mesh)


def test_logical_axes_resolve_as_the_reference():
    from repro.parallel import axes as ref_ax

    for names, sizes in (("data", "model"), (16, 16)), \
            (("pod", "data", "model"), (2, 16, 16)):
        m = FakeMesh(names, sizes)
        with ax.logical_mesh(m), ref_ax.logical_mesh(names):
            for dim in (ax.BATCH, ax.TP, ax.CP, ax.CPTP, ax.EP, None,
                        "model"):
                rdim = {ax.BATCH: ref_ax.BATCH, ax.TP: ref_ax.TP,
                        ax.CP: ref_ax.CP, ax.CPTP: ref_ax.CPTP,
                        ax.EP: ref_ax.EP}.get(dim, dim)
                assert ax.resolve(dim) == ref_ax.resolve(rdim)
            assert tuple(ax.spec(ax.BATCH, None, ax.TP)) == tuple(
                ref_ax.spec(ref_ax.BATCH, None, ref_ax.TP))
            assert ax.mesh_axes() == names
            assert ax.batch_size_divisor() == int(np.prod(sizes[:-1]))
    assert ax.mesh_axes() is None and ax.batch_size_divisor() == 1


def test_off_mesh_helpers_are_no_ops():
    import torch

    x = torch.arange(6.0).reshape(2, 3)
    assert ax.shard(x, ax.BATCH, ax.TP) is x
    with ax.logical_mesh(("data", "model")):
        assert ax.shard(x, ax.BATCH, ax.TP) is x
    assert ax.fsdp_gather(x) is x
    tree = {"a": x, "b": [x]}
    assert ax.fsdp_gather(tree)["b"][0] is x
    assert ax.local(x) is x and ax.like(x, x) is x and ax.full(x) is x
    assert torch.equal(ax.lookup(x, torch.tensor([1, 0, 1])), x[[1, 0, 1]])
