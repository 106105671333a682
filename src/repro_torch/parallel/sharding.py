"""Parameter sharding rules: FSDP x TP over the production mesh.

Port of ``repro.parallel.sharding``.  Design, as in the reference:
  * FSDP (ZeRO-3) shards every matrix's *contraction-side* dimension over
    the ``data`` axis.  Where XLA inserts the per-layer all-gathers and
    gradient reduce-scatters, the port makes them explicit: each unit's
    weights are redistributed to ``Replicate`` on ``data`` at its entry
    (``axes.fsdp_gather``), and the backward of that redistribution is the
    reduce-scatter of their gradients.
  * TP shards head / hidden / vocab output dimensions over ``model``.
  * The ``pod`` axis is pure DP: parameters replicated across pods, batch
    and gradient all-reduce span it.
  * Optimizer moments mirror parameter specs.

Rules are name-suffix driven and right-aligned.  The JAX tree stacks each
unit's (and each encoder or decoder layer's) leaves over units; the port
keeps a list with one dict per unit, so a leaf of such a list takes the
reference's spec of the stacked leaf without its leading unit entry.

Specs are the port's ``PartitionSpec`` (``axes.P``): per tensor dimension
``None``, an axis, or a tuple of axes.  ``placements`` turns one into
DTensor placements on a mesh; ``distribute_state`` and ``init_params``
build a train state or parameters of DTensors from a seed without ever
holding the whole model on one card; ``distribute_params``,
``distribute_cache`` and ``distribute_batch`` lay out trees that exist
(on a device, or as fake tensors in a dry run).
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Any

import numpy as np
import torch

from repro_torch.launch.mesh import mesh_shape
from repro_torch.models.transformer import STACKED, assemble
from repro_torch.parallel.axes import DP_AXES, P, PartitionSpec, placements
from repro_torch.tree import leaves, leaves_with_path, unflatten

FSDP_AXIS = "data"
TP_AXIS = "model"

# (name match, spec for the trailing dims). Earlier rules win.
_RULES: list[tuple[tuple[str, ...], tuple[Any, ...]]] = [
    (("embed",), (TP_AXIS, FSDP_AXIS)),            # [V, D]
    (("lm_head",), (FSDP_AXIS, TP_AXIS)),          # [D, V]
    (("wq", "wk", "wv"), (FSDP_AXIS, TP_AXIS)),    # [D, H*hd]
    (("wo",), (TP_AXIS, FSDP_AXIS)),               # [H*hd, D]
    (("w_gate", "w_up"), (FSDP_AXIS, TP_AXIS)),    # [.., D, F]
    (("w_down",), (TP_AXIS, FSDP_AXIS)),           # [.., F, D]
    (("router",), (FSDP_AXIS, None)),              # [D, E]
    (("in_proj",), (FSDP_AXIS, None)),             # [D, ch] (mamba)
    (("out_proj",), (None, FSDP_AXIS)),            # [d_in, D] (mamba)
    (("bq", "bk", "bv"), (TP_AXIS,)),              # biases follow out dim
]

_REPLICATED = ("conv_w", "conv_b", "A_log", "D", "dt_bias", "norm_scale",
               "mixer_norm", "ffn_norm", "final_norm", "enc_norm",
               "attn_norm", "mlp_norm", "self_norm", "cross_norm")

_moe_ep: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "moe_ep_rules", default=False)

# Expert-parallel weight layout: experts over `model`, D over `data` (FSDP).
_EP_RULES: dict[str, tuple] = {
    "w_gate": (TP_AXIS, FSDP_AXIS, None),   # [E@model, D@data, F]
    "w_up": (TP_AXIS, FSDP_AXIS, None),
    "w_down": (TP_AXIS, None, FSDP_AXIS),   # [E@model, F, D@data]
}


@contextlib.contextmanager
def use_moe_ep(on: bool = True):
    """Context manager: switch MoE weight rules to expert-parallel."""
    tok = _moe_ep.set(on)
    try:
        yield
    finally:
        _moe_ep.reset(tok)


def _leaf_name(path: tuple) -> str:
    for entry in reversed(path):
        if isinstance(entry, str):
            return entry
    return ""


def _ndim(leaf) -> int:
    return getattr(leaf, "ndim", 0)


def _shape(leaf) -> tuple:
    return tuple(getattr(leaf, "shape", ()))


def spec_for(path: tuple, leaf) -> PartitionSpec:
    """The spec of the leaf at ``path`` (dict keys, list indices and
    named-tuple fields, as ``tree.leaves_with_path`` gives them)."""
    stacked = any(e in STACKED for e in path if isinstance(e, str))
    ndim = _ndim(leaf) + stacked
    name = _leaf_name(path)
    out = P()
    if name not in _REPLICATED:
        is_moe_leaf = "moe" in path
        if _moe_ep.get() and is_moe_leaf and name in _EP_RULES:
            tail = _EP_RULES[name]
            if ndim >= len(tail):
                out = P(*((None,) * (ndim - len(tail))), *tail)
        else:
            for names, tail in _RULES:
                if name in names:
                    if ndim >= len(tail):
                        out = P(*((None,) * (ndim - len(tail))), *tail)
                    break
    if stacked and len(out):
        out = P(*out[1:])
    return out


def _axis_size(mesh, axis) -> int:
    shape = mesh_shape(mesh)
    sizes = dict(zip(shape.axis_names, shape.axis_sizes))
    if isinstance(axis, tuple):
        n = 1
        for a in axis:
            n *= sizes.get(a, 1)
        return n
    return sizes.get(axis, 1)


def sanitize(spec: PartitionSpec, shape, mesh) -> PartitionSpec:
    """Drop axes whose mesh size does not divide the dim (e.g. vocab 51865
    on an 8-way model axis): that dim is replicated instead."""
    dims = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for d, axis in zip(shape, dims):
        if axis is None or d % _axis_size(mesh, axis):
            out.append(None)
        else:
            out.append(axis)
    return P(*out)


def _map_with_path(fn, tree):
    flat = leaves_with_path(tree)
    return unflatten(tree, [fn(path, leaf) for path, leaf in flat])


def param_specs(params, mesh=None) -> Any:
    """Tree of specs matching ``params`` (tensors or meta tensors)."""
    def one(path, leaf):
        s = spec_for(path, leaf)
        return sanitize(s, _shape(leaf), mesh) if mesh is not None else s
    return _map_with_path(one, params)


def serving_param_specs(params, mesh=None) -> Any:
    """Weight-stationary serving layout: weights sharded over ``model``
    only and replicated across ``data``, so decode steps gather no weights
    (training wants ZeRO-3; serving wants TP-resident weights)."""
    def one(path, leaf):
        s = spec_for(path, leaf)
        s = P(*[None if d == FSDP_AXIS else d for d in s])
        return sanitize(s, _shape(leaf), mesh) if mesh is not None else s
    return _map_with_path(one, params)


def state_specs(state, mesh=None) -> Any:
    """TrainState: params, m and v share specs; scalars replicated."""
    return param_specs(state, mesh)


def _dp_axes(mesh):
    return tuple(a for a in mesh_shape(mesh).axis_names
                 if a in DP_AXES) or None


def batch_specs(batch, mesh) -> Any:
    """Inputs: batch dim over (pod?, data); replicated if not divisible."""
    dp = _dp_axes(mesh)

    def one(path, x):
        return sanitize(P(dp, *([None] * (_ndim(x) - 1))), _shape(x), mesh)
    return _map_with_path(one, batch)


def cache_specs(cache, mesh, context_parallel: bool = False) -> Any:
    """Decode caches: batch over DP; with CP, the KV sequence axis over
    ``data`` x ``model`` instead (batch=1 long-context decode)."""
    dp = _dp_axes(mesh)
    names = mesh_shape(mesh).axis_names

    def one(path, x):
        name = _leaf_name(path)
        nd = _ndim(x)
        if name == "length" or nd < 2:
            return P()
        spec = [None] * nd
        if context_parallel and name in ("k", "v") and nd >= 3:
            # [..., B, C, KV, hd] -> sequence over data x model (batch=1)
            spec[-3] = tuple(a for a in names
                             if a in ("data", "model")) or None
            return sanitize(P(*spec), _shape(x), mesh)
        # Default: batch over DP + KV sequence over model (the KV cache is
        # the decode memory bottleneck).
        if name in ("k", "v") and nd >= 4:          # [..., B, C, KV, hd]
            spec[-4] = dp
            spec[-3] = "model"
        elif name == "ssm" and nd >= 4:             # [..., B, H, P, N]
            spec[-4] = dp
        elif name == "conv" and nd >= 3:            # [..., B, K-1, ch]
            spec[-3] = dp
        return sanitize(P(*spec), _shape(x), mesh)

    return _map_with_path(one, cache)


# ------------------------------------------------------------- DTensors

def _local_shard(full: torch.Tensor, mesh, pl: tuple) -> torch.Tensor:
    """This rank's block of ``full`` under placements ``pl``: each mesh
    dimension that shards a tensor dimension splits what the earlier ones
    left, as DTensor orders them.  A copy, so ``full`` can be freed."""
    local = full
    for i, p in enumerate(pl):
        if p.is_shard():
            n = mesh.size(i)
            local = local.chunk(n, dim=p.dim)[mesh.get_local_rank(i)]
    return local.clone(memory_format=torch.contiguous_format)


def _distributed(full: torch.Tensor, spec: PartitionSpec, mesh):
    """``full`` as a DTensor laid out by ``spec`` on ``mesh``: this rank's
    block, on its device."""
    from torch.distributed.tensor import DTensor

    pl = placements(spec, mesh)
    local = _local_shard(full, mesh, pl).to(local_device(mesh))
    return DTensor.from_local(local, mesh, pl, run_check=False,
                              shape=full.shape, stride=full.stride())


def _distribute_tree(tree, spec_tree, mesh):
    return unflatten(tree, [
        leaf if not isinstance(leaf, torch.Tensor)
        else _distributed(leaf, spec, mesh)
        for leaf, spec in zip(leaves(tree), leaves(spec_tree))])


def distribute_params(params, mesh, specs=param_specs):
    """A parameter tree as DTensors laid out by ``specs(params, mesh)``
    (``param_specs``, FSDP x TP as the reference's dry run lowers serving,
    or ``state_specs`` for a ``TrainState``), the MoE rules as
    ``use_moe_ep`` sets them."""
    return _distribute_tree(params, specs(params, mesh), mesh)


def distribute_cache(cache, mesh, context_parallel: bool = False):
    """A decode cache (``init_cache``'s, or ``launch.specs.decode_specs``')
    as DTensors laid out by ``cache_specs``; host ints (the lengths) stay
    as they are."""
    return _distribute_tree(cache, cache_specs(cache, mesh,
                                               context_parallel), mesh)


def sharding_rules(mesh):
    """The context a step on DTensors runs in: the logical mesh, and plain
    tensors (rotary tables, masks, zeros, a greedy token) read as
    replicated."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.parallel import axes as ax

    stack = contextlib.ExitStack()
    stack.enter_context(ax.logical_mesh(mesh))
    stack.enter_context(implicit_replication())
    return stack


def local_device(mesh) -> torch.device:
    """This rank's device on ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def distribute_batch(batch: dict, mesh) -> dict:
    """A global batch (numpy arrays or tensors, the same on every rank) as
    DTensors laid out by ``batch_specs``: each rank keeps its rows, on its
    device."""
    specs = batch_specs(batch, mesh)
    return {k: _distributed(torch.from_numpy(np.ascontiguousarray(v))
                            if isinstance(v, np.ndarray) else v, specs[k],
                            mesh)
            for k, v in batch.items()}


def init_params(model, seed: int, mesh):
    """``model.init(seed)`` as DTensors laid out by ``param_specs``, drawn
    a part at a time: each leaf whole on this rank's device from the seed's
    generator, in ``init_lm``'s (``init_encdec``'s) order
    (``Model.init_parts``), the rank keeping its block.  A rank holds one unit's or the embedding's
    full weights at a time, never the model's, and ``full_tensor()`` of
    every leaf equals the one-card init bit for bit.  The MoE weights take
    the expert-parallel rules where the config asks for them
    (``moe_ep``)."""
    def distributed(key: str, value):
        part = {key: [value] if key in STACKED else value}
        got = _distribute_tree(part, param_specs(part, mesh), mesh)[key]
        return key, got[0] if key in STACKED else got

    with use_moe_ep(model.cfg.moe_ep):
        return assemble(distributed(key, value)
                        for key, value in model.init_parts(seed))


def distribute_state(model, optimizer, seed: int, mesh):
    """A ``TrainState`` of DTensors: params, m and v laid out by
    ``state_specs`` on ``mesh``.

    The parameters come from ``init_params`` (a part at a time, never the
    whole model on one rank; ``full_tensor()`` of every leaf equals the
    one-card ``init_state`` bit for bit).  The moments are zeros with their
    parameter's placements."""
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.train.state import TrainState
    from repro_torch.tree import tree_map

    params = init_params(model, seed, mesh)

    def zeros(t):
        return tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32),
                        t)

    return TrainState(step=0, params=params,
                      opt=AdamWState(step=0, m=zeros(params),
                                     v=zeros(params)),
                      rng=seed + 1)


__all__ = ["FSDP_AXIS", "TP_AXIS", "P", "PartitionSpec", "batch_specs",
           "cache_specs", "distribute_batch", "distribute_cache",
           "distribute_params", "distribute_state",
           "init_params", "local_device", "param_specs", "placements",
           "sanitize", "serving_param_specs", "sharding_rules", "spec_for",
           "state_specs", "use_moe_ep"]
