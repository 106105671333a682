"""Logical parallelism axes and activation-sharding helpers.

Port of ``repro.parallel.axes``.  Model code annotates activations with
*logical* axes (BATCH / TP / CP / EP); this module resolves them onto the
physical mesh in use:

  single-pod  (data=32, model=8)           BATCH -> ("data",)
  multi-pod   (pod=2, data=32, model=8)    BATCH -> ("pod", "data")

The JAX package constrains a traced array and leaves the collectives to
XLA.  The port works on ``torch.distributed.tensor.DTensor``s: ``shard``
redistributes a DTensor to the placements the logical axes resolve to, and
returns a plain tensor unchanged, so model code runs unmodified on one
device and off any mesh.

The other helpers mark where the models leave DTensor's own operator rules,
each a no-op on a plain tensor:

  * ``fsdp_gather``: a unit's weights, redistributed to ``Replicate`` on
    ``data``/``pod`` at its entry (ZeRO-3's all-gather; the backward of that
    redistribution is the reduce-scatter of their gradients);
  * ``lookup``: an embedding row lookup on a gathered table;
  * ``local``, ``like``, ``full``: computation on a rank's own rows (the MoE
    routing, dispatch and combine, which are local to a batch row).
"""

from __future__ import annotations

import contextlib
import contextvars
import sys

import torch

from repro_torch.launch.mesh import mesh_shape

# Logical activation axes.
BATCH = "__batch__"    # data parallel (pod x data)
TP = "__tp__"          # tensor parallel (model)
CP = "__cp__"          # context parallel over sequence (data, decode-only)
CPTP = "__cptp__"      # sequence over data x model (batch=1 long decode)
EP = "__ep__"          # expert parallel (model)

DP_AXES = ("pod", "data")    # what BATCH spans; FSDP gathers over them

_mesh_axes: contextvars.ContextVar[tuple[tuple[str, ...], dict] | None] = \
    contextvars.ContextVar("mesh_axes", default=None)


class PartitionSpec:
    """Per tensor dimension: ``None``, a mesh axis, or a tuple of axes
    (major first), as ``jax.sharding.PartitionSpec``, which also reads a
    one-axis tuple as that axis and an empty one as ``None``.  Not a tuple,
    so the port's tree walkers (``repro_torch.tree``) take one as a leaf;
    it compares equal to a spec or tuple of the same entries."""

    __slots__ = ("_entries",)

    def __init__(self, *entries):
        self._entries = tuple(
            (e[0] if len(e) == 1 else e or None) if isinstance(e, tuple)
            else e for e in entries)

    def __iter__(self):
        return iter(self._entries)

    def __len__(self) -> int:
        return len(self._entries)

    def __getitem__(self, i):
        return self._entries[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, PartitionSpec):
            other = other._entries
        return isinstance(other, tuple) and self._entries == other

    def __hash__(self) -> int:
        return hash(self._entries)

    def __repr__(self) -> str:
        return f"P{self._entries!r}"


P = PartitionSpec


def _names_sizes(mesh) -> tuple[tuple[str, ...], dict]:
    if isinstance(mesh, (tuple, list)):
        return tuple(mesh), {}
    shape = mesh_shape(mesh)
    return shape.axis_names, dict(zip(shape.axis_names, shape.axis_sizes))


@contextlib.contextmanager
def logical_mesh(mesh):
    """Declare the physical mesh for activation sharding: its axis names,
    or a mesh (a ``DeviceMesh`` or any object with ``axis_names`` and
    ``axis_sizes``), whose sizes ``batch_size_divisor`` then reads."""
    token = _mesh_axes.set(_names_sizes(mesh))
    try:
        yield
    finally:
        _mesh_axes.reset(token)


def mesh_axes() -> tuple[str, ...] | None:
    got = _mesh_axes.get()
    return None if got is None else got[0]


def _resolve(dim: str | None, axes) -> str | tuple[str, ...] | None:
    if axes is None or dim is None:
        return None
    if dim == BATCH:
        return tuple(a for a in axes if a in DP_AXES) or None
    if dim in (TP, EP):
        return "model" if "model" in axes else None
    if dim == CP:
        return "data" if "data" in axes else None
    if dim == CPTP:
        got = tuple(a for a in axes if a in ("data", "model"))
        return got or None
    return dim   # literal mesh axis name


def resolve(dim: str | None) -> str | tuple[str, ...] | None:
    return _resolve(dim, mesh_axes())


def spec(*dims: str | None) -> PartitionSpec:
    return P(*[resolve(d) for d in dims])


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor.  No DTensor exists before
    ``torch.distributed.tensor`` is imported, and importing it takes about
    a second, so a plain run never does."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def placements(spec: PartitionSpec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: each mesh dimension is
    ``Shard(d)`` for the tensor dimension ``d`` whose entry names it, else
    ``Replicate()``.  A tuple entry such as ``("pod", "data")`` shards one
    tensor dimension over both, the first axis major, as JAX orders it
    (DTensor splits a dimension over its mesh dimensions in mesh order)."""
    from torch.distributed.tensor import Replicate, Shard

    names = _names_sizes(mesh)[0]
    out = []
    for name in names:
        dims = [d for d, entry in enumerate(spec)
                if entry == name or (isinstance(entry, tuple)
                                     and name in entry)]
        if len(dims) > 1:
            raise ValueError(f"{spec}: mesh axis {name!r} shards two "
                             f"dimensions")
        out.append(Shard(dims[0]) if dims else Replicate())
    for entry in spec:
        if isinstance(entry, tuple) and [a for a in names if a in entry] \
                != [a for a in entry if a in names]:
            raise ValueError(f"{spec}: {entry} is not in the mesh's axis "
                             f"order {names}")
    return tuple(out)


def _redistribute(x, target: tuple):
    if tuple(x.placements) == tuple(target):
        return x
    return x.redistribute(x.device_mesh, target)


def shard(x: torch.Tensor, *dims: str | None) -> torch.Tensor:
    """Redistribute a DTensor to the placements of the logical ``dims``;
    a plain tensor is returned unchanged.

    Axes that do not divide the dimension are dropped (e.g. 8 KV heads on a
    16-way model axis), as the reference drops them.  The axes resolve
    against the active ``logical_mesh``, or the DTensor's own mesh where
    none is active (the recompute of a checkpointed unit runs in autograd's
    device thread, which does not see the caller's context)."""
    if not is_dtensor(x):
        return x
    mesh = x.device_mesh
    names = mesh_axes() or tuple(mesh.mesh_dim_names)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    resolved = []
    for d, size in zip([_resolve(d, names) for d in dims], x.shape):
        axes = (d,) if isinstance(d, str) else (d or ())
        n = 1
        for a in axes:
            n *= sizes.get(a, 0)
        resolved.append(d if axes and n and size % n == 0 else None)
    return _redistribute(x, placements(P(*resolved), mesh))


def heads(x: torch.Tensor, n: int) -> torch.Tensor:
    """x [..., n * hd] -> [..., n, hd].  A DTensor whose last dimension is
    split over mesh dimensions that do not divide ``n`` (28 heads on an
    8-way ``model`` axis) is replicated there first, as the reference drops
    such an axis; a plain tensor is reshaped."""
    shape = (*x.shape[:-1], n, x.shape[-1] // n)
    if not is_dtensor(x):
        return x.reshape(shape)
    from torch.distributed.tensor import Replicate

    mesh, last = x.device_mesh, x.ndim - 1
    split = 1
    for i, p in enumerate(x.placements):
        if p.is_shard(last):
            split *= mesh.size(i)
    if n % split:
        x = _redistribute(x, tuple(Replicate() if p.is_shard(last) else p
                                   for p in x.placements))
    return x.reshape(shape)


def batch_size_divisor() -> int:
    """How many ways BATCH is split on the active mesh (1 off-mesh, and 1
    for a mesh given by axis names alone)."""
    got = _mesh_axes.get()
    if not got:
        return 1
    axes, sizes = got
    n = 1
    for a in DP_AXES:
        if a in axes:
            n *= sizes.get(a, 1)
    return n


# ------------------------------------------------ leaving DTensor's rules

def fsdp_gather(tree):
    """Each DTensor leaf of ``tree`` (a dict of a unit's weights, or one
    tensor) redistributed to ``Replicate`` on the FSDP axes (``data``,
    ``pod``), its TP sharding kept; plain tensors unchanged."""
    from torch.distributed.tensor import Replicate

    from repro_torch.tree import tree_map

    def one(x):
        if not is_dtensor(x):
            return x
        names = x.device_mesh.mesh_dim_names
        return _redistribute(x, tuple(
            Replicate() if name in DP_AXES else p
            for name, p in zip(names, x.placements)))

    return tree_map(one, tree)


def lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``.  A DTensor table is gathered whole, and the
    lookup runs on each rank's own tokens (the same indexing as off a
    mesh); the rows come back placed as the tokens (replicated where they
    are a plain tensor, such as a greedy token made whole).  The local
    gradient of the table is a pending sum over the mesh dimensions that
    split the tokens, which the gather's backward reduce-scatters.  (A
    vocab-parallel lookup, which would not gather the table, is later
    work.)"""
    if not is_dtensor(table):
        return table[tokens]
    from torch.distributed.tensor import DTensor, Partial, Replicate

    if not is_dtensor(tokens):   # the same tokens on every rank
        tokens = like_replicated(tokens, table)

    grad = tuple(Partial() if p.is_shard() else Replicate()
                 for p in tokens.placements)
    whole = _redistribute(table, (Replicate(),) * table.device_mesh.ndim)
    rows = whole.to_local(grad_placements=grad)[local(tokens)]
    return DTensor.from_local(rows, tokens.device_mesh, tokens.placements,
                              run_check=False)


def local(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (differentiable: the gradient keeps the
    placements); a plain tensor unchanged."""
    return x.to_local() if is_dtensor(x) else x


def like(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """A local result ``t`` as a DTensor placed as ``ref`` (its rows are
    ``ref``'s rows), or ``t`` itself where ``ref`` is a plain tensor."""
    if not is_dtensor(ref):
        return t
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(t, ref.device_mesh, ref.placements,
                              run_check=False)


def like_replicated(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """A value ``t`` that every rank computed alike, as a DTensor
    replicated on ``ref``'s mesh."""
    from torch.distributed.tensor import DTensor, Replicate

    return DTensor.from_local(t, ref.device_mesh,
                              (Replicate(),) * ref.device_mesh.ndim,
                              run_check=False)


def full(x: torch.Tensor) -> torch.Tensor:
    """The whole value of a DTensor as a plain tensor on every rank
    (differentiable); a plain tensor unchanged."""
    return x.full_tensor() if is_dtensor(x) else x
