"""Roofline terms of a dry-run cell, on the H100's constants.

Port of ``repro.roofline.analysis``.  Per (arch x shape x mesh) cell:

  compute term    = flops / (chips * peak FLOP/s)
  memory term     = hbm_bytes / (chips * HBM bytes/s)
  collective term = collective_bytes / (chips * link bytes/s)

with the constants of ``roofline.hw`` (the H100 SXM data sheet), never the
reference's TPU v5e ones.

The reference reads FLOPs and bytes from XLA's ``cost_analysis()`` and
parses the collectives out of the compiled HLO text.  The port has no
compiled program: ``launch.dryrun`` runs a cell's real step eagerly (on
fake tensors, or on real ones), and ``CollectiveCounter``, a dispatch mode,
counts what one rank runs:

  * collective operand bytes by kind, under the reference's five names:
    the ``_c10d_functional`` ops that DTensor emits and the ``c10d`` ops of
    explicit ``torch.distributed`` calls; point-to-point sends count as
    ``collective-permute``;
  * FLOPs by the formulas of ``torch.utils.flop_counter`` (the table
    ``FlopCounterMode`` reads), which cover matrix products, convolutions
    and attention calls only.  XLA's ``cost_analysis`` counts element-wise
    work as well, so the two FLOP counts are not comparable.

``FlopCounterMode`` itself, like any dispatch mode, sees an operation on
DTensors once, at its global shapes.  The counter instead declines such
operations, so DTensor dispatches them to the local shards with the mode
still active, and counts those local operations and the collectives that
DTensor emits for them; it skips what DTensor's sharding propagation runs
on global-shaped fake tensors to learn an output's shape (cached, so run
once per signature: counting it would make two runs of one step differ).

Depth.  The reference compiles each cell at two reduced depths and
extrapolates, because XLA's cost analysis counts a scanned unit once.  The
port runs every unit eagerly, so its counts cover the full depth; it keeps
``extrapolate`` as a function, and the tests show that the counts are
exactly linear in depth.
"""

from __future__ import annotations

import contextlib
import contextvars
import sys
from dataclasses import dataclass

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.roofline.hw import H100, Chip

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# op name (namespace.name) -> (kind, index of the operand argument).
_COLLECTIVE_OPS = {
    "_c10d_functional.all_gather_into_tensor": ("all-gather", 0),
    "_c10d_functional.all_gather_into_tensor_coalesced": ("all-gather", 0),
    "_c10d_functional.all_reduce": ("all-reduce", 0),
    "_c10d_functional.all_reduce_": ("all-reduce", 0),
    "_c10d_functional.all_reduce_coalesced": ("all-reduce", 0),
    "_c10d_functional.all_reduce_coalesced_": ("all-reduce", 0),
    "_c10d_functional.reduce_scatter_tensor": ("reduce-scatter", 0),
    "_c10d_functional.reduce_scatter_tensor_coalesced": ("reduce-scatter",
                                                         0),
    "_c10d_functional.all_to_all_single": ("all-to-all", 0),
    "c10d.allgather_": ("all-gather", 1),
    "c10d._allgather_base_": ("all-gather", 1),
    "c10d.allgather_into_tensor_coalesced_": ("all-gather", 1),
    "c10d.allreduce_": ("all-reduce", 0),
    "c10d.allreduce_coalesced_": ("all-reduce", 0),
    "c10d.reduce_scatter_": ("reduce-scatter", 1),
    "c10d._reduce_scatter_base_": ("reduce-scatter", 1),
    "c10d.reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1),
    "c10d.alltoall_": ("all-to-all", 1),
    "c10d.alltoall_base_": ("all-to-all", 1),
    "c10d.send": ("collective-permute", 0),
}

_in_propagation: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "in_sharding_propagation", default=False)


def _bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_bytes(t) for t in x)
    return 0


def _dtensor_type():
    mod = sys.modules.get("torch.distributed.tensor")
    return None if mod is None else mod.DTensor


# DTensor's sharding propagation runs each operation on meta tensors to
# learn its output's shape; ``RankOps`` marks those runs so they are not
# counted.  The method's name differs between torch releases.
PROPAGATION_METHODS = ("_propagate_tensor_meta_non_cached",
                       "_propagate_tensor_meta")


def propagation_method(cls) -> str:
    """The name of ``cls``'s (DTensor's ``ShardingPropagator``'s) method
    that runs an operation on meta tensors."""
    for name in PROPAGATION_METHODS:
        if name in vars(cls):
            return name
    raise RuntimeError(
        f"torch {torch.__version__}: ShardingPropagator has none of "
        f"{PROPAGATION_METHODS}; RankOps cannot tell DTensor's shape "
        "propagation from the operations a rank runs")


class RankOps(TorchDispatchMode):
    """A dispatch mode that sees the operations one rank runs: the local
    operations and collectives of DTensor's dispatch, not the DTensor-level
    operation and not DTensor's sharding propagation, nor what runs under
    ``quiet()``.  Subclasses count in ``seen(func, args, kwargs, out)``.

    While the mode is active, DTensor's propagation method is wrapped on
    its class (so in every thread) to flag its own calls; the wrapper
    changes nothing else, and leaving the mode, or failing to enter it,
    puts the original back."""

    def __init__(self):
        super().__init__()
        self._quiet = 0
        self._undo = None

    @contextlib.contextmanager
    def quiet(self):
        """Operations run inside are not seen."""
        self._quiet += 1
        try:
            yield
        finally:
            self._quiet -= 1

    def __enter__(self):
        self._patch_propagation()
        try:
            return super().__enter__()
        except BaseException:
            self._unpatch_propagation()
            raise

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._unpatch_propagation()

    def _patch_propagation(self) -> None:
        self._undo = None
        if "torch.distributed.tensor" not in sys.modules:
            return
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        name = propagation_method(ShardingPropagator)
        orig = vars(ShardingPropagator)[name]

        def flagged(*args, **kwargs):
            token = _in_propagation.set(True)
            try:
                return orig(*args, **kwargs)
            finally:
                _in_propagation.reset(token)

        setattr(ShardingPropagator, name, flagged)
        self._undo = (ShardingPropagator, name, orig)

    def _unpatch_propagation(self) -> None:
        if self._undo is not None:
            cls, name, orig = self._undo
            setattr(cls, name, orig)
            self._undo = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        dtensor = _dtensor_type()
        if dtensor is not None and any(issubclass(t, dtensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if not self._quiet and not _in_propagation.get():
            self.seen(func, args, kwargs, out)
        return out

    def seen(self, func, args, kwargs, out) -> None:
        raise NotImplementedError


class CollectiveCounter(RankOps):
    """One rank's collective operand bytes by kind (``collective``, keyed
    by the reference's five names) and its FLOPs (``flops``, by
    ``torch.utils.flop_counter``'s formulas: products only)."""

    def __init__(self):
        super().__init__()
        self.collective = {k: 0 for k in COLLECTIVES}
        self.flops = 0

    def seen(self, func, args, kwargs, out) -> None:
        from torch.utils.flop_counter import flop_registry

        name = f"{func.namespace}.{func._opname}"
        if name in _COLLECTIVE_OPS:
            kind, i = _COLLECTIVE_OPS[name]
            self.collective[kind] += _bytes(args[i])
        formula = flop_registry.get(func.overloadpacket)
        if formula is not None:
            self.flops += int(formula(*args, **kwargs, out_val=out))


def total_collective_bytes(collective: dict[str, int]) -> int:
    return sum(collective.values())


@dataclass(frozen=True)
class RooflineTerms:
    flops: float                # global FLOPs for one step
    hbm_bytes: float            # global bytes moved to or from HBM
    coll_bytes: float           # global collective bytes (operand sums)
    chips: int
    chip: Chip = H100

    @property
    def compute_s(self) -> float:
        return self.flops / (self.chips * self.chip.peak_flops)

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / (self.chips * self.chip.hbm_bw)

    @property
    def collective_s(self) -> float:
        return self.coll_bytes / (self.chips * self.chip.link_bw)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def as_dict(self) -> dict:
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "coll_bytes": self.coll_bytes, "chips": self.chips,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
        }


def extrapolate(a_units: int, a_val: float, b_units: int, b_val: float,
                units: int) -> float:
    """Linear depth extrapolation from two reduced-depth counts."""
    if b_units == a_units:
        return b_val
    marg = (b_val - a_val) / (b_units - a_units)
    return max(a_val + (units - a_units) * marg, 0.0)


def model_flops_per_step(cfg, shape) -> float:
    """MODEL_FLOPS: 6 N D for training (N the active parameters: a MoE
    layer's experts at k of E), 2 N D for prefill, 2 N per sequence for
    decode (one token each)."""
    from repro_torch.configs.base import active_param_count

    n_active = active_param_count(cfg)
    tokens = shape.global_batch * shape.seq_len
    if shape.kind == "train":
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch
