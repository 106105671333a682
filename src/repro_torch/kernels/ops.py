"""Public kernel entry points: the hand-written kernel for CUDA tensors,
its plain PyTorch version for CPU tensors.

Port of ``repro.kernels.ops``.  The choice follows only the device of the
tensors: a CUDA tensor goes to the kernel, which launches or raises; a CPU
tensor goes to ``repro_torch.kernels.ref``.  Nothing falls back from one to
the other.

Gradients.  On the CPU, autograd differentiates the plain versions.  On the
card, ``flash_attention``, ``rmsnorm``, ``ssd_scan`` and
``fused_cross_entropy`` run under an ``autograd.Function`` whose forward is
the forward kernel and whose backward is a backward kernel, whenever an
input needs a gradient; without one (serving) the forward kernel runs
alone, as before.

DTensors (``parallel.sharding``'s layouts).  A kernel runs on each rank's
local shards, under the placements it can take there:

  flash attention   batch and heads may stay sharded (q, k and v alike)
  RMSNorm           every dimension but the normalised one
  SSD scan          batch and heads (then A and the state follow the heads)
  cross-entropy     rows; the vocabulary is gathered first

Any other placement of an operand (a sharded sequence or vocabulary, a
pending sum, q and k sharded differently) is redistributed explicitly to
``Replicate`` on that mesh dimension first, and the kernel still launches
on the local tensors; the outputs come back as DTensors.  An operand that
is replicated on a mesh dimension where another is sharded (RMSNorm's
scale, the SSD scan's A, B and C) takes its gradient as a pending sum
there.  Nothing falls back to the plain version on the card.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import adamw as _adamw
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import fused_ce as _ce
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as _rn
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch import spans as _spans
from repro_torch.parallel.axes import is_dtensor

#: Launch counter of each kernel: name -> (module, attribute).
KERNELS = {
    "flash_attention": (_fa, "launches"),
    "flash_attention_bwd": (_fa, "bwd_launches"),
    "rmsnorm": (_rn, "launches"),
    "rmsnorm_bwd": (_rn, "bwd_launches"),
    "ssd_scan": (_ssd, "launches"),
    "ssd_scan_bwd": (_ssd, "bwd_launches"),
    "fused_cross_entropy": (_ce, "launches"),
    "fused_cross_entropy_bwd": (_ce, "bwd_launches"),
    "adamw": (_adamw, "launches"),
}
#: The names ``launch_counts`` returns: the kernels', then the MoE counters
#: of ``repro_torch.spans`` (counted only while a profiler session is
#: active).
COUNTERS = (*KERNELS, *_spans.COUNTERS)


def _needs_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _placements_of(ts) -> list:
    """Per mesh dimension, the operands' placements; raises on a kind of
    placement the boundary does not know (a strided shard, a masked
    pending sum)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = ts[0].device_mesh
    for t in ts:
        if t.device_mesh != mesh:
            raise ValueError("kernel operands on different meshes")
        for p in t.placements:
            if type(p) not in (Shard, Replicate, Partial):
                raise ValueError(f"kernel operand placed as {p}: not taken")
    return [[t.placements[i] for t in ts] for i in range(mesh.ndim)]


def _local_call(fn, operands: list, targets: list, grads: list,
                outs: list):
    """``fn`` on the local shards of ``operands`` (DTensors or None), each
    first redistributed to its ``targets`` placements (explicitly; a no-op
    where they are its own), its gradient taken as ``grads``; the results
    returned as DTensors placed as ``outs``."""
    from torch.distributed.tensor import DTensor

    mesh = next(t for t in operands if t is not None).device_mesh
    local = []
    for t, pl, gpl in zip(operands, targets, grads):
        if t is None:
            local.append(None)
            continue
        if tuple(t.placements) != tuple(pl):
            t = t.redistribute(mesh, pl)
        local.append(t.to_local(grad_placements=gpl))
    got = fn(*local)
    single = not isinstance(got, tuple)
    got = (got,) if single else got
    wrapped = tuple(None if o is None else
                    DTensor.from_local(o, mesh, pl, run_check=False)
                    for o, pl in zip(got, outs))
    return wrapped[0] if single else wrapped


def _sharded(p, dims: tuple[int, ...], ndim: int) -> bool:
    return p.is_shard() and p.dim % ndim in dims


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        out, lse = _fa.flash_attention(q, k, v, causal=causal, window=window,
                                       return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()   # the kernel copies rows in 16-byte chunks
        dq, dk, dv = _fa.flash_attention_bwd(q, k, v, out, lse, dout,
                                             causal=ctx.causal,
                                             window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q [B,Sq,H,hd], k/v [B,Sk,KV,hd] (model layout) -> [B,Sq,H,hd].  On
    the card a gradient under the causal mask needs Sq == Sk (the backward
    kernel takes Sq != Sk only without it: cross-attention)."""
    if is_dtensor(q):
        return _flash_dtensor(q, k, v, causal, window)
    if q.device.type == "cpu":
        out = ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                      v.transpose(1, 2), causal=causal,
                                      window=window)
        return out.transpose(1, 2)
    if _needs_grad(q, k, v):
        if causal and q.shape[1] != k.shape[1]:
            raise ValueError(f"flash_attention: the backward kernel needs "
                             f"Sq == Sk under a causal mask, got "
                             f"{q.shape[1]} and {k.shape[1]}")
        return _FlashAttention.apply(q, k, v, causal, window)
    return _fa.flash_attention(q, k, v, causal=causal, window=window)


def _flash_dtensor(q, k, v, causal: bool, window: int):
    """Batch (dim 0) or heads (dim 2) stay sharded where q, k and v are
    sharded alike; any other mesh dimension is replicated first."""
    from torch.distributed.tensor import Replicate

    pl = tuple(ps[0] if len(set(ps)) == 1 and _sharded(ps[0], (0, 2), 4)
               else Replicate() for ps in _placements_of([q, k, v]))
    return _local_call(
        lambda a, b, c: flash_attention(a, b, c, causal=causal,
                                        window=window),
        [q, k, v], [pl] * 3, [pl] * 3, [pl])


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps: float):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _rn.rmsnorm(x, scale, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, dscale = _rn.rmsnorm_bwd(x, scale, dy, ctx.eps)
        return dx, dscale, None


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """x [..., D], scale [D] -> like x, normalized in fp32."""
    if is_dtensor(x):
        return _rmsnorm_dtensor(x, scale, eps)
    if x.device.type == "cpu":
        return ref.rmsnorm_ref(x, scale, eps)
    if _needs_grad(x, scale):
        return _RMSNorm.apply(x, scale, eps)
    return _rn.rmsnorm(x, scale, eps)


def _rmsnorm_dtensor(x, scale, eps: float):
    """Every dimension of x but the normalised one may stay sharded; the
    scale is replicated, its gradient a pending sum where x is sharded."""
    from torch.distributed.tensor import Partial, Replicate

    nd = x.ndim
    pl = tuple(ps[0] if _sharded(ps[0], tuple(range(nd - 1)), nd)
               else Replicate() for ps in _placements_of([x, scale]))
    rep = (Replicate(),) * len(pl)
    gscale = tuple(Partial() if p.is_shard() else Replicate() for p in pl)
    return _local_call(lambda a, b: rmsnorm(a, b, eps), [x, scale],
                       [pl, rep], [pl, gscale], [pl])


class _FusedCrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels):
        nll, lse = _ce.fused_cross_entropy(logits, labels)
        ctx.save_for_backward(logits, labels, lse)
        return nll

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        return _ce.fused_cross_entropy_bwd(logits, labels, lse, g), None


def fused_cross_entropy(logits: torch.Tensor,
                        labels: torch.Tensor) -> torch.Tensor:
    """logits [T, V] (any float dtype), labels [T] -> nll [T] fp32, labels
    clamped at 0 (callers mask negative labels)."""
    if is_dtensor(logits):
        return _ce_dtensor(logits, labels)
    if logits.device.type == "cpu":
        return ref.cross_entropy_ref(logits, labels)
    if _needs_grad(logits):
        return _FusedCrossEntropy.apply(logits, labels)
    return _ce.fused_cross_entropy(logits, labels)[0]


def _ce_dtensor(logits, labels):
    """Rows may stay sharded; the vocabulary is gathered first (what XLA
    does around a custom call it cannot partition)."""
    from torch.distributed.tensor import Replicate

    pl = tuple(ps[0] if _sharded(ps[0], (0,), 2) else Replicate()
               for ps in _placements_of([logits, labels]))
    return _local_call(fused_cross_entropy, [logits, labels], [pl, pl],
                       [pl, pl], [pl])


class _SSDScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, initial_state, chunk: int):
        y, final = _ssd.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk,
                                 initial_state=initial_state)
        ctx.save_for_backward(x, dt, A, Bm, Cm, initial_state)
        ctx.chunk = chunk
        # An unused output (the final state, in training) passes None.
        ctx.set_materialize_grads(False)
        return y, final

    @staticmethod
    def backward(ctx, dy, dfinal):
        x, dt, A, Bm, Cm, initial_state = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        grads = _ssd.ssd_scan_bwd(
            x, dt, A, Bm, Cm, dy, chunk=ctx.chunk,
            initial_state=initial_state,
            dfinal=None if dfinal is None else dfinal.contiguous())
        return *grads, None


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int,
             initial_state: torch.Tensor | None = None):
    """x [B,S,H,P], dt [B,S,H] fp32, A [H] fp32, Bm/Cm [B,S,N], optional
    fp32 initial state [B,H,P,N] -> (y like x, final state fp32)."""
    if is_dtensor(x):
        return _ssd_dtensor(x, dt, A, Bm, Cm, chunk, initial_state)
    if x.device.type == "cpu":
        return ref.ssd_scan_ref(x, dt, A, Bm, Cm, chunk, initial_state)
    inputs = (x, dt, A, Bm, Cm) + (() if initial_state is None
                                   else (initial_state,))
    if _needs_grad(*inputs):
        return _SSDScan.apply(x, dt, A, Bm, Cm, initial_state, chunk)
    return _ssd.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk,
                         initial_state=initial_state)


def _ssd_dtensor(x, dt, A, Bm, Cm, chunk: int, initial_state):
    """Batch or heads of x may stay sharded, and the other operands follow
    x: batch-sharded, every operand with a batch dimension is split alike
    (A replicated); head-sharded, dt, A and the states split by heads (B
    and C replicated).  Any other mesh dimension is replicated first."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    R, Pa = Replicate(), Partial()
    # Per operand (x, dt, A, Bm, Cm, initial state) and output (y, final):
    # its placement where x is split by batch, by heads, or neither.
    batch = ([Shard(0), Shard(0), R, Shard(0), Shard(0), Shard(0)],
             [Shard(0), Shard(0), Pa, Shard(0), Shard(0), Shard(0)],
             [Shard(0), Shard(0)])
    heads = ([Shard(2), Shard(2), Shard(0), R, R, Shard(1)],
             [Shard(2), Shard(2), Shard(0), Pa, Pa, Shard(1)],
             [Shard(2), Shard(1)])
    rep = ([R] * 6, [R] * 6, [R] * 2)
    rows = []
    for (p, *_) in _placements_of([x, dt, A, Bm, Cm]
                                  + ([initial_state] if initial_state
                                     is not None else [])):
        rows.append(batch if _sharded(p, (0,), 4) else
                    heads if _sharded(p, (2,), 4) else rep)

    def col(which: int, j: int) -> tuple:
        return tuple(r[which][j] for r in rows)

    return _local_call(
        lambda a, b, c, d, e, f: ssd_scan(a, b, c, d, e, chunk=chunk,
                                          initial_state=f),
        [x, dt, A, Bm, Cm, initial_state],
        [col(0, j) for j in range(6)], [col(1, j) for j in range(6)],
        [col(2, 0), col(2, 1)])


def launch_counts() -> dict[str, int]:
    """Every counter of ``COUNTERS`` since the last reset: each kernel's
    launches, and the MoE's kept pairs and buffer rows (reading the kept
    pairs waits for the device)."""
    return {**{name: getattr(mod, attr)
               for name, (mod, attr) in KERNELS.items()}, **_spans.counts()}


def reset_launch_counts() -> None:
    """Zero every counter of ``COUNTERS``."""
    for mod, attr in KERNELS.values():
        setattr(mod, attr, 0)
    _spans.reset_counts()
