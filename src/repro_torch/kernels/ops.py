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
"""

from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import fused_ce as _ce
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as _rn
from repro_torch.kernels import ssd_scan as _ssd

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
}


def _needs_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


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
    if x.device.type == "cpu":
        return ref.rmsnorm_ref(x, scale, eps)
    if _needs_grad(x, scale):
        return _RMSNorm.apply(x, scale, eps)
    return _rn.rmsnorm(x, scale, eps)


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
    if logits.device.type == "cpu":
        return ref.cross_entropy_ref(logits, labels)
    if _needs_grad(logits):
        return _FusedCrossEntropy.apply(logits, labels)
    return _ce.fused_cross_entropy(logits, labels)[0]


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
    if x.device.type == "cpu":
        return ref.ssd_scan_ref(x, dt, A, Bm, Cm, chunk, initial_state)
    inputs = (x, dt, A, Bm, Cm) + (() if initial_state is None
                                   else (initial_state,))
    if _needs_grad(*inputs):
        return _SSDScan.apply(x, dt, A, Bm, Cm, initial_state, chunk)
    return _ssd.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk,
                         initial_state=initial_state)


def launch_counts() -> dict[str, int]:
    """Kernel launches per kernel since the last reset."""
    return {name: getattr(mod, attr) for name, (mod, attr) in KERNELS.items()}


def reset_launch_counts() -> None:
    for mod, attr in KERNELS.values():
        setattr(mod, attr, 0)
