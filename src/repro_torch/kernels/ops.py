"""Public kernel entry points: the hand-written kernel for CUDA tensors,
its plain PyTorch version for CPU tensors.

Port of ``repro.kernels.ops``.  The choice follows only the device of the
tensors: a CUDA tensor goes to the kernel, which launches or raises; a CPU
tensor goes to ``repro_torch.kernels.ref``.  Nothing falls back from one to
the other.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as _rn
from repro_torch.kernels import ssd_scan as _ssd

KERNELS = {"flash_attention": _fa, "rmsnorm": _rn, "ssd_scan": _ssd}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q [B,S,H,hd], k/v [B,S,KV,hd] (model layout) -> [B,S,H,hd]."""
    if q.device.type == "cpu":
        out = ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                      v.transpose(1, 2), causal=causal,
                                      window=window)
        return out.transpose(1, 2)
    return _fa.flash_attention(q, k, v, causal=causal, window=window)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """x [..., D], scale [D] -> like x, normalized in fp32."""
    if x.device.type == "cpu":
        return ref.rmsnorm_ref(x, scale, eps)
    return _rn.rmsnorm(x, scale, eps)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int,
             initial_state: torch.Tensor | None = None):
    """x [B,S,H,P], dt [B,S,H] fp32, A [H] fp32, Bm/Cm [B,S,N], optional
    fp32 initial state [B,H,P,N] -> (y like x, final state fp32)."""
    if x.device.type == "cpu":
        return ref.ssd_scan_ref(x, dt, A, Bm, Cm, chunk, initial_state)
    return _ssd.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk,
                         initial_state=initial_state)


def launch_counts() -> dict[str, int]:
    """Kernel launches per kernel since the last reset."""
    return {name: mod.launches for name, mod in KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in KERNELS.values():
        mod.launches = 0
