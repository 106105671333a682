"""Plain PyTorch versions of the port's kernels (the allclose ground truth).

Port of ``repro.kernels.ref`` for the kernels on the serving slice.  The ops
dispatch (``repro_torch.kernels.ops``) runs these for CPU tensors, and
``chip_smoke.py`` holds each kernel against them on the card.
"""

from __future__ import annotations

import math

import torch


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q [B,H,Sq,hd], k/v [B,KV,Sk,hd] (KV divides H) -> [B,H,Sq,hd]."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    kx = k.repeat_interleave(G, dim=1)
    vx = v.repeat_interleave(G, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kx.float()) * scale
    qi = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)  # right-aligned
    kj = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kj <= qi
    if window:
        mask &= kj > qi - window
    s = s.masked_fill(~mask, -math.inf)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p, vx)


def rmsnorm_ref(x, scale, eps: float = 1e-5):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)
