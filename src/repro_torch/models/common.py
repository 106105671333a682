"""Shared model utilities: initializers, norms, rotary embeddings, masks.

Port of ``repro.models.common``.  Layouts and dtypes follow the JAX module
so that the tests compare like with like.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ref import rmsnorm_ref


def cdtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _trunc_normal(shape: tuple[int, ...], generator: torch.Generator,
                  device) -> torch.Tensor:
    """Standard normal truncated to [-3, 3], drawn in fp32."""
    out = torch.empty(shape, dtype=torch.float32, device=device)
    return torch.nn.init.trunc_normal_(out, 0.0, 1.0, -3.0, 3.0,
                                       generator=generator)


def dense_init(generator: torch.Generator, in_dim: int,
               out_shape: tuple[int, ...], dtype, device) -> torch.Tensor:
    """Truncated-normal fan-in init (LLaMA-style 1/sqrt(fan_in)), [in, *out]."""
    w = _trunc_normal((in_dim,) + tuple(out_shape), generator, device)
    return w.mul_(1.0 / math.sqrt(in_dim)).to(dtype)


def embed_init(generator: torch.Generator, vocab: int, dim: int, dtype,
               device) -> torch.Tensor:
    return _trunc_normal((vocab, dim), generator, device).to(dtype)


#: RMSNorm in fp32 accumulation, ``rms_norm(x, scale, eps)``: the plain
#: version of the rmsnorm kernel, which the model reaches via ``ops.rmsnorm``.
rms_norm = rmsnorm_ref


def rotary_cos_sin(positions: torch.Tensor, head_dim: int, theta: float,
                   dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for the given absolute positions [..., S].

    Computed in fp32 and cast to the activation dtype before the multiply in
    ``apply_rotary``, exactly where the JAX module casts.
    """
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / (theta ** exps)
    angles = positions.float()[..., None] * freqs          # [..., S, half]
    return angles.cos().to(dtype), angles.sin().to(dtype)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor) -> torch.Tensor:
    """x: [B, S, H, hd]; cos/sin: [B, S, half] or [S, half]."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.ndim == 2:
        cos = cos[None, :, None, :]
        sin = sin[None, :, None, :]
    else:
        cos = cos[:, :, None, :]
        sin = sin[:, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def causal_mask(q_len: int, kv_len: int, q_offset: int,
                device=None) -> torch.Tensor:
    """[q_len, kv_len] bool: query i attends kv j iff j <= i + offset."""
    qi = torch.arange(q_len, device=device)[:, None] + q_offset
    kj = torch.arange(kv_len, device=device)[None, :]
    return kj <= qi


def sliding_mask(q_len: int, kv_len: int, q_offset: int, window: int,
                 device=None) -> torch.Tensor:
    qi = torch.arange(q_len, device=device)[:, None] + q_offset
    kj = torch.arange(kv_len, device=device)[None, :]
    return (kj <= qi) & (kj > qi - window)
