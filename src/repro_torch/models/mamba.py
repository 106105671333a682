"""Mamba-2 (SSD, state-space duality) mixer block, serving path.

Port of ``repro.models.mamba``.  The full-sequence pass (``mamba_forward``)
runs its chunked SSD scan through ``ops.ssd_scan`` (the CUDA kernel on the
card, the model's chunked plain scan on the CPU) and its gated norm through
``ops.rmsnorm``.  Decode keeps an O(1) recurrent state (conv tail + SSM
state) and steps it in plain torch, as the JAX package does outside any
Pallas kernel; only its gated norm is a kernel.  Under a profiler both run
in an ``rt.mamba`` span (``repro_torch.spans``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.common import dense_init
from repro_torch.parallel import axes as ax
from repro_torch.spans import span

#: Leaves the JAX init keeps in float32 whatever the model's dtype.
FP32_PARAMS = ("A_log", "D", "dt_bias")


class MambaState(NamedTuple):
    conv: torch.Tensor   # [B, K-1, conv_ch]: last K-1 pre-conv inputs
    ssm: torch.Tensor    # [B, H, P, N] fp32: recurrent state
    length: int          # tokens seen so far, kept on the host


def conv_channels(cfg: ModelConfig) -> int:
    return cfg.d_inner + 2 * cfg.ssm_state


def init_mamba(generator: torch.Generator, cfg: ModelConfig, dtype,
               device) -> dict:
    D, d_in, N = cfg.d_model, cfg.d_inner, cfg.ssm_state
    H, K, ch = cfg.ssm_heads, cfg.ssm_conv, conv_channels(cfg)
    # in_proj -> [z (d_in) | x (d_in) | B (N) | C (N) | dt (H)]
    return {
        "in_proj": dense_init(generator, D, (2 * d_in + 2 * N + H,), dtype,
                              device),
        "conv_w": dense_init(generator, K, (ch,), dtype, device),
        "conv_b": torch.zeros((ch,), dtype=dtype, device=device),
        "A_log": torch.linspace(1.0, 16.0, H, device=device).log(),
        "D": torch.ones((H,), dtype=torch.float32, device=device),
        "dt_bias": torch.zeros((H,), dtype=torch.float32, device=device),
        "norm_scale": torch.ones((d_in,), dtype=dtype, device=device),
        "out_proj": dense_init(generator, d_in, (D,), dtype, device),
    }


def _split_proj(zxbcdt, cfg: ModelConfig):
    d_in, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    z = zxbcdt[..., :d_in]
    xBC = zxbcdt[..., d_in:d_in + d_in + 2 * N]
    dt = zxbcdt[..., -H:]
    return z, xBC, dt


def _causal_conv(xBC, w, b, state_tail=None):
    """Depthwise causal conv, window K.  state_tail: [B, K-1, ch] or None."""
    K = w.shape[0]
    if state_tail is not None:
        x = torch.cat([state_tail.to(xBC.dtype), xBC], dim=1)
    else:
        x = F.pad(xBC, (0, 0, K - 1, 0))
    S = x.shape[1] - (K - 1)
    out = sum(x[:, i:i + S] * w[i] for i in range(K))
    return F.silu(out + b)


def mamba_forward(p, u, cfg: ModelConfig, state: MambaState | None = None):
    """Full-sequence mixer: u [B, S, D] -> (y [B, S, D], final MambaState)."""
    with span("rt.mamba"):
        return _forward(p, u, cfg, state)


def _forward(p, u, cfg: ModelConfig, state: MambaState | None):
    B, S, _ = u.shape
    d_in, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    zxbcdt = u @ p["in_proj"]
    z, xBC_pre, dt = _split_proj(zxbcdt, cfg)
    tail_in = state.conv if state is not None else None
    xBC = _causal_conv(xBC_pre, p["conv_w"], p["conv_b"], tail_in)
    # Views of the conv output; the kernel reads them by strides.
    x = xBC[..., :d_in].reshape(B, S, H, P)
    Bm = xBC[..., d_in:d_in + N]
    Cm = xBC[..., d_in + N:]
    x = ax.shard(x, ax.BATCH, None, ax.TP, None)

    A = -torch.exp(p["A_log"])
    dt_s = F.softplus(dt.float() + p["dt_bias"])
    y, final = ops.ssd_scan(x, dt_s, A, Bm, Cm, chunk=cfg.ssm_chunk,
                            initial_state=state.ssm if state is not None
                            else None)
    y = y + x * p["D"][None, None, :, None].to(y.dtype)
    y = y.reshape(B, S, d_in)
    y = ops.rmsnorm(y * F.silu(z), p["norm_scale"], cfg.norm_eps)
    out = y @ p["out_proj"]

    K = cfg.ssm_conv
    tail_src = (torch.cat([tail_in.to(xBC_pre.dtype), xBC_pre], dim=1)
                if state is not None else F.pad(xBC_pre, (0, 0, K - 1, 0)))
    # A copy: a view would keep the whole [B, S, ...] projection alive in
    # the cache.
    new_tail = tail_src[:, -(K - 1):].clone(
        memory_format=torch.contiguous_format)
    length = (state.length if state is not None else 0) + S
    return out, MambaState(conv=new_tail, ssm=final, length=length)


def init_mamba_state(cfg: ModelConfig, batch: int, dtype,
                     device) -> MambaState:
    return MambaState(
        conv=torch.zeros((batch, cfg.ssm_conv - 1, conv_channels(cfg)),
                         dtype=dtype, device=device),
        ssm=torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim,
                         cfg.ssm_state), dtype=torch.float32, device=device),
        length=0)


def state_placed(state: MambaState) -> MambaState:
    """A decode state in ``cache_specs``' placements (batch over the data
    axes; the SSM state's heads whole), where it is made of DTensors."""
    return state._replace(conv=ax.shard(state.conv, ax.BATCH, None, None),
                          ssm=ax.shard(state.ssm, ax.BATCH, None, None, None))


def mamba_decode(p, u, cfg: ModelConfig, state: MambaState):
    """Single-token recurrent step: u [B, 1, D] -> (y [B, 1, D], state).

    On a mesh the mixer's weights are whole on every rank (the rules split
    none of them over ``model``; the unit's FSDP gather joined them) and
    the state is split by batch rows, so the step runs on each rank's rows
    of u and of the state (``_decode_local``)."""
    with span("rt.mamba"):
        if ax.is_dtensor(u):
            return _decode_local(p, u, cfg, state)
        return _decode(p, u, cfg, state)


def _decode(p, u, cfg: ModelConfig, state: MambaState):
    B = u.shape[0]
    d_in, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    zxbcdt = u @ p["in_proj"]
    z, xBC, dt = _split_proj(zxbcdt, cfg)                      # [B,1,*]
    window = torch.cat([state.conv.to(xBC.dtype), xBC], dim=1)  # [B,K,ch]
    conv_out = F.silu(torch.einsum("bkc,kc->bc", window, p["conv_w"])
                      + p["conv_b"])
    x = conv_out[:, :d_in].reshape(B, H, P)
    Bm = conv_out[:, d_in:d_in + N]
    Cm = conv_out[:, d_in + N:]

    A = -torch.exp(p["A_log"])
    dt_s = F.softplus(dt[:, 0].float() + p["dt_bias"])        # [B,H]
    decay = torch.exp(dt_s * A[None, :])
    upd = ((x.float() * dt_s[..., None])[..., None]
           * Bm.float()[:, None, None, :])                      # [B,H,P,N]
    ssm = state.ssm * decay[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", ssm, Cm.float())
    y = y.to(u.dtype) + x * p["D"][None, :, None].to(u.dtype)
    y = y.reshape(B, 1, d_in)
    y = ops.rmsnorm(y * F.silu(z), p["norm_scale"], cfg.norm_eps)
    out = y @ p["out_proj"]
    return out, MambaState(conv=window[:, 1:], ssm=ssm,
                           length=state.length + 1)


def _decode_local(p, u, cfg: ModelConfig, state: MambaState):
    u = ax.shard(u, ax.BATCH, None, None)
    state = state_placed(state)
    y, new = _decode({k: ax.full(w) for k, w in p.items()}, ax.local(u), cfg,
                     state._replace(conv=ax.local(state.conv),
                                    ssm=ax.local(state.ssm)))
    return ax.like(y, u), new._replace(conv=ax.like(new.conv, state.conv),
                                       ssm=ax.like(new.ssm, state.ssm))
