"""GQA attention with RoPE, sliding-window masking, and KV caches.

Port of ``repro.models.attention``:
  * ``attend_train``   — full-sequence self-attention for the train step,
    causal or not (the whisper encoder), through ``ops.flash_attention``
    (on the card the kernel pair under an ``autograd.Function``, on the CPU
    autograd through its plain version).
  * ``attend_prefill`` — full-sequence causal attention through
    ``ops.flash_attention`` (the CUDA kernel on the card, its plain version
    on the CPU), also returning the KV cache.
  * ``attend_decode``  — one-token step against the cache (ring buffer for
    sliding-window layers, linear buffer otherwise), in plain torch on both
    devices, as the JAX package computes it outside any Pallas kernel.
  * ``encode_kv``      — the encoder states' K/V for one decoder layer.
  * ``attend_cross``   — decoder queries against those K/V, without a mask,
    through ``ops.flash_attention`` for any query length (prefill, training
    and the one-token decode step).  The JAX module runs its plain
    ``_sdpa`` here: the same function.

Weights keep the JAX layout [in, out] for ``x @ w``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.common import apply_rotary, dense_init, rotary_cos_sin
from repro_torch.parallel import axes as ax


class KVCache(NamedTuple):
    k: torch.Tensor       # [B, C, KV, hd]  (C = cache length)
    v: torch.Tensor       # [B, C, KV, hd]
    length: int           # tokens written so far (absolute), kept on the host


def init_attn(generator: torch.Generator, cfg: ModelConfig, dtype,
              device) -> dict:
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {
        "wq": dense_init(generator, D, (H * hd,), dtype, device),
        "wk": dense_init(generator, D, (KV * hd,), dtype, device),
        "wv": dense_init(generator, D, (KV * hd,), dtype, device),
        "wo": dense_init(generator, H * hd, (D,), dtype, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H * hd,), dtype=dtype, device=device)
        p["bk"] = torch.zeros((KV * hd,), dtype=dtype, device=device)
        p["bv"] = torch.zeros((KV * hd,), dtype=dtype, device=device)
    return p


def _project_qkv(p, x, cfg: ModelConfig):
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    return (q.reshape(B, S, H, hd), k.reshape(B, S, KV, hd),
            v.reshape(B, S, KV, hd))


def _sdpa(q, k, v, mask, cfg: ModelConfig):
    """[B,Sq,H,hd] x [B,Skv,KV,hd] -> [B,Sq,H,hd] with GQA head grouping.

    Scores and softmax in fp32, weights cast to v's dtype for the second
    product, masked scores at the fp32 minimum: the JAX module's math.  The
    port calls it for decode, where Sq is 1, so the JAX module's query
    chunking for long sequences has no counterpart here.
    """
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float())
    scores = scores / math.sqrt(hd)
    if mask is not None:
        scores = scores.masked_fill(~mask, torch.finfo(scores.dtype).min)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bkgqs,bskh->bqkgh", w, v).reshape(B, Sq, H, hd)


def cache_len(cfg: ModelConfig, max_seq: int) -> int:
    """Sliding-window layers keep a ring buffer of window size."""
    if cfg.sliding_window:
        return min(cfg.sliding_window, max_seq)
    return max_seq


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype,
               device) -> KVCache:
    C = cache_len(cfg, max_seq)
    KV, hd = cfg.n_kv_heads, cfg.hd
    return KVCache(
        k=torch.zeros((batch, C, KV, hd), dtype=dtype, device=device),
        v=torch.zeros((batch, C, KV, hd), dtype=dtype, device=device),
        length=0)


def _rotary_qkv(p, x, cfg: ModelConfig):
    """Projected q, k, v with RoPE at positions 0 .. S-1."""
    q, k, v = _project_qkv(p, x, cfg)
    if cfg.rope_theta > 0:
        pos = torch.arange(x.shape[1], device=x.device)
        cos, sin = rotary_cos_sin(pos, cfg.hd, cfg.rope_theta, x.dtype)
        q = apply_rotary(q, cos, sin)
        k = apply_rotary(k, cos, sin)
    return q, k, v


def attend_train(p, x, cfg: ModelConfig, *, is_causal: bool = True):
    """Self-attention of x [B, S, D] -> [B, S, D]: causal (sliding-window
    where the config has one), or with no mask at all, as the JAX module's
    ``_sdpa`` branch masks it (its ``use_pallas=True`` branch computes the
    same function wherever the port calls it)."""
    B, S, _ = x.shape
    q, k, v = _rotary_qkv(p, x, cfg)
    q = ax.shard(q, ax.BATCH, None, ax.TP, None)
    k = ax.shard(k, ax.BATCH, None, ax.TP if cfg.n_kv_heads > 1 else None,
                 None)
    out = ops.flash_attention(q, k, v, causal=is_causal,
                              window=cfg.sliding_window if is_causal else 0)
    out = ax.shard(out, ax.BATCH, None, ax.TP, None)
    return out.reshape(B, S, -1) @ p["wo"]


def attend_prefill(p, x, cfg: ModelConfig, max_seq: int):
    """Full-sequence pass that also materializes the decode cache."""
    B, S, _ = x.shape
    q, k, v = _rotary_qkv(p, x, cfg)
    out = ops.flash_attention(q, k, v, causal=True,
                              window=cfg.sliding_window)
    y = out.reshape(B, S, -1) @ p["wo"]

    C = cache_len(cfg, max_seq)
    if C >= S:
        ck = F.pad(k, (0, 0, 0, 0, 0, C - S))
        cv = F.pad(v, (0, 0, 0, 0, 0, C - S))
    else:  # ring buffer: keep the last C positions, aligned to pos % C
        start = S - C
        ck = torch.roll(k[:, start:], shifts=S % C, dims=1)
        cv = torch.roll(v[:, start:], shifts=S % C, dims=1)
    return y, KVCache(k=ck, v=cv, length=S)


def attend_decode(p, x, cache: KVCache, cfg: ModelConfig):
    """One-token step: x [B, 1, D] against the cache.

    The new K/V are written in place into ``cache.k``/``cache.v`` at slot
    ``length % C`` (the JAX package donates the buffers instead), and the
    returned cache shares those tensors with a length one higher.  The
    position stays a host int, so a step never waits for the device.
    """
    C = cache.k.shape[1]
    q, k, v = _project_qkv(p, x, cfg)
    pos = cache.length  # absolute position of the new token
    if cfg.rope_theta > 0:
        positions = torch.arange(pos, pos + 1, device=x.device)
        cos, sin = rotary_cos_sin(positions, cfg.hd, cfg.rope_theta, x.dtype)
        q = apply_rotary(q, cos, sin)
        k = apply_rotary(k, cos, sin)

    slot = pos % C
    cache.k[:, slot] = k[:, 0]
    cache.v[:, slot] = v[:, 0]

    # Valid positions are those already written.  For a sliding-window ring
    # buffer every slot holds one of the last C positions once pos >= C;
    # before that, slots > pos are still empty.
    if cfg.sliding_window and pos >= C:
        valid = None
    else:
        valid = torch.arange(C, device=x.device)[None, :] <= pos
    out = _sdpa(q, cache.k, cache.v, valid, cfg)
    y = out.reshape(x.shape[0], 1, -1) @ p["wo"]
    return y, cache._replace(length=pos + 1)


def init_cross_attn(generator: torch.Generator, cfg: ModelConfig, dtype,
                    device) -> dict:
    return init_attn(generator, cfg, dtype, device)


def attend_cross(p, x, enc_kv, cfg: ModelConfig):
    """Decoder cross-attention of x [B, S, D] over the encoder's K/V
    [B, Se, KV, hd] (``encode_kv``), no mask, any S and Se."""
    B, S, _ = x.shape
    H, hd = cfg.n_heads, cfg.hd
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    if cfg.qkv_bias:
        q = q + p["bq"].reshape(1, 1, H, hd)
    k, v = enc_kv
    out = ops.flash_attention(q, k, v, causal=False)
    return out.reshape(B, S, -1) @ p["wo"]


def encode_kv(p, enc_out, cfg: ModelConfig):
    """Encoder states [B, Se, D] -> (k, v), each [B, Se, KV, hd]."""
    B, Se, _ = enc_out.shape
    KV, hd = cfg.n_kv_heads, cfg.hd
    k = (enc_out @ p["wk"]).reshape(B, Se, KV, hd)
    v = (enc_out @ p["wv"]).reshape(B, Se, KV, hd)
    if cfg.qkv_bias:
        k = k + p["bk"].reshape(1, 1, KV, hd)
        v = v + p["bv"].reshape(1, 1, KV, hd)
    return k, v
