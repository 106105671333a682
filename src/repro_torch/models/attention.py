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

Under the layouts (DTensor weights, ``parallel.sharding``) prefill computes
each rank's heads and hands back the cache in ``cache_specs``' placements:
batch over the data axes and the sequence over ``model`` (``cache_dims``),
or, for context-parallel decode, the sequence over ``data`` x ``model``.
Decode writes the new token's K/V into the rank's own rows of that cache
and attends over them; where the sequence is split, the ranks' partial
softmaxes combine exactly (``_sdpa_split``), as the reference's
``context_parallel`` branch leaves to XLA.  Plain tensors take the
one-device path unchanged.
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
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    return (ax.heads(q, cfg.n_heads), ax.heads(k, cfg.n_kv_heads),
            ax.heads(v, cfg.n_kv_heads))


def _merge_heads(out):
    """[B, S, H, hd] -> [B, S, H * hd], split over ``model`` as ``wo``'s
    rows are.  Heads that ``model`` does not divide arrive replicated
    (``axes.heads``); splitting the merged dimension here (a local slice)
    gives the backward its gradient in that placement, where the view back
    to [B, S, H, hd] takes it whole."""
    return ax.shard(out.reshape(*out.shape[:2], -1), ax.BATCH, None, ax.TP)


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
    q, k, v = _rotary_qkv(p, x, cfg)
    q = ax.shard(q, ax.BATCH, None, ax.TP, None)
    k = ax.shard(k, ax.BATCH, None, ax.TP if cfg.n_kv_heads > 1 else None,
                 None)
    out = ops.flash_attention(q, k, v, causal=is_causal,
                              window=cfg.sliding_window if is_causal else 0)
    out = ax.shard(out, ax.BATCH, None, ax.TP, None)
    return _merge_heads(out) @ p["wo"]


def cache_dims(context_parallel: bool = False) -> tuple:
    """The logical axes of a K/V cache [B, C, KV, hd], as ``cache_specs``
    lays it out: batch over the data axes and the sequence over ``model``,
    or (context parallel, batch 1) the sequence over ``data`` x ``model``."""
    if context_parallel:
        return (None, ax.CPTP, None, None)
    return (ax.BATCH, ax.TP, None, None)


def attend_prefill(p, x, cfg: ModelConfig, max_seq: int,
                   context_parallel: bool = False):
    """Full-sequence pass that also materializes the decode cache.  On a
    mesh, K/V are computed on each rank's heads, the ring buffer rolled
    there, and the cache then redistributed to ``cache_dims`` (an
    all-to-all from heads to sequence over ``model``)."""
    B, S, _ = x.shape
    q, k, v = _rotary_qkv(p, x, cfg)
    kv_heads = ax.TP if cfg.n_kv_heads > 1 else None
    q = ax.shard(q, ax.BATCH, None, ax.TP, None)
    k = ax.shard(k, ax.BATCH, None, kv_heads, None)
    v = ax.shard(v, ax.BATCH, None, kv_heads, None)
    out = ops.flash_attention(q, k, v, causal=True,
                              window=cfg.sliding_window)
    out = ax.shard(out, ax.BATCH, None, ax.TP, None)
    y = _merge_heads(out) @ p["wo"]

    C = cache_len(cfg, max_seq)
    kl, vl = ax.local(k), ax.local(v)
    if C >= S:
        ck = F.pad(kl, (0, 0, 0, 0, 0, C - S))
        cv = F.pad(vl, (0, 0, 0, 0, 0, C - S))
    else:  # ring buffer: keep the last C positions, aligned to pos % C
        start = S - C
        ck = torch.roll(kl[:, start:], shifts=S % C, dims=1)
        cv = torch.roll(vl[:, start:], shifts=S % C, dims=1)
    dims = cache_dims(context_parallel)
    return y, KVCache(k=ax.shard(ax.like(ck, k), *dims),
                      v=ax.shard(ax.like(cv, v), *dims), length=S)


def _valid(cfg: ModelConfig, pos: int, C: int, offset: int, rows: int,
           device):
    """Which of the cache rows ``offset .. offset + rows - 1`` (of C) hold
    a position, [1, rows], or None for all of them: the rows already
    written, and every row of a sliding-window ring once it has wrapped
    (``pos >= C``)."""
    if cfg.sliding_window and pos >= C:
        return None
    return (torch.arange(offset, offset + rows, device=device) <= pos)[None]


def attend_decode(p, x, cache: KVCache, cfg: ModelConfig,
                  context_parallel: bool = False):
    """One-token step: x [B, 1, D] against the cache.

    The new K/V are written in place into ``cache.k``/``cache.v`` at slot
    ``length % C`` (the JAX package donates the buffers instead), and the
    returned cache shares those tensors with a length one higher.  The
    position stays a host int, so a step never waits for the device.

    A cache of DTensors is first placed by ``cache_dims(context_parallel)``
    (a no-op where prefill or ``distribute_cache`` put it) and decoded by
    ``_decode_sharded``.
    """
    C = cache.k.shape[1]
    q, k, v = _project_qkv(p, x, cfg)
    pos = cache.length  # absolute position of the new token
    if cfg.rope_theta > 0:
        positions = torch.arange(pos, pos + 1, device=x.device)
        cos, sin = rotary_cos_sin(positions, cfg.hd, cfg.rope_theta, x.dtype)
        q = apply_rotary(q, cos, sin)
        k = apply_rotary(k, cos, sin)

    if ax.is_dtensor(cache.k):
        dims = cache_dims(context_parallel)
        cache = cache._replace(k=ax.shard(cache.k, *dims),
                               v=ax.shard(cache.v, *dims))
        out = _decode_sharded(q, k, v, cache, cfg)
    else:
        slot = pos % C
        cache.k[:, slot] = k[:, 0]
        cache.v[:, slot] = v[:, 0]
        valid = _valid(cfg, pos, C, 0, C, x.device)
        out = _sdpa(q, cache.k, cache.v, valid, cfg)
    y = _merge_heads(out) @ p["wo"]
    return y, cache._replace(length=pos + 1)


def _seq_rows(cache_k) -> tuple[int, int]:
    """(global index of the first, count) of this rank's rows of a cache
    DTensor's sequence: each mesh dimension that shards it splits what the
    earlier ones left, as DTensor orders them."""
    mesh, offset, rows = cache_k.device_mesh, 0, cache_k.shape[1]
    for i, pl in enumerate(cache_k.placements):
        if pl.is_shard(1):
            rows //= mesh.size(i)
            offset += mesh.get_local_rank(i) * rows
    return offset, rows


def _decode_sharded(q, k, v, cache: KVCache, cfg: ModelConfig):
    """Attention of the new token on a cache of DTensors, on local shards.

    q, k and v are gathered to every head and placed by the cache's batch
    (a few KB); the rank whose rows hold ``slot = pos % C`` writes the new
    K/V there; each rank scores its rows for every head, masked by their
    global slot indices; the ranks that split the sequence combine
    (``_sdpa_split``); the output keeps the rank's heads for ``wo``, whose
    rows are split over ``model``.  Where no mesh dimension of size > 1
    splits the sequence (one rank, or a cache length the axis does not
    divide, replicated by ``sanitize``) this is ``_sdpa`` on the local
    tensors, the one-device arithmetic."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = cache.k.device_mesh
    rows = tuple(Shard(0) if pl.is_shard(0) else Replicate()
                 for pl in cache.k.placements)
    q, k, v = (ax.local(t.redistribute(mesh, rows)) for t in (q, k, v))
    kl, vl = ax.local(cache.k), ax.local(cache.v)
    C, pos = cache.k.shape[1], cache.length
    offset, n = _seq_rows(cache.k)
    slot = pos % C
    if offset <= slot < offset + n:
        kl[:, slot - offset] = k[:, 0]
        vl[:, slot - offset] = v[:, 0]
    valid = _valid(cfg, pos, C, offset, n, q.device)
    split = [i for i, pl in enumerate(cache.k.placements)
             if pl.is_shard(1) and mesh.size(i) > 1]
    out = (_sdpa_split(q, kl, vl, valid, mesh, split) if split
           else _sdpa(q, kl, vl, valid, cfg))
    out = DTensor.from_local(out, mesh, rows, run_check=False)
    return ax.shard(out, ax.BATCH, None, ax.TP, None)


def _sdpa_split(q, k, v, valid, mesh, split: list[int]):
    """``_sdpa`` of one query row over a sequence split across the mesh
    dimensions ``split``: each rank's scores over its rows (fp32, masked
    by ``valid``), the max all-reduced, then the exp-sums and the weighted
    values under one all-reduce, in fp32.  A rank with no valid row adds
    exact zeros (its masked entries are zeroed, not exp'd)."""
    import torch.distributed._functional_collectives as funcol

    B, _, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, KV, H // KV, hd)
    s = torch.einsum("bkgh,bskh->bkgs", qg.float(), k.float())
    s = s / math.sqrt(hd)
    if valid is not None:
        s = s.masked_fill(~valid, torch.finfo(s.dtype).min)
    m = s.amax(-1, keepdim=True)
    for i in split:
        m = funcol.all_reduce(m, "max", (mesh, i))
    e = torch.exp(s - m)
    if valid is not None:
        e = e.masked_fill(~valid, 0.0)
    acc = torch.cat([torch.einsum("bkgs,bskh->bkgh", e, v.float()),
                     e.sum(-1, keepdim=True)], dim=-1)
    for i in split:
        acc = funcol.all_reduce(acc, "sum", (mesh, i))
    out = acc[..., :hd] / acc[..., hd:]
    return out.to(v.dtype).reshape(B, 1, H, hd)


def init_cross_attn(generator: torch.Generator, cfg: ModelConfig, dtype,
                    device) -> dict:
    return init_attn(generator, cfg, dtype, device)


def attend_cross(p, x, enc_kv, cfg: ModelConfig):
    """Decoder cross-attention of x [B, S, D] over the encoder's K/V
    [B, Se, KV, hd] (``encode_kv``), no mask, any S and Se."""
    q = ax.heads(x @ p["wq"], cfg.n_heads)
    if cfg.qkv_bias:
        q = q + ax.heads(p["bq"], cfg.n_heads)
    k, v = enc_kv
    out = ops.flash_attention(q, k, v, causal=False)
    return _merge_heads(out) @ p["wo"]


def encode_kv(p, enc_out, cfg: ModelConfig):
    """Encoder states [B, Se, D] -> (k, v), each [B, Se, KV, hd]."""
    KV = cfg.n_kv_heads
    k = ax.heads(enc_out @ p["wk"], KV)
    v = ax.heads(enc_out @ p["wv"], KV)
    if cfg.qkv_bias:
        k = k + ax.heads(p["bk"], KV)
        v = v + ax.heads(p["bv"], KV)
    return k, v
