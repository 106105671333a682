"""Encoder-decoder backbone (whisper-base): serving and the train loss.

Port of ``repro.models.encdec``.  The audio frontend (log-mel and the conv
downsampling) is a stub, as in the JAX package: the caller passes frame
embeddings [B, Se, D].  Positions are sinusoidal, attention is MHA without
RoPE.  The encoder's self-attention has no mask; the decoder's is causal,
and each decoder layer attends to the encoder's output through
``attention.attend_cross``.  Every attention goes through
``ops.flash_attention`` (the CUDA kernels on the card; the cross-attention's
backward with Sq != Sk), every norm through ``ops.rmsnorm`` and the loss
through ``ops.fused_cross_entropy``.  Layers are lists of per-layer dicts
where the JAX tree stacks them, and its ``lax.scan``s are loops.

One difference by design: ``encode`` casts the frames to the config's dtype
(the dtype ``launch/specs.py`` declares for them).  The JAX launchers draw
float32 frames, and JAX's type promotion then runs a bf16 model's encoder,
and every decoder layer after its first cross-attention, in float32; torch
refuses products of mixed dtypes.  For a float32 config the two agree.

Decode runs against two caches: the causal self-attention KV cache of each
decoder layer, and the cross-attention K/V of the encoder output, computed
once by ``prefill``.  On a mesh both come out of ``prefill`` in
``cache_specs``' placements (the self-attention caches' sequence over
``model``; the cross K/V whole on every rank, as that function lays out
leaves it does not name), each layer gathers its weights over the FSDP
axes, and the logits come back vocab-sharded.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import attention as attn
from repro_torch.models.common import cdtype, dense_init, embed_init
from repro_torch.models.mlp import init_mlp, mlp
from repro_torch.models.transformer import assemble, cross_entropy
from repro_torch.parallel import axes as ax


def sinusoid_at(positions: torch.Tensor, D: int, dtype) -> torch.Tensor:
    """[..., D]: sin then cos of position / 10000^(2i/D), i < D/2, computed
    in fp32 and cast to ``dtype``, as the JAX module computes them."""
    dim = torch.arange(D // 2, dtype=torch.float32, device=positions.device)
    angle = positions.float()[..., None] / torch.pow(10000.0, 2 * dim / D)
    return torch.cat([angle.sin(), angle.cos()], dim=-1).to(dtype)


def sinusoid_pos(S: int, D: int, dtype, device=None) -> torch.Tensor:
    """[S, D] position embeddings of positions 0 .. S-1."""
    return sinusoid_at(torch.arange(S, device=device), D, dtype)


def _ones(cfg: ModelConfig, dtype, device) -> torch.Tensor:
    return torch.ones((cfg.d_model,), dtype=dtype, device=device)


def init_encdec_parts(generator: torch.Generator, cfg: ModelConfig,
                     device):
    """``init_encdec``'s entries as ``(key, value)`` in the order it draws
    them, the layers one at a time (``("enc_layers", layer)``, ...)."""
    dtype = cdtype(cfg)
    yield "embed", embed_init(generator, cfg.vocab_size, cfg.d_model, dtype,
                              device)
    for _ in range(cfg.n_enc_layers):
        yield "enc_layers", {
            "attn_norm": _ones(cfg, dtype, device),
            "attn": attn.init_attn(generator, cfg, dtype, device),
            "mlp_norm": _ones(cfg, dtype, device),
            "mlp": init_mlp(generator, cfg, dtype, device)}
    yield "enc_norm", _ones(cfg, dtype, device)
    for _ in range(cfg.n_layers):
        yield "dec_layers", {
            "self_norm": _ones(cfg, dtype, device),
            "self_attn": attn.init_attn(generator, cfg, dtype, device),
            "cross_norm": _ones(cfg, dtype, device),
            "cross_attn": attn.init_cross_attn(generator, cfg, dtype,
                                               device),
            "mlp_norm": _ones(cfg, dtype, device),
            "mlp": init_mlp(generator, cfg, dtype, device)}
    yield "final_norm", _ones(cfg, dtype, device)
    yield "lm_head", dense_init(generator, cfg.d_model, (cfg.vocab_size,),
                                dtype, device)


def init_encdec(generator: torch.Generator, cfg: ModelConfig,
                device) -> dict:
    """Random weights drawn on ``device`` from ``generator``, with the JAX
    module's distributions."""
    return assemble(init_encdec_parts(generator, cfg, device))


def encode(params, frames, cfg: ModelConfig):
    """frames [B, Se, D] (the stub frontend's output) -> encoder states."""
    h = frames.to(cdtype(cfg))
    h = h + sinusoid_pos(h.shape[1], cfg.d_model, h.dtype, h.device)
    h = ax.shard(h, ax.BATCH, None, None)
    for lp in params["enc_layers"]:
        lp = ax.fsdp_gather(lp)
        x = ops.rmsnorm(h, lp["attn_norm"], cfg.norm_eps)
        h = h + attn.attend_train(lp["attn"], x, cfg, is_causal=False)
        x = ops.rmsnorm(h, lp["mlp_norm"], cfg.norm_eps)
        h = h + mlp(lp["mlp"], x, cfg)
    return ops.rmsnorm(h, params["enc_norm"], cfg.norm_eps)


def _embed(params, tokens, cfg: ModelConfig):
    S = tokens.shape[1]
    h = ax.lookup(params["embed"], tokens)
    h = h + sinusoid_pos(S, cfg.d_model, h.dtype, h.device)
    return ax.shard(h, ax.BATCH, None, None)


def _dec_layer_train(h, lp, enc_out, cfg: ModelConfig):
    lp = ax.fsdp_gather(lp)
    x = ops.rmsnorm(h, lp["self_norm"], cfg.norm_eps)
    h = h + attn.attend_train(lp["self_attn"], x, cfg, is_causal=True)
    x = ops.rmsnorm(h, lp["cross_norm"], cfg.norm_eps)
    kv = attn.encode_kv(lp["cross_attn"], enc_out, cfg)
    h = h + attn.attend_cross(lp["cross_attn"], x, kv, cfg)
    x = ops.rmsnorm(h, lp["mlp_norm"], cfg.norm_eps)
    return h + mlp(lp["mlp"], x, cfg)


def forward_train(params, frames, tokens, cfg: ModelConfig):
    """frames [B, Se, D], tokens [B, S] -> logits [B, S, V].

    Activation checkpointing on each decoder layer, as the JAX module's
    ``jax.checkpoint`` on the decoder's scan body (the encoder's layers are
    not checkpointed there either): the backward recomputes each decoder
    layer, so its kernels run twice forward and once backward.
    """
    enc_out = encode(params, frames, cfg)
    h = _embed(params, tokens, cfg)
    for lp in params["dec_layers"]:
        h = checkpoint(_dec_layer_train, h, lp, enc_out, cfg,
                       use_reentrant=False)
    h = ops.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return _logits(params, h)


def loss_fn(params, batch, cfg: ModelConfig):
    """batch: {'frames', 'tokens', 'labels'} -> (loss, {'ce', 'aux'}); aux
    is 0, as in JAX."""
    logits = forward_train(params, batch["frames"], batch["tokens"], cfg)
    ce = cross_entropy(logits, batch["labels"])
    return ce, {"ce": ce, "aux": torch.zeros((), dtype=torch.float32,
                                             device=ce.device)}


class EncDecCache(NamedTuple):
    kv: list[attn.KVCache]                            # per decoder layer
    cross: list[tuple[torch.Tensor, torch.Tensor]]    # encoder K/V per layer


def _logits(params, h):
    return ax.shard(h @ ax.fsdp_gather(params["lm_head"]), ax.BATCH, None,
                    ax.TP)


def prefill(params, frames, tokens, cfg: ModelConfig, max_seq: int):
    """Encode the frames and run the decoder over ``tokens`` -> (last
    position's logits [B, V], EncDecCache).  The final norm and the LM head
    run on the last position only (the norm is per row)."""
    enc_out = encode(params, frames, cfg)
    h = _embed(params, tokens, cfg)
    kvs, crosses = [], []
    for lp in params["dec_layers"]:
        lp = ax.fsdp_gather(lp)
        x = ops.rmsnorm(h, lp["self_norm"], cfg.norm_eps)
        y, kv = attn.attend_prefill(lp["self_attn"], x, cfg, max_seq)
        h = h + y
        x = ops.rmsnorm(h, lp["cross_norm"], cfg.norm_eps)
        ckv = attn.encode_kv(lp["cross_attn"], enc_out, cfg)
        h = h + attn.attend_cross(lp["cross_attn"], x, ckv, cfg)
        x = ops.rmsnorm(h, lp["mlp_norm"], cfg.norm_eps)
        h = ax.shard(h + mlp(lp["mlp"], x, cfg), ax.BATCH, None, None)
        kvs.append(kv)
        crosses.append(tuple(ax.shard(t, None, None, None, None)
                             for t in ckv))
    h = ops.rmsnorm(h[:, -1:], params["final_norm"], cfg.norm_eps)
    return _logits(params, h)[:, 0], EncDecCache(kv=kvs, cross=crosses)


def decode_step(params, token, cache: EncDecCache, cfg: ModelConfig):
    """token [B, 1] + caches -> (logits [B, V], caches).  The self-attention
    K/V are written in place (``attention.attend_decode``); the position
    is the cache's host int."""
    pos = cache.kv[0].length
    h = ax.lookup(params["embed"], token)
    h = h + sinusoid_at(torch.arange(pos, pos + 1, device=h.device),
                        cfg.d_model, h.dtype)
    h = ax.shard(h, ax.BATCH, None, None)
    kvs = []
    for lp, kv, ckv in zip(params["dec_layers"], cache.kv, cache.cross):
        lp = ax.fsdp_gather(lp)
        x = ops.rmsnorm(h, lp["self_norm"], cfg.norm_eps)
        y, kv = attn.attend_decode(lp["self_attn"], x, kv, cfg)
        h = h + y
        x = ops.rmsnorm(h, lp["cross_norm"], cfg.norm_eps)
        h = h + attn.attend_cross(lp["cross_attn"], x, ckv, cfg)
        x = ops.rmsnorm(h, lp["mlp_norm"], cfg.norm_eps)
        h = ax.shard(h + mlp(lp["mlp"], x, cfg), ax.BATCH, None, None)
        kvs.append(kv)
    h = ops.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return _logits(params, h)[:, 0], EncDecCache(kv=kvs, cross=cache.cross)
