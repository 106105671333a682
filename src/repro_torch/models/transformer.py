"""Decoder-only LM backbone: serving and the train loss for dense, MoE, SSM
and hybrid units.

Port of ``repro.models.transformer`` for units of attention or Mamba-2
mixers with an optional dense or MoE FFN (the dense and moe families,
mamba2, and the jamba hybrid with or without experts), and for the VLM
family: precomputed prefix embeddings (the stub vision frontend's patches)
are concatenated ahead of the token embeddings, and the loss scores the
text positions only.  Layers are grouped
into the same repeating *units* as in the JAX module (``unit_layout``), but
parameters are a list with one dict per unit in place of arrays stacked
over units, and the ``lax.scan`` over units becomes a loop.  Every RMSNorm
goes through ``ops.rmsnorm`` (the CUDA kernel on the card), every prefill
or train attention through ``ops.flash_attention``, every prefill SSD scan
through ``ops.ssd_scan`` (the CUDA kernels on the card; the train path's
scans too) and the train loss through ``ops.fused_cross_entropy``
(Triton); on the card the train path's gradients come from their backward
kernels.  The MoE FFN (``moe.moe_ffn``) and the Mamba mixer's conv, gates
and skip are plain torch, as the JAX package computes them.  Under a
profiler each unit's attention runs in an ``rt.attention`` span
(``repro_torch.spans``).

On a mesh (DTensor parameters, ``parallel.sharding``) the train and
serving paths carry the reference's activation annotations
(``axes.shard``: a no-op on plain tensors), each unit gathers its weights
over the FSDP axes at its entry (``axes.fsdp_gather``), and the embedding
lookup runs on each rank's own tokens (``axes.lookup``).  Prefill hands
back its caches in ``cache_specs``' placements, and decode runs on them
(``attention.attend_decode``, ``mamba.mamba_decode``); ``context_parallel``
puts the K/V caches' sequence over ``data`` x ``model`` (batch-1 long
contexts), as the reference's ``decode_step`` takes it.  The logits come
back vocab-sharded: the caller makes them whole before an argmax.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mb
from repro_torch.models.common import cdtype, dense_init, embed_init
from repro_torch.models.mlp import init_mlp, mlp
from repro_torch.models.moe import init_moe, load_balancing_loss, moe_ffn
from repro_torch.parallel import axes as ax
from repro_torch.spans import span

AUX_LOSS_WEIGHT = 0.01


def unit_layout(cfg: ModelConfig) -> list[dict[str, str | None]]:
    if cfg.family == "hybrid":
        unit_len = cfg.attn_layer_period
    elif cfg.is_moe and cfg.moe_layer_period > 1:
        unit_len = cfg.moe_layer_period
    else:
        unit_len = 1
    if cfg.n_layers % unit_len:
        raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} not divisible "
                         f"by unit length {unit_len}")
    layout = []
    for i in range(unit_len):
        mixer = "attn" if cfg.is_attn_layer(i) else "mamba"
        if cfg.d_ff <= 0:
            ffn = None
        elif cfg.is_moe_layer(i):
            ffn = "moe"
        else:
            ffn = "mlp"
        layout.append({"mixer": mixer, "ffn": ffn})
    return layout


def n_units(cfg: ModelConfig) -> int:
    return cfg.n_layers // len(unit_layout(cfg))


def _init_unit(generator, cfg: ModelConfig, dtype, device) -> dict:
    p: dict[str, Any] = {}
    for j, sub in enumerate(unit_layout(cfg)):
        sp: dict[str, Any] = {"mixer_norm": torch.ones((cfg.d_model,),
                                                       dtype=dtype,
                                                       device=device)}
        if sub["mixer"] == "attn":
            sp["attn"] = attn.init_attn(generator, cfg, dtype, device)
        else:
            sp["mamba"] = mb.init_mamba(generator, cfg, dtype, device)
        if sub["ffn"]:
            sp["ffn_norm"] = torch.ones((cfg.d_model,), dtype=dtype,
                                        device=device)
            if sub["ffn"] == "moe":
                sp["moe"] = init_moe(generator, cfg, dtype, device)
            else:
                sp["mlp"] = init_mlp(generator, cfg, dtype, device)
        p[f"sub{j}"] = sp
    return p


def init_lm_parts(generator: torch.Generator, cfg: ModelConfig, device):
    """``init_lm``'s entries as ``(key, value)`` in the order it draws
    them, the units one at a time (``("units", unit)``)."""
    dtype = cdtype(cfg)
    yield "embed", embed_init(generator, cfg.vocab_size, cfg.d_model, dtype,
                              device)
    for _ in range(n_units(cfg)):
        yield "units", _init_unit(generator, cfg, dtype, device)
    yield "final_norm", torch.ones((cfg.d_model,), dtype=dtype,
                                   device=device)
    if not cfg.tie_embeddings:
        yield "lm_head", dense_init(generator, cfg.d_model,
                                    (cfg.vocab_size,), dtype, device)


#: Top-level subtrees that the JAX tree stacks over layers (``vmap``ped
#: inits), and the port keeps as lists of per-layer dicts: the units, and
#: the encoder-decoder's layers.
STACKED = ("units", "enc_layers", "dec_layers")


def assemble(parts) -> dict:
    """A parameter tree from ``(key, value)`` parts, the values of a
    ``STACKED`` key collected into its list."""
    params: dict = {}
    for key, value in parts:
        if key in STACKED:
            params.setdefault(key, []).append(value)
        else:
            params[key] = value
    return params


def init_lm(generator: torch.Generator, cfg: ModelConfig, device) -> dict:
    """Random weights drawn on ``device`` from ``generator`` (a generator on
    that device), with the JAX module's distributions."""
    return assemble(init_lm_parts(generator, cfg, device))


def decayed(path: tuple, p: torch.Tensor) -> bool:
    """Whether AdamW decays the leaf at ``path``: JAX decays leaves of rank
    >= 2, and its tree stacks each layer's leaves over layers ([L, ...]),
    so a leaf of a ``STACKED`` subtree counts one axis more than here.  A
    layer's norm scales and QKV biases are decayed, the top-level norms are
    not; the port reproduces this quirk of the reference."""
    return p.ndim + (path[0] in STACKED) >= 2


def embed_tokens(params, tokens, cfg: ModelConfig, prefix=None):
    """Token embeddings [B, S, D], after the prefix embeddings [B, P, D]
    (cast to the model's dtype) where there are any."""
    h = ax.lookup(params["embed"], tokens)
    if prefix is not None:
        h = torch.cat([prefix.to(h.dtype), h], dim=1)
    return ax.shard(h, ax.BATCH, None, None)


def lm_head(params, h, cfg: ModelConfig):
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return ax.shard(h @ ax.fsdp_gather(w), ax.BATCH, None, ax.TP)


# ----------------------------------------------------------------- training

def _ffn(sp, x, sub, cfg: ModelConfig):
    """The sub-layer's FFN -> (y, router logits or None)."""
    if sub["ffn"] == "moe":
        return moe_ffn(sp["moe"], x, cfg)
    return mlp(sp["mlp"], x, cfg), None


def _apply_unit_train(h, up, cfg: ModelConfig):
    """-> (h, aux): aux sums each MoE sub-layer's load-balancing loss.  On
    a mesh the unit's weights are gathered over the FSDP axes first."""
    up = ax.fsdp_gather(up)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for j, sub in enumerate(unit_layout(cfg)):
        sp = up[f"sub{j}"]
        x = ops.rmsnorm(h, sp["mixer_norm"], cfg.norm_eps)
        if sub["mixer"] == "attn":
            with span("rt.attention"):
                y = attn.attend_train(sp["attn"], x, cfg)
            h = h + y
        else:
            h = h + mb.mamba_forward(sp["mamba"], x, cfg)[0]
        if sub["ffn"]:
            x = ops.rmsnorm(h, sp["ffn_norm"], cfg.norm_eps)
            y, router_logits = _ffn(sp, x, sub, cfg)
            if router_logits is not None:
                aux = aux + load_balancing_loss(router_logits, cfg)
            h = h + y
        h = ax.shard(h, ax.BATCH, None, None)
    return h, aux


def _units_train(params, tokens, cfg: ModelConfig, prefix=None):
    """The hidden states after the last unit [B, P + S, D], and the aux
    loss.

    Activation checkpointing as in the JAX module (``jax.checkpoint`` on
    the unit body): only unit boundaries are kept, and the backward pass
    recomputes each unit (``torch.utils.checkpoint``, non-reentrant), so
    each unit's kernels run twice forward and once backward.  The aux loss
    is the sum over units of their MoE load-balancing losses, 0 for dense
    units, as in JAX.
    """
    h = embed_tokens(params, tokens, cfg, prefix)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for up in params["units"]:
        h, a = checkpoint(_apply_unit_train, h, up, cfg, use_reentrant=False)
        aux = aux + a
    return h, aux


def forward_train(params, tokens, cfg: ModelConfig, prefix=None):
    """tokens [B, S] (+ prefix embeddings [B, P, D]) -> (logits
    [B, P + S, V], aux loss)."""
    h, aux = _units_train(params, tokens, cfg, prefix)
    h = ops.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return lm_head(params, h, cfg), aux


def cross_entropy(logits, labels, mask=None):
    """Token-mean CE in fp32; labels < 0 are ignored.  The per-row NLL goes
    through ``ops.fused_cross_entropy`` on [B*S, V]; the masked mean, which
    gives ignored rows a zero gradient, is plain torch over [B*S]."""
    V = logits.shape[-1]
    nll = ops.fused_cross_entropy(logits.reshape(-1, V),
                                  labels.reshape(-1)).reshape(labels.shape)
    valid = (labels >= 0) if mask is None else mask & (labels >= 0)
    nll = torch.where(valid, nll, 0.0)
    return nll.sum() / valid.sum().clamp(min=1)


def loss_fn(params, batch, cfg: ModelConfig):
    """batch: {'tokens': [B, S], 'labels': [B, S], optional 'prefix'
    [B, P, D]} -> (loss, {'ce', 'aux'}).

    The loss scores the text positions only.  The final norm and the LM
    head run on those positions alone: both are per row, so this is the JAX
    module's loss over its sliced logits, without the prefix's logits.
    """
    prefix = batch.get("prefix")
    h, aux = _units_train(params, batch["tokens"], cfg, prefix)
    if prefix is not None:
        h = h[:, prefix.shape[1]:]
    h = ops.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    ce = cross_entropy(lm_head(params, h, cfg), batch["labels"])
    return ce + AUX_LOSS_WEIGHT * aux, {"ce": ce, "aux": aux}


# ----------------------------------------------------------------- serving

class LayerCache(NamedTuple):
    """Per-unit decode state: one KVCache per attention sub-layer and one
    MambaState per Mamba sub-layer, in layout order."""

    kv: tuple[attn.KVCache, ...]
    ssm: tuple[mb.MambaState, ...]


def init_decode_cache(cfg: ModelConfig, batch: int, max_seq: int,
                      device) -> list[LayerCache]:
    dtype = cdtype(cfg)
    layout = unit_layout(cfg)
    n_attn = sum(1 for s in layout if s["mixer"] == "attn")
    n_mamba = len(layout) - n_attn
    return [LayerCache(
        kv=tuple(attn.init_cache(cfg, batch, max_seq, dtype, device)
                 for _ in range(n_attn)),
        ssm=tuple(mb.init_mamba_state(cfg, batch, dtype, device)
                  for _ in range(n_mamba)))
            for _ in range(n_units(cfg))]


def _apply_unit_prefill(h, up, cfg: ModelConfig, max_seq: int,
                        context_parallel: bool = False):
    up = ax.fsdp_gather(up)
    kvs, ssms = [], []
    for j, sub in enumerate(unit_layout(cfg)):
        sp = up[f"sub{j}"]
        x = ops.rmsnorm(h, sp["mixer_norm"], cfg.norm_eps)
        if sub["mixer"] == "attn":
            with span("rt.attention"):
                y, kv = attn.attend_prefill(sp["attn"], x, cfg, max_seq,
                                            context_parallel)
            kvs.append(kv)
        else:
            y, st = mb.mamba_forward(sp["mamba"], x, cfg)
            ssms.append(mb.state_placed(st))
        h = h + y
        if sub["ffn"]:
            x = ops.rmsnorm(h, sp["ffn_norm"], cfg.norm_eps)
            h = h + _ffn(sp, x, sub, cfg)[0]
        h = ax.shard(h, ax.BATCH, None, None)
    return h, LayerCache(kv=tuple(kvs), ssm=tuple(ssms))


def prefill(params, tokens, cfg: ModelConfig, max_seq: int, prefix=None,
            context_parallel: bool = False):
    """Full-context pass over the prefix embeddings (if any) and ``tokens``
    -> (last-position logits [B, V], per-unit caches).  ``max_seq`` counts
    the prefix rows: a cache shorter than the context keeps only its last
    ``max_seq`` positions, as in JAX.

    The final norm and the LM head run on the last position only: the norm
    is per row, so this is the JAX module's result without the [B, S, V]
    logits.
    """
    h = embed_tokens(params, tokens, cfg, prefix)
    caches = []
    for up in params["units"]:
        h, cache = _apply_unit_prefill(h, up, cfg, max_seq, context_parallel)
        caches.append(cache)
    h = ops.rmsnorm(h[:, -1:], params["final_norm"], cfg.norm_eps)
    return lm_head(params, h, cfg)[:, 0], caches


def _apply_unit_decode(h, up, cache: LayerCache, cfg: ModelConfig,
                       context_parallel: bool = False):
    up = ax.fsdp_gather(up)
    kvs, ssms = [], []
    for j, sub in enumerate(unit_layout(cfg)):
        sp = up[f"sub{j}"]
        x = ops.rmsnorm(h, sp["mixer_norm"], cfg.norm_eps)
        if sub["mixer"] == "attn":
            with span("rt.attention"):
                y, kv = attn.attend_decode(sp["attn"], x, cache.kv[len(kvs)],
                                           cfg, context_parallel)
            kvs.append(kv)
        else:
            y, st = mb.mamba_decode(sp["mamba"], x, cfg, cache.ssm[len(ssms)])
            ssms.append(st)
        h = h + y
        if sub["ffn"]:
            x = ops.rmsnorm(h, sp["ffn_norm"], cfg.norm_eps)
            h = h + _ffn(sp, x, sub, cfg)[0]
        h = ax.shard(h, ax.BATCH, None, None)
    return h, LayerCache(kv=tuple(kvs), ssm=tuple(ssms))


def decode_step(params, token, cache: list[LayerCache], cfg: ModelConfig,
                context_parallel: bool = False):
    """token [B, 1] + caches -> (logits [B, V], caches).  The K/V buffers
    are updated in place (see ``attention.attend_decode``); the Mamba
    states are replaced."""
    h = embed_tokens(params, token, cfg)
    new_caches = []
    for up, ucache in zip(params["units"], cache):
        h, new = _apply_unit_decode(h, up, ucache, cfg, context_parallel)
        new_caches.append(new)
    h = ops.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return lm_head(params, h, cfg)[:, 0], new_caches
