"""Zero-allocation input, parameter, state and cache stand-ins for every
(arch x shape) cell.

Port of ``repro.launch.specs``.  Every tensor is on the ``meta`` device:
the reference's shapes and dtypes, no storage.  Modality frontends are
stubs, as in the reference: whisper gets precomputed frame embeddings,
llava gets patch embeddings, both inside the assigned ``seq_len`` budget.

The encoder-decoder's decode cache comes from the config's arithmetic
(the reference takes it from ``eval_shape`` of prefill): one causal K/V
cache per decoder layer of ``seq_len`` rows, and the cross-attention K/V
of ``seq_len`` frames.  ``params_struct`` and ``state_struct`` give the
model's parameters and train state as meta tensors, for the spec functions
of ``parallel.sharding``.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import attention as attn
from repro_torch.models import encdec, transformer
from repro_torch.models.common import cdtype
from repro_torch.optim.adamw import AdamW
from repro_torch.train.state import TrainState

META = torch.device("meta")


def _sds(shape: tuple, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def train_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    B, S = shape.global_batch, shape.seq_len
    dt = cdtype(cfg)
    if cfg.family == "encdec":
        return {
            "frames": _sds((B, S, cfg.d_model), dt),
            "tokens": _sds((B, S), torch.int32),
            "labels": _sds((B, S), torch.int32),
        }
    if cfg.frontend == "vision_patches":
        S_text = S - cfg.n_prefix_tokens
        return {
            "tokens": _sds((B, S_text), torch.int32),
            "labels": _sds((B, S_text), torch.int32),
            "prefix": _sds((B, cfg.n_prefix_tokens, cfg.d_model), dt),
        }
    return {
        "tokens": _sds((B, S), torch.int32),
        "labels": _sds((B, S), torch.int32),
    }


def prefill_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    B, S = shape.global_batch, shape.seq_len
    dt = cdtype(cfg)
    if cfg.family == "encdec":
        return {
            "frames": _sds((B, S, cfg.d_model), dt),
            "tokens": _sds((B, S), torch.int32),
        }
    if cfg.frontend == "vision_patches":
        return {
            "tokens": _sds((B, S - cfg.n_prefix_tokens), torch.int32),
            "prefix": _sds((B, cfg.n_prefix_tokens, cfg.d_model), dt),
        }
    return {"tokens": _sds((B, S), torch.int32)}


def decode_specs(cfg: ModelConfig, shape: ShapeConfig) -> tuple:
    """(token, cache): one new token against a ``seq_len`` cache (the
    reference also takes the model, for ``eval_shape`` of its prefill)."""
    B, S = shape.global_batch, shape.seq_len
    token = _sds((B, 1), torch.int32)
    if cfg.family == "encdec":
        dt, KV, hd = cdtype(cfg), cfg.n_kv_heads, cfg.hd
        kv = [attn.KVCache(k=_sds((B, attn.cache_len(cfg, S), KV, hd), dt),
                           v=_sds((B, attn.cache_len(cfg, S), KV, hd), dt),
                           length=S)
              for _ in range(cfg.n_layers)]
        cross = [(_sds((B, S, KV, hd), dt), _sds((B, S, KV, hd), dt))
                 for _ in range(cfg.n_layers)]
        return token, encdec.EncDecCache(kv=kv, cross=cross)
    return token, transformer.init_decode_cache(cfg, B, S, META)


def params_struct(cfg: ModelConfig) -> dict:
    """The model's parameters as meta tensors (the generator draws
    nothing on the meta device)."""
    g = torch.Generator()
    if cfg.family == "encdec":
        return encdec.init_encdec(g, cfg, META)
    return transformer.init_lm(g, cfg, META)


def state_struct(cfg: ModelConfig) -> TrainState:
    """The train state (parameters and fp32 moments) as meta tensors."""
    params = params_struct(cfg)
    return TrainState(step=0, params=params, opt=AdamW().init(params), rng=1)
