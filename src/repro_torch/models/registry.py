"""Uniform model API over every architecture family.

Port of ``repro.models.registry``.  ``get_model(cfg, device=...)`` returns a
``Model`` with:

  init(seed)                       -> params, drawn on the device
  init_parts(seed)                 -> init's (key, value) entries in draw
                                      order, a unit (layer) at a time
  loss(params, batch)              -> (loss, {'ce', 'aux'}), differentiable
  prefill(params, batch, max_seq)  -> (logits, cache)
  decode(params, token, cache)     -> (logits, cache)
  init_cache(batch, max_seq)       -> cache

``batch`` is a dict whose keys depend on the family: tokens (and labels for
the loss) always, plus ``prefix`` patch embeddings for the VLM family and
``frames`` for the encoder-decoder.  ``max_seq`` is the self-attention
cache's length; for a VLM it counts the prefix rows.  With
``context_parallel`` (the reference's ``long_500k`` cells) the decoder-only
families' K/V caches put their sequence over ``data`` x ``model``.  The encoder-decoder's
``init_cache`` raises ``NotImplementedError``, as JAX's does: its decode
cache holds the encoder's K/V, so it comes from ``prefill``.  ``loss``
takes every family; on the card a Mamba unit's SSD scans train through the
SSD backward kernel.
"""

from __future__ import annotations

from collections.abc import Callable
from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, transformer


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable[..., Any]
    loss: Callable[..., Any]
    prefill: Callable[..., Any]
    decode: Callable[..., Any]
    init_cache: Callable[..., Any]
    decays: Callable[[tuple, torch.Tensor], bool]   # AdamW's decay rule
    init_parts: Callable[..., Any]


def get_model(cfg: ModelConfig, device: str | torch.device = "cuda",
              context_parallel: bool = False) -> Model:
    device = torch.device(device)

    def generator() -> torch.Generator:
        return torch.Generator(device=device)

    if cfg.family == "encdec":
        def init_encdec(seed: int):
            return encdec.init_encdec(generator().manual_seed(seed), cfg,
                                      device)

        def loss_encdec(params, batch):
            return encdec.loss_fn(params, batch, cfg)

        def prefill_encdec(params, batch, max_seq):
            return encdec.prefill(params, batch["frames"], batch["tokens"],
                                  cfg, max_seq)

        def decode_encdec(params, token, cache):
            return encdec.decode_step(params, token, cache, cfg)

        def no_cache(batch: int, max_seq: int):
            raise NotImplementedError(
                f"{cfg.name}: the encoder-decoder's decode cache holds the "
                f"encoder's K/V, so it comes from prefill")

        def parts_encdec(seed: int):
            return encdec.init_encdec_parts(generator().manual_seed(seed),
                                            cfg, device)

        return Model(cfg, init_encdec, loss_encdec, prefill_encdec,
                     decode_encdec, no_cache, transformer.decayed,
                     parts_encdec)

    def init(seed: int):
        return transformer.init_lm(generator().manual_seed(seed), cfg, device)

    def loss(params, batch):
        return transformer.loss_fn(params, batch, cfg)

    def prefill_fn(params, batch, max_seq):
        return transformer.prefill(params, batch["tokens"], cfg, max_seq,
                                   prefix=batch.get("prefix"),
                                   context_parallel=context_parallel)

    def decode_fn(params, token, cache):
        return transformer.decode_step(params, token, cache, cfg,
                                       context_parallel=context_parallel)

    def init_cache(batch: int, max_seq: int):
        return transformer.init_decode_cache(cfg, batch, max_seq, device)

    def init_parts(seed: int):
        return transformer.init_lm_parts(generator().manual_seed(seed), cfg,
                                         device)

    return Model(cfg, init, loss, prefill_fn, decode_fn, init_cache,
                 transformer.decayed, init_parts)
