"""Uniform model API: serving for the dense, moe, SSM and hybrid families,
the train loss for the dense and moe families.

Port of ``repro.models.registry``.  ``get_model(cfg, device=...)`` returns a
``Model`` with:

  init(seed)                       -> params, drawn on the device
  loss(params, batch)              -> (loss, {'ce', 'aux'}), differentiable
  prefill(params, batch, max_seq)  -> (logits, cache)
  decode(params, token, cache)     -> (logits, cache)
  init_cache(batch, max_seq)       -> cache

``loss`` raises ``NotImplementedError`` for a config with Mamba units (the
SSM family and the jamba hybrid, with or without experts: the SSD backward
kernel is a later slice).  The ``encdec`` and ``vlm`` families raise when
the model is asked for.
"""

from __future__ import annotations

from collections.abc import Callable
from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer

_LATER_SLICE = {
    "encdec": "the encoder-decoder slice",
    "vlm": "the VLM slice",
}


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable[..., Any]
    loss: Callable[..., Any]
    prefill: Callable[..., Any]
    decode: Callable[..., Any]
    init_cache: Callable[..., Any]
    decays: Callable[[tuple, torch.Tensor], bool]   # AdamW's decay rule


def get_model(cfg: ModelConfig, device: str | torch.device = "cuda") -> Model:
    if cfg.family in _LATER_SLICE:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is ported in "
            f"{_LATER_SLICE[cfg.family]}")
    device = torch.device(device)

    def init(seed: int):
        generator = torch.Generator(device=device).manual_seed(seed)
        return transformer.init_lm(generator, cfg, device)

    def loss(params, batch):
        return transformer.loss_fn(params, batch, cfg)

    def prefill_fn(params, batch, max_seq):
        return transformer.prefill(params, batch["tokens"], cfg, max_seq)

    def decode_fn(params, token, cache):
        return transformer.decode_step(params, token, cache, cfg)

    def init_cache(batch: int, max_seq: int):
        return transformer.init_decode_cache(cfg, batch, max_seq, device)

    return Model(cfg, init, loss, prefill_fn, decode_fn, init_cache,
                 transformer.decayed)
