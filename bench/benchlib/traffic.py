"""The one generator of inputs: it reads a traffic mix's parameters
(``bench/traffic/<mix>.json``) and draws from the seed.

- ``kind: train``: batches of ``batch`` rows of ``seq + 1`` tokens, uniform
  over the vocabulary, drawn on the device; step i's batch has a generator
  of its own, so the reference draws the same rows again.
- ``kind: serve_grouped``: closed-loop batches of ``clients`` requests of
  one prompt length each, the lengths a fixed set (the ``lengths_per_cycle``
  quantiles of a log-uniform law on [prompt_min, prompt_max]) in an order
  drawn from the seed, cycle after cycle.  Every seed sends the same set of
  sizes, in another order; the prompts' tokens are drawn from the seed.
"""

from __future__ import annotations

import numpy as np
import torch

from benchlib.weights import derive


def _generator(seed: int, tag: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(derive(seed, tag))
    return g


def train_batch(cfg: dict, mix: dict, seed: int, step: int, device,
                rows: slice | None = None) -> dict:
    """Step ``step``'s batch: tokens and labels [batch, seq], int32 (the
    labels are the next tokens); ``rows`` takes a part of the rows."""
    B, S = mix["batch"], mix["seq"]
    toks = torch.randint(0, cfg["vocab_size"], (B, S + 1), device=device,
                         generator=_generator(seed, f"train/{step}", device))
    toks = toks.to(torch.int32)
    if rows is not None:
        toks = toks[rows]
    return {"tokens": toks[:, :-1].contiguous(),
            "labels": toks[:, 1:].contiguous()}


def serve_lengths(mix: dict) -> list[int]:
    """The prompt lengths of one cycle, in increasing order."""
    lo, hi, n = mix["prompt_min"], mix["prompt_max"], mix["lengths_per_cycle"]
    return [int(round(lo * (hi / lo) ** ((i + 0.5) / n))) for i in range(n)]


def serve_order(mix: dict, seed: int) -> list[int]:
    """One cycle's lengths in the seed's order."""
    lengths = serve_lengths(mix)
    rng = np.random.default_rng(derive(seed, "serve/order"))
    return [lengths[i] for i in rng.permutation(len(lengths))]


def serve_prompts(cfg: dict, mix: dict, seed: int, batch: int, length: int,
                  device) -> torch.Tensor:
    """Batch ``batch``'s prompts [clients, length], int64."""
    return torch.randint(0, cfg["vocab_size"], (mix["clients"], length),
                         device=device,
                         generator=_generator(seed, f"serve/{batch}", device))
