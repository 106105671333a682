"""Deterministic synthetic token pipeline with a straggler hook.

The port's own copy of ``repro.data.pipeline`` (numpy, no JAX; the port
imports nothing of the JAX package).  ``batch_at(step)`` is a pure function
of (seed, step), so restart and resume need no data-loader state beyond the
step counter.  ``tests/test_torch_train.py`` holds its batches equal to the
original's for the same seed and step.

Straggler simulation (``delay_prob``) injects per-host latency for the
fault-tolerance tests of the training loop's EWMA detector.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclass
class SyntheticTokens:
    cfg: ModelConfig
    batch: int
    seq: int
    seed: int = 0
    delay_prob: float = 0.0       # straggler injection
    delay_s: float = 0.05

    def batch_at(self, step: int) -> dict:
        """Markov-ish synthetic tokens: learnable bigram structure, so the
        quickstart loss visibly falls below the unigram entropy."""
        rng = np.random.default_rng((self.seed, step))
        if self.delay_prob and rng.random() < self.delay_prob:
            time.sleep(self.delay_s)
        V = self.cfg.vocab_size
        B, S = self.batch, self.seq
        # tokens follow t_{i+1} = (t_i + delta) mod V with delta = 0 at 85%
        # of positions — a copy-dominated bigram process whose entropy
        # (~0.6 nats) is far below the unigram ln(V), so learning is
        # visible within a few hundred steps at any vocab size.
        t0 = rng.integers(0, V, (B, 1))
        delta = rng.integers(1, 7, (B, S)) * (rng.random((B, S)) > 0.85)
        toks = np.empty((B, S + 1), np.int64)
        toks[:, :1] = t0
        for i in range(S):
            toks[:, i + 1] = (toks[:, i] + delta[:, i]) % V
        batch = {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }
        if self.cfg.family == "encdec":
            batch["frames"] = rng.standard_normal(
                (B, S, self.cfg.d_model)).astype(np.float32)
        if self.cfg.frontend == "vision_patches":
            batch["prefix"] = rng.standard_normal(
                (B, self.cfg.n_prefix_tokens,
                 self.cfg.d_model)).astype(np.float32)
        return batch

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def make_pipeline(cfg: ModelConfig, shape: ShapeConfig, seed: int = 0,
                  batch_override: int | None = None,
                  seq_override: int | None = None) -> SyntheticTokens:
    return SyntheticTokens(cfg=cfg,
                           batch=batch_override or shape.global_batch,
                           seq=seq_override or shape.seq_len, seed=seed)
