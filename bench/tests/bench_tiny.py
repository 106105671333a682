"""Smoke-width configurations and mixes of the benchmark's kinds, for the
CPU tests: the same files' keys, float32, a few layers.  ``HYBRID`` is the
port's hybrid layout (a NoPE attention sub-layer with a dense FFN, then a
Mamba sub-layer with a MoE FFN, in each unit), whose architecture module
is ``tiny_hybrid.py`` beside this file."""

import copy
import time

import torch

from benchlib.record import Context

REFERENCE = "bench/benchlib/reference.py"
MOE = {"name": "tiny-moe", "family": "moe", "reference": REFERENCE,
       "n_layers": 2, "d_model": 64,
       "n_heads": 4, "n_kv_heads": 2, "head_dim": 16, "d_ff": 96,
       "vocab_size": 256, "n_experts": 4, "experts_per_token": 2,
       "moe_layer_period": 1, "capacity_factor": 1.25, "sliding_window": 24,
       "rope_theta": 10000.0, "norm_eps": 1e-5, "tie_embeddings": False,
       "dtype": "float32", "aux_loss_weight": 0.01}
SSM = {"name": "tiny-ssm", "family": "ssm", "reference": REFERENCE,
       "n_layers": 2, "d_model": 64,
       "n_heads": 0, "n_kv_heads": 0, "d_ff": 0, "vocab_size": 256,
       "ssm_state": 16, "ssm_expand": 2, "ssm_head_dim": 16, "ssm_conv": 4,
       "ssm_chunk": 16, "tie_embeddings": True, "norm_eps": 1e-5,
       "rope_theta": 1e6, "dtype": "float32"}
HYBRID = {"name": "tiny-hybrid", "family": "hybrid",
          "reference": "bench/tests/tiny_hybrid.py", "n_layers": 4,
          "attn_layer_period": 2, "moe_layer_period": 2, "d_model": 64,
          "n_heads": 4, "n_kv_heads": 2, "head_dim": 16, "d_ff": 96,
          "vocab_size": 256, "n_experts": 4, "experts_per_token": 2,
          "capacity_factor": 1.25, "sliding_window": 0, "ssm_state": 16,
          "ssm_expand": 2, "ssm_head_dim": 16, "ssm_conv": 4,
          "ssm_chunk": 16, "rope_theta": 0.0, "norm_eps": 1e-5,
          "tie_embeddings": True, "dtype": "float32",
          "aux_loss_weight": 0.01}
ADAMW = {"warmup_steps": 1, "min_lr_ratio": 0.1, "b1": 0.9, "b2": 0.95,
         "eps": 1e-8, "weight_decay": 0.1, "clip_norm": 1.0}
TRAIN = {"kind": "train", "batch": 2, "seq": 48, "lr": 3e-4,
         "schedule_steps": 4, "check_steps": 3, "trace_steps": 2,
         "adamw": ADAMW}
SERVE = {"kind": "serve_grouped", "clients": 3, "prompt_min": 8,
         "prompt_max": 40, "lengths_per_cycle": 4, "gen": 6,
         "check_requests": 5, "trace_quantiles": [1, 3]}
CPU = torch.device("cpu")


def ctx(cfg: dict, mix: dict, seed: int = 123456789012, seconds=0.05,
        trace: bool = False) -> Context:
    return Context(cfg, mix, seed, seconds, trace, CPU, time.perf_counter())


def unchanged(step):
    """A train step broken underneath: it returns its state unchanged."""
    def f(state, batch):
        _, metrics = step(copy.deepcopy(state), batch)
        return state, metrics
    return f
