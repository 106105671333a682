"""Dense FFN (SwiGLU).  Port of ``repro.models.mlp``; the products are
``torch.matmul`` on weights kept in the JAX layout [in, out]."""

from __future__ import annotations

import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import dense_init
from repro_torch.parallel import axes as ax


def init_mlp(generator, cfg: ModelConfig, dtype, device) -> dict:
    D, Fd = cfg.d_model, cfg.d_ff
    return {
        "w_gate": dense_init(generator, D, (Fd,), dtype, device),
        "w_up": dense_init(generator, D, (Fd,), dtype, device),
        "w_down": dense_init(generator, Fd, (D,), dtype, device),
    }


def mlp(p, x, cfg: ModelConfig):
    h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    return ax.shard(h, ax.BATCH, None, ax.TP) @ p["w_down"]
