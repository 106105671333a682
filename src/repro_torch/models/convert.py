"""Parameters of the JAX package, as numpy arrays, into the port's layout.

The JAX tree stacks the layers of each ``transformer.STACKED`` subtree (the
units ``units/sub{j}/...``, the encoder-decoder's ``enc_layers`` and
``dec_layers``) as arrays of shape [L, ...]; the port keeps a list with one
dict per layer.  Weights stay [in, out] for ``x @ w`` on both sides, so
nothing is transposed.  Each leaf takes the dtype the JAX init gives it: the
config's dtype (the cross-attention's too), except the Mamba and MoE leaves
that stay float32 (``mamba.FP32_PARAMS``, ``moe.FP32_PARAMS``: the SSM decay
and skip parameters, the router).  This is how the tests make the JAX model
and the port compute the same function.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import mamba, moe
from repro_torch.models.common import cdtype
from repro_torch.models.transformer import STACKED

#: Float32 leaves by the name of the dict that holds them.
_FP32 = {"mamba": mamba.FP32_PARAMS, "moe": moe.FP32_PARAMS}


def _map(tree: dict, fn, path: tuple[str, ...] = ()) -> dict:
    return {k: _map(v, fn, path + (k,)) if isinstance(v, dict)
            else fn(path + (k,), v) for k, v in tree.items()}


def _first_leaf(tree: dict):
    v = next(iter(tree.values()))
    return _first_leaf(v) if isinstance(v, dict) else v


def from_jax_params(tree: dict, cfg: ModelConfig,
                    device: str | torch.device = "cuda") -> dict:
    """``tree``: the JAX ``init_lm`` or ``init_encdec`` parameter dict with
    numpy (or any array-like) leaves.  Returns the port's parameter dict on
    ``device``, each leaf in the dtype the JAX init gives it."""

    def tensor(path: tuple[str, ...], a) -> torch.Tensor:
        fp32 = len(path) >= 2 and path[-1] in _FP32.get(path[-2], ())
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(
            device=device, dtype=torch.float32 if fp32 else cdtype(cfg))

    params = {k: tensor((k,), v) for k, v in tree.items()
              if k not in STACKED}
    for key in STACKED:
        if key in tree:
            params[key] = [
                _map(tree[key],
                     lambda path, a, i=i: tensor(path, np.asarray(a)[i]))
                for i in range(len(_first_leaf(tree[key])))]
    return params
