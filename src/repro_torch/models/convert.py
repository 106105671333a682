"""Parameters of the JAX package, as numpy arrays, into the port's layout.

The JAX tree stacks the units as ``units/sub{j}/...`` arrays of shape
[U, ...]; the port keeps a list with one dict per unit.  Weights stay
[in, out] for ``x @ w`` on both sides, so nothing is transposed.  This is
how the tests make the JAX model and the port compute the same function.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import cdtype
from repro_torch.models.transformer import n_units


def _map(tree: dict, fn) -> dict:
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def from_jax_params(tree: dict, cfg: ModelConfig,
                    device: str | torch.device = "cuda") -> dict:
    """``tree``: the JAX ``init_lm`` parameter dict with numpy (or any
    array-like) leaves.  Returns the port's parameter dict on ``device`` in
    the config's dtype."""
    dtype = cdtype(cfg)

    def tensor(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(
            device=device, dtype=dtype)

    params = {k: tensor(v) for k, v in tree.items() if k != "units"}
    params["units"] = [_map(tree["units"], lambda a, u=u: tensor(np.asarray(a)[u]))
                       for u in range(n_units(cfg))]
    return params
