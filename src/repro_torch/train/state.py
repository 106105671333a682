"""Train state: the step, the parameters, the optimizer state and a seed
counter.

Port of ``repro.train.state``.  ``rng`` is a seed counter, not a JAX PRNG
key: the dense loss draws no random numbers, and the port never reproduces
JAX's PRNG.  It starts at ``seed + 1`` and each step adds one, where JAX
folds 1 into its key.
"""

from __future__ import annotations

from typing import Any, NamedTuple

from repro_torch.optim.adamw import AdamW, AdamWState


class TrainState(NamedTuple):
    step: int             # host int
    params: Any
    opt: AdamWState
    rng: int              # seed counter


def init_state(model, optimizer: AdamW, seed: int) -> TrainState:
    """Parameters drawn from ``seed`` on the model's device, zero moments."""
    params = model.init(seed)
    return TrainState(step=0, params=params, opt=optimizer.init(params),
                      rng=seed + 1)
