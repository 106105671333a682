"""AdamW with global-norm clipping and a cosine LR schedule.

Port of ``repro.optim.adamw``.  Moments are fp32 whatever the parameter
dtype; the update is computed in fp32 and cast to the parameter's dtype
before it is added, as in JAX.  Unlike JAX, the update is in place and per
leaf: each leaf's fp32 gradient, moments and step live only while that leaf
is updated, so no second fp32 copy of the whole tree exists.  The state and
parameters passed to ``update`` are the ones it returns, modified.

JAX decays the leaves of rank >= 2.  Which leaves those are depends on the
model's tree layout, so ``update`` takes the model's ``decay`` predicate
(``Model.decays``) and applies JAX's rule only where it is given none.
"""

from __future__ import annotations

from collections.abc import Callable
from dataclasses import dataclass
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.tree import leaves, leaves_with_path, tree_map


class AdamWState(NamedTuple):
    step: int              # updates applied so far (a host int)
    m: Any                 # fp32 tree like params
    v: Any                 # fp32 tree like params


def _matrices(path: tuple, p: torch.Tensor) -> bool:
    return p.ndim >= 2


@dataclass(frozen=True)
class AdamW:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def lr(self, step: int) -> float:
        """The schedule at ``step``, in float32 arithmetic as in JAX."""
        f32 = np.float32
        s = f32(step)
        warm = s / f32(max(self.warmup_steps, 1))
        prog = np.clip((s - f32(self.warmup_steps))
                       / f32(max(self.total_steps - self.warmup_steps, 1)),
                       f32(0), f32(1))
        cos = f32(self.min_lr_ratio) + f32((1 - self.min_lr_ratio) * 0.5) * (
            f32(1) + np.cos(f32(np.pi) * prog))
        return float(f32(self.peak_lr) * (warm if s < self.warmup_steps
                                          else cos))

    def init(self, params) -> AdamWState:
        def zeros(t):
            return tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                                  device=x.device), t)
        return AdamWState(step=0, m=zeros(params), v=zeros(params))

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params,
               decay: Callable[[tuple, torch.Tensor], bool] = _matrices
               ) -> tuple[Any, AdamWState, dict]:
        """One step; ``decay(path, p)`` says whether the leaf at ``path``
        takes the decoupled weight decay."""
        gnorm = global_norm(grads)
        scale = torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0)

        step = state.step + 1
        f32 = np.float32
        b1c = float(f32(1) - f32(self.b1) ** f32(step))
        b2c = float(f32(1) - f32(self.b2) ** f32(step))
        lr = self.lr(step)

        for (path, p), g, mu, nu in zip(leaves_with_path(params),
                                        leaves(grads), leaves(state.m),
                                        leaves(state.v)):
            g32 = g.float() * scale
            # JAX's order of operations: b1*mu + (1-b1)*g, b2*nu + (1-b2)*g*g
            mu.mul_(self.b1).add_((1 - self.b1) * g32)
            nu.mul_(self.b2).add_((1 - self.b2) * g32 * g32)
            del g32
            upd = (mu / b1c).div_((nu / b2c).sqrt_().add_(self.eps))
            if decay(path, p):
                upd.add_(p.float(), alpha=self.weight_decay)
            p.add_(upd.mul_(-lr).to(p.dtype))
        metrics = {"grad_norm": gnorm, "lr": lr}
        return params, AdamWState(step=step, m=state.m, v=state.v), metrics


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of sum(x^2), in fp32."""
    return torch.sqrt(torch.stack([x.float().square().sum()
                                   for x in leaves(tree)]).sum())
