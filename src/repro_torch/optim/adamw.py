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

CUDA leaves go to the multi-tensor kernels (``kernels/adamw.py``: the
global norm and the update of every leaf in three launches, the same
arithmetic in JAX's order), under a ``rt.train.optimizer`` span; CPU leaves
to the per-leaf loop below, the plain version.  DTensor leaves on the card
run the kernels on their local shards, each leaf's sum of squares summed
over the mesh dimensions where it is sharded.
"""

from __future__ import annotations

from collections.abc import Callable
from dataclasses import dataclass
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.kernels import adamw as _kernels
from repro_torch.parallel.axes import is_dtensor
from repro_torch.spans import span
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

    def _bias_and_lr(self, step: int) -> tuple[float, float, float]:
        """1 - b1**step, 1 - b2**step (float32, as in JAX) and the LR."""
        f32 = np.float32
        return (float(f32(1) - f32(self.b1) ** f32(step)),
                float(f32(1) - f32(self.b2) ** f32(step)), self.lr(step))

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params,
               decay: Callable[[tuple, torch.Tensor], bool] = _matrices
               ) -> tuple[Any, AdamWState, dict]:
        """One step; ``decay(path, p)`` says whether the leaf at ``path``
        takes the decoupled weight decay.  CUDA leaves go to the kernels,
        CPU leaves to :meth:`plain_update`."""
        pairs = leaves_with_path(params)
        if not pairs or pairs[0][1].device.type != "cuda":
            return self.plain_update(grads, state, params, decay)
        step = state.step + 1
        b1c, b2c, lr = self._bias_and_lr(step)
        with span("rt.train.optimizer"):
            gnorm = self._kernel_update(pairs, leaves(grads), leaves(state.m),
                                        leaves(state.v), decay, b1c, b2c, lr)
        return params, AdamWState(step=step, m=state.m, v=state.v), {
            "grad_norm": gnorm, "lr": lr}

    @torch.no_grad()
    def plain_update(self, grads, state: AdamWState, params,
                     decay: Callable[[tuple, torch.Tensor], bool] = _matrices
                     ) -> tuple[Any, AdamWState, dict]:
        """:meth:`update` as the plain version: a leaf at a time in eager
        torch, on any device."""
        step = state.step + 1
        b1c, b2c, lr = self._bias_and_lr(step)
        gnorm = global_norm(grads)
        scale = torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0)
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

    def _kernel_update(self, pairs, grads, ms, vs, decay, b1c: float,
                       b2c: float, lr: float) -> torch.Tensor:
        """The kernels' step on CUDA leaves (local shards of DTensors)."""
        params = [p for _, p in pairs]
        sum_over = None
        if is_dtensor(params[0]):
            for p, g, m, v in zip(params, grads, ms, vs):
                if not (g.placements == m.placements == v.placements
                        == p.placements):
                    raise ValueError(
                        f"AdamW: gradient and moments placed as "
                        f"{g.placements}, {m.placements}, {v.placements}, "
                        f"their parameter as {p.placements}")
            sum_over = [tuple(p.device_mesh.get_group(i)
                              for i, pl in enumerate(p.placements)
                              if pl.is_shard()) for p in params]
            params, grads, ms, vs = ([t.to_local() for t in ts]
                                     for ts in (params, grads, ms, vs))
        return _kernels.step(
            params, grads, ms, vs, [decay(path, p) for path, p in pairs],
            b1=self.b1, b2=self.b2, eps=self.eps,
            weight_decay=self.weight_decay, clip_norm=self.clip_norm,
            b1c=b1c, b2c=b2c, lr=lr, sum_over=sum_over)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of sum(x^2), in fp32."""
    return torch.sqrt(torch.stack([x.float().square().sum()
                                   for x in leaves(tree)]).sum())
