"""Train step factory.

Port of ``repro.train.step.make_train_step``: ``(state, batch) -> (state,
metrics)``.  ``torch.autograd.grad`` of the model's loss replaces
``jax.value_and_grad``; on the card the gradients come from the kernels'
backward kernels (``kernels/ops.py``).  ``grad_transform`` is the hook for
explicit gradient paths (collectives, compression), applied before the
optimizer as in JAX.  The optimizer updates the parameters in place, so the
state passed in is consumed.  Under a profiler the forward and the backward
each run in a span (``repro_torch.spans``).
"""

from __future__ import annotations

from collections.abc import Callable

import numpy as np
import torch

from repro_torch.models.registry import Model
from repro_torch.optim.adamw import AdamW
from repro_torch.spans import span
from repro_torch.train.state import TrainState
from repro_torch.tree import leaves, unflatten


def _to_device(batch: dict, device: torch.device) -> dict:
    """numpy arrays (from the data pipeline) or tensors -> tensors on
    ``device``."""
    return {k: (torch.from_numpy(np.ascontiguousarray(v))
                if isinstance(v, np.ndarray) else v).to(device)
            for k, v in batch.items()}


def make_train_step(model: Model, optimizer: AdamW,
                    grad_transform: Callable | None = None,
                    microbatches: int = 1):
    """(state, batch) -> (state, metrics).

    ``microbatches > 1`` splits the batch along its first axis and
    accumulates the gradients in fp32; each is cast back to its parameter's
    dtype after the accumulation and before the optimizer, as in JAX.
    """

    def grads_of(params, batch):
        with span("rt.train.forward"):
            loss, parts = model.loss(params, batch)
        with span("rt.train.backward"):
            grads = torch.autograd.grad(loss, leaves(params))
        return loss.detach(), {k: v.detach() for k, v in parts.items()}, grads

    def train_step(state: TrainState, batch) -> tuple[TrainState, dict]:
        params = state.params
        flat = leaves(params)
        for p in flat:
            p.requires_grad_(True)
        batch = _to_device(batch, flat[0].device)
        if microbatches == 1:
            loss, parts, grads = grads_of(params, batch)
        else:
            rows = next(iter(batch.values())).shape[0]
            if rows % microbatches:
                raise ValueError(f"batch of {rows} rows does not split into "
                                 f"{microbatches} microbatches")
            size = rows // microbatches
            g32 = [torch.zeros_like(p, dtype=torch.float32) for p in flat]
            loss = 0.0
            parts_sum: dict = {}
            for i in range(microbatches):
                mb = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
                l, parts, g = grads_of(params, mb)
                for acc, gi in zip(g32, g):
                    acc.add_(gi.float())
                loss = loss + l
                for k, v in parts.items():
                    parts_sum[k] = parts_sum.get(k, 0.0) + v
            inv = 1.0 / microbatches
            grads = [(a * inv).to(p.dtype) for a, p in zip(g32, flat)]
            del g32
            loss = loss * inv
            parts = {k: v / microbatches for k, v in parts_sum.items()}
        grads = unflatten(params, grads)

        if grad_transform is not None:
            grads = grad_transform(grads)
        params, opt, om = optimizer.update(grads, state.opt, params,
                                           model.decays)
        metrics = {"loss": loss, **parts, **om}
        return TrainState(step=state.step + 1, params=params, opt=opt,
                          rng=state.rng + 1), metrics

    return train_step

