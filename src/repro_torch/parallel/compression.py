"""Int8 gradient compression with error feedback.

Port of ``repro.parallel.compression``.  Each leaf's gradient plus its
residual is quantized to int8 with one scale per leaf before it would
cross the network (4x less traffic than fp32), and the quantization
residual is kept locally and added back at the next step (error feedback,
Seide et al. / Karimireddy et al.), so the compression noise does not
accumulate into the optimizer.

``compress_grads`` plugs into ``make_train_step``'s ``grad_transform``
(``make_compressing_step``).  The transform is plain eager torch, leaf by
leaf, with one scale per leaf of the JAX tree (``compress_grads``) and the
reference's arithmetic: both ``jnp.round`` and ``torch.round`` round half
to even and the scale divides, so the int8 codes, the dequantized
gradients and the residuals equal the JAX function's bit for bit on the
same inputs.  Unlike JAX, the residual is
updated in place: the ``EFState`` passed in is the one returned, modified,
so no second fp32 copy of the parameters' size exists.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.models.transformer import STACKED
from repro_torch.train.step import make_train_step
from repro_torch.tree import leaves, leaves_with_path, tree_map, unflatten


class EFState(NamedTuple):
    residual: Any     # fp32 tree like the parameters, on their device


def init_ef(params) -> EFState:
    return EFState(residual=tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params))


def _scale(amax: torch.Tensor) -> torch.Tensor:
    # A tensor divisor: CUDA divides by a Python number as a product with
    # its rounded reciprocal, one float32 step off the quotient for ~5% of
    # the maxima, where the CPU and JAX divide.
    return torch.clamp(amax, min=1e-12) / amax.new_full((), 127.0)


def _codes(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.round(x / scale).clamp_(-127, 127).to(torch.int8)


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(int8 codes, fp32 scale): scale = max(max|x|, 1e-12) / 127."""
    scale = _scale(x.abs().amax())
    return _codes(x, scale), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _jax_leaf(path: tuple) -> tuple:
    """The path of the JAX tree's leaf that holds the port's leaf at
    ``path``: the JAX tree stacks a ``STACKED`` subtree's layers into one
    leaf, where the port keeps a list with one tree per layer."""
    if path and path[0] in STACKED and len(path) > 1 \
            and isinstance(path[1], int):
        return (path[0],) + path[2:]
    return path


@torch.no_grad()
def compress_grads(grads, ef: EFState) -> tuple[Any, EFState, dict]:
    """Quantize (grad + residual) per leaf of the JAX tree; return the
    dequantized grads (what the collective would carry) in each grad's
    dtype, the new residual (grad + residual - dequantized, in fp32,
    written into ``ef``'s tensors) and ``ef_residual_sq``, the sum of its
    squares.

    A layer's leaf of a stacked subtree (the units, an encoder-decoder's
    layers) shares one scale with the same leaf of every other layer, as
    the one stacked leaf of the JAX tree has one scale: the largest |x|
    over all of them.
    """
    paths, gs = zip(*leaves_with_path(grads))
    xs = [r.add_(g) for g, r in zip(gs, leaves(ef.residual))]  # g.float() + r
    groups: dict[tuple, list[int]] = {}
    for i, path in enumerate(paths):
        groups.setdefault(_jax_leaf(path), []).append(i)
    scales: list = [None] * len(xs)
    for idx in groups.values():
        scale = _scale(torch.stack([xs[i].abs().amax() for i in idx]).amax())
        for i in idx:
            scales[i] = scale
    deq, err = [], 0.0
    for g, x, scale in zip(gs, xs, scales):
        d = dequantize_int8(_codes(x, scale), scale)
        x.sub_(d)                                 # the residual
        err = err + x.square().sum()
        deq.append(d.to(g.dtype))
    return unflatten(grads, deq), ef, {"ef_residual_sq": err}


def make_compressing_step(model, optimizer, microbatches: int = 1):
    """Train step whose gradients pass through int8 + error feedback.

    The carry is ``(TrainState, EFState)``; the metrics add the residual
    energy ``ef_residual_sq``.
    """
    holder: dict = {}

    def transform(grads):
        deq, holder["ef"], holder["m"] = compress_grads(grads, holder["ef"])
        return deq

    inner = make_train_step(model, optimizer, grad_transform=transform,
                            microbatches=microbatches)

    def step(carry, batch):
        state, ef = carry
        holder["ef"] = ef
        new_state, metrics = inner(state, batch)
        metrics.update(holder.pop("m"))
        return (new_state, holder.pop("ef")), metrics

    return step
