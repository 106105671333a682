"""Explicitly ordered collectives: MSA's schedule made real in the step.

Port of ``repro.parallel.collectives`` on ``torch.distributed``.  The
priority list from ``core.comm_schedule.plan_step_comm`` becomes the order
in which the training step issues its gradient collectives.  XLA may
reorder independent collectives, so the reference chains them through
value dependencies; eager torch issues each call in program order, so
here the order is the loop's and needs no such chain.

Each bucket (a tree of tensors) goes out as one collective per dtype: its
leaves of that dtype are flattened into one buffer and split back after.
So the sequence of calls is the sequence of buckets, and a recording of
the calls (element counts, in issue order) reads the order back.
"""

from __future__ import annotations

from collections.abc import Sequence
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.tree import leaves, unflatten


def _check_order(order: Sequence[int], n: int) -> None:
    if sorted(order) != list(range(n)):
        raise ValueError(f"order {list(order)} is not a permutation of "
                         f"{n} buckets")


def _by_dtype(bucket: Any) -> dict[torch.dtype, list[int]]:
    """Leaf positions of ``bucket`` grouped by dtype, in leaf order."""
    groups: dict[torch.dtype, list[int]] = {}
    for i, x in enumerate(leaves(bucket)):
        groups.setdefault(x.dtype, []).append(i)
    return groups


def _all_reduce_bucket(bucket: Any, group) -> Any:
    xs = leaves(bucket)
    out: list = [None] * len(xs)
    for idx in _by_dtype(bucket).values():
        buf = torch.cat([xs[i].reshape(-1) for i in idx])
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
        parts = torch.split(buf, [xs[i].numel() for i in idx])
        for i, p in zip(idx, parts):
            out[i] = p.view(xs[i].shape)
    return unflatten(bucket, out)


def ordered_psum(buckets: Sequence[Any], order: Sequence[int],
                 group=None) -> list[Any]:
    """All-reduce (sum) each bucket over ``group`` in exactly ``order``,
    synchronously.  Returns the synced buckets in their original
    positions."""
    _check_order(order, len(buckets))
    out: list[Any] = [None] * len(buckets)
    for i in order:
        out[i] = _all_reduce_bucket(buckets[i], group)
    return out


def _reduce_scatter(output: torch.Tensor, input: torch.Tensor, group) -> None:
    fn = getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor
    fn(output, input, op=dist.ReduceOp.SUM, group=group)


def _reduce_scatter_bucket(bucket: Any, group, tiled: bool) -> Any:
    n = dist.get_world_size(group)
    xs = leaves(bucket)
    out: list = [None] * len(xs)
    for idx in _by_dtype(bucket).values():
        for i in idx:
            shape = tuple(xs[i].shape)
            if not shape or (shape[0] % n if tiled else shape[0] != n):
                raise ValueError(f"a {shape} leaf does not scatter over "
                                 f"{n} ranks (tiled={tiled})")
        # Rank r's rows of every leaf, side by side: the buffer is
        # rank-major, so the collective hands rank r its rows of each.
        buf = torch.cat([xs[i].reshape(n, -1) for i in idx], dim=1)
        mine = torch.empty(buf.shape[1], dtype=buf.dtype, device=buf.device)
        _reduce_scatter(mine, buf.reshape(-1), group)
        parts = torch.split(mine, [xs[i].numel() // n for i in idx])
        for i, p in zip(idx, parts):
            shape = xs[i].shape
            out[i] = p.view(((shape[0] // n,) if tiled else ()) + shape[1:])
    return unflatten(bucket, out)


def ordered_psum_scatter(buckets: Sequence[Any], order: Sequence[int],
                         group=None, tiled: bool = True) -> list[Any]:
    """Reduce-scatter variant (FSDP gradient sync): each leaf's leading
    dimension is scattered over ``group``, bucket by bucket in ``order``.
    ``tiled`` keeps the leading axis (rank r takes rows ``[r*k, (r+1)*k)``
    of a leading dimension of n*k); otherwise the leading dimension must
    equal the world size n and rank r's slice drops it."""
    _check_order(order, len(buckets))
    out: list[Any] = [None] * len(buckets)
    for i in order:
        out[i] = _reduce_scatter_bucket(buckets[i], group, tiled)
    return out


def unit_grad_buckets(grads: dict) -> list[Any]:
    """Split a grads tree into one bucket per unit (the metaflows of the
    step DAG; ``grads["units"]`` is the port's list of per-unit trees)
    and one last bucket of the non-unit leaves (embeddings, head, final
    norm)."""
    buckets = list(grads["units"])
    buckets.append({k: v for k, v in grads.items() if k != "units"})
    return buckets


def merge_unit_buckets(buckets: list[Any], template: dict) -> dict:
    """Inverse of ``unit_grad_buckets`` (``template`` is the tree that was
    split; its structure is the buckets')."""
    out = dict(buckets[-1])
    out["units"] = list(buckets[:-1])
    return {k: out[k] for k in template}
