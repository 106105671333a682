"""GPipe-style pipeline parallelism over a mesh dimension.

Port of ``repro.parallel.pipeline``.  Stages hold consecutive layer blocks;
microbatches stream through the ring of stages with point-to-point sends
(``torch.distributed.batch_isend_irecv``) where the reference uses
``jax.lax.ppermute`` inside a ``shard_map``.  The schedule is the
reference's GPipe loop: ``M + S - 1`` ticks, stage ``s`` on microbatch
``t - s`` at tick ``t``; the last stage collects microbatch ``t - (S - 1)``,
and its result reaches every rank by a sum in which the other stages add
zeros.

Bubble ticks do not compute here: at a tick where stage ``s`` holds no
microbatch (``t < s`` or ``t - s >= M``) it passes its buffer on without
calling ``stage_fn``, where the reference computes on a stale buffer and
discards the result.  The output is the same either way, since the last
stage collects only the ticks that hold a microbatch; no shift follows the
last tick, which nothing reads.

In metaflow terms each hop is a single-flow metaflow consumed by the next
stage's compute: the DAG is a total order.
"""

from __future__ import annotations

from collections.abc import Callable
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.tree import tree_map


def _shift(y: torch.Tensor, to: int, frm: int, group) -> torch.Tensor:
    """Send ``y`` to global rank ``to`` and receive a tensor like it from
    ``frm``, both posted together."""
    got = torch.empty_like(y)
    ops = [dist.P2POp(dist.isend, y.contiguous(), to, group),
           dist.P2POp(dist.irecv, got, frm, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return got


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params: Any, x: torch.Tensor, *, n_stages: int,
                   stage: int, group=None) -> torch.Tensor:
    """Run on every rank of ``group`` (the stages, in group-rank order).

    Args:
      stage_fn: (params of one stage, act [B, ...]) -> act [B, ...]
      stage_params: this stage's params
      x: [M, B, ...] microbatches, the same on every stage (only stage 0
        injects them)
      n_stages: the group's size
      stage: this rank's stage (its rank in ``group``)

    Returns [M, B, ...], the last stage's outputs, on every stage.
    """
    M, S = x.shape[0], n_stages
    if S > 1:
        to = dist.get_global_rank(group, (stage + 1) % S)
        frm = dist.get_global_rank(group, (stage - 1) % S)
    buf = torch.zeros_like(x[0])
    out = torch.zeros_like(x)
    ticks = M + S - 1
    for t in range(ticks):
        if stage == 0:
            buf = x[min(t, M - 1)]
        m = t - stage                       # this stage's microbatch
        y = stage_fn(stage_params, buf) if 0 <= m < M else buf
        if stage == S - 1 and 0 <= m < M:
            out[m] = y
        if S > 1 and t < ticks - 1:
            buf = _shift(y, to, frm, group)
        else:
            buf = y
    if S > 1:
        if stage != S - 1:
            out.zero_()
        dist.all_reduce(out, group=group)
    return out


def _stage_slice(stacked: Any, stage: int) -> Any:
    """A stage's params from params stacked over stages ([S, ...]): a
    DTensor sharded over the stage dimension gives its local row, a plain
    tensor its row ``stage``."""
    from repro_torch.parallel.axes import is_dtensor

    return tree_map(lambda p: p.to_local()[0] if is_dtensor(p) else
                    p[stage], stacked)


def make_pipelined_fn(stage_fn: Callable, mesh, axis_name: str = "stage",
                      stacked: bool = True):
    """``pipeline_apply`` over the ``axis_name`` dimension of a
    ``DeviceMesh``.

    Returned callable: (params, x [M, B, ...]) -> [M, B, ...], on every
    rank.  With ``stacked`` (the reference's form) every leaf of ``params``
    has a leading stage dimension [S, ...] (whole on every rank, or a
    DTensor sharded over ``axis_name``) and each stage takes its row; else
    ``params`` are this rank's stage's own (a stage that holds only its
    layers)."""
    group = mesh.get_group(axis_name)
    n_stages = dist.get_world_size(group)
    stage = dist.get_rank(group)

    def fn(params, x):
        local = _stage_slice(params, stage) if stacked else params
        return pipeline_apply(stage_fn, local, x, n_stages=n_stages,
                              stage=stage, group=group)

    return fn
