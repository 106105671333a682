"""Mixture-of-Experts FFN: top-k routing into per-expert capacity buffers.

Port of ``repro.models.moe``.  Groups are batch rows: each row's (token, choice) pairs are stably sorted by
expert, the first ``capacity`` pairs of each expert go into an
[B, E, C, D] buffer and the rest are dropped (their residual passes
through), the experts run as batched products over E (``torch.einsum``,
cuBLAS, as the JAX package computes them outside any Pallas kernel), and
the results are added back to their tokens weighted by the router
probabilities.

Every shape depends only on the config and the input's shape, never on the
routing: no boolean indexing, no ``nonzero``.  So the recompute of
``torch.utils.checkpoint`` sees the metadata of the first pass, and the
path can be captured in a CUDA graph.

On a mesh (DTensors) the routing, dispatch and combine run on each rank's
own rows (a group never spans ranks), and the expert products on
DTensors, annotated as the reference annotates them: with ``cfg.moe_ep``
the buffer's expert axis is sharded over ``model`` (the buffer goes
``Replicate`` -> ``Shard(E)`` for the products -> ``Replicate`` for the
combine, where XLA uses all-to-alls), else each expert's hidden dimension
is (TP within the expert).

Under a profiler ``moe_ffn`` runs its parts in the spans ``rt.moe.route``,
``rt.moe.dispatch``, ``rt.moe.experts`` and ``rt.moe.combine``, and counts
its kept pairs and buffer rows (``repro_torch.spans``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import dense_init
from repro_torch.parallel import axes as ax
from repro_torch.spans import count_moe, span

#: Leaves the JAX init keeps in float32 whatever the config's dtype.
FP32_PARAMS = ("router",)


def init_moe(generator: torch.Generator, cfg: ModelConfig, dtype,
             device) -> dict:
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.n_experts

    def stack(d_in: int, d_out: int) -> torch.Tensor:
        return torch.stack([dense_init(generator, d_in, (d_out,), dtype,
                                       device) for _ in range(E)])

    return {
        "router": dense_init(generator, D, (E,), torch.float32, device),
        "w_gate": stack(D, Fd),
        "w_up": stack(D, Fd),
        "w_down": stack(Fd, D),
    }


def capacity(cfg: ModelConfig, tokens_per_group: int) -> int:
    c = int(tokens_per_group * cfg.experts_per_token * cfg.capacity_factor
            / max(cfg.n_experts, 1))
    return max(c, 1)


def route_topk(router_logits: torch.Tensor, cfg: ModelConfig):
    """[..., E] -> (expert indices [..., k], probabilities [..., k]): the k
    largest logits, renormalised by a softmax over them.

    ``jax.lax.top_k`` puts the lower index first among equal values; a
    stable descending sort does the same (``torch.topk`` does not promise
    an order for ties).
    """
    k = cfg.experts_per_token
    vals, idx = torch.sort(router_logits, dim=-1, descending=True,
                           stable=True)
    probs = torch.softmax(vals[..., :k], dim=-1)
    return idx[..., :k], probs.to(router_logits.dtype)


class Routing(NamedTuple):
    """Each row's (token, choice) pairs, sorted by expert: [B, k*S] each."""

    tok: torch.Tensor     # source token of the pair
    prob: torch.Tensor    # its router probability
    keep: torch.Tensor    # whether it fits in its expert's capacity
    dest: torch.Tensor    # its buffer row e*C + position, or E*C (dropped)


def route(logits: torch.Tensor, cfg: ModelConfig) -> Routing:
    """Router logits [B, S, E] -> the dispatch of ``moe_ffn``."""
    B, S, E = logits.shape
    C, T = capacity(cfg, S), cfg.experts_per_token * S
    top_idx, probs = route_topk(logits, cfg)                  # [B, S, k]
    # Choice-major flattening: every top-1 pick claims capacity before any
    # top-2 pick (GShard priority).
    e_flat = top_idx.transpose(1, 2).reshape(B, T)
    p_flat = probs.transpose(1, 2).reshape(B, T)
    sort_ix = torch.argsort(e_flat, dim=1, stable=True)
    e_sorted = e_flat.gather(1, sort_ix)
    counts = F.one_hot(e_flat, E).sum(1)                      # [B, E]
    seg_start = counts.cumsum(1) - counts                     # exclusive
    pos_in_e = (torch.arange(T, device=logits.device)
                - seg_start.gather(1, e_sorted))
    keep = pos_in_e < C
    dest = torch.where(keep, e_sorted * C + pos_in_e, E * C)
    return Routing(tok=sort_ix % S, prob=p_flat.gather(1, sort_ix),
                   keep=keep, dest=dest)


def moe_ffn(p, x: torch.Tensor, cfg: ModelConfig):
    """x [B, S, D] -> (y [B, S, D], router logits [B, S, E] in float32).

    dtypes as in JAX: the router in float32; the buffer, the weights (cast)
    and the products in ``x.dtype``; the weighted sum in ``x.dtype``.
    """
    B, S, D = x.shape
    E, C = cfg.n_experts, capacity(cfg, S)
    with span("rt.moe.route"):
        logits = x.float() @ p["router"]
        # This rank's rows (all of them off a mesh).
        xl = ax.local(x)
        r = route(ax.local(ax.shard(logits, ax.BATCH, None, None)), cfg)
    b = xl.shape[0]
    count_moe(r.keep, b * E * C)

    def rows(t: torch.Tensor) -> torch.Tensor:          # [B, T] -> [B, T, D]
        return t[..., None].expand(-1, -1, D)

    with span("rt.moe.dispatch"):
        x_src = xl.gather(1, rows(r.tok))
        # Kept pairs have distinct rows; dropped ones all land on the extra
        # row E*C, which is cut off.
        buf = xl.new_zeros(b, E * C + 1, D).scatter(1, rows(r.dest), x_src)
        buf = ax.like(buf[:, :E * C].reshape(b, E, C, D), x)
        spec_e = ax.EP if cfg.moe_ep else None
        buf = ax.shard(buf, ax.BATCH, spec_e, None, None)
    with span("rt.moe.experts"):
        w_gate, w_up, w_down = (p[n].to(x.dtype) for n in ("w_gate", "w_up",
                                                           "w_down"))
        h = (F.silu(torch.einsum("becd,edf->becf", buf, w_gate))
             * torch.einsum("becd,edf->becf", buf, w_up))
        if not cfg.moe_ep:
            h = ax.shard(h, ax.BATCH, None, None, ax.TP)
        out = torch.einsum("becf,efd->becd", h, w_down)
        out = ax.shard(out, ax.BATCH, spec_e, None, None)
        out = ax.local(ax.shard(out, ax.BATCH, None, None, None))
    with span("rt.moe.combine"):
        out = F.pad(out.reshape(b, E * C, D), (0, 0, 0, 1))  # drop row: 0
        w = (r.prob * r.keep).to(x.dtype)[..., None]
        # Each token receives k <= 2 terms into a zeroed row, and a + b ==
        # b + a in floating point, so the card's atomic adds give the same
        # sum in any order: the result is deterministic.
        y = xl.new_zeros(b, S, D).scatter_add(1, rows(r.tok),
                                              out.gather(1, rows(r.dest)) * w)
    return ax.like(y, x), logits


def moe_ffn_dense_reference(p, x: torch.Tensor, cfg: ModelConfig):
    """Oracle: every expert on every token, weighted by the renormalised
    top-k probabilities, nothing dropped.  Equals ``moe_ffn`` when the
    capacity factor is generous."""
    logits = x.float() @ p["router"]
    top_idx, probs = route_topk(logits, cfg)
    y = torch.zeros_like(x)
    for e in range(cfg.n_experts):
        h = F.silu(x @ p["w_gate"][e]) * (x @ p["w_up"][e])
        o = h @ p["w_down"][e]
        w = (probs * (top_idx == e)).sum(-1)                  # [B, S]
        y = y + o * w[..., None].to(x.dtype)
    return y, logits


def load_balancing_loss(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Switch/GShard auxiliary loss ``E * sum_e f_e * p_e``: f the share of
    tokens whose top-1 expert is e, p the mean router probability of e.  On
    a mesh every rank computes it from all the rows' logits (gathered)."""
    if ax.is_dtensor(logits):
        return ax.like_replicated(load_balancing_loss(ax.full(logits), cfg),
                                  logits)
    E = cfg.n_experts
    probs = torch.softmax(logits, dim=-1)                     # [B, S, E]
    f = F.one_hot(logits.argmax(-1), E).float().mean((0, 1))
    return E * (f * probs.mean((0, 1))).sum()
