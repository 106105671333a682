"""Operations and bytes from shapes, and the card's peaks.

The peaks are the NVIDIA H100 SXM data sheet's (dense, without sparsity, at
the 700 W limit).  The counts are frozen copies of ``chip_smoke.py``'s
(``bound``, ``_flash_pairs``, ``_ssd_flops``, ``_ssd_bwd_flops``,
``_train_model_flops``), rewritten on the benchmark's own configuration
files and leaf list: a later change to the port cannot move them.

A kernel's counts (``flash_*``, ``ssd_*``) are shared by every
architecture that calls it.  The model-level counts (``train_flops``,
``prefill_flops``, ``decode_bytes``) take an architecture's leaf list and
its number of sub-layers of each mixer kind (``{"attn": n, "mamba": n}``),
as its architecture module states them (``spec.Architecture``).
"""

from __future__ import annotations

import numpy as np

from benchlib.weights import Leaf

PEAK_BF16_FLOPS = 989e12     # dense bf16 tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12    # HBM3

_ITEM = {"bfloat16": 2, "float16": 2, "float32": 4}


def least_s(n_bytes: float, flops: float,
            peak_flops: float = PEAK_BF16_FLOPS) -> float:
    """The least time a call can take: the larger of its operations over
    the peak rate and its bytes over the memory rate."""
    return max(n_bytes / HBM_BYTES_PER_S, flops / peak_flops)


def flash_pairs(Sq: int, Sk: int, causal: bool, window: int) -> int:
    """Visible (query, key) pairs, the queries right-aligned to the keys:
    query i sits at position i + Sk - Sq; causal keeps keys at or before
    it, a window the last ``window`` of those."""
    qi = np.arange(Sq, dtype=np.int64) + (Sk - Sq)
    hi = np.minimum(qi, Sk - 1) if causal else np.full(Sq, Sk - 1)
    lo = np.maximum(qi - window + 1, 0) if window else np.zeros(Sq, np.int64)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def flash_fwd(B: int, Sq: int, Sk: int, H: int, KV: int, hd: int,
              causal: bool, window: int, lse: bool) -> tuple[float, float]:
    """(bytes, FLOPs) of one forward call in bf16: q, k, v read once, the
    output written once (and the fp32 lse where the train path keeps it);
    two products per visible pair and head."""
    n_bytes = 2 * (2 * B * Sq * H * hd + 2 * B * Sk * KV * hd)
    if lse:
        n_bytes += 4 * B * H * Sq
    return n_bytes, 4 * B * H * hd * flash_pairs(Sq, Sk, causal, window)


def flash_bwd(B: int, S: int, H: int, KV: int, hd: int, causal: bool,
              window: int) -> tuple[float, float]:
    """(bytes, FLOPs) of one backward call in bf16: q, k, v, o, dO and lse
    read once, dq, dk, dv written once; five products of the forward's
    size (scores, dP, dV, dK, dQ)."""
    q, kv = B * S * H * hd, B * S * KV * hd
    n_bytes = 2 * (4 * q + 4 * kv) + 4 * B * H * S
    return n_bytes, 10 * B * H * hd * flash_pairs(S, S, causal, window)


def _chunk_pairs(S: int, chunk: int) -> int:
    return sum(q * (q + 1) // 2
               for q in (min(chunk, S - c0) for c0 in range(0, S, chunk)))


def ssd_flops(B: int, S: int, H: int, P: int, N: int, chunk: int) -> int:
    """Operations of one forward call: C.B^T once per (row, chunk) since B
    and C are shared by the heads, its causal half and diagonal; the
    decayed scores times x*dt per head; the carried-state term and the
    state update."""
    return 2 * B * _chunk_pairs(S, chunk) * (N + H * P) + 4 * B * H * S * N * P


def ssd_bwd_flops(B: int, S: int, H: int, P: int, N: int, chunk: int) -> int:
    """Operations of one backward call: C.B^T once per causal pair of rows;
    per head and causal pair, dy.x, W.B, W^T.C and (G o L)^T.dy; per head
    and row, five [P, N] products (the local state and d(state) again,
    S_in^T dy, dS_out B, dS_out^T x)."""
    pairs = _chunk_pairs(S, chunk)
    return (2 * B * pairs * N + 4 * B * H * pairs * (P + N)
            + 10 * B * H * S * P * N)


def ssd_bytes(B: int, S: int, H: int, P: int, N: int, backward: bool) -> int:
    """Forward: x, B, C (bf16), dt (fp32) and A read once, y (bf16) and the
    fp32 final state written once.  Backward: x, dt, A, B, C and dy read
    once, dx, ddt, dA, dB, dC written once."""
    x, bc, dt = 2 * B * S * H * P, 2 * 2 * B * S * N, 4 * B * S * H
    if backward:
        return 2 * (x + bc + dt + 4 * H) + x
    return x + bc + dt + 4 * H + x + 4 * B * H * P * N


def _is_expert(leaf: Leaf) -> bool:
    return "moe" in leaf.path and leaf.path[-1] != "router"


def train_flops(cfg: dict, leaves: list[Leaf], mixers: dict, B: int,
                S: int) -> float:
    """Model FLOPs of one train step on [B, S] tokens: 6 per active
    parameter per token (the LM head, or the tied embedding, on every
    token; of a MoE layer's experts the k of E each token is routed to;
    the input embedding, a gather, none), three times the forward's
    attention (4 * B * H * hd per visible pair per attention layer) and
    three times the forward's SSD scan per Mamba layer."""
    k_of_e = cfg.get("experts_per_token", 0) / max(cfg.get("n_experts", 0), 1)
    tied = cfg.get("tie_embeddings", False)
    total = 0.0
    for leaf in leaves:
        n = float(np.prod(leaf.shape))
        if leaf.path == ("embed",) and not tied:
            continue
        total += 6 * n * B * S * (k_of_e if _is_expert(leaf) else 1.0)
    if mixers["attn"]:
        total += 3 * mixers["attn"] * 4 * B * cfg["n_heads"] * (
            cfg["head_dim"] * flash_pairs(S, S, True,
                                          cfg.get("sliding_window", 0)))
    if mixers["mamba"]:
        total += 3 * mixers["mamba"] * ssd_flops(B, S, *_ssd_dims(cfg))
    return total


def _ssd_dims(cfg: dict) -> tuple[int, int, int, int]:
    d_in = cfg["ssm_expand"] * cfg["d_model"]
    P = cfg["ssm_head_dim"]
    return d_in // P, P, cfg["ssm_state"], cfg["ssm_chunk"]


def prefill_flops(cfg: dict, leaves: list[Leaf], mixers: dict, B: int,
                  S: int) -> float:
    """Model FLOPs of one prefill of [B, S] tokens: 2 per active parameter
    per token in the layers, the LM head on the last position only, and the
    forward's attention."""
    k_of_e = cfg.get("experts_per_token", 0) / max(cfg.get("n_experts", 0), 1)
    total = 0.0
    for leaf in leaves:
        n = float(np.prod(leaf.shape))
        if leaf.path[0] == "units":
            total += 2 * n * B * S * (k_of_e if _is_expert(leaf) else 1.0)
    total += 2 * cfg["d_model"] * cfg["vocab_size"] * B
    if mixers["attn"]:
        total += mixers["attn"] * 4 * B * cfg["n_heads"] * (
            cfg["head_dim"] * flash_pairs(S, S, True,
                                          cfg.get("sliding_window", 0)))
    if mixers["mamba"]:
        total += mixers["mamba"] * ssd_flops(B, S, *_ssd_dims(cfg))
    return total


def decode_bytes(cfg: dict, leaves: list[Leaf], mixers: dict, B: int,
                 context: int) -> float:
    """Bytes one decode step of B rows reads at least, the new token at
    position ``context`` (so ``context + 1`` positions in the cache): every
    weight of the layers and the LM head once (every expert: B rows of k
    picks each touch nearly all of them), the embedding rows of the B
    tokens, and the cache's K and V of the visible positions."""
    total = 0.0
    for leaf in leaves:
        item = _ITEM[leaf.dtype]
        if leaf.path == ("embed",):
            total += B * leaf.shape[1] * item
            if cfg.get("tie_embeddings", False):
                total += float(np.prod(leaf.shape)) * item
        else:
            total += float(np.prod(leaf.shape)) * item
    if mixers["attn"]:
        window = cfg.get("sliding_window", 0)
        seen = min(context + 1, window) if window else context + 1
        total += (mixers["attn"] * 2 * B * seen * cfg["n_kv_heads"]
                  * cfg["head_dim"] * _ITEM[cfg["dtype"]])
    return total

