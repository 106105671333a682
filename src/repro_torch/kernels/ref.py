"""Plain PyTorch versions of the port's kernels (the allclose ground truth).

Port of ``repro.kernels.ref``, plus the Mamba-2 model's chunked SSD scan
(``repro.models.mamba.ssd_scan``).  The ops dispatch
(``repro_torch.kernels.ops``) runs these for CPU tensors, and
``chip_smoke.py`` holds each kernel against them on the card.  They are
written in differentiable torch, so autograd through them is the plain
version of each backward kernel.
"""

from __future__ import annotations

import math

import torch


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q [B,H,Sq,hd], k/v [B,KV,Sk,hd] (KV divides H) -> [B,H,Sq,hd]."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    kx = k.repeat_interleave(G, dim=1)
    vx = v.repeat_interleave(G, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kx.float()) * scale
    qi = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)  # right-aligned
    kj = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kj <= qi
    if window:
        mask &= kj > qi - window
    s = s.masked_fill(~mask, -math.inf)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p, vx)


def rmsnorm_ref(x, scale, eps: float = 1e-5):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def cross_entropy_ref(logits, labels):
    """Per-row NLL [T] in fp32 of logits [T, V] (any float dtype) and labels
    [T]: ``logsumexp(logits) - logits[label]``.  Labels are clamped at 0, so
    a negative-label row gives ``lse - logits[row, 0]``; callers mask it."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = lf.gather(-1, labels.long().clamp(min=0)[:, None])[:, 0]
    return lse - ll


def ssd_ref(x, dt, A, Bm, Cm, initial_state=None):
    """Sequential SSD recurrence (the semantic definition, O(S) steps).

    x [B,S,H,P], dt [B,S,H] (post-softplus), A [H], Bm/Cm [B,S,N].
    Returns (y [B,S,H,P] in x's dtype, final_state [B,H,P,N] fp32).
    """
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    state = (torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
             if initial_state is None else initial_state)
    ys = []
    for t in range(S):
        decay = torch.exp(dt[:, t] * A[None, :])                      # [B,H]
        upd = ((x[:, t].float() * dt[:, t, :, None])[..., None]
               * Bm[:, t].float()[:, None, None, :])                    # [B,H,P,N]
        state = state * decay[..., None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", state, Cm[:, t].float()))
    return torch.stack(ys, dim=1).to(x.dtype), state


def _segsum(x):
    """out[..., i, j] = sum_{j < k <= i} x[..., k] for j <= i, -inf above."""
    T = x.shape[-1]
    cs = x.cumsum(-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((T, T), dtype=torch.bool, device=x.device).tril()
    return out.masked_fill(~mask, -math.inf)


def ssd_scan_ref(x, dt, A, Bm, Cm, chunk: int, initial_state=None):
    """The Mamba-2 model's chunked SSD scan (paper Listing 1), batched.

    Port of ``repro.models.mamba.ssd_scan``, including ``initial_state``
    and the chunk shrink: a sequence that is not a multiple of the chunk
    runs with chunk ``gcd(S, chunk)``.  Shapes as in :func:`ssd_ref`;
    returns (y in x's dtype, final_state fp32).

    All arithmetic is fp32, as in the Pallas kernel, the sequential
    recurrence and the CUDA kernel.  The JAX model's scan rounds ``x*dt``
    and ``C.B^T`` to x's dtype; for bf16 inputs those roundings move y by up
    to a few bf16 steps of the largest term where the terms cancel, further
    from the Pallas kernel than a 3e-2 allclose allows, so a plain version
    with them could not hold the kernel to that tolerance.  For float32
    inputs the two are the same function.
    """
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    if S % Q:
        Q = math.gcd(S, Q)   # short/ragged sequences: shrink the chunk
    dtA = (dt * A[None, None, :]).float()                       # [B,S,H]
    xdt = x.float() * dt[..., None]                             # [B,S,H,P]
    state = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
             if initial_state is None else initial_state)
    ys = []
    for c0 in range(0, S, Q):
        xq, dA = xdt[:, c0:c0 + Q], dtA[:, c0:c0 + Q]
        Bq, Cq = Bm[:, c0:c0 + Q].float(), Cm[:, c0:c0 + Q].float()
        csum = dA.cumsum(1)                                     # [B,Q,H]
        # 1. diagonal block: Y = (C B^T o L) X
        L = torch.exp(_segsum(dA.transpose(1, 2)))              # [B,H,Q,Q]
        scores = torch.einsum("bqn,bkn->bqk", Cq, Bq)           # [B,Q,Q]
        y_diag = torch.einsum("bhqk,bkhp->bqhp", scores[:, None] * L, xq)
        # 2. contribution of the incoming state
        y_off = (torch.einsum("bqn,bhpn->bqhp", Cq, state)
                 * torch.exp(csum)[..., None])
        # 3. state update
        total = dA.sum(1)                                       # [B,H]
        decay_end = torch.exp(total[:, None, :] - csum)         # [B,Q,H]
        chunk_state = torch.einsum("bkn,bkhp->bhpn", Bq,
                                   xq * decay_end[..., None])
        state = state * torch.exp(total)[..., None, None] + chunk_state
        ys.append((y_diag + y_off).to(x.dtype))
    return torch.cat(ys, dim=1), state
