"""The tiling of the bf16 flash-attention kernels, on the CPU.

The tensor-core kernels (``csrc/flash_attention.cu``,
``csrc/flash_attention_bwd.cu``) visit only the tiles that can hold a live
(query, key) pair and apply the per-element mask only on tiles that also
hold a dead one.  ``kernels/flash_attention.py`` mirrors those walks
(``key_tiles``, ``query_tiles``, ``tile_needs_mask``) and the tile sizes;
these tests hold the mirror to the sources' constants and to the mask's
definition over many shapes: every live pair lies in a visited tile, every
skipped tile is wholly masked, and every tile that skips the mask is wholly
live.  The backward's walks are held over self-attention and over
attention without the causal mask with Sq != Sk (cross-attention, keys
longer or shorter than the queries, with and without a window), the
shapes its launcher takes.

A blocked emulation of the three kernels at those tiles (the forward's
online softmax in log2 units, P rounded to bf16 for P.V; the dQ pass and the
dK/dV pass with P and dS rounded to bf16 where the kernels round them) is
then held against ``ref.flash_attention_ref`` and autograd through it with
the card's tolerances: output 2e-2 (bf16), lse 2e-5, gradients 2e-2
relative and 2e-2 of the gradient's largest entry.  The plain version
itself is held to the Pallas kernel in ``tests/test_torch_kernels.py``.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ref
from repro_torch.launch import profile_serve

CSRC = Path(tfa.__file__).resolve().parent / "csrc"
FLASH_TOL, LSE_TOL, BWD_TOL = 2e-2, 2e-5, 2e-2
LOG2E = 1.0 / math.log(2.0)

# (Sq, Sk, causal, window): lengths around the 64- and 128-row tiles,
# queries right-aligned (Sq < Sk), windows inside one tile and across tiles.
SHAPES = [(1, 1, True, 0), (5, 5, True, 0), (63, 63, True, 0),
          (64, 64, True, 0), (65, 65, False, 0), (127, 127, True, 0),
          (128, 128, True, 0), (129, 129, True, 0), (200, 200, False, 0),
          (300, 300, True, 1), (300, 300, True, 32), (300, 300, True, 70),
          # a window edge on a tile edge, for each tile size
          (300, 300, True, 66), (260, 260, True, 2), (300, 300, True, 127),
          (300, 300, False, 63), (300, 300, True, 31),
          (513, 513, True, 128), (513, 513, False, 100), (257, 257, True, 200),
          (64, 256, True, 0), (129, 300, True, 0), (1, 200, True, 0),
          (100, 400, True, 64), (129, 300, False, 0),
          # without the causal mask, keys of another length: whisper's
          # cross-attention (448 text rows against 1500 frames), fewer keys
          # than queries, a window that leaves the first keys unseen
          (448, 1500, False, 0), (300, 129, False, 0), (1, 300, False, 0),
          (100, 400, False, 64), (300, 129, False, 40)]
# The shapes the backward kernel takes: Sq == Sk, or no causal mask.
BWD = [s for s in SHAPES if s[0] == s[1] or not s[2]]


def _live(Sq: int, Sk: int, causal: bool, window: int) -> torch.Tensor:
    """[Sq, Sk] bool: the mask of ``ref.flash_attention_ref``."""
    qi = torch.arange(Sq)[:, None] + (Sk - Sq)
    kj = torch.arange(Sk)[None, :]
    live = torch.ones(Sq, Sk, dtype=torch.bool)
    if causal:
        live &= kj <= qi
    if window:
        live &= kj > qi - window
    return live


def _check_walk(live, rows0: int, n_rows: int, tiles: range, tile: int,
                n_tiles: int, masked, by_key: bool) -> None:
    """Over the tiles of one block (rows ``rows0`` .. ``+n_rows`` of the
    block's axis): skipped tiles are dead, unmasked ones wholly live."""
    assert 0 <= tiles.start and tiles.stop <= n_tiles
    for t in range(n_tiles):
        sl = slice(t * tile, (t + 1) * tile)
        blk = (live[sl, rows0:rows0 + n_rows] if by_key
               else live[rows0:rows0 + n_rows, sl])
        if t not in tiles:
            assert not blk.any(), f"tile {t} skipped but holds a live pair"
        elif not masked(t * tile):
            full = (tile, n_rows) if by_key else (n_rows, tile)
            assert blk.shape == full and blk.all(), f"tile {t} unmasked"


def test_tiles_match_the_kernel_sources():
    fwd = (CSRC / "flash_attention.cu").read_text()
    bwd = (CSRC / "flash_attention_bwd.cu").read_text()

    def const(src, name):
        return int(re.search(rf"static constexpr int {name} = (\d+);",
                             src).group(1))

    assert tfa.FWD_TILES == (const(fwd, "BM"), const(fwd, "BN"))
    assert tfa.BWD_DQ_TILES == (const(bwd, "BM"), const(bwd, "BN"))
    assert tfa.BWD_DKV_TILES == (const(bwd, "BK"), const(bwd, "BQ"))


@pytest.mark.parametrize("Sq,Sk,causal,window", SHAPES)
def test_forward_walk_covers_every_live_pair(Sq, Sk, causal, window):
    live = _live(Sq, Sk, causal, window)
    bm, bn = tfa.FWD_TILES
    for q0 in range(0, Sq, bm):
        tiles = tfa.key_tiles(q0, bm, bn, Sq, Sk, causal, window)
        _check_walk(live, q0, bm, tiles, bn, math.ceil(Sk / bn),
                    lambda k0: tfa.tile_needs_mask(q0, bm, k0, bn, Sq, Sk,
                                                   causal, window),
                    by_key=False)


@pytest.mark.parametrize("Sq,Sk,causal,window", BWD)
def test_dq_pass_walk_covers_every_live_pair(Sq, Sk, causal, window):
    live = _live(Sq, Sk, causal, window)
    bm, bn = tfa.BWD_DQ_TILES
    for q0 in range(0, Sq, bm):
        tiles = tfa.key_tiles(q0, bm, bn, Sq, Sk, causal, window)
        _check_walk(live, q0, bm, tiles, bn, math.ceil(Sk / bn),
                    lambda k0: tfa.tile_needs_mask(q0, bm, k0, bn, Sq, Sk,
                                                   causal, window),
                    by_key=False)


@pytest.mark.parametrize("Sq,Sk,causal,window", BWD)
def test_dkv_pass_walk_covers_every_live_pair(Sq, Sk, causal, window):
    live = _live(Sq, Sk, causal, window)
    bk, bq = tfa.BWD_DKV_TILES
    for k0 in range(0, Sk, bk):
        tiles = tfa.query_tiles(k0, bk, bq, Sq, Sk, causal, window)
        _check_walk(live, k0, bk, tiles, bq, math.ceil(Sq / bq),
                    lambda q0: tfa.tile_needs_mask(q0, bq, k0, bk, Sq, Sk,
                                                   causal, window),
                    by_key=True)


# ------------------------------------------------------ blocked emulation
# Layout [B, heads, S, hd] in float32 holding bf16 values: a product of
# bf16 values accumulated in fp32, as wgmma computes it (up to the order of
# the sums).

def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _emulate_fwd(q, k, v, causal: bool, window: int):
    """The forward kernel: out [B, H, Sq, hd] (bf16 values), lse [B, H, Sq]."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G = H // KV
    bm, bn = tfa.FWD_TILES
    live = _live(Sq, Sk, causal, window)
    scale_log2 = LOG2E / math.sqrt(hd)
    out = torch.zeros(B, H, Sq, hd)
    lse = torch.zeros(B, H, Sq)
    for h in range(H):
        kh, vh = k[:, h // G], v[:, h // G]
        for q0 in range(0, Sq, bm):
            qb = q[:, h, q0:q0 + bm]
            m = torch.full(qb.shape[:2], -1e30)
            l = torch.zeros(qb.shape[:2])
            acc = torch.zeros(qb.shape)
            for t in tfa.key_tiles(q0, bm, bn, Sq, Sk, causal, window):
                k0 = t * bn
                s = qb @ kh[:, k0:k0 + bn].transpose(1, 2) * scale_log2
                dead = torch.zeros(s.shape[1:], dtype=torch.bool)
                if tfa.tile_needs_mask(q0, bm, k0, bn, Sq, Sk, causal, window):
                    dead = ~live[q0:q0 + bm, k0:k0 + bn]
                s = s.masked_fill(dead, -1e30)
                m_new = torch.maximum(m, s.amax(-1))
                alpha = torch.exp2(m - m_new)
                p = torch.exp2(s - m_new[..., None]).masked_fill(dead, 0.0)
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[..., None] + _bf16(p) @ vh[:, k0:k0 + bn]
                m = m_new
            denom = l.clamp(min=1e-30)
            out[:, h, q0:q0 + bm] = _bf16(acc / denom[..., None])
            lse[:, h, q0:q0 + bm] = m * math.log(2.0) + denom.log()
    return out, lse


def _emulate_bwd(q, k, v, out, lse, dout, causal: bool, window: int):
    """The two backward passes: (dq, dk, dv), bf16 values."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G = H // KV
    live = _live(Sq, Sk, causal, window)
    scale = 1.0 / math.sqrt(hd)
    D = (dout * out).sum(-1)                                 # [B, H, S]

    def p_ds(h, q0, bq, k0, bk):
        """P and dS (bf16 values) of query rows q0.. x keys k0.. of head h."""
        qb, gb = q[:, h, q0:q0 + bq], dout[:, h, q0:q0 + bq]
        kb, vb = k[:, h // G, k0:k0 + bk], v[:, h // G, k0:k0 + bk]
        s = qb @ kb.transpose(1, 2)
        p = torch.exp2(s * scale * LOG2E
                       - lse[:, h, q0:q0 + bq, None] * LOG2E)
        if tfa.tile_needs_mask(q0, bq, k0, bk, Sq, Sk, causal, window):
            p = p.masked_fill(~live[q0:q0 + bq, k0:k0 + bk], 0.0)
        dp = gb @ vb.transpose(1, 2)
        return p, _bf16(p * (dp - D[:, h, q0:q0 + bq, None]))

    dq = torch.zeros_like(q)
    bm, bn = tfa.BWD_DQ_TILES
    for h in range(H):
        for q0 in range(0, Sq, bm):
            acc = torch.zeros_like(q[:, h, q0:q0 + bm])
            for t in tfa.key_tiles(q0, bm, bn, Sq, Sk, causal, window):
                _, ds = p_ds(h, q0, bm, t * bn, bn)
                acc = acc + ds @ k[:, h // G, t * bn:(t + 1) * bn]
            dq[:, h, q0:q0 + bm] = _bf16(acc * scale)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    bk, bq = tfa.BWD_DKV_TILES
    for kvh in range(KV):
        for k0 in range(0, Sk, bk):
            # zero where no query row sees these keys, as the kernel writes
            acc_k = torch.zeros_like(k[:, kvh, k0:k0 + bk])
            acc_v = torch.zeros_like(acc_k)
            for h in range(kvh * G, (kvh + 1) * G):
                for t in tfa.query_tiles(k0, bk, bq, Sq, Sk, causal, window):
                    p, ds = p_ds(h, t * bq, bq, k0, bk)
                    rows = slice(t * bq, (t + 1) * bq)
                    acc_v = acc_v + _bf16(p).transpose(1, 2) @ dout[:, h, rows]
                    acc_k = acc_k + ds.transpose(1, 2) @ q[:, h, rows]
            dk[:, kvh, k0:k0 + bk] = _bf16(acc_k * scale)
            dv[:, kvh, k0:k0 + bk] = _bf16(acc_v)
    return dq, dk, dv


# (B, H, KV, Sq, Sk, hd, causal, window)
EMULATED = [(1, 4, 2, 200, 200, 128, True, 0), (2, 4, 1, 129, 129, 64, True, 0),
            (1, 2, 2, 300, 300, 128, True, 70), (1, 4, 2, 130, 130, 16, False, 0),
            (1, 2, 1, 64, 256, 128, True, 0), (1, 4, 4, 257, 257, 64, True, 32),
            (1, 2, 2, 1, 1, 64, True, 0), (1, 4, 2, 129, 300, 16, False, 0),
            # no causal mask, Sq != Sk: fewer keys than queries, whisper's
            # heads, a window that leaves the first keys unseen
            (1, 2, 2, 300, 129, 64, False, 0), (1, 8, 8, 70, 200, 64, False, 0),
            (1, 2, 1, 100, 400, 16, False, 64)]


def _inputs(B, H, KV, Sq, Sk, hd, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(torch.bfloat16)
            for shape in ((B, H, Sq, hd), (B, KV, Sk, hd), (B, KV, Sk, hd),
                          (B, H, Sq, hd))]


def _close(got, want, tol, atol):
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               rtol=tol, atol=atol)


@pytest.mark.parametrize("B,H,KV,Sq,Sk,hd,causal,window", EMULATED)
def test_emulated_forward_matches_plain(B, H, KV, Sq, Sk, hd, causal, window):
    q, k, v, _ = _inputs(B, H, KV, Sq, Sk, hd)
    out, lse = _emulate_fwd(q.float(), k.float(), v.float(), causal, window)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    _close(out, want, FLASH_TOL, FLASH_TOL)
    s = (q.float() @ k.float().repeat_interleave(H // KV, 1).transpose(2, 3)
         / math.sqrt(hd))
    s = s.masked_fill(~_live(Sq, Sk, causal, window), -math.inf)
    _close(lse, torch.logsumexp(s, -1), LSE_TOL, LSE_TOL)


@pytest.mark.parametrize("B,H,KV,Sq,Sk,hd,causal,window",
                         [c for c in EMULATED if c[3] == c[4] or not c[6]])
def test_emulated_backward_matches_autograd(B, H, KV, Sq, Sk, hd, causal,
                                            window):
    q, k, v, dout = _inputs(B, H, KV, Sq, Sk, hd, seed=1)
    out, lse = _emulate_fwd(q.float(), k.float(), v.float(), causal, window)
    got = _emulate_bwd(q.float(), k.float(), v.float(), out, lse,
                       dout.float(), causal, window)
    xs = [x.float().requires_grad_(True) for x in (q, k, v)]
    want = torch.autograd.grad(
        ref.flash_attention_ref(*xs, causal=causal, window=window), xs,
        dout.float())
    top = max(float(w.abs().max()) for w in want)
    for g, w in zip(got, want):
        # dq is exactly 0 at S = 1 (the one key's weight is 1 whatever q
        # is): there the atol scale is the other gradients' largest entry.
        scale = float(w.abs().max()) or top
        _close(g, w, BWD_TOL, BWD_TOL * scale)


def test_bf16_rows_must_be_16_byte_aligned():
    ok = torch.zeros(1, 64, 4, 64, dtype=torch.bfloat16)
    tfa._check_aligned("q", ok)
    tfa._check_aligned("q", ok[:, :, :1])          # a length-1 axis: any stride
    tfa._check_aligned("q", torch.zeros(1, 64, 4, 68)[..., :64])   # float32
    for bad in (torch.zeros(1, 64, 4, 68, dtype=torch.bfloat16)[..., :64],
                torch.zeros(ok.numel() + 1,
                            dtype=torch.bfloat16)[1:].view(ok.shape)):
        with pytest.raises(ValueError, match="16-byte"):
            tfa._check_aligned("q", bad)


@pytest.mark.parametrize("name,group", [
    ("void (anonymous namespace)::flash_fwd_bf16_kernel<128>(Params)",
     "flash_attention"),
    ("void (anonymous namespace)::flash_fwd_kernel<float, 128>(Params)",
     "flash_attention"),
    ("void (anonymous namespace)::flash_bwd_dq_bf16_kernel<128>(Params)",
     "flash_attention_bwd"),
    ("void (anonymous namespace)::flash_bwd_dkv_bf16_kernel<128>(Params)",
     "flash_attention_bwd"),
    ("void (anonymous namespace)::flash_bwd_dkv_kernel<float, 64>(Params)",
     "flash_attention_bwd")])
def test_profiler_groups_every_flash_kernel(name, group):
    assert profile_serve._group(name) == group
