"""The benchmark's operation and byte counts against values worked out by
hand at small shapes."""

import pytest
import torch
from bench_tiny import MOE, SSM

from benchlib import counts


def _mask_pairs(Sq, Sk, causal, window):
    qi = torch.arange(Sq)[:, None] + (Sk - Sq)
    kj = torch.arange(Sk)[None, :]
    mask = torch.ones(Sq, Sk, dtype=torch.bool)
    if causal:
        mask &= kj <= qi
    if window:
        mask &= kj > qi - window
    return int(mask.sum())


@pytest.mark.parametrize("Sq,Sk,causal,window,want", [
    (4, 4, True, 0, 10),          # 1 + 2 + 3 + 4
    (4, 4, False, 0, 16),
    (6, 6, True, 2, 11),          # 1 + 2 + 2 + 2 + 2 + 2
    (2, 5, True, 0, 9),           # queries at 3 and 4: 4 + 5
    (1, 8, True, 3, 3),
    (5, 5, True, 8, 15),          # a window past the sequence: causal
])
def test_flash_pairs_by_hand(Sq, Sk, causal, window, want):
    assert counts.flash_pairs(Sq, Sk, causal, window) == want
    assert _mask_pairs(Sq, Sk, causal, window) == want


def test_flash_pairs_match_the_mask_at_the_train_window():
    for S, window in ((300, 64), (257, 256), (64, 0)):
        assert counts.flash_pairs(S, S, True, window) == _mask_pairs(
            S, S, True, window)


def test_flash_bytes_and_flops_by_hand():
    # B1 S4 H2 KV1 hd8, causal: q and o 1*4*2*8 each, k and v 1*4*1*8
    # each, 2 bytes apiece; 10 pairs * 4 * B * H * hd FLOPs.
    n_bytes, flops = counts.flash_fwd(1, 4, 4, 2, 1, 8, True, 0, False)
    assert n_bytes == 2 * (2 * 64 + 2 * 32)
    assert flops == 4 * 1 * 2 * 8 * 10
    n_bytes_lse, _ = counts.flash_fwd(1, 4, 4, 2, 1, 8, True, 0, True)
    assert n_bytes_lse - n_bytes == 4 * 2 * 4
    n_bytes, flops = counts.flash_bwd(1, 4, 2, 1, 8, True, 0)
    assert n_bytes == 2 * (4 * 64 + 4 * 32) + 4 * 2 * 4
    assert flops == 10 * 2 * 8 * 10


def test_ssd_counts_by_hand():
    # B1 S4 H1 P2 N3 chunk 2: two chunks of 3 causal pairs each.
    assert counts.ssd_flops(1, 4, 1, 2, 3, 2) == 2 * 6 * (3 + 2) + 4 * 4 * 3 * 2
    assert counts.ssd_bwd_flops(1, 4, 1, 2, 3, 2) == (
        2 * 6 * 3 + 4 * 6 * (2 + 3) + 10 * 4 * 2 * 3)
    # forward: x 16 B, B and C 24 B each, dt 16 B, A 4 B, y 16 B, state 24 B
    assert counts.ssd_bytes(1, 4, 1, 2, 3, False) == 16 + 48 + 16 + 4 + 16 + 24
    assert counts.ssd_bytes(1, 4, 1, 2, 3, True) == 2 * (16 + 48 + 16 + 4) + 16


def test_least_time_is_the_larger_bound():
    assert counts.least_s(3.35e12, 0.0) == pytest.approx(1.0)
    assert counts.least_s(0.0, 989e12) == pytest.approx(1.0)
    assert counts.least_s(3.35e12, 2 * 989e12) == pytest.approx(2.0)


def test_train_flops_by_hand():
    cfg = dict(MOE, n_layers=1, sliding_window=0)
    B, S, D, V, E, F = 2, 8, 64, 256, 4, 96
    attn = D * 4 * 16 * 2 + 2 * D * 2 * 16        # wq, wo; wk, wv
    per_token = (attn + 2 * D + D * E             # norms, router
                 + E * 3 * D * F * 2 / E          # 2 of 4 experts
                 + D + D * V)                     # final norm, LM head
    want = 6 * per_token * B * S + 3 * 4 * B * 4 * 16 * 36   # 36 pairs
    assert counts.train_flops(cfg, B, S) == pytest.approx(want)


def test_ssm_train_flops_count_the_tied_head_and_the_scan():
    cfg = dict(SSM, n_layers=1)
    B, S, D, V = 1, 32, 64, 256
    d_in, N, H, P = 128, 16, 8, 16
    mixer = (D * (2 * d_in + 2 * N + H) + 4 * (d_in + 2 * N) + (d_in + 2 * N)
             + 3 * H + d_in + d_in * D)
    want = 6 * (D + mixer + D + V * D) * B * S + 3 * counts.ssd_flops(
        B, S, H, P, N, 16)
    assert counts.train_flops(cfg, B, S) == pytest.approx(want)


def test_prefill_flops_and_decode_bytes_by_hand():
    cfg = dict(MOE, n_layers=1, sliding_window=0)
    B, S, D, V, E, F = 2, 8, 64, 256, 4, 96
    layer = (D * 4 * 16 * 2 + 2 * D * 2 * 16 + 2 * D + D * E
             + E * 3 * D * F * 2 / E)
    want = 2 * layer * B * S + 2 * D * V * B + 4 * B * 4 * 16 * 36
    assert counts.prefill_flops(cfg, B, S) == pytest.approx(want)
    weights = 4 * (D * 4 * 16 * 2 + 2 * D * 2 * 16 + 2 * D + D * E
                   + E * 3 * D * F + D + D * V)   # float32: 4 bytes
    cache = 2 * B * 10 * 2 * 16 * 4              # K and V of 10 positions
    assert counts.decode_bytes(cfg, B, 9) == pytest.approx(
        weights + B * D * 4 + cache)
