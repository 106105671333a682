"""The port's CUDA and Triton kernels against their plain versions, on the
card.  Every test here needs a CUDA device and skips without one; on a
machine with a card (no JAX needed):

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Inputs come from numpy with a seed.  Tolerances: float32 2e-5 (the same
sums in another order), bfloat16 2e-2 (one bf16 rounding of the output, and
of the attention weights in the plain version).  The SSD scan: y in
bfloat16 3e-2 (one rounding of the output; both sides compute in fp32);
y in float32, and the fp32 state, 2e-4 relative and 2e-4 of the largest
entry: exp of differences of a chunk's cumulative sum of dt*A, summed in
another order, errs by ~|cumsum| * 2^-24, and over a 256-row chunk that
reaches ~1e-4 of the largest term where the terms cancel.  The train
path's kernels (the fused cross-entropy and the three backward kernels)
and the MoE FFN (plain torch with cuBLAS products) state their tolerances
below.  The bf16 SSD kernels split each fp32
operand into a hi and a lo bf16 product; the tolerances stay those above.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import fused_ce as tce
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rmsnorm as trn
from repro_torch.kernels import ssd_scan as tssd

TOLS = {"float32": dict(rtol=2e-5, atol=2e-5),
        "bfloat16": dict(rtol=2e-2, atol=2e-2),
        # RMSNorm only: one float16 rounding (2^-11) of the output
        "float16": dict(rtol=2e-3, atol=2e-3)}


def _normal(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _torch(x: np.ndarray, dtype: str, device):
    return torch.from_numpy(x).to(device=device, dtype=getattr(torch, dtype))


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().float().cpu().numpy()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


GPU_FLASH = [  # (B, H, KV, Sq, Sk, hd, causal, window, dtype)
    (1, 4, 4, 128, 128, 64, True, 0, "float32"),
    (2, 8, 2, 200, 200, 64, True, 0, "float32"),
    (1, 4, 1, 64, 256, 128, True, 0, "float32"),
    (1, 4, 2, 100, 100, 16, True, 0, "float32"),
    (1, 2, 2, 256, 256, 64, True, 32, "float32"),
    (1, 2, 2, 130, 130, 128, False, 0, "float32"),
    (2, 28, 4, 512, 512, 128, True, 0, "bfloat16"),
    (1, 28, 4, 200, 200, 128, True, 128, "bfloat16"),
    # bf16 (tensor cores) for each feature above, and S around the 128-row
    # query tile
    (1, 4, 4, 128, 128, 64, True, 0, "bfloat16"),
    (2, 8, 2, 200, 200, 64, True, 0, "bfloat16"),     # GQA, ragged
    (1, 4, 1, 64, 256, 128, True, 0, "bfloat16"),     # Sq < Sk
    (1, 4, 2, 100, 100, 16, True, 0, "bfloat16"),
    (1, 2, 2, 256, 256, 64, True, 32, "bfloat16"),
    (1, 2, 2, 130, 130, 128, False, 0, "bfloat16"),   # non-causal
    (1, 4, 2, 300, 300, 128, True, 70, "bfloat16"),   # window across tiles
    (1, 4, 2, 1, 1, 128, True, 0, "bfloat16"),
    (1, 4, 2, 127, 127, 128, True, 0, "bfloat16"),
    (1, 4, 2, 129, 129, 64, True, 0, "bfloat16"),
    (1, 4, 2, 129, 300, 16, False, 0, "bfloat16"),    # Sq < Sk, non-causal
    # head_dim 32 at launch/train_lm.py's tiny preset (batch 4, seq 64, four
    # heads), and ragged with GQA
    (4, 4, 4, 64, 64, 32, True, 0, "float32"),
    (4, 4, 4, 64, 64, 32, True, 0, "bfloat16"),
    (1, 4, 2, 200, 200, 32, True, 0, "float32"),
    (1, 4, 2, 200, 200, 32, True, 0, "bfloat16"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KV,Sq,Sk,hd,causal,window,dtype", GPU_FLASH)
def test_cuda_flash_matches_plain(cuda, B, H, KV, Sq, Sk, hd, causal, window,
                                  dtype):
    q = _torch(_normal(0, (B, Sq, H, hd)), dtype, cuda)
    k = _torch(_normal(1, (B, Sk, KV, hd)), dtype, cuda)
    v = _torch(_normal(2, (B, Sk, KV, hd)), dtype, cuda)
    before = tfa.launches
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert tfa.launches == before + 1 and got.dtype == q.dtype
    want = ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), causal=causal,
                                   window=window).transpose(1, 2)
    np.testing.assert_allclose(_np(got), _np(want), **TOLS[dtype])


@pytest.mark.cuda
def test_cuda_flash_refuses_what_it_does_not_take(cuda):
    q = torch.zeros(1, 64, 6, 64, device=cuda)
    with pytest.raises(ValueError, match="not divisible"):
        tfa.flash_attention(q, torch.zeros(1, 64, 4, 64, device=cuda),
                            torch.zeros(1, 64, 4, 64, device=cuda))
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_attention(torch.zeros(1, 64, 4, 48, device=cuda),
                            torch.zeros(1, 64, 4, 48, device=cuda),
                            torch.zeros(1, 64, 4, 48, device=cuda))
    with pytest.raises(ValueError, match="dtype"):
        h = torch.zeros(1, 64, 4, 64, device=cuda, dtype=torch.float16)
        tfa.flash_attention(h, h, h)


@pytest.mark.cuda
def test_cuda_flash_refuses_unaligned_bf16_rows(cuda):
    """The bf16 kernels copy 16-byte chunks: a base pointer or a stride that
    breaks that raises before a launch (float32 takes them)."""
    ok = torch.zeros(1, 64, 4, 64, device=cuda, dtype=torch.bfloat16)
    shifted = torch.zeros(ok.numel() + 1, device=cuda,
                          dtype=torch.bfloat16)[1:].view(ok.shape)
    padded = torch.zeros(1, 64, 4, 68, device=cuda,
                         dtype=torch.bfloat16)[..., :64]   # head stride 68
    before = (tfa.launches, tfa.bwd_launches)
    for bad in (shifted, padded):
        with pytest.raises(ValueError, match="16-byte"):
            tfa.flash_attention(bad, ok, ok)
        with pytest.raises(ValueError, match="16-byte"):
            tfa.flash_attention(ok, ok, bad)
    out, lse = tfa.flash_attention(ok, ok, ok, return_lse=True)
    with pytest.raises(ValueError, match="16-byte"):
        tfa.flash_attention_bwd(ok, ok, ok, out, lse, padded)
    assert (tfa.launches, tfa.bwd_launches) == (before[0] + 1, before[1])
    padded32 = torch.zeros(1, 64, 4, 68, device=cuda)[..., :64]
    tfa.flash_attention(padded32, ok.float(), ok.float())
    assert tfa.launches == before[0] + 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 128), (2, 64, 256), (1, 7, 512),
                                   (4, 512, 3584), (4, 1, 3584)])
def test_cuda_rmsnorm_matches_plain(cuda, shape, dtype):
    x = _torch(_normal(0, shape), dtype, cuda)
    scale = _torch(_normal(1, (shape[-1],)), dtype, cuda)
    before = trn.launches
    got = ops.rmsnorm(x, scale, 1e-6)
    torch.cuda.synchronize()
    assert trn.launches == before + 1 and got.dtype == x.dtype
    np.testing.assert_allclose(_np(got), _np(ref.rmsnorm_ref(x, scale, 1e-6)),
                               **TOLS[dtype])


@pytest.mark.cuda
def test_cuda_rmsnorm_strided_rows(cuda):
    """The last prefill position h[:, -1:] is a row-strided view."""
    h = _torch(_normal(0, (3, 10, 256)), "float32", cuda)
    scale = _torch(_normal(1, (256,)), "float32", cuda)
    got = ops.rmsnorm(h[:, -1:], scale, 1e-6)
    np.testing.assert_allclose(_np(got), _np(ref.rmsnorm_ref(h[:, -1:], scale,
                                                             1e-6)),
                               **TOLS["float32"])


GPU_SSD = [  # (B, S, H, P, N, chunk, dtype); the cases of test_kernels.py
    (1, 128, 8, 16, 16, 32, "float32"),
    (2, 256, 4, 32, 64, 64, "float32"),
    (1, 64, 16, 64, 128, 64, "float32"),
    (2, 300, 4, 64, 128, 256, "float32"),   # ragged: a partial last chunk
    (1, 200, 4, 64, 128, 64, "float32"),    # ragged inside the last tile
    (1, 128, 8, 16, 16, 32, "bfloat16"),
    (2, 256, 4, 32, 64, 64, "bfloat16"),
    (1, 64, 16, 64, 128, 64, "bfloat16"),
    (2, 300, 4, 64, 128, 256, "bfloat16"),
    # bf16 (the chunk-parallel tensor-core kernels) for each float32-only
    # feature above, and S around the 64-row tiles
    (1, 200, 4, 64, 128, 64, "bfloat16"),   # ragged inside the last tile
    (2, 1, 4, 64, 128, 256, "bfloat16"),
    (1, 63, 4, 64, 128, 256, "bfloat16"),
    (1, 65, 4, 64, 128, 256, "bfloat16"),
    (2, 257, 4, 64, 128, 256, "bfloat16"),  # a one-row last chunk
    (2, 100, 8, 16, 16, 32, "bfloat16"),    # chunk 32, P16/N16, ragged
    (3, 130, 4, 32, 64, 64, "bfloat16"),    # B > 1, ragged
    # long chunks (8, 16 and 64 query tiles), ragged in the last chunk
    (1, 700, 4, 64, 128, 512, "bfloat16"),
    (2, 1100, 2, 32, 64, 1024, "bfloat16"),
    (1, 4200, 2, 64, 128, 4096, "bfloat16"),  # MAX_CHUNK
]
SSD_TOL = {"float32": 2e-4, "bfloat16": 3e-2}


def _assert_ssd_close(got, want, tol, scaled):
    """allclose at rtol ``tol`` and atol ``tol``, times the largest |want|
    when ``scaled``."""
    want = _np(want)
    atol = tol * max(1.0, float(np.abs(want).max())) if scaled else tol
    np.testing.assert_allclose(_np(got), want, rtol=tol, atol=atol)


def _ssd_inputs(B, S, H, P, N, dtype, device, strided):
    """x, Bm and Cm as the model passes them: slices of one [B, S, H*P + 2N]
    conv output when ``strided``."""
    xbc = _torch(_normal(0, (B, S, H * P + 2 * N)), dtype, device)
    if not strided:
        xbc = xbc.clone()
    x = xbc[..., :H * P].reshape(B, S, H, P)
    Bm, Cm = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
    if not strided:
        x, Bm, Cm = x.contiguous(), Bm.contiguous(), Cm.contiguous()
    dt = torch.nn.functional.softplus(_torch(_normal(1, (B, S, H)), "float32",
                                             device))
    A = -torch.exp(0.5 * _torch(_normal(2, (H,)), "float32", device))
    return x, dt, A, Bm, Cm


@pytest.mark.cuda
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("B,S,H,P,N,chunk,dtype", GPU_SSD)
def test_cuda_ssd_scan_matches_plain(cuda, B, S, H, P, N, chunk, dtype,
                                     strided, with_state):
    x, dt, A, Bm, Cm = _ssd_inputs(B, S, H, P, N, dtype, cuda, strided)
    assert x.is_contiguous() != strided
    init = (_torch(0.5 * _normal(3, (B, H, P, N)), "float32", cuda)
            if with_state else None)
    before = tssd.launches
    y, st = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, initial_state=init)
    torch.cuda.synchronize()
    assert tssd.launches == before + 1
    assert y.dtype == x.dtype and st.dtype == torch.float32
    want_y, want_st = ref.ssd_scan_ref(x, dt, A, Bm, Cm, chunk, init)
    _assert_ssd_close(y, want_y, SSD_TOL[dtype], scaled=dtype == "float32")
    _assert_ssd_close(st, want_st, SSD_TOL["float32"], scaled=True)


@pytest.mark.cuda
def test_cuda_ssd_scan_refuses_what_it_does_not_take(cuda):
    x, dt, A, Bm, Cm = _ssd_inputs(1, 64, 4, 16, 16, "float32", cuda, False)
    before = tssd.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        tssd.ssd_scan(x.cpu(), dt, A, Bm, Cm, chunk=32)
    with pytest.raises(ValueError, match="dtype"):
        tssd.ssd_scan(x.half(), dt, A, Bm.half(), Cm.half(), chunk=32)
    with pytest.raises(ValueError, match="float32"):
        tssd.ssd_scan(x, dt.bfloat16(), A, Bm, Cm, chunk=32)
    with pytest.raises(ValueError, match="head_dim, state"):
        _, _, _, Bm32, Cm32 = _ssd_inputs(1, 64, 4, 16, 32, "float32", cuda,
                                          False)
        tssd.ssd_scan(x, dt, A, Bm32, Cm32, chunk=32)
    with pytest.raises(ValueError, match="contiguous last"):
        tssd.ssd_scan(x.transpose(-1, -2).contiguous().transpose(-1, -2),
                      dt, A, Bm, Cm, chunk=32)
    with pytest.raises(ValueError, match="chunk"):
        tssd.ssd_scan(x, dt, A, Bm, Cm, chunk=0)
    assert tssd.launches == before


@pytest.mark.cuda
def test_cuda_ssd_scan_bf16_is_deterministic(cuda):
    """No atomics: two calls on the same inputs give bit-equal y and state."""
    x, dt, A, Bm, Cm = _ssd_inputs(2, 300, 8, 64, 128, "bfloat16", cuda, True)
    init = _torch(0.5 * _normal(3, (2, 8, 64, 128)), "float32", cuda)
    first = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=256, initial_state=init)
    for _ in range(2):
        again = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=256, initial_state=init)
        assert all(map(torch.equal, first, again))


@pytest.mark.cuda
def test_cuda_ssd_scan_refuses_unaligned_bf16_rows(cuda):
    """The bf16 kernels copy 16-byte chunks: a base pointer or a row stride
    that breaks that raises before a launch (float32 takes them)."""
    B, S, H, P, N = 1, 64, 4, 16, 16
    x, dt, A, Bm, Cm = _ssd_inputs(B, S, H, P, N, "bfloat16", cuda, False)
    flat = torch.zeros(B * S * N + 1, device=cuda, dtype=torch.bfloat16)
    shifted = flat[1:].view(B, S, N)
    wide = torch.zeros(B, S, N + 4, device=cuda, dtype=torch.bfloat16)[..., :N]
    before = tssd.launches
    for bad in (shifted, wide):
        with pytest.raises(ValueError, match="16-byte"):
            tssd.ssd_scan(x, dt, A, bad, Cm, chunk=32)
        with pytest.raises(ValueError, match="16-byte"):
            tssd.ssd_scan(x, dt, A, Bm, bad, chunk=32)
    with pytest.raises(ValueError, match="16-byte"):
        xs = torch.zeros(x.numel() + 1, device=cuda,
                         dtype=torch.bfloat16)[1:].view(x.shape)
        tssd.ssd_scan(xs, dt, A, Bm, Cm, chunk=32)
    assert tssd.launches == before
    tssd.ssd_scan(x.float(), dt, A, wide.float(), Cm.float(), chunk=32)
    assert tssd.launches == before + 1


# ------------------------------------------------------- the train path's
# kernels: the fused cross-entropy and the three backward kernels.  Each is
# held against autograd through its plain version in float32 on the same
# values.  Backward tolerances, as rtol and times the gradient's largest
# entry as atol: bfloat16 2e-2 (one bf16 rounding of each gradient, and of
# the forward's output in D = rowsum(dO*O)); float32 1e-4 (sums over keys,
# query rows or rows in another order).  Cross-entropy: float32 1e-5,
# bfloat16 2e-2, as in tests/test_kernels.py.

BWD_TOLS = {"float32": 1e-4, "bfloat16": 2e-2,
            "float16": 2e-3}   # RMSNorm only: one float16 rounding


def _assert_grad_close(got, want, dtype, label="", top=0.0):
    """Within rtol ``tol`` and ``tol`` times the gradient's largest entry;
    for a gradient that is exactly 0 (dq at S = 1, where the one key's
    weight is 1 whatever q is), ``tol`` times ``top``, the largest entry of
    the other gradients, since rounding leaves a residue of that scale."""
    tol = BWD_TOLS[dtype]
    want = _np(want)
    scale = float(np.abs(want).max()) or top
    np.testing.assert_allclose(_np(got), want, rtol=tol, atol=tol * scale,
                               err_msg=label)


def _plain_grads(fn, inputs, dout):
    xs = [x.detach().float().requires_grad_(True) for x in inputs]
    return torch.autograd.grad(fn(*xs), xs, dout.float())


GPU_FLASH_BWD = [  # (B, H, KV, S, hd, causal, window, dtype)
    (1, 4, 4, 128, 64, True, 0, "float32"),       # MHA
    (2, 8, 2, 200, 64, True, 0, "float32"),       # GQA 4:1, ragged
    (1, 4, 1, 130, 128, True, 0, "float32"),      # MQA, hd 128
    (1, 4, 2, 100, 16, True, 0, "float32"),       # hd 16
    (1, 2, 2, 256, 64, True, 32, "float32"),      # window 32
    (1, 2, 2, 130, 128, False, 0, "float32"),     # non-causal
    (2, 28, 4, 512, 128, True, 0, "bfloat16"),    # qwen2's heads
    (1, 28, 4, 200, 128, True, 32, "bfloat16"),   # window, ragged
    (1, 4, 1, 100, 16, True, 0, "bfloat16"),      # MQA, hd 16
    (1, 8, 2, 70, 64, True, 0, "bfloat16"),       # a single ragged tile
    # bf16 (tensor cores) for each float32 feature above, and S around the
    # 128-row tiles
    (1, 4, 4, 128, 64, True, 0, "bfloat16"),      # MHA
    (2, 8, 2, 200, 64, True, 0, "bfloat16"),      # GQA 4:1, ragged
    (1, 4, 1, 130, 128, True, 0, "bfloat16"),     # MQA, hd 128
    (1, 2, 2, 256, 64, True, 32, "bfloat16"),     # window 32
    (1, 2, 2, 130, 128, False, 0, "bfloat16"),    # non-causal
    (1, 4, 2, 300, 128, True, 70, "bfloat16"),    # window across tiles
    (1, 4, 2, 1, 128, True, 0, "bfloat16"),
    (1, 4, 2, 127, 128, True, 0, "bfloat16"),
    (1, 4, 2, 129, 64, True, 0, "bfloat16"),
    (1, 4, 2, 200, 16, False, 0, "bfloat16"),     # non-causal, hd 16
    (4, 4, 4, 64, 32, True, 0, "float32"),        # hd 32: the tiny preset
    (4, 4, 4, 64, 32, True, 0, "bfloat16"),
    (2, 8, 2, 200, 32, True, 0, "float32"),       # hd 32, GQA, ragged
    (2, 8, 2, 200, 32, True, 0, "bfloat16"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KV,S,hd,causal,window,dtype", GPU_FLASH_BWD)
def test_cuda_flash_bwd_matches_plain(cuda, B, H, KV, S, hd, causal, window,
                                      dtype):
    q, k, v = (_torch(_normal(i, (B, S, n, hd)), dtype, cuda).requires_grad_()
               for i, n in enumerate((H, KV, KV)))
    dout = _torch(_normal(3, (B, S, H, hd)), dtype, cuda)
    before = (tfa.launches, tfa.bwd_launches)
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    got = torch.autograd.grad(out, (q, k, v), dout)
    torch.cuda.synchronize()
    assert (tfa.launches, tfa.bwd_launches) == (before[0] + 1, before[1] + 1)
    with torch.no_grad():   # the forward with lse writes the same output
        assert torch.equal(out, tfa.flash_attention(q, k, v, causal=causal,
                                                    window=window))
    want = _plain_grads(
        lambda q, k, v: ref.flash_attention_ref(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal, window=window).transpose(1, 2), (q, k, v), dout)
    top = max(float(w.abs().max()) for w in want)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == q.dtype and g.shape == w.shape
        _assert_grad_close(g, w, dtype, f"d{name}", top)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_bwd_is_deterministic(cuda, dtype):
    """No atomics: the same inputs give bit-equal dq, dk and dv."""
    B, H, KV, S, hd, window = 2, 28, 4, 300, 128, 0
    q, k, v, dout = (_torch(_normal(i, (B, S, n, hd)), dtype, cuda)
                     for i, n in enumerate((H, KV, KV, H)))
    out, lse = tfa.flash_attention(q, k, v, window=window, return_lse=True)
    first = tfa.flash_attention_bwd(q, k, v, out, lse, dout, window=window)
    for _ in range(3):
        again = tfa.flash_attention_bwd(q, k, v, out, lse, dout,
                                        window=window)
        assert all(map(torch.equal, first, again))


@pytest.mark.cuda
def test_cuda_flash_lse_is_the_rows_logsumexp(cuda):
    B, H, KV, S, hd, window = 1, 4, 2, 150, 64, 32
    q, k, v = (_torch(_normal(i, (B, S, n, hd)), "float32", cuda)
               for i, n in enumerate((H, KV, KV)))
    _, lse = tfa.flash_attention(q, k, v, window=window, return_lse=True)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k.repeat_interleave(H // KV, 2))
    qi = torch.arange(S, device=cuda)[:, None]
    kj = torch.arange(S, device=cuda)[None, :]
    mask = (kj <= qi) & (kj > qi - window)
    want = torch.logsumexp((s / hd ** 0.5).masked_fill(~mask, float("-inf")),
                           -1)
    np.testing.assert_allclose(_np(lse), _np(want), rtol=2e-5, atol=2e-5)


GPU_FLASH_BWD_CROSS = [  # (B, H, KV, Sq, Sk, hd, window, dtype), no causal mask
    (2, 8, 8, 100, 300, 64, 0, "float32"),        # whisper's heads, Sq < Sk
    (1, 4, 2, 300, 129, 128, 0, "float32"),       # Sq > Sk, GQA
    (1, 2, 1, 100, 400, 16, 64, "float32"),       # first keys seen by none
    (2, 8, 8, 224, 1500, 64, 0, "bfloat16"),      # whisper's cross-attention
    (2, 8, 8, 1, 300, 64, 0, "bfloat16"),         # one query row
    (1, 4, 2, 300, 129, 128, 0, "bfloat16"),
    (1, 2, 1, 100, 400, 16, 64, "bfloat16"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KV,Sq,Sk,hd,window,dtype", GPU_FLASH_BWD_CROSS)
def test_cuda_flash_bwd_cross_attention_matches_plain(cuda, B, H, KV, Sq, Sk,
                                                      hd, window, dtype):
    """The backward without the causal mask over keys of another length,
    through ``ops.flash_attention``'s autograd.Function, against autograd
    through the plain version; two backward calls bit-equal."""
    q = _torch(_normal(0, (B, Sq, H, hd)), dtype, cuda).requires_grad_()
    k, v = (_torch(_normal(i, (B, Sk, KV, hd)), dtype, cuda).requires_grad_()
            for i in (1, 2))
    dout = _torch(_normal(3, (B, Sq, H, hd)), dtype, cuda)
    before = tfa.bwd_launches
    out = ops.flash_attention(q, k, v, causal=False, window=window)
    got = torch.autograd.grad(out, (q, k, v), dout)
    torch.cuda.synchronize()
    assert tfa.bwd_launches == before + 1
    o, lse = tfa.flash_attention(q.detach(), k.detach(), v.detach(),
                                 causal=False, window=window, return_lse=True)
    again = tfa.flash_attention_bwd(q.detach(), k.detach(), v.detach(), o,
                                    lse, dout, causal=False, window=window)
    assert all(map(torch.equal, got, again))
    want = _plain_grads(
        lambda q, k, v: ref.flash_attention_ref(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=False, window=window).transpose(1, 2), (q, k, v), dout)
    top = max(float(w.abs().max()) for w in want)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == q.dtype and g.shape == w.shape
        _assert_grad_close(g, w, dtype, f"d{name}", top)


@pytest.mark.cuda
def test_cuda_flash_bwd_refuses_cross_attention(cuda):
    """Cross-attention (Sq != Sk) under the causal mask: the backward kernel
    takes Sq != Sk only without it, and refuses before launching."""
    q = torch.zeros(1, 64, 4, 64, device=cuda, requires_grad=True)
    kv = torch.zeros(1, 128, 4, 64, device=cuda)
    with pytest.raises(ValueError, match="Sq == Sk"):
        ops.flash_attention(q, kv, kv)
    out, lse = tfa.flash_attention(q.detach(), kv, kv, return_lse=True)
    before = tfa.bwd_launches
    with pytest.raises(ValueError, match="Sq == Sk"):
        tfa.flash_attention_bwd(q.detach(), kv, kv, out, lse, out)
    assert tfa.bwd_launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 128), (2, 64, 256), (1, 7, 512),
                                   (2, 512, 3584), (3, 1000)])
def test_cuda_rmsnorm_bwd_matches_plain(cuda, shape, dtype):
    x = _torch(_normal(0, shape), dtype, cuda).requires_grad_()
    scale = _torch(1 + 0.1 * _normal(1, shape[-1:]), dtype,
                   cuda).requires_grad_()
    dy = _torch(_normal(2, shape), dtype, cuda)
    before = (trn.launches, trn.bwd_launches)
    got = torch.autograd.grad(ops.rmsnorm(x, scale, 1e-6), (x, scale), dy)
    torch.cuda.synchronize()
    assert (trn.launches, trn.bwd_launches) == (before[0] + 1, before[1] + 1)
    want = _plain_grads(lambda x, s: ref.rmsnorm_ref(x, s, 1e-6), (x, scale),
                        dy)
    for name, g, w in zip(("x", "scale"), got, want):
        assert g.dtype == x.dtype
        _assert_grad_close(g, w, dtype, f"d{name}")


def _norm_widths() -> list[int]:
    """Every width a config normalises up to the kernels' limit: d_model,
    and the Mamba mixer's inner width where the config has one."""
    from repro_torch.configs import all_configs

    widths = set()
    for cfg in all_configs().values():
        widths.add(cfg.d_model)
        if cfg.ssm_state:
            widths.add(cfg.d_inner)
    return sorted(w for w in widths if w <= trn.MAX_D)


def _rmsnorm_fwd_bwd(x, scale, dy, eps=1e-6):
    """The kernels' forward and backward on x, counting one launch each,
    against the plain version and autograd through it in float32.  dx's
    atol is the tolerance times its largest entry or, where larger, times
    the largest rstd*g*s: at D 1, dx = rstd*g*s*(1 - x^2) cancels to
    rounding noise of that size on both sides."""
    before = (trn.launches, trn.bwd_launches)
    xk, sk = x.detach().requires_grad_(), scale.detach().requires_grad_()
    y = ops.rmsnorm(xk, sk, eps)
    got = torch.autograd.grad(y, (xk, sk), dy)
    torch.cuda.synchronize()
    assert (trn.launches, trn.bwd_launches) == (before[0] + 1, before[1] + 1)
    dtype = str(x.dtype).split(".")[-1]
    np.testing.assert_allclose(_np(y), _np(ref.rmsnorm_ref(x, scale, eps)),
                               **TOLS[dtype])
    want = _plain_grads(lambda a, b: ref.rmsnorm_ref(a, b, eps), (x, scale),
                        dy)
    xf = x.float()
    rstd = torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    terms = float((rstd * dy.float() * scale.float()).abs().max())
    for name, g, w, like in zip(("x", "scale"), got, want, (x, scale)):
        assert g.dtype == like.dtype and g.shape == like.shape
        if name == "x":
            tol = BWD_TOLS[dtype]
            np.testing.assert_allclose(
                _np(g), _np(w), rtol=tol,
                atol=tol * max(float(w.abs().max()), terms), err_msg="dx")
        else:
            _assert_grad_close(g, w, dtype, f"d{name}")
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", _norm_widths())
def test_cuda_rmsnorm_at_config_widths(cuda, D, dtype):
    """Forward and backward at every config width, over more rows than the
    backward has blocks (a row count the grid does not divide)."""
    rows = 3 * 132 + 5
    x = _torch(_normal(0, (rows, D)), dtype, cuda)
    scale = _torch(1 + 0.1 * _normal(1, (D,)), dtype, cuda)
    _rmsnorm_fwd_bwd(x, scale, _torch(_normal(2, (rows, D)), dtype, cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("shape", [(5, 1), (9, 7), (3, 2, 33), (17, 1000),
                                   (1, 4096), (1, 1000), (1, 16384)])
def test_cuda_rmsnorm_odd_widths_and_one_row(cuda, shape, dtype):
    """D 1, 7, 33 (not 16-byte rows: the plain-load path), 1000, and one
    row of a wide and a narrow D."""
    x = _torch(_normal(3, shape), dtype, cuda)
    scale = _torch(1 + 0.1 * _normal(4, shape[-1:]), dtype, cuda)
    _rmsnorm_fwd_bwd(x, scale, _torch(_normal(5, shape), dtype, cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("D", [512, 3584])
def test_cuda_rmsnorm_unaligned_views(cuda, D):
    """Rows that start 2 bytes past a 16-byte boundary, with a row stride of
    D + 1 elements, and a float32 scale beside bf16 rows."""
    buf = _torch(_normal(6, (40, D + 1)), "bfloat16", cuda)
    x = buf[:, 1:]
    assert x.data_ptr() % 16 and x.stride(0) == D + 1
    dy = _torch(_normal(7, (40, D + 1)), "bfloat16", cuda)[:, 1:]
    scale = _torch(1 + 0.1 * _normal(8, (D,)), "bfloat16", cuda)
    _rmsnorm_fwd_bwd(x, scale, dy)
    _rmsnorm_fwd_bwd(x.contiguous(), scale.float(), dy.contiguous())


@pytest.mark.cuda
def test_cuda_rmsnorm_zero_rows(cuda):
    x = torch.empty(0, 3, 512, device=cuda, dtype=torch.bfloat16)
    scale = torch.ones(512, device=cuda, dtype=torch.bfloat16)
    before = (trn.launches, trn.bwd_launches)
    assert trn.rmsnorm(x, scale, 1e-6).shape == x.shape
    dx, dscale = trn.rmsnorm_bwd(x, scale, x, 1e-6)
    assert dx.shape == x.shape and bool((dscale == 0).all())
    assert (trn.launches, trn.bwd_launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("D", [1024, 7168])
def test_cuda_rmsnorm_bwd_takes_a_strided_dy(cuda, D):
    """A dy whose last dimension is not contiguous (copied), and one whose
    rows are strided (read in place)."""
    x = _torch(_normal(9, (2, 33, D)), "bfloat16", cuda)
    scale = _torch(1 + 0.1 * _normal(10, (D,)), "bfloat16", cuda)
    dy_t = _torch(_normal(11, (D, 33, 2)), "bfloat16", cuda).permute(2, 1, 0)
    assert dy_t.stride(-1) != 1
    _rmsnorm_fwd_bwd(x, scale, dy_t)
    dy_r = _torch(_normal(12, (2, 66, D)), "bfloat16", cuda)[:, ::2]
    _rmsnorm_fwd_bwd(x, scale, dy_r)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 4096, 1024), (2, 1000, 3584)])
def test_cuda_rmsnorm_bwd_is_deterministic(cuda, shape, dtype):
    x = _torch(_normal(13, shape), dtype, cuda)
    scale = _torch(1 + 0.1 * _normal(14, shape[-1:]), dtype, cuda)
    dy = _torch(_normal(15, shape), dtype, cuda)
    a = trn.rmsnorm_bwd(x, scale, dy, 1e-6)
    b = trn.rmsnorm_bwd(x, scale, dy, 1e-6)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,D", [(6341, 512), (5000, 7), (5000, 1000),
                                    (3000, 2048), (1200, 3584),
                                    (300, 16384)])
def test_cuda_rmsnorm_dscale_is_the_blocked_order(cuda, rows, D, dtype):
    """The kernel's dscale equals ``rmsnorm_bwd_blocked``'s bit for bit at
    the grid the launcher takes (``bwd_grid``), over more rows than the
    grid's teams (several rows a team, several blocks a dscale group).  x is
    +-1 and eps 0, so rstd is exactly 1 and each row's g*x^ is +-g exactly
    on both sides: only the order of the sums over rows, teams and blocks
    is left, and random g's float32 sums change their last bits under
    another order."""
    rng = np.random.default_rng(16)
    x = _torch(np.where(rng.random((rows, D)) < 0.5, -1.0, 1.0)
               .astype(np.float32), dtype, cuda)
    scale = _torch(1 + 0.1 * _normal(17, (D,)), "float32", cuda)
    dy = _torch(_normal(18, (rows, D)), dtype, cuda)
    blocks, teams = trn.bwd_grid(x, scale, dy)
    assert rows > 2 * blocks * teams
    dx, dscale = trn.rmsnorm_bwd(x, scale, dy, 0.0)
    want_dx, want = trn.rmsnorm_bwd_blocked(x.cpu(), scale.cpu(), dy.cpu(),
                                            0.0, blocks, teams)
    assert torch.equal(dscale.cpu(), want), (blocks, teams)
    _assert_grad_close(dx, want_dx, dtype, "dx")


@pytest.mark.cuda
def test_cuda_rmsnorm_refuses_what_it_does_not_take(cuda):
    x = torch.ones(4, 16, device=cuda)
    before = (trn.launches, trn.bwd_launches)
    for bad_x, bad_s, match in (
            (torch.ones(4, 16384 + 8, device=cuda),
             torch.ones(16384 + 8, device=cuda), "D must be"),
            (x.double(), torch.ones(16, device=cuda), "float32, bfloat16"),
            (x.t(), torch.ones(4, device=cuda), "contiguous"),
            (x, torch.ones(8, device=cuda), "scale must be")):
        with pytest.raises(ValueError, match=match):
            trn.rmsnorm(bad_x, bad_s, 1e-6)
    with pytest.raises(ValueError, match="dy must be like x"):
        trn.rmsnorm_bwd(x, torch.ones(16, device=cuda), x.bfloat16(), 1e-6)
    assert (trn.launches, trn.bwd_launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,V", [(8, 512), (16, 1000), (4, 4096),
                                 (33, 152064)])
def test_cuda_cross_entropy_fwd_bwd_matches_plain(cuda, T, V, dtype):
    """Negative labels included; V 1000 and 152064 are not powers of two."""
    logits = _torch(2 * _normal(0, (T, V)), dtype, cuda).requires_grad_()
    labels = torch.from_numpy(np.random.default_rng(1).integers(
        -1, V, T)).to(cuda)
    labels[0] = -1
    g = _torch(np.random.default_rng(2).random(T).astype(np.float32),
               "float32", cuda)
    before = (tce.launches, tce.bwd_launches)
    nll = ops.fused_cross_entropy(logits, labels)
    (got,) = torch.autograd.grad(nll, logits, g)
    torch.cuda.synchronize()
    assert (tce.launches, tce.bwd_launches) == (before[0] + 1, before[1] + 1)
    assert nll.dtype == torch.float32 and got.dtype == logits.dtype
    tol = {"float32": 1e-5, "bfloat16": 2e-2}[dtype]
    np.testing.assert_allclose(_np(nll), _np(ref.cross_entropy_ref(logits,
                                                                   labels)),
                               rtol=tol, atol=tol)
    (want,) = _plain_grads(lambda x: ref.cross_entropy_ref(x, labels),
                           (logits,), g)
    _assert_grad_close(got, want, "float32" if dtype == "float32"
                       else "bfloat16")


# The SSD scan's backward kernel against autograd through the plain scan in
# float32 on the same values, as rtol and times the gradient's largest entry
# as atol, per output: d(conv output) (dx, dB and dC, in x's dtype) bfloat16
# 2e-2 (one rounding of each); float32 1e-3 (exp of a chunk's cumulative sum
# of dt*A in another order errs by ~|cumsum| * 2^-24; dA and ddt sum such
# terms over every row), which also holds ddt, dA and d(initial state) in
# either dtype: they are float32 on both sides.
SSD_BWD_TOLS = {"float32": 1e-3, "bfloat16": 2e-2}
# The bf16 edge cases hold dx, dB and dC apart, each at rtol 2e-2 and as atol
# this times its median |entry| (chip_smoke.py's SSD_BWD_MEDIAN_ATOL): an
# error the size of a median entry fails.
SSD_BWD_MEDIAN_ATOL = 2e-2
GPU_SSD_BWD = [  # (B, S, H, P, N, chunk, dtype)
    (1, 128, 8, 16, 16, 32, "float32"),
    (2, 256, 4, 32, 64, 64, "float32"),
    (2, 300, 4, 64, 128, 256, "float32"),   # a partial last chunk
    (1, 200, 4, 64, 128, 64, "float32"),    # ragged inside the last tile
    (1, 128, 8, 16, 16, 32, "bfloat16"),
    (2, 300, 4, 64, 128, 256, "bfloat16"),
    (2, 257, 4, 64, 128, 256, "bfloat16"),  # a one-row last chunk
    (2, 1, 4, 64, 128, 256, "bfloat16"),
    (3, 130, 4, 32, 64, 64, "bfloat16"),
    (1, 96, 256, 16, 16, 32, "bfloat16"),   # jamba's 256 heads
    (1, 700, 4, 64, 128, 512, "bfloat16"),  # 8 query tiles a chunk
    (1, 4200, 2, 64, 128, 4096, "bfloat16"),  # MAX_CHUNK
]


def _ssd_grads(xbc, dt, A, init, dy, dfinal, H, P, N, chunk, scan):
    """Gradients of sum(y dy) + sum(final dfinal) through ``scan`` of the
    conv output xbc (x, Bm and Cm its views), dt, A and the initial state."""
    leaves_ = [t.detach().requires_grad_(True) for t in (xbc, dt, A)]
    st = None if init is None else init.detach().requires_grad_(True)
    B, S = xbc.shape[:2]
    x = leaves_[0][..., :H * P].reshape(B, S, H, P)
    Bm, Cm = leaves_[0][..., H * P:H * P + N], leaves_[0][..., H * P + N:]
    y, final = scan(x, leaves_[1], leaves_[2], Bm, Cm, chunk, st)
    loss = (y * dy.to(y.dtype)).float().sum()
    if dfinal is not None:
        loss = loss + (final * dfinal).sum()
    return torch.autograd.grad(loss, leaves_ + ([] if st is None else [st]))


def _ssd_bwd_inputs(B, S, H, P, N, dtype, device, state):
    xbc = _torch(_normal(0, (B, S, H * P + 2 * N)), dtype, device)
    dt = torch.nn.functional.softplus(_torch(_normal(1, (B, S, H)), "float32",
                                             device))
    A = -torch.exp(0.5 * _torch(_normal(2, (H,)), "float32", device))
    init = (_torch(0.5 * _normal(3, (B, H, P, N)), "float32", device)
            if state else None)
    dy = _torch(_normal(4, (B, S, H, P)), dtype, device)
    dfinal = (_torch(_normal(5, (B, H, P, N)), "float32", device)
              if state else None)
    return xbc, dt, A, init, dy, dfinal


@pytest.mark.cuda
@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("B,S,H,P,N,chunk,dtype", GPU_SSD_BWD)
def test_cuda_ssd_scan_bwd_matches_plain(cuda, B, S, H, P, N, chunk, dtype,
                                         state):
    """Through ``ops.ssd_scan`` as the model calls it (x, Bm and Cm strided
    views of one conv output); with ``state`` an initial state and a
    d(final state)."""
    xbc, dt, A, init, dy, dfinal = _ssd_bwd_inputs(B, S, H, P, N, dtype,
                                                   cuda, state)
    before = (tssd.launches, tssd.bwd_launches)
    got = _ssd_grads(xbc, dt, A, init, dy, dfinal, H, P, N, chunk,
                     lambda *a: ops.ssd_scan(*a[:5], chunk=a[5],
                                             initial_state=a[6]))
    torch.cuda.synchronize()
    assert (tssd.launches, tssd.bwd_launches) == (before[0] + 1,
                                                  before[1] + 1)
    want = _ssd_grads(xbc.float(), dt, A, init, dy.float(), dfinal, H, P, N,
                      chunk, ref.ssd_scan_ref)
    for name, g, w in zip(("xbc", "dt", "A", "initial_state"), got, want):
        tol = SSD_BWD_TOLS[dtype if name == "xbc" else "float32"]
        w = _np(w)
        np.testing.assert_allclose(_np(g), w, rtol=tol,
                                   atol=tol * float(np.abs(w).max()),
                                   err_msg=f"d{name}")


# The bf16 tensor-core backward's edges: (B, S, H, P, N, chunk).  Its
# blocks sum dB and dC over groups of 8 heads (a partial group at H 6 and
# H 12), walk 64-row tiles (a chunk under 64 rows), take one row, and
# jamba-1.5-large's 256 heads at the models' head sizes.
GPU_SSD_BWD_BF16_EDGES = [
    (2, 300, 6, 64, 128, 256),
    (1, 200, 12, 32, 64, 48),
    (2, 100, 4, 64, 128, 40),
    (3, 1, 8, 64, 128, 256),
    (1, 512, 256, 64, 128, 256),
]


@pytest.mark.cuda
@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("B,S,H,P,N,chunk", GPU_SSD_BWD_BF16_EDGES)
def test_cuda_ssd_scan_bwd_bf16_edges(cuda, B, S, H, P, N, chunk, state):
    """As test_cuda_ssd_scan_bwd_matches_plain, in bf16, at the tensor-core
    kernels' edges; two calls bit-equal."""
    xbc, dt, A, init, dy, dfinal = _ssd_bwd_inputs(B, S, H, P, N, "bfloat16",
                                                   cuda, state)

    def kernel():
        return _ssd_grads(xbc, dt, A, init, dy, dfinal, H, P, N, chunk,
                          lambda *a: ops.ssd_scan(*a[:5], chunk=a[5],
                                                  initial_state=a[6]))
    before = tssd.bwd_launches
    got = kernel()
    again = kernel()
    torch.cuda.synchronize()
    assert tssd.bwd_launches == before + 2
    assert all(map(torch.equal, got, again))
    want = _ssd_grads(xbc.float(), dt, A, init, dy.float(), dfinal, H, P, N,
                      chunk, ref.ssd_scan_ref)
    parts = {"x": slice(0, H * P), "Bm": slice(H * P, H * P + N),
             "Cm": slice(H * P + N, None)}
    for name, cols in parts.items():
        w = _np(want[0][..., cols])
        np.testing.assert_allclose(
            _np(got[0][..., cols]), w, rtol=SSD_BWD_TOLS["bfloat16"],
            atol=SSD_BWD_MEDIAN_ATOL * float(np.median(np.abs(w))),
            err_msg=f"d{name}")
    for name, g, w in zip(("dt", "A", "initial_state"), got[1:], want[1:]):
        tol = SSD_BWD_TOLS["float32"]
        w = _np(w)
        np.testing.assert_allclose(_np(g), w, rtol=tol,
                                   atol=tol * float(np.abs(w).max()),
                                   err_msg=f"d{name}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (4, 4096, 32, 64, 128, 256), (2, 300, 6, 64, 128, 256),
    (1, 200, 12, 32, 64, 48), (3, 1, 8, 16, 16, 1),
    (1, 4096, 256, 64, 128, 256)])
def test_cuda_ssd_scan_bwd_workspace_matches_the_library(cuda, B, S, H, P, N,
                                                         chunk, dtype):
    """bwd_workspace_bytes, the layout the CPU tests read, is the size the
    library's ssd_scan_bwd_workspace_bytes gives the launcher."""
    _, ws_bytes = tssd._bwd_kernel()
    dt = getattr(torch, dtype)
    assert ws_bytes(tssd.DTYPES[dt], B, S, H, P, N, chunk) \
        == tssd.bwd_workspace_bytes(B, S, H, P, N, chunk, dt)


@pytest.mark.cuda
def test_cuda_ssd_scan_bwd_refuses_unaligned_bf16_rows(cuda):
    """The bf16 backward copies rows in 16-byte chunks (cp.async)."""
    B, S, H, P, N = 1, 64, 4, 16, 16
    xbc, dt, A, _, dy, _ = _ssd_bwd_inputs(B, S, H, P, N, "bfloat16", cuda,
                                           False)
    wide = torch.zeros(B, S, H * P + 2 * N + 1, device=cuda,
                       dtype=torch.bfloat16)
    x = wide[..., 1:1 + H * P].reshape(B, S, H, P)
    Bm, Cm = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
    before = tssd.bwd_launches
    with pytest.raises(ValueError, match="16-byte"):
        tssd.ssd_scan_bwd(x, dt, A, Bm, Cm, dy, chunk=32)
    assert tssd.bwd_launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_ssd_scan_bwd_is_deterministic(cuda, dtype):
    """No atomics: two calls give bit-equal gradients."""
    B, S, H, P, N = 2, 300, 8, 64, 128
    xbc, dt, A, init, dy, dfinal = _ssd_bwd_inputs(B, S, H, P, N, dtype,
                                                   cuda, True)
    x = xbc[..., :H * P].reshape(B, S, H, P)
    Bm, Cm = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
    first = tssd.ssd_scan_bwd(x, dt, A, Bm, Cm, dy, chunk=256,
                              initial_state=init, dfinal=dfinal)
    for _ in range(2):
        again = tssd.ssd_scan_bwd(x, dt, A, Bm, Cm, dy, chunk=256,
                                  initial_state=init, dfinal=dfinal)
        assert all(map(torch.equal, first, again))


@pytest.mark.cuda
def test_cuda_ssd_scan_bwd_refuses_what_it_does_not_take(cuda):
    B, S, H, P, N = 1, 64, 4, 16, 16
    xbc, dt, A, init, dy, dfinal = _ssd_bwd_inputs(B, S, H, P, N, "float32",
                                                   cuda, True)
    x = xbc[..., :H * P].reshape(B, S, H, P)
    Bm, Cm = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
    before = tssd.bwd_launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        tssd.ssd_scan_bwd(x.cpu(), dt, A, Bm, Cm, dy, chunk=32)
    with pytest.raises(ValueError, match="head_dim, state"):
        B32 = torch.zeros(B, S, 32, device=cuda)
        tssd.ssd_scan_bwd(x, dt, A, B32, B32, dy, chunk=32)
    with pytest.raises(ValueError, match="dy"):
        tssd.ssd_scan_bwd(x, dt, A, Bm, Cm, dy.bfloat16(), chunk=32)
    with pytest.raises(ValueError, match="dy"):
        tssd.ssd_scan_bwd(x, dt, A, Bm, Cm, dy.transpose(1, 2).contiguous()
                          .transpose(1, 2), chunk=32)
    with pytest.raises(ValueError, match="dfinal"):
        tssd.ssd_scan_bwd(x, dt, A, Bm, Cm, dy, chunk=32,
                          dfinal=dfinal[:, :2])
    with pytest.raises(ValueError, match="chunk"):
        tssd.ssd_scan_bwd(x, dt, A, Bm, Cm, dy, chunk=0)
    assert tssd.bwd_launches == before


# A Mamba model's gradients, card against CPU, as rtol and times the leaf's
# largest entry: 1e-4, as every model's, but 1e-3 for each mixer's small
# leaves (dt_bias, D, A_log, one entry a head).  These are sums that cancel
# to ~1e-3 of their terms, so the card's float32 elementwise torch alone
# moves them by ~4e-4 (test_cuda_mamba_grads_gain_no_error_from_kernels
# measures it).
GRAD_TOL = 1e-4
MAMBA_GRAD_TOL = 1e-3
MAMBA_SMALL_LEAVES = ("A_log", "D", "dt_bias")


def _grad_tol(path: tuple) -> float:
    return (MAMBA_GRAD_TOL if "mamba" in path
            and path[-1] in MAMBA_SMALL_LEAVES else GRAD_TOL)


def _mamba_smoke_setups(cuda):
    """The float32 Mamba-2 smoke with the real head sizes (P 64, N 128,
    chunk 64; 100 tokens: a partial chunk), set up on the CPU and on the
    card from the same parameters, and a batch."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.tree import tree_map

    cfg = get_config("mamba2-370m").smoke(ssm_head_dim=64, ssm_state=128,
                                          ssm_chunk=64)
    t_cpu, t_gpu = (train.setup(cfg, steps=2, batch=2, seq=100, device=d)
                    for d in ("cpu", "cuda"))
    s_cpu = t_cpu.init()
    s_gpu = tree_map(lambda x: x.to(cuda) if isinstance(x, torch.Tensor)
                     else x, s_cpu)
    return cfg, (t_cpu, s_cpu), (t_gpu, s_gpu), t_cpu.pipeline.batch_at(0)


def _loss_and_grads(t, s, batch, device):
    """The loss and {leaf path: gradient on the CPU}."""
    from repro_torch.tree import leaves, leaves_with_path

    for p in leaves(s.params):
        p.requires_grad_(True)
    loss, _ = t.model.loss(s.params, {k: torch.from_numpy(v).to(device)
                                      for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves(s.params))
    return loss.item(), {path: g.cpu() for (path, _), g in
                         zip(leaves_with_path(s.params), grads)}


def _worst(got, want) -> dict[float, tuple[float, str]]:
    """For each gradient limit, the largest |got - want| of a leaf held to
    it over that leaf's largest entry, and the leaf's path."""
    out: dict[float, tuple[float, str]] = {}
    for path, b in want.items():
        rel = float((got[path] - b).abs().max()
                    / b.abs().max().clamp(min=1e-30))
        tol = _grad_tol(path)
        if rel >= out.get(tol, (-1.0, ""))[0]:
            out[tol] = (rel, "/".join(map(str, path)))
    return out


@pytest.mark.cuda
def test_cuda_mamba_train_step_matches_cpu(cuda):
    """One float32 Mamba-2 smoke step on the card (kernels, the SSD backward
    once per layer) against the CPU (plain versions), from the same
    parameters: loss within 1e-4, each gradient within its limit
    (``_grad_tol``) relative and of the leaf's largest entry."""
    cfg, (t_cpu, s_cpu), (t_gpu, s_gpu), batch = _mamba_smoke_setups(cuda)
    lc, gc = _loss_and_grads(t_cpu, s_cpu, batch, "cpu")
    before = tssd.bwd_launches
    lg, gg = _loss_and_grads(t_gpu, s_gpu, batch, cuda)
    assert tssd.bwd_launches == before + cfg.n_layers
    assert abs(lc - lg) <= 1e-4
    print("largest gradient error of a leaf, card against CPU: "
          + "; ".join(f"limit {tol:g}: {rel:.2e} ({where})" for tol,
                      (rel, where) in sorted(_worst(gg, gc).items())))
    for path, b in gc.items():
        tol, w = _grad_tol(path), _np(b)
        np.testing.assert_allclose(_np(gg[path]), w, rtol=tol,
                                   atol=tol * np.abs(w).max(),
                                   err_msg="/".join(map(str, path)))
    s_cpu, m_cpu = t_cpu.train_step(s_cpu, batch)
    s_gpu, m_gpu = t_gpu.train_step(s_gpu, batch)
    assert abs(float(m_cpu["loss"]) - float(m_gpu["loss"])) <= 1e-4


@pytest.mark.cuda
def test_cuda_mamba_grads_gain_no_error_from_kernels(cuda, monkeypatch):
    """The floor under MAMBA_GRAD_TOL: the same gradients with every kernel
    (RMSNorm, the SSD scan, the cross-entropy, each both ways) swapped for
    its plain version on the CPU through differentiable copies, so that
    only the card's plain torch (products, conv, gates, softplus) runs
    there.  That alone moves a mixer's small leaves (dt_bias, D, A_log) by
    well over 1e-4 of their largest entry, and the kernels add no more than
    a tenth of it.  Both runs' worst leaf under each limit is printed."""
    _, (t_cpu, s_cpu), (t_gpu, s_gpu), batch = _mamba_smoke_setups(cuda)
    _, gc = _loss_and_grads(t_cpu, s_cpu, batch, "cpu")
    with_kernels = _worst(_loss_and_grads(t_gpu, s_gpu, batch, cuda)[1], gc)

    def on_cpu(fn):
        def run(*args, **kw):
            def cpu(x):
                return x.cpu() if isinstance(x, torch.Tensor) else x
            out = fn(*map(cpu, args), **{k: cpu(v) for k, v in kw.items()})
            return (tuple(o.to(cuda) for o in out) if isinstance(out, tuple)
                    else out.to(cuda))
        return run

    for name in ("rmsnorm", "ssd_scan", "fused_cross_entropy"):
        monkeypatch.setattr(ops, name, on_cpu(getattr(ops, name)))
    launches = ops.launch_counts()
    plain_torch = _worst(_loss_and_grads(t_gpu, s_gpu, batch, cuda)[1], gc)
    assert ops.launch_counts() == launches   # no kernel ran
    for name, worst in (("the kernels", with_kernels),
                        ("the card's plain torch alone", plain_torch)):
        print(f"largest gradient error of a leaf, card against CPU, with "
              f"{name}: " + "; ".join(
                  f"limit {tol:g}: {rel:.2e} ({where})"
                  for tol, (rel, where) in sorted(worst.items())))
    assert plain_torch[MAMBA_GRAD_TOL][0] > GRAD_TOL
    assert with_kernels[MAMBA_GRAD_TOL][0] <= 1.1 * plain_torch[
        MAMBA_GRAD_TOL][0]


@pytest.mark.cuda
def test_cuda_train_step_matches_cpu(cuda):
    """One float32 smoke train step on the card (kernels) against the CPU
    (plain versions), from the same parameters: loss within 1e-4, gradients
    within 1e-4 relative and of the leaf's largest entry."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.tree import leaves, tree_map

    cfg = get_config("qwen2-7b").smoke(sliding_window=32, n_kv_heads=2)
    t_cpu, t_gpu = (train.setup(cfg, steps=2, batch=2, seq=100, device=d)
                    for d in ("cpu", "cuda"))
    s_cpu = t_cpu.init()
    s_gpu = tree_map(lambda x: x.to(cuda) if isinstance(x, torch.Tensor)
                     else x, s_cpu)
    batch = t_cpu.pipeline.batch_at(0)
    grads = []
    for t, s, dev in ((t_cpu, s_cpu, "cpu"), (t_gpu, s_gpu, cuda)):
        for p in leaves(s.params):
            p.requires_grad_(True)
        loss, _ = t.model.loss(s.params, {k: torch.from_numpy(v).to(dev)
                                          for k, v in batch.items()})
        grads.append((loss, torch.autograd.grad(loss, leaves(s.params))))
    (lc, gc), (lg, gg) = grads
    assert abs(lc.item() - lg.item()) <= 1e-4
    for a, b in zip(gg, gc):
        _assert_grad_close(a, b, "float32")
    s_cpu, m_cpu = t_cpu.train_step(s_cpu, batch)
    s_gpu, m_gpu = t_gpu.train_step(s_gpu, batch)
    assert abs(float(m_cpu["loss"]) - float(m_gpu["loss"])) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("arch,frames", [("whisper-base", 100),
                                         ("llava-next-34b", None)])
def test_cuda_family_serves_and_trains_like_cpu(cuda, arch, frames):
    """The encoder-decoder (100 frames against 40 tokens) and the VLM (a
    prefix of 8 patch rows) smoke models in float32, card (kernels) against
    CPU (plain versions) from the same parameters: equal greedy tokens and
    the last logits within 1e-3; one batch's loss within 1e-4 and its
    gradients within 1e-4 relative and of the leaf's largest entry."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve, train
    from repro_torch.tree import leaves, tree_map

    def to(device):
        return lambda x: x.to(device) if isinstance(x, torch.Tensor) else x

    cfg = get_config(arch).smoke()
    t_cpu, t_gpu = (train.setup(cfg, steps=2, batch=2, seq=40, device=d)
                    for d in ("cpu", "cuda"))
    s_cpu = t_cpu.init()
    s_gpu = tree_map(to(cuda), s_cpu)
    batch = serve.prompt_batch(cfg, 2, 40, 0, "cpu", frames=frames)
    r_cpu = serve.generate(t_cpu.model, s_cpu.params, batch, 5)
    r_gpu = serve.generate(t_gpu.model, s_gpu.params,
                           tree_map(to(cuda), batch), 5)
    assert torch.equal(r_gpu["tokens"].cpu(), r_cpu["tokens"])
    np.testing.assert_allclose(_np(r_gpu["logits"]), _np(r_cpu["logits"]),
                               rtol=1e-3, atol=1e-3)

    data = t_cpu.pipeline.batch_at(0)
    if frames:
        data["frames"] = _normal(5, (2, frames, cfg.d_model))
    grads = []
    for t, s, dev in ((t_cpu, s_cpu, "cpu"), (t_gpu, s_gpu, cuda)):
        for p in leaves(s.params):
            p.requires_grad_(True)
        loss, _ = t.model.loss(s.params, {k: torch.from_numpy(v).to(dev)
                                          for k, v in data.items()})
        grads.append((loss, torch.autograd.grad(loss, leaves(s.params))))
    (lc, gc), (lg, gg) = grads
    assert abs(lc.item() - lg.item()) <= 1e-4
    for a, b in zip(gg, gc):
        _assert_grad_close(a, b, "float32")


@pytest.mark.cuda
def test_cuda_moe_ffn_matches_cpu_with_drops(cuda):
    """The MoE FFN in float32 at a capacity that drops pairs: the card's
    keep mask equals the CPU's and its output is within 1e-5 (the same sums
    in another order)."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe

    cfg = get_config("mixtral-8x22b").smoke(capacity_factor=0.5)
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg, torch.float32,
                     "cpu")
    x = torch.from_numpy(_normal(0, (3, 70, cfg.d_model)))
    y, logits = moe.moe_ffn(p, x, cfg)
    yg, lg = moe.moe_ffn({k: v.to(cuda) for k, v in p.items()}, x.to(cuda),
                         cfg)
    keep = moe.route(logits, cfg).keep
    assert not bool(keep.all())
    assert torch.equal(moe.route(lg, cfg).keep.cpu(), keep)
    np.testing.assert_allclose(_np(lg), _np(logits), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(yg), _np(y), rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_cuda_moe_ffn_bf16_at_mixtral_width(cuda):
    """One MoE layer at mixtral-8x22b's widths in bf16 (batch 4, 512
    tokens; weights drawn on the card): the same routing as the float32 CPU
    result on the same bf16 values, the output within 2e-2 of it (bf16
    roundings of the buffer products and the sum), and two calls bit-equal
    (each token's at most two terms are added to a zeroed row)."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe

    cfg = get_config("mixtral-8x22b")
    g = torch.Generator(device=cuda).manual_seed(0)
    p = moe.init_moe(g, cfg, torch.bfloat16, cuda)
    x = torch.randn(4, 512, cfg.d_model, generator=g, device=cuda).bfloat16()
    y, logits = moe.moe_ffn(p, x, cfg)
    again, _ = moe.moe_ffn(p, x, cfg)
    assert torch.equal(y, again)
    del again
    p32 = {k: v.float().cpu() for k, v in p.items()}
    y32, l32 = moe.moe_ffn(p32, x.float().cpu(), cfg)
    assert torch.equal(moe.route(logits, cfg).dest.cpu(),
                       moe.route(l32, cfg).dest)
    np.testing.assert_allclose(_np(y), _np(y32), rtol=2e-2, atol=2e-2)


ENGINE_CASES = [  # (scenario, topology): every registered one, and fat_tree
    ("dense_dp", None), ("fb_shuffle", None), ("mixed", None),
    ("mixed_oversub_3to1", None), ("moe_ep", None), ("pipe_serve", None),
    ("mixed", "fat_tree"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("scenario,topology", ENGINE_CASES)
def test_cuda_engine_lanes_match_cpu(cuda, scenario, topology):
    """The lockstep fifo engine on the card against the same lanes on the
    CPU (quick scenarios, seeds 0-4): per-job JCT/CCT and makespan within
    1e-6 (the CPU tests' tolerance against the numpy core; the card's
    cumsum associates float sums differently), equal lockstep events."""
    from repro_torch.appdag import build_scenario
    from repro_torch.core.simtorch import pack_instance, run_fifo_batch

    lanes = [pack_instance(*build_scenario(scenario, seed=s, quick=True,
                                           topology=topology))
             for s in range(5)]
    on_card = run_fifo_batch(lanes, device=cuda)
    on_cpu = run_fifo_batch(lanes, device="cpu")
    for a, b in zip(on_card, on_cpu):
        assert a.events == b.events
        assert abs(a.makespan - b.makespan) <= 1e-6
        for key in ("jct", "cct"):
            x, y = getattr(a, key), getattr(b, key)
            assert set(x) == set(y)
            assert max(abs(x[n] - y[n]) for n in y) <= 1e-6


# ------------------------------------------------- the gradient path

def _compression_tree(dtype: str, seed: int = 0) -> tuple[dict, dict]:
    """Seeded grads (magnitudes 1e-6 to 1e2, an all-zero leaf, two units
    sharing one scale) and fp32 residuals."""
    rng = np.random.default_rng(seed)

    def leaf(*shape):
        mag = 10.0 ** rng.uniform(-6, 2, shape)
        return torch.from_numpy((rng.standard_normal(shape) * mag).astype(
            np.float32)).to(getattr(torch, dtype))

    grads = {"embed": leaf(1000, 33), "zero": leaf(64) * 0,
             "units": [{"w": leaf(128, 96), "b": leaf(96)} for _ in range(2)]}
    res = {"embed": torch.zeros(1000, 33), "zero": torch.zeros(64),
           "units": [{"w": torch.from_numpy(
                          1e-3 * rng.standard_normal((128, 96)).astype(
                              np.float32)),
                      "b": torch.zeros(96)} for _ in range(2)]}
    return grads, res


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_compression_bit_equal_to_cpu(cuda, dtype):
    """``compress_grads`` on the card equals the CPU's bit for bit (the
    same IEEE operations; the division is correctly rounded on both);
    ``ef_residual_sq`` sums in another order (1e-6 relative)."""
    from repro_torch.parallel.compression import EFState, compress_grads
    from repro_torch.tree import leaves, tree_map

    grads, res = _compression_tree(dtype)
    dc, ec, mc = compress_grads(tree_map(lambda x: x.to(cuda), grads),
                                EFState(tree_map(lambda x: x.to(cuda), res)))
    dh, eh, mh = compress_grads(grads, EFState(res))
    for a, b in zip(leaves(dc) + leaves(ec.residual),
                    leaves(dh) + leaves(eh.residual)):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b)
    assert float(mc["ef_residual_sq"]) == pytest.approx(
        float(mh["ef_residual_sq"]), rel=1e-6)


@pytest.mark.cuda
def test_cuda_nccl_ordered_psum_issue_order(cuda, tmp_path):
    """World 1 on NCCL: the all-reduces go out in the given order (a
    recording wrapper around the call) and a one-rank sum is the input."""
    import torch.distributed as dist

    from repro_torch.parallel import collectives as col

    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), world_size=1, rank=0)
    calls = []
    all_reduce = dist.all_reduce

    def recording(t, *args, **kw):
        calls.append(t.numel())
        return all_reduce(t, *args, **kw)

    dist.all_reduce = recording
    try:
        g = torch.Generator(device=cuda).manual_seed(0)
        buckets = [torch.randn(n, device=cuda, generator=g)
                   for n in (8, 16, 32, 64)]
        out = col.ordered_psum(buckets, [2, 0, 3, 1])
        assert calls == [32, 8, 64, 16]
        assert all(torch.equal(a, b) for a, b in zip(out, buckets))
        scattered = col.ordered_psum_scatter(
            [{"w": b.reshape(-1, 4)} for b in buckets], [3, 2, 1, 0])
        assert all(torch.equal(s["w"], b.reshape(-1, 4))
                   for s, b in zip(scattered, buckets))
    finally:
        dist.all_reduce = all_reduce
        dist.destroy_process_group()


# The DP launcher's preset on the cards: "full" (head_dim 64), the
# launcher's default.
DP_CARD_PRESET = "full"


def _dp_card_rank(rank: int, world: int, tmp: str, steps: int) -> None:
    """One NCCL rank of the DP launcher's step on card ``rank``."""
    import torch.distributed as dist

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.launch import train_lm
    from repro_torch.models import get_model
    from repro_torch.train.state import init_state
    from repro_torch.tree import leaves

    torch.cuda.set_device(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("nccl", init_method=f"file://{tmp}/rendezvous",
                            world_size=world, rank=rank)
    calls = []
    all_reduce = dist.all_reduce

    def recording(t, *args, **kw):
        calls.append(t.numel())
        return all_reduce(t, *args, **kw)

    dist.all_reduce = recording
    try:
        cfg = train_lm.preset_config(DP_CARD_PRESET)
        p = train_lm.PRESETS[DP_CARD_PRESET]
        shape = ShapeConfig("example", seq_len=p["seq"],
                            global_batch=p["batch"] * world, kind="train")
        order, _ = train_lm.sync_order(cfg, shape, world, "msa")
        model = get_model(cfg, device=f"cuda:{rank}")
        opt = train_lm.make_optimizer(p["steps"])
        state = init_state(model, opt, 0)
        step = train_lm.make_dp_step(model, opt, order)
        pipe = SyntheticTokens(cfg, batch=shape.global_batch, seq=p["seq"])
        losses, norms = [], []
        for i in range(steps):
            state, m = step(state, train_lm.rank_rows(pipe.batch_at(i), rank,
                                                      world))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        torch.save({"order": order, "calls": calls, "losses": losses,
                    "norms": norms,
                    "params": [x.detach().cpu() for x in
                               leaves(state.params)]},
                   f"{tmp}/rank{rank}.pt")
    finally:
        dist.all_reduce = all_reduce
        dist.destroy_process_group()


@pytest.mark.cuda
def test_cuda_dp_step_on_every_card_matches_one_card(cuda, tmp_path):
    """The DP launcher's step (its ``full`` preset, float32) on every card
    (one NCCL rank each, MSA order), three steps with its optimizer: the
    ranks' parameters bit-equal; parameters within 1e-5, and losses and
    gradient norms within 1e-5 relative, of one card's step on the global
    batch (the CPU test's limits, ``tests/test_torch_collectives.py``);
    one all-reduce per bucket in the plan's order, then the loss's."""
    import time

    import torch.multiprocessing as mp

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.launch import train_lm
    from repro_torch.models import get_model
    from repro_torch.parallel.collectives import unit_grad_buckets
    from repro_torch.train.state import init_state
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import leaves

    world, steps = torch.cuda.device_count(), 3
    if world < 2:
        pytest.skip("needs two or more CUDA devices")
    ctx = mp.start_processes(_dp_card_rank,
                             args=(world, str(tmp_path), steps),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + 300
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
            pytest.fail("ranks still running after 300 s")
    outs = [torch.load(tmp_path / f"rank{r}.pt") for r in range(world)]

    cfg = train_lm.preset_config(DP_CARD_PRESET)
    p = train_lm.PRESETS[DP_CARD_PRESET]
    model = get_model(cfg, device=cuda)
    opt = train_lm.make_optimizer(p["steps"])
    state = init_state(model, opt, 0)
    sizes = [sum(x.numel() for x in leaves(b))
             for b in unit_grad_buckets(state.params)]
    step = make_train_step(model, opt)
    pipe = SyntheticTokens(cfg, batch=p["batch"] * world, seq=p["seq"])
    losses, norms = [], []
    for i in range(steps):
        state, m = step(state, pipe.batch_at(i))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    shape = ShapeConfig("example", seq_len=p["seq"],
                        global_batch=p["batch"] * world, kind="train")
    order, plan = train_lm.sync_order(cfg, shape, world, "msa")
    assert order == plan.order + [len(sizes) - 1]
    for out in outs:
        assert out["order"] == order
        assert out["calls"] == steps * ([sizes[i] for i in out["order"]]
                                        + [1])
        np.testing.assert_allclose(out["losses"], losses, rtol=1e-5)
        np.testing.assert_allclose(out["norms"], norms, rtol=1e-5)
        for a, b in zip(out["params"], outs[0]["params"]):
            assert torch.equal(a, b)
    for got, want in zip(outs[0]["params"], leaves(state.params)):
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-5)


# ------------------------------------------- the parallel layouts (DTensor)

def _world1_mesh(tmp_path):
    """A (data=1, model=1) NCCL mesh over this process alone."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_test_mesh

    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("nccl", store=store, world_size=1, rank=0)
    return make_test_mesh(1, 1, device_type="cuda")


@pytest.mark.cuda
def test_cuda_layouts_at_world_one(cuda, tmp_path):
    """One card as a (1, 1) mesh: ``placements`` and ``distribute_state``
    give each leaf its spec's placements and the one-card init bit for
    bit; ``shard`` redistributes a DTensor and leaves a plain tensor; one
    ``make_sharded_step`` (float32 qwen2 smoke, kernels on the local
    shards) equals the plain step bit for bit, with the same kernel
    launches."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.parallel import axes as ax
    from repro_torch.parallel.sharding import (param_specs, placements,
                                               sanitize)
    from repro_torch.tree import leaves

    mesh = _world1_mesh(tmp_path)
    try:
        assert placements(ax.P("data", "model"), mesh) == (Shard(0),
                                                           Shard(1))
        x = torch.ones(4, 8, device=cuda)
        assert ax.shard(x, ax.BATCH, ax.TP) is x
        d = DTensor.from_local(x, mesh, (Replicate(), Replicate()))
        with ax.logical_mesh(mesh):
            got = ax.shard(d, ax.BATCH, ax.TP)
        assert got.placements == (Shard(0), Shard(1))
        assert torch.equal(got.full_tensor(), x)

        cfg = get_config("qwen2-7b-smoke")
        kw = dict(steps=60, batch=4, seq=64, seed=0, device=cuda)
        plain = train.setup(cfg, **kw)
        sharded = train.setup(cfg, mesh=mesh, **kw)
        s0, s1 = plain.init(), sharded.init()
        specs = leaves(param_specs(s0.params))
        assert len(specs) == len(leaves(s0.params))
        for p, q, spec in zip(leaves(s0.params), leaves(s1.params), specs):
            assert q.placements == placements(sanitize(spec, p.shape, mesh),
                                              mesh)
            assert torch.equal(q.full_tensor(), p)
        batch = plain.pipeline.batch_at(0)
        ops.reset_launch_counts()
        s0, m0 = plain.train_step(s0, batch)
        want_counts = ops.launch_counts()
        ops.reset_launch_counts()
        s1, m1 = sharded.train_step(s1, batch)
        assert ops.launch_counts() == want_counts
        assert float(m1["loss"]) == float(m0["loss"])
        for p, q in zip(leaves(s0.params), leaves(s1.params)):
            assert torch.equal(q.full_tensor(), p)
    finally:
        dist.destroy_process_group()


LAYOUT_MESH = (2, 2)
LAYOUT_TIMEOUT_S = 480


def _spawn_cards(fn, tmp_path, *args) -> None:
    import time

    import torch.multiprocessing as mp

    world = LAYOUT_MESH[0] * LAYOUT_MESH[1]
    ctx = mp.start_processes(fn, args=(world, str(tmp_path)) + args,
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + LAYOUT_TIMEOUT_S
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
            pytest.fail(f"ranks still running after {LAYOUT_TIMEOUT_S} s")


def _card_mesh(rank: int, world: int, tmp: str, dims=LAYOUT_MESH,
               names=("data", "model")):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.cuda.set_device(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("nccl", init_method=f"file://{tmp}/rendezvous",
                            world_size=world, rank=rank)
    return init_device_mesh("cuda", dims, mesh_dim_names=names)


def _qwen2(layers: int, dtype: str):
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("qwen2-7b"), n_layers=layers,
                               dtype=dtype)


LAYOUT_F32 = dict(layers=2, batch=2, seq=1024)


def _layout_f32_rank(rank: int, world: int, tmp: str) -> None:
    """(a): loss and every gathered gradient of the sharded step on a
    (2, 2) mesh; rank 0 then computes the one-card step on its card and
    saves the worst errors."""
    import torch.distributed as dist

    from repro_torch.launch import train
    from repro_torch.parallel import axes as ax
    from repro_torch.parallel.sharding import distribute_batch
    from repro_torch.tree import leaves_with_path

    mesh = _card_mesh(rank, world, tmp)
    try:
        cfg = _qwen2(LAYOUT_F32["layers"], "float32")
        kw = dict(steps=60, batch=LAYOUT_F32["batch"],
                  seq=LAYOUT_F32["seq"], seed=0)
        t = train.setup(cfg, mesh=mesh, device=f"cuda:{rank}", **kw)
        state = t.init()
        batch = t.pipeline.batch_at(0)
        flat = [p for _, p in leaves_with_path(state.params)]
        for p in flat:
            p.requires_grad_(True)
        with train.sharding_rules(mesh):
            loss, _ = t.model.loss(state.params,
                                   distribute_batch(batch, mesh))
            loss = ax.full(loss)
            grads = torch.autograd.grad(loss, flat)
        got = [g.full_tensor().cpu() for g in grads]
        got_loss = float(loss.detach())
        del state, grads, flat, loss
        torch.cuda.empty_cache()
        dist.barrier()
        if rank == 0:
            one = train.setup(cfg, device="cuda:0", **kw)
            s = one.init()
            paths = [path for path, _ in leaves_with_path(s.params)]
            params = [p.requires_grad_(True) for _, p in
                      leaves_with_path(s.params)]
            want_loss, _ = one.model.loss(s.params, {
                k: torch.from_numpy(v).cuda() for k, v in batch.items()})
            want = torch.autograd.grad(want_loss, params)
            worst = []
            for path, g, w in zip(paths, got, want):
                w = w.float().cpu()
                worst.append((float((g - w).abs().max())
                               / max(float(w.abs().max()), 1e-30),
                               str(path)))
            torch.save({"loss": got_loss, "want_loss": float(want_loss),
                        "worst": sorted(worst, reverse=True)},
                       f"{tmp}/out.pt")
        dist.barrier()
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_cuda_layouts_qwen2_f32_on_four_cards_match_one_card(cuda,
                                                               tmp_path):
    """(a) qwen2-7b at full width in float32, 2 layers, 2 x 1024, on a
    (data=2, model=2) NCCL mesh: the loss within 1e-4 relative, and every
    gathered gradient leaf within 1e-4 of its largest entry, of the same
    step on one card."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    _spawn_cards(_layout_f32_rank, tmp_path)
    out = torch.load(tmp_path / "out.pt")
    print(f"loss {out['loss']!r} one card {out['want_loss']!r}; worst "
          f"gradient leaves {out['worst'][:3]}")
    assert out["loss"] == pytest.approx(out["want_loss"], rel=1e-4)
    assert out["worst"][0][0] <= 1e-4, out["worst"][:3]


LAYOUT_BF16 = dict(layers=28, batch=2, seq=4096, steps=3)
LAYOUT_SAMPLE = ("embed", "final_norm", "lm_head")


def _vocab_gather_ms(mesh, cfg, tokens: int) -> float:
    """CUDA-event ms of the cross-entropy's vocab gather at the train
    shape: a rank's rows of the logits, [tokens / data, V] bf16, from
    ``Shard(1)`` on ``model`` to ``Replicate`` (the mean of 10 after 3)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    data, model = mesh.shape
    local = torch.randn(tokens // data, cfg.vocab_size // model,
                        device="cuda", dtype=torch.bfloat16)
    x = DTensor.from_local(local, mesh, (Shard(0), Shard(1)),
                           run_check=False)
    for _ in range(3):
        x.redistribute(mesh, (Shard(0), Replicate()))
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(10):
        x.redistribute(mesh, (Shard(0), Replicate()))
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 10


def _layout_bf16_rank(rank: int, world: int, tmp: str) -> None:
    """(b): qwen2-7b at full depth, three sharded steps; the losses, step
    times and peak memory, every replicated leaf, and a sample of leaves
    gathered from the sharded init."""
    import time

    import torch.distributed as dist

    from repro_torch.launch import train
    from repro_torch.tree import leaves_with_path

    mesh = _card_mesh(rank, world, tmp)
    try:
        cfg = _qwen2(LAYOUT_BF16["layers"], "bfloat16")
        t = train.setup(cfg, mesh=mesh, device=f"cuda:{rank}",
                        steps=LAYOUT_BF16["steps"] + 2,
                        batch=LAYOUT_BF16["batch"], seq=LAYOUT_BF16["seq"],
                        seed=0)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state = t.init()
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        init_peak = torch.cuda.max_memory_allocated()
        sample = {}
        for path, p in leaves_with_path(state.params):
            if path[0] in LAYOUT_SAMPLE or path[:2] == (
                    "units", LAYOUT_BF16["layers"] - 1):
                full = p.full_tensor()
                if rank == 0:
                    sample[str(path)] = full.cpu()
                del full
        state_bytes = sum(p._local_tensor.numel() * p._local_tensor
                          .element_size() for _, p in
                          leaves_with_path((state.params, state.opt.m,
                                            state.opt.v)))
        torch.cuda.reset_peak_memory_stats()
        losses, step_ms = [], []
        for i in range(LAYOUT_BF16["steps"]):
            t0 = time.perf_counter()
            state, m = t.train_step(state, t.pipeline.batch_at(i))
            losses.append(float(m["loss"]))
            step_ms.append(1e3 * (time.perf_counter() - t0))
        peak = torch.cuda.max_memory_allocated()
        gather_ms = _vocab_gather_ms(mesh, cfg, LAYOUT_BF16["batch"]
                                     * LAYOUT_BF16["seq"])
        torch.save({"losses": losses, "step_ms": step_ms, "peak": peak,
                    "vocab_gather_ms": gather_ms,
                    "init_peak": init_peak, "init_s": init_s,
                    "state_bytes": state_bytes, "sample": sample,
                    "replicated": {k: p._local_tensor.cpu() for k, p in
                                   ((str(path), p) for path, p in
                                    leaves_with_path(state.params))
                                   if all(pl.is_replicate()
                                          for pl in p.placements)}},
                   f"{tmp}/rank{rank}.pt")
        dist.barrier()
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_cuda_layouts_qwen2_full_depth_on_four_cards(cuda, tmp_path):
    """(b) qwen2-7b at full width and depth (28 layers), bf16, 2 x 4096, on
    a (2, 2) NCCL mesh, three steps: finite losses; every replicated leaf
    bit-equal across the ranks; the embedding, final norm, LM head and the
    last unit gathered from the sharded init equal to the one-card init,
    bit for bit (drawn here a part at a time from the same seed).  Prints
    the per-card peak memory and ms/step."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    from repro_torch.models import get_model
    from repro_torch.tree import leaves_with_path

    _spawn_cards(_layout_bf16_rank, tmp_path)
    outs = [torch.load(tmp_path / f"rank{r}.pt") for r in range(4)]
    for r, out in enumerate(outs):
        print(f"rank {r}: vocab gather {out['vocab_gather_ms']:.3f} ms; "
              f"losses {out['losses']}, ms/step "
              f"{[round(x, 1) for x in out['step_ms']]}, peak "
              f"{out['peak'] / 1e9:.2f} GB (init {out['init_peak'] / 1e9:.2f}"
              f" GB, {out['init_s']:.1f} s), state "
              f"{out['state_bytes'] / 1e9:.2f} GB")
        assert all(np.isfinite(out["losses"]))
        assert out["losses"] == outs[0]["losses"]
        assert sorted(out["replicated"]) == sorted(outs[0]["replicated"])
        for k, v in out["replicated"].items():
            assert torch.equal(v, outs[0]["replicated"][k]), (r, k)
    model = get_model(_qwen2(LAYOUT_BF16["layers"], "bfloat16"),
                      device=cuda)
    want, unit = {}, -1
    for key, value in model.init_parts(0):
        if key == "units":
            unit += 1
            if unit != LAYOUT_BF16["layers"] - 1:
                continue
            prefix = ("units", unit)
        else:
            prefix = (key,)
        for path, leaf in leaves_with_path(value):
            want[str(prefix + path)] = leaf.cpu()
    sample = outs[0]["sample"]
    assert sample and set(sample) <= set(want)
    for k, v in sample.items():
        assert torch.equal(v, want[k]), k


PIPE_STAGES, PIPE_UNITS, PIPE_MICRO = 4, 28, 4
PIPE_BATCH, PIPE_SEQ = 4, 512


def _pipe_stage_fn(cfg):
    from repro_torch.models import transformer

    def stage(units, h):
        for up in units:
            h = transformer._apply_unit_train(h, up, cfg)[0]
        return h
    return stage


def _pipeline_rank(rank: int, world: int, tmp: str) -> None:
    """(c): qwen2-7b's 28 units, 7 a stage, through ``make_pipelined_fn``;
    each rank holds only its stage's units.  Rank 0 also runs the one-card
    forward and saves both logits' difference."""
    import torch.distributed as dist

    from repro_torch.kernels import ops as kops
    from repro_torch.models import get_model, transformer
    from repro_torch.parallel.pipeline import make_pipelined_fn

    mesh = _card_mesh(rank, world, tmp, dims=(PIPE_STAGES,),
                      names=("stage",))
    try:
        cfg = _qwen2(PIPE_UNITS, "bfloat16")
        model = get_model(cfg, device=f"cuda:{rank}")
        per = PIPE_UNITS // PIPE_STAGES
        params, units, i = {}, [], 0
        for key, value in model.init_parts(0):
            if key == "units":
                if rank * per <= i < (rank + 1) * per or rank == 0:
                    units.append((i, value))
                i += 1
            else:
                params[key] = value
        mine = [u for j, u in units if rank * per <= j < (rank + 1) * per]
        tokens = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (PIPE_BATCH, PIPE_SEQ))).cuda()
        stage = _pipe_stage_fn(cfg)
        with torch.no_grad():
            h = transformer.embed_tokens(params, tokens, cfg)
            x = h.reshape(PIPE_MICRO, PIPE_BATCH // PIPE_MICRO, *h.shape[1:])
            kops.reset_launch_counts()
            out = make_pipelined_fn(stage, mesh, stacked=False)(mine, x)
            counts = kops.launch_counts()
            h = out.reshape(h.shape)
            logits = transformer.lm_head(
                params, kops.rmsnorm(h, params["final_norm"], cfg.norm_eps),
                cfg)
            if rank == 0:
                ref = stage([u for _, u in units],
                            transformer.embed_tokens(params, tokens, cfg))
                want = transformer.lm_head(
                    params, kops.rmsnorm(ref, params["final_norm"],
                                         cfg.norm_eps), cfg)
                err = float((logits.float() - want.float()).abs().max())
                torch.save({"err": err,
                            "scale": float(want.float().abs().max()),
                            "finite": bool(torch.isfinite(logits).all()),
                            "counts": counts}, f"{tmp}/out.pt")
        dist.barrier()
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_cuda_pipeline_qwen2_on_four_cards_matches_one_card(cuda, tmp_path):
    """(c) ``make_pipelined_fn`` over four cards with qwen2-7b's 28 units,
    7 a stage, as ``stage_fn``: bf16 logits of a 4 x 512 batch in 4
    microbatches within 2e-2 of the largest |logit| of the one-card forward
    of the same units; each stage launches the flash kernel once per
    attention layer and microbatch (bubble ticks compute nothing)."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    _spawn_cards(_pipeline_rank, tmp_path)
    out = torch.load(tmp_path / "out.pt")
    print(f"pipeline vs one card: max |diff| {out['err']!r} of largest "
          f"|logit| {out['scale']!r}; stage 0 launches {out['counts']}")
    assert out["finite"]
    assert out["err"] <= 2e-2 * out["scale"]
    assert out["counts"]["flash_attention"] == \
        PIPE_MICRO * PIPE_UNITS // PIPE_STAGES


# ------------------------------------------ serving under the layouts

SERVE_LLAVA = dict(layers=60, batch=4, prompt=128, gen=32)
SERVE_F32 = dict(layers=2, batch=4, prompt=128, gen=8)
SERVE_CP = dict(layers=2, prompt=8192, gen=16)


def _serve_model(arch: str, layers: int, dtype: str, rank: int,
                 context_parallel: bool = False):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import get_model

    cfg = dataclasses.replace(get_config(arch), n_layers=layers, dtype=dtype)
    return get_model(cfg, device=f"cuda:{rank}",
                     context_parallel=context_parallel)


def _serve_llava_rank(rank: int, world: int, tmp: str) -> None:
    """(d): llava-next-34b at 60 layers on (data=1, model=4), each rank
    drawing the parameters a part at a time and keeping its shards.  Then
    the same prefill in float32 on the same mesh (137.6 GB of weights: no
    card holds them alone), and rank 0, its shards freed, runs the bf16
    prefill on its card alone (68.8 GB of weights fit one card; the
    serving phase of ``chip_smoke.py`` cuts depth for its time)."""
    import time

    import torch.distributed as dist

    from repro_torch.kernels import ops as kops
    from repro_torch.launch import serve
    from repro_torch.parallel.sharding import init_params

    mesh = _card_mesh(rank, world, tmp, dims=(1, 4))
    try:
        model = _serve_model("llava-next-34b", SERVE_LLAVA["layers"],
                             "bfloat16", rank)
        t0 = time.perf_counter()
        params = init_params(model, 0, mesh)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        state_bytes = sum(p.to_local().numel() * p.element_size()
                          for p in _leaves(params))
        inputs = serve.prompt_batch(model.cfg, SERVE_LLAVA["batch"],
                                    SERVE_LLAVA["prompt"], 0, f"cuda:{rank}")
        serve.generate(model, params, inputs, 2)
        torch.cuda.reset_peak_memory_stats()
        kops.reset_launch_counts()
        r = serve.generate(model, params, inputs, SERVE_LLAVA["gen"])
        out = {"tokens": r["tokens"].cpu(), "finite": bool(r["finite"]),
               "prefill_ms": 1e3 * r["prefill_s"],
               "decode_ms": 1e3 * r["decode_s"] / r["decode_steps"],
               "peak": torch.cuda.max_memory_allocated(),
               "param_bytes": state_bytes, "init_s": init_s,
               "launches": kops.launch_counts()}
        prefill = serve.generate(model, params, inputs, 1)["logits"]
        out["prefill_logits"] = prefill.float().cpu()
        del params, r, prefill
        torch.cuda.empty_cache()
        model32 = _serve_model("llava-next-34b", SERVE_LLAVA["layers"],
                               "float32", rank)
        params = init_params(model32, 0, mesh)
        prefill = serve.generate(model32, params, inputs, 1)["logits"]
        out["f32_logits"] = prefill.float().cpu()
        del params, prefill
        torch.cuda.empty_cache()
        dist.barrier()
        if rank == 0:
            torch.cuda.reset_peak_memory_stats()
            one = serve.generate(model, model.init(0), inputs, 1)
            out["one_card_logits"] = one["logits"].float().cpu()
            out["one_card_peak"] = torch.cuda.max_memory_allocated()
            del one
            torch.cuda.empty_cache()
        torch.save(out, f"{tmp}/rank{rank}.pt")
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _leaves(tree):
    from repro_torch.tree import leaves

    return leaves(tree)


@pytest.mark.cuda
def test_cuda_serve_llava_full_depth_on_four_cards(cuda, tmp_path):
    """(d) llava-next-34b at full width and depth (60 layers, bf16, 68.8
    GB of weights) served on (data=1, model=4): batch 4, 2880 prefix rows
    and a 128-token prompt, 32 tokens.  The tokens equal on every rank,
    the logits finite, the flash and RMSNorm kernels launched on each
    rank's shards.  The prefill's logits are held to the float32 prefill
    of the same weights on the same mesh: their relative L2 error at most
    twice that of the bf16 prefill on one card (at 60 layers the bf16
    roundings of the split sums reach 2.9e-2 of the largest |logit|
    between the two bf16 runs, so neither is the other's reference).
    Prints the per-card peak memory, prefill ms and decode ms/step."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    _spawn_cards(_serve_llava_rank, tmp_path)
    outs = [torch.load(tmp_path / f"rank{r}.pt") for r in range(4)]
    for r, out in enumerate(outs):
        print(f"rank {r}: init {out['init_s']:.1f} s, weights "
              f"{out['param_bytes'] / 1e9:.2f} GB, peak "
              f"{out['peak'] / 1e9:.2f} GB; prefill {out['prefill_ms']:.1f} "
              f"ms, decode {out['decode_ms']:.2f} ms/step; launches "
              f"{out['launches']}; tokens[0, :8] "
              f"{out['tokens'][0, :8].tolist()}")
        assert out["finite"]
        assert torch.equal(out["tokens"], outs[0]["tokens"])
        assert torch.equal(out["prefill_logits"], outs[0]["prefill_logits"])
        assert out["launches"]["flash_attention"] == SERVE_LLAVA["layers"]
        assert out["launches"]["rmsnorm"] > 0
    got, one = outs[0]["prefill_logits"], outs[0]["one_card_logits"]
    ref = outs[0]["f32_logits"]

    def rel(x):
        return float((x - ref).norm() / ref.norm())

    e_tp, e_one = rel(got), rel(one)
    err, scale = float((got - one).abs().max()), float(one.abs().max())
    print(f"prefill against float32 on the mesh (relative L2): four cards "
          f"{e_tp!r}, one card {e_one!r}; four cards vs one card max |diff| "
          f"{err!r} of largest |logit| {scale!r} ({err / scale!r}); first "
          f"tokens equal {torch.equal(got.argmax(-1), one.argmax(-1))} "
          f"(float32 {torch.equal(got.argmax(-1), ref.argmax(-1))}); "
          f"one-card peak {outs[0]['one_card_peak'] / 1e9:.2f} GB")
    assert torch.isfinite(one).all() and torch.isfinite(ref).all()
    assert e_tp <= 2 * e_one


def _serve_f32_rank(rank: int, world: int, tmp: str) -> None:
    """(e): float32 qwen2 and llava, 2 layers, on (2, 2); rank 0 then
    serves the same models on its card alone."""
    import torch.distributed as dist

    from repro_torch.launch import serve
    from repro_torch.parallel.sharding import init_params

    mesh = _card_mesh(rank, world, tmp)
    try:
        out = {}
        for arch in ("qwen2-7b", "llava-next-34b"):
            model = _serve_model(arch, SERVE_F32["layers"], "float32", rank)
            inputs = serve.prompt_batch(model.cfg, SERVE_F32["batch"],
                                        SERVE_F32["prompt"], 0,
                                        f"cuda:{rank}")
            params = init_params(model, 0, mesh)
            r = serve.generate(model, params, inputs, SERVE_F32["gen"])
            del params
            torch.cuda.empty_cache()
            dist.barrier()
            if rank == 0:
                one = serve.generate(model, model.init(0), inputs,
                                     SERVE_F32["gen"])
                out[arch] = {"tokens": r["tokens"].cpu(),
                             "want_tokens": one["tokens"].cpu(),
                             "err": float((r["logits"] - one["logits"])
                                          .abs().max()),
                             "scale": float(one["logits"].abs().max())}
                torch.cuda.empty_cache()
            dist.barrier()
        if rank == 0:
            torch.save(out, f"{tmp}/out.pt")
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_cuda_serve_f32_on_four_cards_matches_one_card(cuda, tmp_path):
    """(e) float32 qwen2-7b and llava-next-34b at full width, 2 layers, on
    (data=2, model=2): greedy tokens equal to one card's, the last logits
    within 1e-4 of the largest |logit|."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    _spawn_cards(_serve_f32_rank, tmp_path)
    out = torch.load(tmp_path / "out.pt")
    for arch, got in out.items():
        print(f"{arch}: max |diff| {got['err']!r} of largest |logit| "
              f"{got['scale']!r}; tokens equal "
              f"{torch.equal(got['tokens'], got['want_tokens'])}")
        assert torch.equal(got["tokens"], got["want_tokens"]), arch
        assert got["err"] <= 1e-4 * got["scale"], arch


def _serve_cp_rank(rank: int, world: int, tmp: str) -> None:
    """(f): mixtral-8x22b (2 layers) at batch 1 with context-parallel
    decode on (2, 2), every step's logits kept; rank 0 then runs the same
    model on its card alone, fed the same tokens."""
    import time

    import torch.distributed as dist

    from repro_torch.launch import serve
    from repro_torch.parallel import axes as ax
    from repro_torch.parallel.sharding import (distribute_batch, init_params,
                                               sharding_rules)

    mesh = _card_mesh(rank, world, tmp)
    try:
        model = _serve_model("mixtral-8x22b", SERVE_CP["layers"], "bfloat16",
                             rank, context_parallel=True)
        inputs = serve.prompt_batch(model.cfg, 1, SERVE_CP["prompt"], 0,
                                    f"cuda:{rank}")
        max_seq = SERVE_CP["prompt"] + SERVE_CP["gen"]
        params = init_params(model, 0, mesh)
        logits_by_step, tokens = [], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with sharding_rules(mesh):
            logits, cache = model.prefill(params,
                                          distribute_batch(inputs, mesh),
                                          max_seq)
            placements = [str(c.kv[0].k.placements) for c in cache]
            for _ in range(SERVE_CP["gen"]):
                logits = ax.full(logits)
                logits_by_step.append(logits.float().cpu())
                tokens.append(logits.argmax(-1, keepdim=True))
                if len(tokens) < SERVE_CP["gen"]:
                    logits, cache = model.decode(params, tokens[-1], cache)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        del params, cache
        torch.cuda.empty_cache()
        dist.barrier()
        if rank == 0:
            params = model.init(0)
            with torch.no_grad():
                want, cache = model.prefill(params, inputs, max_seq)
                wants = [want.float().cpu()]
                for token in tokens[:-1]:
                    want, cache = model.decode(params, token, cache)
                    wants.append(want.float().cpu())
            torch.save({"got": logits_by_step, "want": wants,
                        "tokens": torch.cat(tokens, 1).cpu(),
                        "placements": placements, "run_s": run_s},
                       f"{tmp}/out.pt")
        dist.barrier()
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_cuda_context_parallel_decode_on_four_cards_matches_one_card(
        cuda, tmp_path):
    """(f) mixtral-8x22b at full width cut to 2 of its 56 layers, bf16,
    batch 1, a prompt of 8192 (twice its 4096-row sliding window, so the
    ring has wrapped), 16 tokens, the caches' sequence over data x model on
    (2, 2): every step's logits within 2e-2 of the largest |logit| of the
    same model on one card fed the same tokens."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    _spawn_cards(_serve_cp_rank, tmp_path)
    out = torch.load(tmp_path / "out.pt")
    errs = [float((g - w).abs().max()) / float(w.abs().max())
            for g, w in zip(out["got"], out["want"])]
    print(f"CP decode: cache placements {out['placements'][0]}; "
          f"{out['run_s']:.2f} s for prefill and {SERVE_CP['gen'] - 1} "
          f"steps; worst step {max(errs)!r} of the largest |logit|; tokens "
          f"{out['tokens'][0].tolist()}")
    assert "Shard(dim=1), Shard(dim=1)" in out["placements"][0]
    assert len(errs) == SERVE_CP["gen"] and max(errs) <= 2e-2, errs
