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
state their tolerances below.  The bf16 SSD kernels split each fp32
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
        "bfloat16": dict(rtol=2e-2, atol=2e-2)}


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
        tfa.flash_attention(torch.zeros(1, 64, 4, 32, device=cuda),
                            torch.zeros(1, 64, 4, 32, device=cuda),
                            torch.zeros(1, 64, 4, 32, device=cuda))
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

BWD_TOLS = {"float32": 1e-4, "bfloat16": 2e-2}


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


@pytest.mark.cuda
def test_cuda_flash_bwd_refuses_cross_attention(cuda):
    q = torch.zeros(1, 64, 4, 64, device=cuda, requires_grad=True)
    kv = torch.zeros(1, 128, 4, 64, device=cuda)
    with pytest.raises(ValueError, match="Sq == Sk"):
        ops.flash_attention(q, kv, kv)
    out, lse = tfa.flash_attention(q.detach(), kv, kv, return_lse=True)
    with pytest.raises(ValueError, match="Sq == Sk"):
        tfa.flash_attention_bwd(q.detach(), kv, kv, out, lse, out)


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
