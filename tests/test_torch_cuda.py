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
reaches ~1e-4 of the largest term where the terms cancel.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as tfa
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
    return x.float().cpu().numpy()


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
