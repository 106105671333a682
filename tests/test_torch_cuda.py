"""The port's CUDA and Triton kernels against their plain versions, on the
card.  Every test here needs a CUDA device and skips without one; on a
machine with a card (no JAX needed):

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Inputs come from numpy with a seed.  Tolerances: float32 2e-5 (the same
sums in another order), bfloat16 2e-2 (one bf16 rounding of the output, and
of the attention weights in the plain version).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rmsnorm as trn

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
