"""The RMSNorm backward kernel's order on the CPU, and the launcher's limits.

``rmsnorm_bwd_blocked`` repeats the CUDA backward's order in plain torch:
rows dealt to blocks by a fixed stride, per-block fp32 partials of dscale,
the blocks summed in a fixed order.  It is held against autograd through the
port's plain version and against ``jax.grad`` of the JAX package's
reference, and to itself bit for bit.  The kernels themselves run only on a
card (``tests/test_torch_cuda.py``); here the launcher must refuse what the
kernels do not take without building anything.

Inputs come from numpy with a seed.  Tolerances, as rtol and times the
gradient's largest entry as atol: float32 1e-5 (sums over D and over rows in
another order), bfloat16 2e-2 (one bf16 rounding of each gradient).
"""

import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import build, ref
from repro_torch.kernels import rmsnorm as trn

REPO = Path(__file__).resolve().parents[1]
TOLS = {"float32": 1e-5, "bfloat16": 2e-2}
EPS = 1e-6
WIDTHS = (64, 512, 1000, 1024, 2048, 3584, 7168, 16384)
CTAS = (1, 7, 132)


def _normal(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


MAX_ROWS = 2 * max(CTAS) + 3


def _inputs(rows: int, D: int):
    """x, scale and dy of ``rows`` rows: the first rows of one draw of
    MAX_ROWS (or more) rows per D."""
    n = max(rows, MAX_ROWS)
    return (_normal(D, (n, D))[:rows], 1 + 0.1 * _normal(D + 1, (D,)),
            _normal(D + 2, (n, D))[:rows])


def _torch(a: np.ndarray, dtype: str) -> torch.Tensor:
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _autograd(rows: int, D: int, dtype: str):
    """Autograd through ref.rmsnorm_ref: (dx, dscale) as float32 numpy."""
    x, s, g = _inputs(rows, D)
    xt, st = (_torch(a, dtype).requires_grad_() for a in (x, s))
    return [t.float().numpy() for t in torch.autograd.grad(
        ref.rmsnorm_ref(xt, st, EPS), (xt, st), _torch(g, dtype))]


@functools.lru_cache(maxsize=None)
def _jax_vjp(dtype: str):
    f = functools.partial(jref.rmsnorm_ref, eps=EPS)
    return jax.jit(lambda x, s, g: jax.vjp(f, x, s)[1](g))


def _jax_grads(rows: int, D: int, dtype: str):
    """jax.grad of the JAX reference, as float32 numpy: computed on MAX_ROWS
    rows with dy zero past ``rows`` (those rows add exact zeros to dscale),
    so each D and dtype compiles once."""
    x, s, g = _inputs(MAX_ROWS, D)
    g = g.copy()
    g[rows:] = 0.0
    jd = jnp.dtype(dtype)
    dx, ds = _jax_vjp(dtype)(*(jnp.asarray(a).astype(jd) for a in (x, s, g)))
    return [np.asarray(dx.astype(jnp.float32))[:rows],
            np.asarray(ds.astype(jnp.float32))]


def _blocked(rows: int, D: int, dtype: str, ctas: int, warps: int = 1):
    x, s, g = (_torch(a, dtype) for a in _inputs(rows, D))
    return trn.rmsnorm_bwd_blocked(x, s, g, EPS, ctas, warps)


def _assert_close(got, want, dtype: str, label: str) -> None:
    tol = TOLS[dtype]
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * float(np.abs(want).max()),
                               err_msg=label)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ctas", CTAS)
@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("D", WIDTHS)
def test_blocked_backward_matches_autograd_and_jax(D, ragged, ctas, dtype):
    """One row, or a row count the block count does not divide (2 * ctas +
    3; for one block every count divides)."""
    rows = 2 * ctas + 3 if ragged else 1
    dx, dscale = _blocked(rows, D, dtype, ctas)
    assert dx.dtype == dscale.dtype == getattr(torch, dtype)
    assert dx.shape == (rows, D) and dscale.shape == (D,)
    for source, want in (("autograd", _autograd(rows, D, dtype)),
                         ("jax.grad", _jax_grads(rows, D, dtype))):
        for name, got, w in zip(("dx", "dscale"), (dx, dscale), want):
            _assert_close(got.float().numpy(), w, dtype, f"{name} {source}")


@pytest.mark.parametrize("warps", [2, 8])
@pytest.mark.parametrize("ctas,rows", [(7, 100), (132, 2113)])
def test_blocked_backward_with_warp_teams(ctas, rows, warps):
    """Narrow rows go a warp a row, `warps` teams a block."""
    dx, dscale = _blocked(rows, 512, "float32", ctas, warps)
    want = _autograd(rows, 512, "float32")
    _assert_close(dx.numpy(), want[0], "float32", "dx")
    _assert_close(dscale.numpy(), want[1], "float32", "dscale")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D,rows,ctas", [(1024, 300, 132), (7168, 17, 7)])
def test_blocked_dscale_is_bit_equal_across_calls(D, rows, ctas, dtype):
    a = _blocked(rows, D, dtype, ctas, 8)
    b = _blocked(rows, D, dtype, ctas, 8)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.fixture
def no_build(monkeypatch):
    """Fails the test if anything would build or load the CUDA library."""
    def refuse(*args, **kwargs):
        raise AssertionError("the launcher tried to build the library")

    monkeypatch.setattr(build, "build", refuse)
    monkeypatch.setattr(build, "load", refuse)
    monkeypatch.setattr(trn, "_fns", {})
    yield
    assert trn._fns == {}


@pytest.mark.parametrize("fn", ["rmsnorm", "rmsnorm_bwd", "bwd_grid"])
@pytest.mark.parametrize("case,match", [
    ("cpu", "CUDA tensors"),
    ("int", "float32, bfloat16 or float16"),
    ("strided", "last dimension must be contiguous"),
    ("wide", "D must be in"),
])
def test_launcher_refuses_without_building(no_build, fn, case, match):
    x = torch.ones(4, 16)
    scale = torch.ones(16)
    if case == "int":
        x = x.int()
    elif case == "strided":
        x = torch.ones(16, 4).t()
    elif case == "wide":
        x, scale = torch.ones(2, trn.MAX_D + 1), torch.ones(trn.MAX_D + 1)
    before = (trn.launches, trn.bwd_launches)
    with pytest.raises(ValueError, match=match):
        if fn == "rmsnorm":
            trn.rmsnorm(x, scale, EPS)
        elif fn == "rmsnorm_bwd":
            trn.rmsnorm_bwd(x, scale, torch.ones_like(x), EPS)
        else:
            trn.bwd_grid(x, scale, torch.ones_like(x))
    assert (trn.launches, trn.bwd_launches) == before


def test_module_imports_without_triton_or_nvcc():
    """The module imports on this host (no nvcc, no triton) and names no
    triton: its kernels are the CUDA library built by build.py."""
    src = Path(trn.__file__).read_text()
    assert "triton" not in src
    assert "rmsnorm" in build.SOURCES
    assert (build.CSRC / "rmsnorm.cu").exists()


def test_launcher_constants_match_the_cuda_source():
    """The scratch rows a SM, the dscale sum's groups (which the CPU mirror
    follows) and the width limit are the .cu file's."""
    src = (REPO / "src/repro_torch/kernels/csrc/rmsnorm.cu").read_text()
    for name, value in (("BWD_CTAS_PER_SM", trn.BWD_CTAS_PER_SM),
                        ("DSCALE_GROUPS", trn.DSCALE_GROUPS),
                        ("MAX_D", trn.MAX_D)):
        assert int(re.search(rf"constexpr int {name} = (\d+);",
                             src).group(1)) == value, name
