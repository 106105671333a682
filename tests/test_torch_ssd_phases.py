"""The bf16 SSD kernels' chunk-parallel steps, mirrored in plain torch
(``repro_torch.kernels.ssd_scan.ssd_scan_phases``: the chunks' local states,
the state passing, the outputs by 64-row tiles, with the hi/lo split of each
fp32 operand where the kernels apply it), against the JAX package's Pallas
kernel in interpret mode and its sequential ``ssd_ref``, and against the
port's plain scans, on the same bf16 inputs.

Tolerances are ``chip_smoke.py``'s for the bf16 kernel: y within rtol 3e-2
and atol 3e-2 (one bf16 rounding of the output; the split carries ~16 bits
of each fp32 operand), the fp32 state within rtol 1e-3 and 1e-3 of its
largest entry (the chunk's cumulative sum, summed in another order).  At
the serving statistics one bf16 rounding of the same operands misses both,
which is why the kernels split them.
"""

import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels import ssd_scan as jssd
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.launch import profile_serve

REPO = Path(__file__).resolve().parent.parent
Y_TOL = dict(rtol=3e-2, atol=3e-2)
STATE_TOL = 1e-3


@pytest.fixture(autouse=True)
def _jax_32bit():
    with jax.enable_x64(False):
        yield


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _inputs(B, S, H, P, N, seed=0, model_a=False, init=False):
    """bf16 x, Bm and Cm as views of one [B, S, H*P + 2N] conv output, fp32
    dt (softplus) and A (the tests' -exp(0.5 N(0, 1)) or the model's
    -linspace(1, 16)), and an optional fp32 initial state; numpy first, so
    JAX gets the same values."""
    rng = np.random.default_rng(seed)
    xbc = rng.standard_normal((B, S, H * P + 2 * N)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((B, S, H)), 0).astype(np.float32)
    A = (-np.linspace(1, 16, H) if model_a
         else -np.exp(0.5 * rng.standard_normal(H))).astype(np.float32)
    st = ((0.5 * rng.standard_normal((B, H, P, N))).astype(np.float32)
          if init else None)
    t_xbc = torch.from_numpy(xbc).bfloat16()
    x = t_xbc[..., :H * P].reshape(B, S, H, P)
    Bm, Cm = t_xbc[..., H * P:H * P + N], t_xbc[..., H * P + N:]
    t = (x, torch.from_numpy(dt), torch.from_numpy(A), Bm, Cm,
         None if st is None else torch.from_numpy(st))
    j = tuple(None if v is None else jnp.asarray(_np(v)) for v in t)
    j = (j[0].astype(jnp.bfloat16), j[1], j[2], j[3].astype(jnp.bfloat16),
         j[4].astype(jnp.bfloat16), j[5])
    return t, j


def _assert_y(got, want, label=""):
    np.testing.assert_allclose(_np(got), _np(want), **Y_TOL, err_msg=label)


def _assert_state(got, want, label=""):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=STATE_TOL,
                               atol=STATE_TOL * np.abs(want).max(),
                               err_msg=label)


def _ratio(got, want, rtol, atol) -> float:
    """The worst |got - want| / (atol + rtol |want|): above 1 fails."""
    got, want = got.float(), want.float()
    return float(((got - want).abs() / (atol + rtol * want.abs())).max())


# Cases of tests/test_kernels.py::TestSSDScan: (B, S, H, P, N, chunk).
SSD_CASES = {
    "small": (1, 128, 8, 16, 16, 32),
    "mid": (2, 256, 4, 32, 64, 64),
    "model_heads": (1, 64, 16, 64, 128, 64),
}


@pytest.mark.parametrize("name", list(SSD_CASES))
def test_phases_match_pallas_and_references(name):
    B, S, H, P, N, chunk = SSD_CASES[name]
    (x, dt, A, Bm, Cm, _), (jx, jdt, jA, jB, jC, _) = _inputs(B, S, H, P, N)
    y, st = tssd.ssd_scan_phases(x, dt, A, Bm, Cm, chunk)
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    assert y.shape == (B, S, H, P) and st.shape == (B, H, P, N)
    wants = {
        "pallas": jssd.ssd_scan(jx, jdt, jA, jB, jC, chunk=chunk,
                                head_block=min(4, H), interpret=True),
        "jax ssd_ref": jref.ssd_ref(jx, jdt, jA, jB, jC),
        "ssd_scan_ref": ref.ssd_scan_ref(x, dt, A, Bm, Cm, chunk),
        "ssd_ref": ref.ssd_ref(x, dt, A, Bm, Cm),
    }
    for label, (wy, wst) in wants.items():
        _assert_y(y, wy, label)
        _assert_state(st, wst, label)


# (B, S, H, P, N, chunk, initial state): ragged S with chunk 256 (a partial
# last chunk, ragged 64-row tiles), chunks that are not multiples of the
# tile (100, 200) or longer than S, and S = 1.
RAGGED = [(2, 70, 4, 64, 128, 256, False), (2, 200, 4, 64, 128, 256, True),
          (1, 300, 4, 64, 128, 256, True), (2, 300, 4, 32, 64, 100, True),
          (1, 200, 8, 16, 16, 200, False), (3, 1, 4, 64, 128, 256, True),
          (2, 130, 8, 16, 16, 32, True)]


@pytest.mark.parametrize("B,S,H,P,N,chunk,init", RAGGED)
def test_phases_ragged_and_initial_state(B, S, H, P, N, chunk, init):
    (x, dt, A, Bm, Cm, st0), (jx, jdt, jA, jB, jC, jst0) = _inputs(
        B, S, H, P, N, seed=S, init=init)
    y, st = tssd.ssd_scan_phases(x, dt, A, Bm, Cm, chunk, st0)
    wy, wst = ref.ssd_scan_ref(x, dt, A, Bm, Cm, chunk, st0)
    _assert_y(y, wy, "ssd_scan_ref")
    _assert_state(st, wst, "ssd_scan_ref")
    jy, jst = jref.ssd_ref(jx, jdt, jA, jB, jC, jst0)
    _assert_y(y, jy, "jax ssd_ref")
    _assert_state(st, jst, "jax ssd_ref")


def test_phases_read_strided_views_as_copies():
    """The kernels read x, Bm and Cm as views of one conv output; the steps
    give the same values on contiguous copies."""
    (x, dt, A, Bm, Cm, st0), _ = _inputs(2, 300, 4, 64, 128, seed=9,
                                         init=True)
    assert not x.is_contiguous() and not Bm.is_contiguous()
    got = tssd.ssd_scan_phases(x, dt, A, Bm, Cm, 256, st0)
    want = tssd.ssd_scan_phases(x.contiguous(), dt, A, Bm.contiguous(),
                                Cm.contiguous(), 256, st0)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_split_holds_the_tolerances_where_one_rounding_does_not():
    """The serving statistics (one row of mamba2-370m's heads: H 32, P 64,
    N 128, chunk 256, A = -linspace(1, 16)) at S 512: the kernels' hi/lo
    split stays inside both tolerances; one bf16 rounding of the same
    operands misses both."""
    (x, dt, A, Bm, Cm, _), _ = _inputs(1, 512, 32, 64, 128, model_a=True)
    wy, wst = ref.ssd_scan_ref(x, dt, A, Bm, Cm, 256)
    state_atol = STATE_TOL * float(wst.abs().max())
    ratios = {}
    for rounding in ("hi_lo", "bf16"):
        y, st = tssd.ssd_scan_phases(x, dt, A, Bm, Cm, 256, rounding=rounding)
        ratios[rounding] = (_ratio(y, wy, **Y_TOL),
                            _ratio(st, wst, STATE_TOL, state_atol))
    assert max(ratios["hi_lo"]) < 0.5, ratios
    assert min(ratios["bf16"]) > 1.0, ratios


def test_split_carries_sixteen_bits():
    v = torch.from_numpy(np.random.default_rng(1).standard_normal(
        10_000).astype(np.float32)) * 1e3
    pair = tssd._split(v, "hi_lo")
    single = tssd._split(v, "bf16")
    rel = ((pair - v).abs() / v.abs()).max().item()
    assert rel <= 2.0 ** -16
    assert ((single - v).abs() / v.abs()).max().item() > 2.0 ** -10
    with pytest.raises(ValueError, match="rounding"):
        tssd._split(v, "tf32")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_workspace_and_counts_at_the_serving_shape():
    """B 4, S 2048, H 32, P 64, N 128, chunk 256: the local states (33.6 MB)
    and C.B^T (8.4 MB) in the workspace; the split's second products
    roughly double the work the function needs (``chip_smoke.py``'s count
    of the tiles' operations against its bound's count)."""
    args = (4, 2048, 32, 64, 128, 256)
    assert tssd.workspace_bytes(*args) == (4 * 4 * 8 * 32 * 64 * 128
                                           + 4 * 4 * 8 * 32
                                           + 4 * 4 * 8 * 16 * 64 * 64)
    smoke = _chip_smoke()
    needed = (2 * 4 * 8 * (256 * 257 // 2) * (128 + 32 * 64)
              + 4 * 4 * 32 * 2048 * 128 * 64)
    assert smoke._ssd_flops(*args) == needed
    assert 2 * needed < smoke._ssd_executed_flops(*args) < 2.3 * needed


def test_tile_and_workspace_match_the_cuda_source():
    """The launcher's tile rows and workspace layout are the .cu file's."""
    src = (REPO / "src/repro_torch/kernels/csrc/ssd_scan.cu").read_text()
    assert int(re.search(r"constexpr int KT = (\d+);", src).group(1)) \
        == tssd.TILE
    layout = re.search(r"inline Workspace workspace_layout\(.*?\n}", src,
                       re.S).group(0)
    for line in ("w.totals = align256(sizeof(float) * B * nc * H * P * N);",
                 "w.cb = w.totals + align256(sizeof(float) * B * nc * H);",
                 "w.bytes = w.cb + sizeof(float) * B * nc * qt * qt * KT * KT;"):
        assert line in layout, line


@pytest.mark.parametrize("S,chunk", [(70, 256), (300, 256), (300, 100),
                                     (1, 32)])
def test_workspace_counts_whole_tiles(S, chunk):
    """The launcher passes min(chunk, S): chunks and 64-row tiles round up."""
    Q = min(chunk, S)
    nc, qt = -(-S // Q), -(-Q // 64)
    got = tssd.workspace_bytes(1, S, 2, 16, 16, Q)
    assert got >= 4 * nc * 2 * 256 + 4 * nc * qt * qt * 4096
    assert got % 256 == 0


@pytest.mark.parametrize("name", [
    "void (anonymous namespace)::ssd_scan_kernel<float, 64, 128>(Params)",
    "void (anonymous namespace)::ssd_cb_kernel<64, 128>(Params)",
    "void (anonymous namespace)::ssd_chunk_state_kernel<64, 128>(Params)",
    "void (anonymous namespace)::ssd_state_pass_kernel(Params, int)",
    "void (anonymous namespace)::ssd_chunk_out_kernel<64, 128>(Params)"])
def test_profiler_groups_every_ssd_kernel(name):
    """None of the names reads as a matrix product to the profiler."""
    assert profile_serve._group(name) == "ssd_scan"
