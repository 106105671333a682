"""The SSD scan's backward on the CPU, all in float32.

* Autograd through the port's plain scan (``ref.ssd_scan_ref``, the plain
  version of the backward kernel) against ``jax.grad`` of the JAX model's
  scan (``repro.models.mamba.ssd_scan``) on the same numpy inputs, for
  every input gradient: x, dt, A, Bm, Cm and the initial state.
* ``ssd_scan.ssd_scan_bwd_phases`` (the backward kernel's steps and 64-row
  tile walk in plain torch) against autograd through ``ref.ssd_scan_ref``
  and through the sequential recurrence ``ref.ssd_ref``.

The loss is sum(y * dy) + sum(final_state * dfinal), with dfinal zero where
a case has none.  Cases: S a multiple of the chunk and S with a partial
last chunk, with and without an initial state and a d(final state), x, Bm
and Cm as strided views of one conv output (as ``mamba_forward`` passes
them), up to 256 heads at small P and N, and the models' head sizes
(P 64, N 128) at a small S.

Tolerances, as rtol and times the gradient's largest entry as atol.  The
plain scan against JAX's: 2e-4 (the same operations in another
framework's order; at the model's A the chunk's cumulative sum of dt*A
reaches ~-1e3, and its exp carries ~|cs| * 2^-24 of relative error:
measured, at most 8e-5 of the largest ddt).  The phases against either
plain version: 1e-3, as ``chip_smoke.py`` holds the fp32 state.  The
phases sum in another order (each chunk's states, the state passes, the
tile pairs, the heads' partial dB and dC), and exp of a chunk's
cumulative sum of dt*A, which reaches ~-1e3 at the model's A, carries
~|cs| * 2^-24 of relative error in any order; measured, at most ~1e-4 of
the largest entry (dA, a sum over every row).  The sequential recurrence
takes one exp per row instead; the same bound holds.

The bf16 kernels' splits (``ssd_scan_bwd_phases(..., rounding=...)``), on
bf16 x, Bm, Cm and dy at the model's A with a ragged chunk, an initial
state and a d(final state), against autograd through ``ref.ssd_scan_ref``
and ``jax.grad`` of the JAX scan on the same values in float32, at
``chip_smoke.py``'s limits for the bf16 kernel: dx, dB and dC 2e-2 as rtol
and 2e-2 of their median |entry| as atol (they are rounded to bf16), ddt,
dA and d(initial state) 1e-3 of their largest entry.  The hi/lo pair holds
them with a wide margin (measured: at most 0.18 of the limit, dx's and
dB's bf16 rounding); one bf16 rounding of the same operands misses
d(initial state) (measured: 1.13 and 1.60 times the limit at 8 and 4
heads).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba as jmb
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.launch import profile_serve

PLAIN_TOL = 2e-4
PHASES_TOL = 1e-3
NAMES = ("x", "dt", "A", "Bm", "Cm", "initial_state")


@pytest.fixture(autouse=True)
def _jax_32bit():
    with jax.enable_x64(False):
        yield


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _arrays(B, S, H, P, N, seed, model_a, init, dfinal):
    """numpy inputs: xbc [B, S, H*P + 2N] (x, Bm and Cm are its slices), dt
    (softplus), A (the tests' -exp(0.5 N(0, 1)) or the model's
    -linspace(1, 16)), the initial state, dy and d(final state)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    xbc = rng.standard_normal((B, S, H * P + 2 * N)).astype(f32)
    dt = np.logaddexp(rng.standard_normal((B, S, H)), 0).astype(f32)
    A = (-np.linspace(1, 16, H) if model_a
         else -np.exp(0.5 * rng.standard_normal(H))).astype(f32)
    st = (0.5 * rng.standard_normal((B, H, P, N))).astype(f32) if init else None
    dy = rng.standard_normal((B, S, H, P)).astype(f32)
    df = rng.standard_normal((B, H, P, N)).astype(f32) if dfinal else None
    return xbc, dt, A, st, dy, df


def _split(xbc, H, P, N):
    B, S = xbc.shape[:2]
    return (xbc[..., :H * P].reshape(B, S, H, P), xbc[..., H * P:H * P + N],
            xbc[..., H * P + N:])


def _torch_grads(scan, arrays, H, P, N):
    """Autograd of the loss through ``scan`` (x, dt, A, Bm, Cm, initial
    state -> y, final state), x, Bm and Cm views of one leaf; the gradients
    of x, dt, A, Bm, Cm (and of the initial state where there is one)."""
    xbc, dt, A, st, dy, df = arrays
    leaf = torch.from_numpy(xbc).requires_grad_(True)
    x, Bm, Cm = _split(leaf, H, P, N)
    xs = [x, Bm, Cm]
    for t in xs:
        t.retain_grad()
    tdt, tA = (torch.from_numpy(a).requires_grad_(True) for a in (dt, A))
    tst = None if st is None else torch.from_numpy(st).requires_grad_(True)
    y, final = scan(x, tdt, tA, Bm, Cm, tst)
    loss = (y * torch.from_numpy(dy)).sum()
    if df is not None:
        loss = loss + (final * torch.from_numpy(df)).sum()
    loss.backward()
    out = [x.grad, tdt.grad, tA.grad, Bm.grad, Cm.grad]
    return out + ([] if tst is None else [tst.grad])


def _phases(arrays, chunk, H, P, N):
    xbc, dt, A, st, dy, df = arrays
    x, Bm, Cm = _split(torch.from_numpy(xbc), H, P, N)
    assert not x.is_contiguous()     # the strided views the model passes
    return [g for g in tssd.ssd_scan_bwd_phases(
        x, torch.from_numpy(dt), torch.from_numpy(A), Bm, Cm,
        torch.from_numpy(dy), chunk,
        None if st is None else torch.from_numpy(st),
        None if df is None else torch.from_numpy(df)) if g is not None]


def _assert_grads(got, want, tol, label):
    assert len(got) == len(want)
    for name, g, w in zip(NAMES, got, want):
        g, w = _np(g), _np(w)
        assert g.shape == w.shape, (label, name)
        np.testing.assert_allclose(g, w, rtol=tol,
                                   atol=tol * float(np.abs(w).max()),
                                   err_msg=f"{label} d{name}")


# (B, S, H, P, N, chunk, the model's A, initial state, d(final state)).
CASES = {
    "whole_chunks": (2, 128, 4, 16, 16, 32, False, False, False),
    "whole_chunks_state_dfinal": (2, 128, 4, 16, 16, 32, False, True, True),
    "partial_chunk": (2, 100, 4, 16, 16, 64, False, False, False),
    "partial_chunk_state": (1, 100, 4, 32, 64, 64, True, True, False),
    "partial_chunk_dfinal": (2, 100, 4, 16, 16, 64, False, False, True),
    "partial_chunk_state_dfinal": (1, 300, 4, 32, 64, 256, False, True, True),
    "heads_256": (1, 96, 256, 16, 16, 32, False, True, True),
    "model_heads": (1, 128, 4, 64, 128, 64, True, True, True),
    "model_heads_partial": (1, 100, 2, 64, 128, 64, True, False, True),
}


@pytest.mark.parametrize("name", list(CASES))
def test_plain_backward_matches_jax_grad(name):
    B, S, H, P, N, chunk, model_a, init, dfinal = CASES[name]
    arrays = _arrays(B, S, H, P, N, S + H, model_a, init, dfinal)
    xbc, dt, A, st, dy, df = arrays

    def loss(xbc, dt, A, st):
        x, Bm, Cm = _split(xbc, H, P, N)
        y, final = jmb.ssd_scan(x, dt, A, Bm, Cm, chunk, st)
        out = (y * dy).sum()
        return out + (final * df).sum() if df is not None else out

    argnums = (0, 1, 2, 3) if init else (0, 1, 2)
    jg = jax.grad(loss, argnums=argnums)(
        jnp.asarray(xbc), jnp.asarray(dt), jnp.asarray(A),
        None if st is None else jnp.asarray(st))
    jx, jB, jC = _split(np.asarray(jg[0]), H, P, N)
    want = [jx, jg[1], jg[2], jB, jC] + ([jg[3]] if init else [])
    got = _torch_grads(
        lambda x, dt, A, Bm, Cm, st: ref.ssd_scan_ref(x, dt, A, Bm, Cm,
                                                      chunk, st),
        arrays, H, P, N)
    _assert_grads(got, want, PLAIN_TOL, name)


@pytest.mark.parametrize("name", list(CASES))
def test_phases_match_plain_backward(name):
    B, S, H, P, N, chunk, model_a, init, dfinal = CASES[name]
    arrays = _arrays(B, S, H, P, N, S + H, model_a, init, dfinal)
    want = _torch_grads(
        lambda x, dt, A, Bm, Cm, st: ref.ssd_scan_ref(x, dt, A, Bm, Cm,
                                                      chunk, st),
        arrays, H, P, N)
    _assert_grads(_phases(arrays, chunk, H, P, N), want, PHASES_TOL, name)


# The sequential recurrence takes S steps: the cases up to 128 rows.
SEQ_CASES = [n for n, c in CASES.items() if c[1] <= 128]


@pytest.mark.parametrize("name", SEQ_CASES)
def test_phases_match_sequential_backward(name):
    B, S, H, P, N, chunk, model_a, init, dfinal = CASES[name]
    arrays = _arrays(B, S, H, P, N, S + H, model_a, init, dfinal)
    want = _torch_grads(ref.ssd_ref, arrays, H, P, N)
    _assert_grads(_phases(arrays, chunk, H, P, N), want, PHASES_TOL, name)


def test_phases_take_a_chunk_longer_than_the_sequence():
    """chunk > S runs one chunk of S rows (the kernel's min(chunk, S))."""
    B, S, H, P, N = 1, 70, 2, 16, 16
    arrays = _arrays(B, S, H, P, N, 5, False, True, True)
    want = _torch_grads(
        lambda x, dt, A, Bm, Cm, st: ref.ssd_scan_ref(x, dt, A, Bm, Cm, 256,
                                                      st),
        arrays, H, P, N)
    _assert_grads(_phases(arrays, 256, H, P, N), want, PHASES_TOL, "chunk>S")


# The bf16 kernels' splits: (B, S, H, P, N, chunk), a 44-row last chunk.
ROUND_CASE = (1, 300, 8, 64, 128, 256)
ROUND_TOL = {"x": 2e-2, "dt": 1e-3, "A": 1e-3, "Bm": 2e-2, "Cm": 2e-2,
             "initial_state": 1e-3}
# chip_smoke.py's SSD_BWD_MEDIAN_ATOL: dx, dB and dC's atol in bf16, times
# their median |entry|.
ROUND_MEDIAN_ATOL = 2e-2
REPO = Path(__file__).resolve().parent.parent


def _bf16_case(H):
    """The round case's arrays with xbc and dy rounded to bf16 values (still
    float32 numpy, so every reference sees what the kernel sees)."""
    B, S, _, P, N, _ = ROUND_CASE
    xbc, dt, A, st, dy, df = _arrays(B, S, H, P, N, 7, True, True, True)

    def to_bf16(a):
        return torch.from_numpy(a).bfloat16().float().numpy()
    return to_bf16(xbc), dt, A, st, to_bf16(dy), df


def _rounded_phases(arrays, H, rounding):
    _, _, _, P, N, chunk = ROUND_CASE
    xbc, dt, A, st, dy, df = arrays
    x, Bm, Cm = _split(torch.from_numpy(xbc).bfloat16(), H, P, N)
    return tssd.ssd_scan_bwd_phases(
        x, torch.from_numpy(dt), torch.from_numpy(A), Bm, Cm,
        torch.from_numpy(dy).bfloat16(), chunk, torch.from_numpy(st),
        torch.from_numpy(df), rounding=rounding)


def _jax_grads(arrays, H):
    _, _, _, P, N, chunk = ROUND_CASE
    xbc, dt, A, st, dy, df = arrays

    def loss(xbc, dt, A, st):
        x, Bm, Cm = _split(xbc, H, P, N)
        y, final = jmb.ssd_scan(x, dt, A, Bm, Cm, chunk, st)
        return (y * dy).sum() + (final * df).sum()

    jg = jax.grad(loss, argnums=(0, 1, 2, 3))(*map(jnp.asarray,
                                                    (xbc, dt, A, st)))
    jx, jB, jC = _split(np.asarray(jg[0]), H, P, N)
    return [jx, jg[1], jg[2], jB, jC, jg[3]]


def _plain_grads(arrays, H):
    _, _, _, P, N, chunk = ROUND_CASE
    return _torch_grads(
        lambda x, dt, A, Bm, Cm, st: ref.ssd_scan_ref(x, dt, A, Bm, Cm,
                                                      chunk, st),
        arrays, H, P, N)


def _limit_ratios(got, want):
    """Each output's largest |got - want| over its allclose bound, by name:
    rtol ROUND_TOL and as atol, dx, dB and dC (bf16) ROUND_MEDIAN_ATOL times
    their median |entry|, the rest ROUND_TOL times their largest."""
    out = {}
    for name, g, w in zip(NAMES, got, want):
        g, w = _np(g), _np(w)
        tol = ROUND_TOL[name]
        scale = (ROUND_MEDIAN_ATOL * float(np.median(np.abs(w)))
                 if name in ("x", "Bm", "Cm") else
                 tol * float(np.abs(w).max()))
        out[name] = float((np.abs(g - w) / (scale + tol * np.abs(w))).max())
    return out


@pytest.mark.parametrize("reference", ["plain", "jax"])
@pytest.mark.parametrize("H", [8, 4])
def test_hi_lo_phases_hold_the_bf16_limits(reference, H):
    """The bf16 kernels' hi/lo splits (W summed over a head group for dC,
    W and G o L per head, the weighted rows of the local states, S_in and
    dS_out) hold every output within the bf16 limits, against both plain
    backwards, with 8 heads (one whole group) and 4 (a partial one)."""
    arrays = _bf16_case(H)
    want = (_plain_grads if reference == "plain" else _jax_grads)(arrays, H)
    ratios = _limit_ratios(_rounded_phases(arrays, H, "hi_lo"), want)
    assert max(ratios.values()) < 0.5, ratios


def test_one_bf16_rounding_misses_the_limits():
    """One bf16 rounding where the kernels split misses the 1e-3 limit of
    ddt, dA or d(initial state), which is why they split."""
    arrays = _bf16_case(8)
    ratios = _limit_ratios(_rounded_phases(arrays, 8, "bf16"),
                           _plain_grads(arrays, 8))
    assert max(ratios[n] for n in ("dt", "A", "initial_state")) > 1.0, ratios
    with pytest.raises(ValueError, match="rounding"):
        _rounded_phases(arrays, 8, "tf32")


def test_bwd_workspace_matches_the_cuda_source():
    """The launcher's bf16 tile, head group and pass threads are the .cu
    file's constants (the card tests hold its scratch size to the library's
    ssd_scan_bwd_workspace_bytes), and at mamba2-370m's train shape (B 4, S
    4096, H 32, P 64, N 128, chunk 256) the bf16 scratch is 214 MB: the two
    fp32 states (67.1 MB each), the four head groups' partial dB and dC
    (33.6 MB each) and the per-row parts (12.6 MB)."""
    src = (REPO / "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu").read_text()
    for name, value in (("HG", tssd.HEAD_GROUP),
                        ("PASS_THREADS", tssd.PASS_THREADS),
                        ("TILE", tssd.TILE)):
        assert int(re.search(rf"constexpr int {name} = (\d+);",
                             src).group(1)) == value, name
    B, S, H, P, N, Q = 4, 4096, 32, 64, 128, 256
    rows = B * H * (S // Q) * Q
    states = 4 * B * (S // Q) * H * P * N
    parts = 4 * B * S * (H // 8) * N
    per_chunk = 4 * B * (S // Q) * H
    got = tssd.bwd_workspace_bytes(B, S, H, P, N, Q, torch.bfloat16)
    # totals and shares of dA, and <S_in, dS_out> by the pass's 4 blocks.
    assert got == (8 * rows + 4 * 4 * rows + 2 * per_chunk + 4 * per_chunk
                   + 2 * states + 2 * parts)
    assert 200e6 < got < 220e6
    # float32 keeps the CUDA-core kernels' layout: per-head partials, C.B^T
    # tiles.
    assert tssd.bwd_workspace_bytes(B, S, H, P, N, Q) > 680e6


@pytest.mark.parametrize("name", [
    "void (anonymous namespace)::ssd_bwd_local_kernel<64, 128>(Params)",
    "void (anonymous namespace)::ssd_bwd_states_kernel(Params, int)",
    "void (anonymous namespace)::ssd_bwd_dc_kernel<64, 128>(Params)",
    "void (anonymous namespace)::ssd_bwd_dcs_kernel<64, 128>(Params)",
    "void (anonymous namespace)::ssd_bwd_db_kernel<64, 128>(Params)",
    "void (anonymous namespace)::ssd_bwd_reduce_kernel<__nv_bfloat16, 128>"
    "(Params, int)",
    "void (anonymous namespace)::ssd_bwd_dA_kernel(Params)"])
def test_profiler_groups_every_bf16_backward_kernel(name):
    """The bf16 backward's seven kernels all read as the SSD backward (the
    train step's trace groups them so)."""
    assert profile_serve._group(name) == "ssd_scan_bwd"
