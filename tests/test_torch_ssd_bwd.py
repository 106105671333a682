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
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba as jmb
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as tssd

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
