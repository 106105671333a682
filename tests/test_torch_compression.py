"""The port's int8 error-feedback gradient compression against the JAX
package's, on the CPU.

``repro_torch.parallel.compression`` keeps the reference's arithmetic:
scale = max(max|x|, 1e-12) / 127, q = clip(round(x / scale)) with both
``round``s rounding half to even, deq = q * scale, one scale per leaf of the
JAX tree (the units' leaves, stacked there, share one).  So on the same
grads and residuals the dequantized grads and the residuals equal JAX's
bit for bit; ``ef_residual_sq`` sums the same squares in another order
(1e-6 relative).

Three compressed train steps of the qwen2 smoke are held to JAX's
``make_compressing_step``, each from JAX's state before it (parameters,
moments and residual).  The gradients themselves differ from JAX's by
float-order noise, and where x = grad + residual sits within that noise of
a rounding boundary, the int8 code flips: the dequantized gradient and the
residual of that entry move by one scale step, and the parameter by up to
the learning rate.  Such entries are counted (at most 1e-4 of the entries)
and their parameters held within lr; every other parameter entry within
1e-5 of its leaf's largest entry, the losses within 1e-5 relative.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import registry as jregistry
from repro.models import transformer as jtf
from repro.optim import adamw as jadamw
from repro.parallel import compression as jcomp
from repro.train import state as jstate
from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.models import get_model
from repro_torch.models.convert import from_jax_params
from repro_torch.optim.adamw import AdamW, AdamWState
from repro_torch.parallel.compression import (EFState, compress_grads,
                                              dequantize_int8, init_ef,
                                              make_compressing_step,
                                              quantize_int8)
from repro_torch.train.state import TrainState, init_state
from repro_torch.tree import leaves, leaves_with_path

REPO = Path(__file__).resolve().parent.parent
LR = 1e-3
PARAM_ATOL_OF_MAX = 1e-5
LOSS_RTOL = 1e-5
MAX_FLIPPED_SHARE = 1e-4


@pytest.fixture(autouse=True)
def _jax_32bit():
    with jax.enable_x64(False):
        yield


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _leaves_np(seed: int) -> dict:
    """Seeded grads and residuals: entries of magnitude 1e-6 to 1e2 (a
    different spread in each leaf) and one all-zero leaf."""
    rng = np.random.default_rng(seed)
    shapes = {"a": (64,), "b": (33, 17), "c": (8, 8, 5), "d": (300,)}
    grads, res = {}, {}
    for i, (name, shape) in enumerate(shapes.items()):
        mag = 10.0 ** rng.uniform(-6, 2 - i, shape)
        grads[name] = (rng.standard_normal(shape) * mag).astype(np.float32)
        res[name] = (rng.standard_normal(shape) * 1e-3
                     * 10.0 ** -i).astype(np.float32)
    grads["zero"] = np.zeros((16,), np.float32)
    res["zero"] = np.zeros((16,), np.float32)
    return {"grads": grads, "res": res}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", [0, 1])
def test_compress_grads_bit_equal_to_jax(dtype, seed):
    data = _leaves_np(seed)
    jg = {k: jnp.asarray(v).astype(dtype) for k, v in data["grads"].items()}
    jr = {k: jnp.asarray(v) for k, v in data["res"].items()}
    tg = {k: torch.from_numpy(v).to(getattr(torch, dtype))
          for k, v in data["grads"].items()}
    tr = {k: torch.from_numpy(v.copy()) for k, v in data["res"].items()}
    for k in jg:   # the same bf16 roundings of the inputs on both sides
        np.testing.assert_array_equal(_np(tg[k]), _np(jg[k]))

    jdeq, jef, jm = jcomp.compress_grads(jg, jcomp.EFState(residual=jr))
    deq, ef, m = compress_grads(tg, EFState(residual=tr))
    for k in jg:
        assert deq[k].dtype == tg[k].dtype
        assert ef.residual[k].dtype == torch.float32
        np.testing.assert_array_equal(_np(deq[k]), _np(jdeq[k]), err_msg=k)
        np.testing.assert_array_equal(_np(ef.residual[k]),
                                      _np(jef.residual[k]), err_msg=k)
    assert not _np(deq["zero"]).any() and not _np(ef.residual["zero"]).any()
    assert float(m["ef_residual_sq"]) == pytest.approx(
        float(jm["ef_residual_sq"]), rel=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stacked_leaves_share_the_jax_leaf_scale(dtype):
    """The JAX tree stacks the units' leaves ([U, ...], one scale); the
    port's list of per-unit trees is quantized with that one scale too."""
    rng = np.random.default_rng(5)
    U = 3
    w = (rng.standard_normal((U, 12, 7))
         * 10.0 ** rng.uniform(-6, 2, (U, 1, 1))).astype(np.float32)
    b = (rng.standard_normal((U, 7)) * 1e-4).astype(np.float32)
    e = rng.standard_normal((10, 4)).astype(np.float32)
    rw, rb, re = (1e-3 * rng.standard_normal(x.shape).astype(np.float32)
                  for x in (w, b, e))
    jg = {"units": {"w": jnp.asarray(w).astype(dtype),
                    "b": jnp.asarray(b).astype(dtype)},
          "embed": jnp.asarray(e).astype(dtype)}
    jr = {"units": {"w": jnp.asarray(rw), "b": jnp.asarray(rb)},
          "embed": jnp.asarray(re)}
    td = getattr(torch, dtype)
    tg = {"units": [{"w": torch.from_numpy(w[u]).to(td),
                     "b": torch.from_numpy(b[u]).to(td)} for u in range(U)],
          "embed": torch.from_numpy(e).to(td)}
    tr = {"units": [{"w": torch.from_numpy(rw[u].copy()),
                     "b": torch.from_numpy(rb[u].copy())} for u in range(U)],
          "embed": torch.from_numpy(re.copy())}
    jdeq, jef, jm = jcomp.compress_grads(jg, jcomp.EFState(residual=jr))
    deq, ef, m = compress_grads(tg, EFState(residual=tr))
    for u in range(U):
        for k in ("w", "b"):
            np.testing.assert_array_equal(_np(deq["units"][u][k]),
                                          _np(jdeq["units"][k][u]))
            np.testing.assert_array_equal(_np(ef.residual["units"][u][k]),
                                          _np(jef.residual["units"][k][u]))
    np.testing.assert_array_equal(_np(deq["embed"]), _np(jdeq["embed"]))
    assert float(m["ef_residual_sq"]) == pytest.approx(
        float(jm["ef_residual_sq"]), rel=1e-6)


def test_quantize_matches_jax_codes():
    x = np.random.default_rng(3).standard_normal(4096).astype(np.float32)
    x[:8] = [0.5, -0.5, 1.5, 2.5, -2.5, 3.5, 0.0, -0.0]   # exact halves
    jq, js = jcomp.quantize_int8(jnp.asarray(x))
    q, s = quantize_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    q, s = quantize_int8(torch.zeros(5))
    assert float(s) == np.float32(np.float32(1e-12) / np.float32(127.0))
    assert not q.any()


# --------------------------------------------- mirrors of the reference's
# checks (tests/test_optim.py::TestCompression)

def test_quantize_roundtrip_error_bounded():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1024, generator=g)
    q, s = quantize_int8(x)
    err = (dequantize_int8(q, s) - x).abs().max()
    assert float(err) <= float(s) / 2 + 1e-7


def test_error_feedback_training_converges():
    """int8 + error feedback still optimizes (toy regression)."""
    g = torch.Generator().manual_seed(1)
    X = torch.randn(64, 8, generator=g)
    w_true = torch.arange(8.0)
    y = X @ w_true
    params = {"w": torch.zeros(8)}
    ef = init_ef(params)
    lr = 0.05
    for _ in range(300):
        w = params["w"].clone().requires_grad_(True)
        (grad,) = torch.autograd.grad(((X @ w - y) ** 2).mean(), [w])
        deq, ef, _ = compress_grads({"w": grad}, ef)
        params = {"w": params["w"] - lr * deq["w"]}
    assert float((params["w"] - w_true).abs().max()) < 0.1


def test_compressing_step_runs():
    cfg = get_config("qwen1.5-4b").smoke(vocab_size=64)
    model = get_model(cfg, device="cpu")
    opt = AdamW(peak_lr=1e-3)
    state = init_state(model, opt, 0)
    ef = init_ef(state.params)
    step = make_compressing_step(model, opt)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, 64, (2, 32)).astype(np.int32),
             "labels": rng.integers(0, 64, (2, 32)).astype(np.int32)}
    (state2, ef2), metrics = step((state, ef), batch)
    assert state2.step == 1 and ef2 is ef
    assert torch.isfinite(metrics["loss"])
    assert float(metrics["ef_residual_sq"]) >= 0
    assert all(r.dtype == torch.float32 for r in leaves(ef2.residual))


# ------------------------------------------- three compressed train steps

def _jax_params(jcfg, seed=0) -> dict:
    """The JAX init as numpy, with seeded noise on the QKV biases and the
    norm scales (JAX initialises them to 0 and 1)."""
    params = jax.tree.map(np.asarray, jtf.init_lm(jax.random.PRNGKey(seed),
                                                  jcfg))
    rng = np.random.default_rng(seed)
    sub = params["units"]["sub0"]
    for name in ("bq", "bk", "bv"):
        a = sub["attn"][name]
        sub["attn"][name] = (0.1 * rng.standard_normal(a.shape)).astype(
            np.float32)
    for name in ("mixer_norm", "ffn_norm"):
        sub[name] = (1 + 0.1 * rng.standard_normal(sub[name].shape)).astype(
            np.float32)
    return params


def _jax_compressed_states(jcfg, np_params, batches, opt_kwargs):
    """JAX's (state, ef) before and after each compressed step, and the
    step's metrics, as numpy."""
    opt = jadamw.AdamW(**opt_kwargs)
    jp = jax.tree.map(jnp.asarray, np_params)
    carry = (jstate.TrainState(step=jnp.zeros((), jnp.int32), params=jp,
                               opt=opt.init(jp), rng=jax.random.PRNGKey(0)),
             jcomp.init_ef(jp))
    step = jax.jit(jcomp.make_compressing_step(jregistry.get_model(jcfg), opt))
    out = []
    for b in batches:
        new, m = step(carry, {k: jnp.asarray(v) for k, v in b.items()})
        out.append((jax.tree.map(np.asarray, carry),
                    jax.tree.map(np.asarray, new),
                    {k: float(v) for k, v in m.items()}))
        carry = new
    return out


def test_compressed_train_steps_match_jax():
    jcfg = jget_config("qwen2-7b").smoke(n_kv_heads=2)
    cfg = get_config("qwen2-7b").smoke(n_kv_heads=2)
    assert cfg.dtype == "float32"
    np_params = _jax_params(jcfg)
    batches = [SyntheticTokens(cfg, batch=4, seq=32, seed=0).batch_at(i)
               for i in range(3)]
    opt_kwargs = dict(peak_lr=LR, warmup_steps=1, total_steps=10)
    model = get_model(cfg, device="cpu")
    step = make_compressing_step(model, AdamW(**opt_kwargs))

    def tree(t):
        return from_jax_params(t, cfg, "cpu")

    flipped = []
    for i, ((jbefore, jbef_ef), (jafter, jaft_ef), jm) in enumerate(
            _jax_compressed_states(jcfg, np_params, batches, opt_kwargs)):
        state = TrainState(step=i, params=tree(jbefore.params),
                           opt=AdamWState(step=int(jbefore.opt.step),
                                          m=tree(jbefore.opt.m),
                                          v=tree(jbefore.opt.v)), rng=1)
        (state, ef), m = step((state, EFState(tree(jbef_ef.residual))),
                              batches[i])
        assert state.step == i + 1 and state.opt.step == int(jafter.opt.step)
        for key in ("loss", "ce", "grad_norm", "ef_residual_sq"):
            assert float(m[key]) == pytest.approx(jm[key], rel=LOSS_RTOL), key
        n_flip = n_all = 0
        for (path, want_r), got_r, want_p, got_p in zip(
                leaves_with_path(tree(jaft_ef.residual)), leaves(ef.residual),
                leaves(tree(jafter.params)), leaves(state.params)):
            want_r, got_r = _np(want_r), _np(got_r)
            want_p, got_p = _np(want_p), _np(got_p)
            # |residual| <= scale/2, so a flipped code moves the residual by
            # one scale, ~2x the leaf's largest residual; float-order noise
            # moves it by ~1e-7 of the leaf's largest |grad + residual|.
            flip = np.abs(got_r - want_r) > np.abs(want_r).max()
            n_flip += int(flip.sum())
            n_all += flip.size
            np.testing.assert_allclose(
                got_p[~flip], want_p[~flip], rtol=0,
                atol=PARAM_ATOL_OF_MAX * np.abs(want_p).max(),
                err_msg=str(path))
            np.testing.assert_allclose(got_p[flip], want_p[flip], rtol=0,
                                       atol=LR, err_msg=str(path))
            np.testing.assert_allclose(
                got_r[~flip], want_r[~flip], rtol=0,
                atol=1e-3 * max(np.abs(want_r).max(), 1e-30),
                err_msg=str(path))
        flipped.append((n_flip, n_all))
        assert n_flip <= MAX_FLIPPED_SHARE * n_all, (i, n_flip, n_all)
    print(f"flipped int8 codes per step (of entries): {flipped}")


# ----------------------------------------------------------------- the CLI

def test_train_cli_compress(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                        "--device", "cpu", "--compress", "--steps", "11",
                        "--ckpt-dir", str(tmp_path / "ckpt")],
                       capture_output=True, text=True, timeout=300,
                       cwd=tmp_path, env=env)
    assert r.returncode == 0, r.stderr
    lines = r.stdout.splitlines()
    logged = [ln for ln in lines if ln.startswith("step ")]
    assert [ln.split()[1] for ln in logged] == ["0", "10"]
    assert all(" loss " in ln and " ef_sq " in ln for ln in logged)
    assert lines[-1].startswith("done: first5=") and "last5=" in lines[-1]
    assert not (tmp_path / "ckpt").exists()   # the minimal loop saves none
