"""The port's train path (dense models, and models with Mamba-2 units)
against the JAX package, on the CPU.

On the CPU the port's ``ops`` run each kernel's plain version and autograd
differentiates it; the CUDA/Triton kernels and their backward kernels are
held against these plain versions on the card by ``tests/test_torch_cuda.py``
and ``chip_smoke.py``.  Inputs and parameters come from numpy (the JAX
``init_lm`` tree, with QKV biases and norm scales overwritten by seeded
noise so that those paths are tested), and both packages get the same
arrays.  The JAX side runs in 32-bit mode: under ``jax_enable_x64``, which
another test module may switch on in this process, parts of the JAX model
raise (ROADMAP §C).

Tolerances, all float32:
  * cross-entropy: 1e-5 (float32) and 2e-2 (bfloat16 logits), as in
    ``tests/test_kernels.py``; the plain backwards against ``jax.grad``
    2e-5 (the same sums in another order);
  * the loss: 1e-5 relative (measured: at most 8e-8);
  * gradients: rtol 1e-4 and 2e-5 of the leaf's largest entry (measured:
    at most 3e-6 of it, over a few layers and ~100 tokens);
  * parameters after AdamW steps.  The first step's update is
    ``m̂/(√v̂+eps) ≈ g/(|g|+1e-8)``, which turns float-order noise in a
    gradient that is 0 in exact arithmetic (the key bias: softmax ignores a
    constant added to every key) into updates of up to ±lr.  After one
    step, entries whose gradient exceeds 1e-6 agree within 1e-6; all
    entries within lr.  After three steps all entries within lr (measured:
    0.015 lr on the key bias, 1e-8 elsewhere).  Losses of each step within
    1e-5 relative.
"""

import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.data import pipeline as jpipeline
from repro.kernels import fused_ce as jce
from repro.kernels import ref as jref
from repro.models import registry as jregistry
from repro.models import transformer as jtf
from repro.optim import adamw as jadamw
from repro.train import state as jstate
from repro.train import step as jstep
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import SyntheticTokens, make_pipeline
from repro_torch.kernels import fused_ce as tce
from repro_torch.kernels import ops, ref
from repro_torch.models import get_model
from repro_torch.models import transformer as ttf
from repro_torch.models.convert import from_jax_params
from repro_torch.optim.adamw import AdamW, AdamWState, global_norm
from repro_torch.train import loop as loop_lib
from repro_torch.train.state import TrainState, init_state
from repro_torch.train.step import make_train_step
from repro_torch.tree import leaves, leaves_with_path

REPO = Path(__file__).resolve().parent.parent
CE_TOLS = {"float32": dict(rtol=1e-5, atol=1e-5),
           "bfloat16": dict(rtol=2e-2, atol=2e-2)}
GRAD_RTOL, GRAD_ATOL_OF_MAX = 1e-4, 2e-5
LOSS_RTOL = 1e-5
LR = 1e-3


@pytest.fixture(autouse=True)
def _jax_32bit():
    with jax.enable_x64(False):
        yield


def _normal(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _assert_grad_close(got, want, label=""):
    got, want = _np(got), _np(want)
    atol = GRAD_ATOL_OF_MAX * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=GRAD_RTOL, atol=atol,
                               err_msg=str(label))


# ------------------------------------------------------- the kernels' plain
# versions and their backwards

# TestFusedCE's shapes in tests/test_kernels.py: (T, V, block_t, block_v).
CE_CASES = [(8, 512, 4, 128), (16, 1000, 8, 125), (4, 4096, 4, 1024)]


def _ce_inputs(T, V, seed=0):
    logits = _normal(seed, (T, V))
    labels = np.random.default_rng(seed + 1).integers(-1, V, T).astype(np.int32)
    labels[0] = -1          # at least one masked row
    return logits, labels


class TestCrossEntropy:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("T,V,bt,bv", CE_CASES)
    def test_plain_matches_pallas_and_jax_ref(self, T, V, bt, bv, dtype):
        """Negative labels included: every version clamps them to 0."""
        logits, labels = _ce_inputs(T, V)
        tl = torch.from_numpy(logits).to(getattr(torch, dtype))
        got = ref.cross_entropy_ref(tl, torch.from_numpy(labels))
        jl = jnp.asarray(logits).astype(jnp.dtype(dtype))
        jlab = jnp.asarray(labels)
        pallas = jce.fused_cross_entropy(jl, jlab, block_t=bt, block_v=bv,
                                         interpret=True)
        want = jref.cross_entropy_ref(jl, jlab)
        assert got.dtype == torch.float32 and got.shape == (T,)
        np.testing.assert_allclose(_np(got), _np(pallas), **CE_TOLS[dtype])
        np.testing.assert_allclose(_np(got), _np(want), **CE_TOLS[dtype])
        # a negative label gives lse - logits[row, 0]
        lf = tl[0].float()
        assert float(got[0]) == pytest.approx(
            float(torch.logsumexp(lf, 0) - lf[0]), rel=1e-6)

    @pytest.mark.parametrize("T,V", [(8, 512), (16, 1000)])
    def test_plain_backward_matches_jax_grad(self, T, V):
        logits, labels = _ce_inputs(T, V, seed=3)
        w = _normal(4, (T,))
        tl = torch.from_numpy(logits).requires_grad_(True)
        nll = ops.fused_cross_entropy(tl, torch.from_numpy(labels))
        (got,) = torch.autograd.grad((nll * torch.from_numpy(w)).sum(), tl)
        want = jax.grad(lambda x: (jref.cross_entropy_ref(x, labels)
                                   * w).sum())(jnp.asarray(logits))
        np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)

    def test_model_cross_entropy_matches_jax(self):
        """The masked mean over [B, S] and its gradient: rows with a
        negative label get a zero gradient."""
        B, S, V = 2, 8, 256
        logits = _normal(5, (B, S, V))
        labels = np.random.default_rng(6).integers(-1, V, (B, S)).astype(
            np.int32)
        labels[0, :3] = -1
        tl = torch.from_numpy(logits).requires_grad_(True)
        got = ttf.cross_entropy(tl, torch.from_numpy(labels))
        (g,) = torch.autograd.grad(got, tl)
        want, jg = jax.value_and_grad(jtf.cross_entropy)(jnp.asarray(logits),
                                                         jnp.asarray(labels))
        assert got.item() == pytest.approx(float(want), rel=1e-6)
        np.testing.assert_allclose(_np(g), _np(jg), rtol=1e-5, atol=1e-7)
        assert not _np(g)[labels < 0].any()

    def test_ops_routes_cpu_tensors_to_plain(self):
        logits, labels = _ce_inputs(8, 512)
        ops.reset_launch_counts()
        got = ops.fused_cross_entropy(torch.from_numpy(logits),
                                      torch.from_numpy(labels))
        want = ref.cross_entropy_ref(torch.from_numpy(logits),
                                     torch.from_numpy(labels))
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        assert not any(ops.launch_counts().values())

    def test_kernel_refuses_cpu_tensors(self):
        before = (tce.launches, tce.bwd_launches)
        with pytest.raises(ValueError, match="CUDA"):
            tce.fused_cross_entropy(torch.zeros(4, 8),
                                    torch.zeros(4, dtype=torch.int64))
        with pytest.raises(ValueError, match="CUDA"):
            tce.fused_cross_entropy_bwd(torch.zeros(4, 8),
                                        torch.zeros(4, dtype=torch.int64),
                                        torch.zeros(4), torch.zeros(4))
        assert (tce.launches, tce.bwd_launches) == before


# (B, H, KV, S, hd, window): self-attention, as on the train path.
FLASH_GRAD_CASES = {"mha": (1, 4, 4, 64, 32, 0), "gqa4": (2, 8, 2, 40, 16, 0),
                    "mqa": (1, 4, 1, 70, 16, 0), "window16": (1, 2, 2, 80, 16, 16)}


@pytest.mark.parametrize("name", list(FLASH_GRAD_CASES))
def test_flash_plain_backward_matches_jax_grad(name):
    """ops.flash_attention (model layout) differentiated by autograd, the
    plain version of the backward kernel, against jax.grad of the JAX
    reference."""
    B, H, KV, S, hd, window = FLASH_GRAD_CASES[name]
    q, k, v = (_normal(1, (B, S, H, hd)), _normal(2, (B, S, KV, hd)),
               _normal(3, (B, S, KV, hd)))
    w = _normal(4, (B, S, H, hd))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, causal=True, window=window)
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), (tq, tk, tv))

    def f(q, k, v):
        o = jref.flash_attention_ref(q.transpose(0, 2, 1, 3),
                                     k.transpose(0, 2, 1, 3),
                                     v.transpose(0, 2, 1, 3), causal=True,
                                     window=window)
        return (o.transpose(0, 2, 1, 3) * w).sum()

    want = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for label, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(_np(a), _np(b), rtol=2e-5, atol=2e-5,
                                   err_msg=f"d{label}")


@pytest.mark.parametrize("shape", [(4, 128), (2, 7, 256)])
def test_rmsnorm_plain_backward_matches_jax_grad(shape):
    x, s, w = _normal(1, shape), _normal(2, shape[-1:]), _normal(3, shape)
    tx, ts = (torch.from_numpy(a).requires_grad_(True) for a in (x, s))
    out = ops.rmsnorm(tx, ts, 1e-6)
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), (tx, ts))
    want = jax.grad(lambda x, s: (jref.rmsnorm_ref(x, s, 1e-6) * w).sum(),
                    argnums=(0, 1))(jnp.asarray(x), jnp.asarray(s))
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), _np(b), rtol=2e-5, atol=2e-5)


# ------------------------------------------------------------- the model

CONFIGS = {
    "gqa": {"n_kv_heads": 2},
    "sliding-window": {"sliding_window": 32, "n_kv_heads": 2},   # 32 < 48
}


def _configs(name):
    overrides = CONFIGS[name]
    return (jget_config("qwen2-7b").smoke(**overrides),
            get_config("qwen2-7b").smoke(**overrides))


def _jax_params(jcfg, seed=0) -> dict:
    """The JAX init as numpy, with seeded noise on the QKV biases and the
    norm scales (JAX initialises them to 0 and 1)."""
    params = jax.tree.map(np.asarray, jtf.init_lm(jax.random.PRNGKey(seed),
                                                  jcfg))
    rng = np.random.default_rng(seed)

    def noise(a, base):
        return (base + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)

    sub = params["units"]["sub0"]
    for name in ("bq", "bk", "bv"):
        sub["attn"][name] = noise(sub["attn"][name], 0.0)
    for name in ("mixer_norm", "ffn_norm"):
        sub[name] = noise(sub[name], 1.0)
    params["final_norm"] = noise(params["final_norm"], 1.0)
    return params


def _batch(cfg, batch=2, seq=48, step=0):
    b = SyntheticTokens(cfg, batch=batch, seq=seq, seed=0).batch_at(step)
    b["labels"][0, :5] = -1       # ignored positions
    return b


@pytest.mark.parametrize("name", list(CONFIGS))
def test_loss_and_grads_match_jax(name):
    jcfg, cfg = _configs(name)
    assert cfg.qkv_bias and cfg.dtype == "float32"
    np_params = _jax_params(jcfg)
    batch = _batch(cfg)
    (jloss, jparts), jgrads = jax.value_and_grad(
        lambda p: jtf.loss_fn(p, {k: jnp.asarray(v) for k, v in
                                  batch.items()}, jcfg),
        has_aux=True)(jax.tree.map(jnp.asarray, np_params))

    params = from_jax_params(np_params, cfg, device="cpu")
    for p in leaves(params):
        p.requires_grad_(True)
    model = get_model(cfg, device="cpu")
    loss, parts = model.loss(params, {k: torch.from_numpy(v)
                                      for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves(params))

    assert loss.item() == pytest.approx(float(jloss), rel=LOSS_RTOL)
    assert parts["ce"].item() == pytest.approx(float(jparts["ce"]),
                                               rel=LOSS_RTOL)
    assert float(parts["aux"]) == float(jparts["aux"]) == 0.0
    want = from_jax_params(jax.tree.map(np.asarray, jgrads), cfg, "cpu")
    for (path, w), g in zip(leaves_with_path(want), grads):
        assert g.shape == w.shape, path
        _assert_grad_close(g, w, path)


def test_forward_train_recomputes_each_unit_once(monkeypatch):
    """Activation checkpointing: the units' norms run twice forward (the
    pass and the recompute) and the final norm once, in the order the JAX
    module's jax.checkpoint gives; counted through the plain version."""
    cfg = get_config("qwen2-7b-smoke")
    model = get_model(cfg, device="cpu")
    params = model.init(0)
    for p in leaves(params):
        p.requires_grad_(True)
    calls = []
    orig = ops.ref.rmsnorm_ref

    def counting(x, scale, eps):
        calls.append(x.shape)
        return orig(x, scale, eps)

    monkeypatch.setattr(ops.ref, "rmsnorm_ref", counting)
    loss, _ = model.loss(params, {k: torch.from_numpy(v) for k, v in
                                  _batch(cfg).items()})
    n_forward = len(calls)
    torch.autograd.grad(loss, leaves(params))
    assert n_forward == 2 * cfg.n_layers + 1
    assert len(calls) == 4 * cfg.n_layers + 1


# ------------------------------------------- Mamba-2 and hybrid training

# The SSM family and the jamba hybrid without and with experts.  On the CPU
# the SSD scans run the plain chunked scan and autograd differentiates it.
MAMBA_CONFIGS = {"mamba2": ("mamba2-370m", {}),
                 "jamba": ("jamba-1.5-large-398b", {"n_experts": 0}),
                 "jamba-moe": ("jamba-1.5-large-398b", {})}


def _mamba_configs(name):
    arch, overrides = MAMBA_CONFIGS[name]
    return (jget_config(arch).smoke(**overrides),
            get_config(arch).smoke(**overrides))


def _mamba_jax_params(jcfg, seed=0) -> dict:
    """The JAX init as numpy, with seeded noise on every leaf it sets to a
    constant: the norm scales, and each Mamba mixer's conv bias, dt bias, D
    skip and gated-norm scale (and on A_log), so that those paths carry
    gradients of their own."""
    params = jax.tree.map(np.asarray, jtf.init_lm(jax.random.PRNGKey(seed),
                                                  jcfg))
    rng = np.random.default_rng(seed)

    def noise(a, base):
        return (base + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)

    for sp in params["units"].values():
        for name in ("mixer_norm", "ffn_norm"):
            if name in sp:
                sp[name] = noise(sp[name], 1.0)
        if "mamba" in sp:
            m = sp["mamba"]
            for name, base in (("conv_b", 0.0), ("dt_bias", 0.0), ("D", 1.0),
                               ("norm_scale", 1.0)):
                m[name] = noise(m[name], base)
            m["A_log"] = noise(m["A_log"], 0.0) + m["A_log"]
    params["final_norm"] = noise(params["final_norm"], 1.0)
    return params


@pytest.mark.parametrize("name", list(MAMBA_CONFIGS))
def test_mamba_loss_and_grads_match_jax(name):
    """The loss, ce, aux and every gradient leaf of a model with Mamba units
    against ``jax.grad`` of the JAX loss (48 tokens: a partial chunk of 16
    after one of 32)."""
    jcfg, cfg = _mamba_configs(name)
    assert any(s["mixer"] == "mamba" for s in ttf.unit_layout(cfg))
    np_params = _mamba_jax_params(jcfg)
    batch = _batch(cfg)
    (jloss, jparts), jgrads = jax.value_and_grad(
        lambda p: jtf.loss_fn(p, {k: jnp.asarray(v) for k, v in
                                  batch.items()}, jcfg),
        has_aux=True)(jax.tree.map(jnp.asarray, np_params))

    params = from_jax_params(np_params, cfg, device="cpu")
    for p in leaves(params):
        p.requires_grad_(True)
    loss, parts = get_model(cfg, device="cpu").loss(
        params, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves(params))

    for got, want in ((loss, jloss), (parts["ce"], jparts["ce"]),
                      (parts["aux"], jparts["aux"])):
        assert got.item() == pytest.approx(float(want), rel=LOSS_RTOL)
    assert (float(jparts["aux"]) > 0) == cfg.is_moe
    want = from_jax_params(jax.tree.map(np.asarray, jgrads), cfg, "cpu")
    names = set()
    for (path, w), g in zip(leaves_with_path(want), grads):
        assert g.shape == w.shape and g.dtype == w.dtype, path
        _assert_grad_close(g, w, path)
        names.add(path[-1])
    assert {"in_proj", "conv_w", "conv_b", "A_log", "D", "dt_bias",
            "norm_scale", "out_proj"} <= names


def _jax_states(jcfg, np_params, batches, opt_kwargs):
    """JAX's train state before and after each step, and the step's
    metrics, as numpy."""
    opt = jadamw.AdamW(**opt_kwargs)
    jp = jax.tree.map(jnp.asarray, np_params)
    state = jstate.TrainState(step=jnp.zeros((), jnp.int32), params=jp,
                              opt=opt.init(jp), rng=jax.random.PRNGKey(0))
    step = jax.jit(jstep.make_train_step(jregistry.get_model(jcfg), opt))
    out = []
    for b in batches:
        new, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        out.append((jax.tree.map(np.asarray, state),
                    jax.tree.map(np.asarray, new),
                    {k: float(v) for k, v in m.items()}))
        state = new
    return out


# A Mamba mixer's small leaves (dt_bias, D, A_log, one entry a head): sums
# over batch, rows and head dims that cancel, so at these steps' batches
# their gradients, and with them the first moments, differ from JAX's by up
# to ~6e-5 of the leaf's largest entry, 3x GRAD_ATOL_OF_MAX; their moments
# are held to 2e-4 of it.  A moment carried wrongly between steps errs by
# the order of the moment itself.
MAMBA_SMALL_LEAVES = ("A_log", "D", "dt_bias")
MAMBA_SMALL_ATOL_OF_MAX = 2e-4


@pytest.mark.parametrize("name", list(MAMBA_CONFIGS))
def test_mamba_train_steps_match_jax(name):
    """Three steps of make_train_step against JAX's, each from JAX's state
    (parameters and moments) before it: the step's loss, ce, aux and
    gradient norm, and every parameter within lr, as
    ``test_train_steps_match_jax``; the moments after it as gradients are
    held (``_assert_grad_close``; a mixer's small leaves at
    MAMBA_SMALL_ATOL_OF_MAX), the second moment at twice that (its gradient
    enters squared).  Each step starts from JAX's state
    because AdamW's first update turns float-order noise in a gradient
    entry below ~1e-6 into a parameter difference of up to lr (on the
    hybrid with experts, a conv bias entry), which moves the next
    gradient's norm by ~4e-4 relative: a compounded difference of the
    comparison, not of the step."""
    jcfg, cfg = _mamba_configs(name)
    np_params = _mamba_jax_params(jcfg)
    batches = [_batch(cfg, batch=4, seq=32, step=i) for i in range(3)]
    opt_kwargs = dict(peak_lr=LR, warmup_steps=1, total_steps=10)
    model = get_model(cfg, device="cpu")
    opt = AdamW(**opt_kwargs)
    step = make_train_step(model, opt)
    for i, (before, after, jm) in enumerate(
            _jax_states(jcfg, np_params, batches, opt_kwargs)):
        state = TrainState(
            step=i, params=from_jax_params(before.params, cfg, "cpu"),
            opt=AdamWState(step=int(before.opt.step),
                           m=from_jax_params(before.opt.m, cfg, "cpu"),
                           v=from_jax_params(before.opt.v, cfg, "cpu")),
            rng=1)
        state, m = step(state, batches[i])
        assert state.step == i + 1 and state.opt.step == int(after.opt.step)
        for key in ("loss", "ce", "aux", "grad_norm"):
            assert float(m[key]) == pytest.approx(jm[key], rel=LOSS_RTOL), key
        jp = from_jax_params(after.params, cfg, "cpu")
        for (path, w), p in zip(leaves_with_path(jp), leaves(state.params)):
            assert p.dtype == w.dtype, path
            np.testing.assert_allclose(_np(p), _np(w), rtol=LOSS_RTOL,
                                       atol=LR, err_msg=str(path))
        for k, (name, want, got) in enumerate(
                (("m", after.opt.m, state.opt.m),
                 ("v", after.opt.v, state.opt.v))):
            for (path, w), g in zip(
                    leaves_with_path(from_jax_params(want, cfg, "cpu")),
                    leaves(got)):
                w = _np(w)
                atol_of_max = (MAMBA_SMALL_ATOL_OF_MAX
                               if path[-1] in MAMBA_SMALL_LEAVES
                               else GRAD_ATOL_OF_MAX)
                np.testing.assert_allclose(
                    _np(g), w, rtol=(1 + k) * GRAD_RTOL,
                    atol=(1 + k) * atol_of_max * max(float(np.abs(w).max()),
                                                     1e-30),
                    err_msg=str((name,) + path))


@pytest.mark.parametrize("name", list(MAMBA_CONFIGS))
def test_mamba_forward_train_recomputes_each_scan_once(name, monkeypatch):
    """Activation checkpointing: each Mamba sub-layer's SSD scan runs once
    in the forward pass and once more in the backward's recompute (on the
    card, two forward launches and one of the backward kernel per layer);
    counted through the plain version."""
    cfg = _mamba_configs(name)[1]
    n_mamba = ttf.n_units(cfg) * sum(s["mixer"] == "mamba"
                                     for s in ttf.unit_layout(cfg))
    model = get_model(cfg, device="cpu")
    params = model.init(0)
    for p in leaves(params):
        p.requires_grad_(True)
    calls = []
    orig = ops.ref.ssd_scan_ref

    def counting(*args):
        calls.append(args[0].shape)
        return orig(*args)

    monkeypatch.setattr(ops.ref, "ssd_scan_ref", counting)
    loss, _ = model.loss(params, {k: torch.from_numpy(v) for k, v in
                                  _batch(cfg).items()})
    n_forward = len(calls)
    torch.autograd.grad(loss, leaves(params))
    assert n_mamba > 0 and n_forward == n_mamba
    assert len(calls) == 2 * n_mamba


# ------------------------------------------------------------- optimizer

def _jax_train(jcfg, np_params, batches, microbatches, opt_kwargs):
    jmodel = jregistry.get_model(jcfg)
    opt = jadamw.AdamW(**opt_kwargs)
    jp = jax.tree.map(jnp.asarray, np_params)
    state = jstate.TrainState(step=jnp.zeros((), jnp.int32), params=jp,
                              opt=opt.init(jp), rng=jax.random.PRNGKey(0))
    step = jax.jit(jstep.make_train_step(jmodel, opt,
                                         microbatches=microbatches))
    out = []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        out.append((jax.tree.map(np.asarray, state.params),
                    {k: float(v) for k, v in m.items()}))
    return out


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_steps_match_jax(microbatches):
    """Three steps of make_train_step on the same params and batches."""
    jcfg, cfg = _configs("gqa")
    np_params = _jax_params(jcfg)
    batches = [_batch(cfg, batch=4, seq=32, step=i) for i in range(3)]
    opt_kwargs = dict(peak_lr=LR, warmup_steps=1, total_steps=10)
    want = _jax_train(jcfg, np_params, batches, microbatches, opt_kwargs)
    # The first step's gradient, the mean of the microbatches' as JAX takes
    # it: where it exceeds 1e-6 the first update is compared tightly.
    size = batches[0]["tokens"].shape[0] // microbatches
    g1 = [jax.grad(lambda p, mb: jtf.loss_fn(p, mb, jcfg)[0])(
        jax.tree.map(jnp.asarray, np_params),
        {k: jnp.asarray(v[i * size:(i + 1) * size])
         for k, v in batches[0].items()}) for i in range(microbatches)]
    g1 = from_jax_params(jax.tree.map(lambda *g: np.mean(g, axis=0), *g1),
                         cfg, "cpu")

    model = get_model(cfg, device="cpu")
    opt = AdamW(**opt_kwargs)
    params = from_jax_params(np_params, cfg, device="cpu")
    state = TrainState(step=0, params=params, opt=opt.init(params), rng=1)
    step = make_train_step(model, opt, microbatches=microbatches)
    for i, (b, (jparams, jm)) in enumerate(zip(batches, want)):
        state, m = step(state, b)
        assert state.step == i + 1 and state.opt.step == i + 1
        for key in ("loss", "ce", "grad_norm"):
            assert float(m[key]) == pytest.approx(jm[key], rel=LOSS_RTOL), key
        assert m["lr"] == pytest.approx(jm["lr"], rel=1e-6)
        jp = from_jax_params(jparams, cfg, "cpu")
        for (path, w), p, g in zip(leaves_with_path(jp), leaves(state.params),
                                   leaves(g1)):
            p = p.detach()
            assert p.dtype == w.dtype, path
            np.testing.assert_allclose(_np(p), _np(w), rtol=LOSS_RTOL,
                                       atol=LR, err_msg=str(path))
            if i == 0:
                live = g.abs() > 1e-6
                np.testing.assert_allclose(_np(p[live]), _np(w[live]),
                                           rtol=0, atol=1e-6,
                                           err_msg=str(path))


def test_microbatch_grads_cast_to_param_dtype():
    """bf16 params: the fp32 accumulation is cast back before the optimizer
    (the optimizer sees bf16 gradients), as at step.py:59-60 in JAX."""
    cfg = get_config("qwen2-7b").smoke(dtype="bfloat16")
    model = get_model(cfg, device="cpu")
    seen = []

    class Spy(AdamW):
        def update(self, grads, state, params, decay):
            seen.extend(g.dtype for g in leaves(grads))
            return super().update(grads, state, params, decay)

    opt = Spy(peak_lr=LR, warmup_steps=1, total_steps=10)
    state = init_state(model, opt, 0)
    state, m = make_train_step(model, opt, microbatches=2)(
        state, _batch(cfg, batch=4, seq=16))
    assert seen and set(seen) == {torch.bfloat16}
    assert all(t.dtype == torch.float32 for t in leaves(state.opt.m))
    assert np.isfinite(float(m["loss"]))


def test_microbatches_must_divide_the_batch():
    cfg = get_config("qwen2-7b-smoke")
    model = get_model(cfg, device="cpu")
    opt = AdamW()
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(model, opt, microbatches=3)(
            init_state(model, opt, 0), _batch(cfg, batch=4, seq=8))


def test_weight_decay_follows_jax_rank():
    """JAX decays leaves of rank >= 2, and its unit leaves are stacked over
    units: the units' norm scales and QKV biases are decayed, final_norm is
    not.  One AdamW step on converted qwen2-7b-smoke params with the same
    (non-tiny) gradients, against JAX."""
    jcfg, cfg = _configs("gqa")
    np_params = _jax_params(jcfg)
    rng = np.random.default_rng(7)
    np_grads = jax.tree.map(
        lambda a: (0.01 * rng.standard_normal(a.shape)).astype(np.float32),
        np_params)
    kw = dict(peak_lr=1e-2, warmup_steps=1, total_steps=10, weight_decay=0.1)
    jopt = jadamw.AdamW(**kw)
    jp = jax.tree.map(jnp.asarray, np_params)
    jnew, _, _ = jopt.update(jax.tree.map(jnp.asarray, np_grads),
                             jopt.init(jp), jp)
    want = from_jax_params(jax.tree.map(np.asarray, jnew), cfg, "cpu")

    opt = AdamW(**kw)
    params = from_jax_params(np_params, cfg, device="cpu")
    before = {path: p.clone() for path, p in leaves_with_path(params)}
    grads = from_jax_params(np_grads, cfg, device="cpu")
    decays = get_model(cfg, device="cpu").decays
    params, st, _ = opt.update(grads, opt.init(params), params, decays)
    assert st.step == 1
    decayed = set()
    for (path, p), w in zip(leaves_with_path(params), leaves(want)):
        np.testing.assert_allclose(_np(p), _np(w), rtol=1e-6, atol=1e-7,
                                   err_msg=str(path))
        if decays(path, p):
            decayed.add(path[-1])
        else:
            assert path == ("final_norm",), path
            assert p.ndim == 1 and before[path].ndim == 1
    assert {"mixer_norm", "ffn_norm", "bq", "bk", "bv", "wq"} <= decayed


def test_global_norm_matches_jax():
    tree = {"a": _normal(0, (3, 4)), "b": [_normal(1, (5,)), _normal(2, (2, 2))]}
    got = global_norm(jax.tree.map(torch.from_numpy, tree))
    want = jadamw.global_norm(jax.tree.map(jnp.asarray, tree))
    assert float(got) == pytest.approx(float(want), rel=1e-6)


def test_lr_schedule_matches_jax():
    kw = dict(peak_lr=1.0, warmup_steps=10, total_steps=100,
              min_lr_ratio=0.1)
    jopt, opt = jadamw.AdamW(**kw), AdamW(**kw)
    for s in (0, 1, 5, 9, 10, 11, 55, 99, 100, 150):
        assert opt.lr(s) == pytest.approx(float(jopt.lr(jnp.asarray(s))),
                                          rel=1e-6, abs=1e-7)


class TestAdamW:
    """tests/test_optim.py::TestAdamW, for the port."""

    def test_quadratic_converges(self):
        opt = AdamW(peak_lr=0.1, warmup_steps=5, total_steps=200,
                    weight_decay=0.0, clip_norm=1e9)
        params = {"w": torch.tensor([5.0, -3.0])}
        state = opt.init(params)
        for _ in range(200):
            g = {"w": 2 * params["w"]}
            params, state, _ = opt.update(g, state, params)
        assert float(params["w"].abs().max()) < 0.05

    def test_lr_schedule_shape(self):
        opt = AdamW(peak_lr=1.0, warmup_steps=10, total_steps=100,
                    min_lr_ratio=0.1)
        lrs = [opt.lr(s) for s in (0, 5, 10, 55, 100)]
        assert lrs[0] == pytest.approx(0.0)
        assert lrs[1] == pytest.approx(0.5)
        assert lrs[2] == pytest.approx(1.0)
        assert 0.1 < lrs[3] < 1.0
        assert lrs[4] == pytest.approx(0.1, abs=1e-6)

    def test_grad_clipping(self):
        opt = AdamW(peak_lr=1e-3, clip_norm=1.0, warmup_steps=0)
        params = {"w": torch.zeros(4)}
        state = opt.init(params)
        g = {"w": torch.full((4,), 100.0)}
        _, state2, m = opt.update(g, state, params)
        assert float(m["grad_norm"]) == pytest.approx(200.0)
        # post-clip moment magnitude bounded by clip_norm
        assert float(global_norm(state2.m)) <= (1 - 0.9) * 1.0 + 1e-6

    def test_moments_fp32_for_bf16_params(self):
        opt = AdamW()
        params = {"w": torch.zeros(4, dtype=torch.bfloat16)}
        state = opt.init(params)
        assert state.m["w"].dtype == torch.float32
        assert state.v["w"].dtype == torch.float32


# ------------------------------------------------------------ checkpoint

def _tiny_state():
    return {
        "params": {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
                   "b": torch.ones(4, dtype=torch.bfloat16) * 1.5},
        "step": 7,
    }


def _template(state):
    return {"params": {k: torch.zeros_like(v)
                       for k, v in state["params"].items()}, "step": 0}


def test_checkpoint_save_restore_roundtrip(tmp_path):
    state = _tiny_state()
    ckpt.save(tmp_path, 7, state)
    assert ckpt.latest_step(tmp_path) == 7
    assert (tmp_path / "step_00000007" / "_COMMITTED").exists()
    restored, manifest = ckpt.restore(tmp_path, _template(state))
    assert manifest["step"] == 7
    assert manifest["dtypes"]["params||b"] == "bfloat16"
    assert restored["step"] == 7 and isinstance(restored["step"], int)
    torch.testing.assert_close(restored["params"]["w"], state["params"]["w"],
                               rtol=0, atol=0)
    assert restored["params"]["b"].dtype == torch.bfloat16
    torch.testing.assert_close(restored["params"]["b"], state["params"]["b"],
                               rtol=0, atol=0)


def test_checkpoint_uncommitted_ignored(tmp_path):
    ckpt.save(tmp_path, 5, _tiny_state())
    d = tmp_path / "step_00000009"
    d.mkdir()
    (d / "manifest.json").write_text("{}")   # no _COMMITTED marker
    assert ckpt.latest_step(tmp_path) == 5


def test_checkpoint_async_and_gc(tmp_path):
    saver = ckpt.AsyncCheckpointer(tmp_path, keep=2)
    state = _tiny_state()
    for s in (10, 20, 30, 40):
        saver.save(s, state)
    saver.wait()
    assert ckpt.committed_steps(tmp_path) == [30, 40]


def test_checkpoint_template_mismatch_raises(tmp_path):
    ckpt.save(tmp_path, 1, _tiny_state())
    bad = {"params": {"w": torch.zeros(3, 4)}, "step": 0}
    with pytest.raises(ValueError, match="mismatch"):
        ckpt.restore(tmp_path, bad)


def test_checkpoint_train_state_roundtrip(tmp_path):
    """A whole TrainState (bf16 params, fp32 moments, int counters)."""
    cfg = get_config("qwen2-7b").smoke(dtype="bfloat16")
    model = get_model(cfg, device="cpu")
    opt = AdamW()
    state = init_state(model, opt, 0)
    state, _ = make_train_step(model, opt)(state, _batch(cfg, seq=16))
    ckpt.save(tmp_path, state.step, state)
    restored, _ = ckpt.restore(tmp_path, init_state(model, opt, 1))
    assert (restored.step, restored.opt.step, restored.rng) == (1, 1, 2)
    for a, b in zip(leaves(restored), leaves(state)):
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype
            torch.testing.assert_close(a, b.detach(), rtol=0, atol=0)


# ------------------------------------------------------------------ loop
# tests/test_loop.py, for the port, with its qwen1.5-4b smoke setup.

@pytest.fixture(scope="module")
def loop_setup():
    cfg = get_config("qwen1.5-4b").smoke(vocab_size=64)
    model = get_model(cfg, device="cpu")
    opt = AdamW(peak_lr=1e-2, warmup_steps=5, total_steps=60)
    shape = ShapeConfig("tiny", seq_len=32, global_batch=4, kind="train")
    pipe = make_pipeline(cfg, shape)
    step = make_train_step(model, opt)

    def init():
        return init_state(model, opt, 0)

    return model, opt, step, init, pipe


def test_loop_loss_decreases(loop_setup, tmp_path):
    _, _, step, init, pipe = loop_setup
    cfg = loop_lib.LoopConfig(total_steps=30, ckpt_every=100,
                              ckpt_dir=str(tmp_path / "c1"))
    rep = loop_lib.run(step, init, pipe.batch_at, cfg)
    assert rep.steps_run == 30
    first, last = np.mean(rep.losses[:5]), np.mean(rep.losses[-5:])
    assert last < first * 0.9, f"no learning: {first} -> {last}"


def test_loop_resume_from_checkpoint(loop_setup, tmp_path):
    """A run resumed from its checkpoint gives the losses of an
    uninterrupted run."""
    _, _, step, init, pipe = loop_setup
    d = str(tmp_path / "c2")
    rep1 = loop_lib.run(step, init, pipe.batch_at, loop_lib.LoopConfig(
        total_steps=10, ckpt_every=5, ckpt_dir=d))
    assert rep1.final_step == 10
    rep2 = loop_lib.run(step, init, pipe.batch_at, loop_lib.LoopConfig(
        total_steps=15, ckpt_every=5, ckpt_dir=d))
    assert rep2.resumed_from == 10
    assert rep2.steps_run == 5          # only the remaining steps
    assert rep2.final_step == 15
    whole = loop_lib.run(step, init, pipe.batch_at, loop_lib.LoopConfig(
        total_steps=15, ckpt_every=100, ckpt_dir=str(tmp_path / "c2b")))
    assert rep1.losses + rep2.losses == whole.losses


def test_loop_preemption_checkpoint(loop_setup, tmp_path):
    """SIGTERM mid-run -> the loop checkpoints and exits cleanly; a rerun
    resumes from the preemption point."""
    _, _, step, init, pipe = loop_setup
    d = str(tmp_path / "c3")
    calls = {"n": 0}
    orig = pipe.batch_at

    def batch_with_preemption(s):
        calls["n"] += 1
        if calls["n"] == 4:
            os.kill(os.getpid(), signal.SIGTERM)
        return orig(s)

    rep = loop_lib.run(step, init, batch_with_preemption, loop_lib.LoopConfig(
        total_steps=50, ckpt_every=1000, ckpt_dir=d))
    assert rep.preempted
    assert rep.final_step < 50
    assert ckpt.latest_step(d) == rep.final_step
    rep2 = loop_lib.run(step, init, orig, loop_lib.LoopConfig(
        total_steps=rep.final_step + 3, ckpt_every=1000, ckpt_dir=d))
    assert rep2.resumed_from == rep.final_step
    assert rep2.steps_run == 3


def test_loop_straggler_detection(loop_setup, tmp_path):
    _, _, step, init, pipe = loop_setup
    orig = pipe.batch_at

    def slow_batch(s):
        if s == 7:
            time.sleep(1.0)       # injected straggler
        return orig(s)

    rep = loop_lib.run(step, init, slow_batch, loop_lib.LoopConfig(
        total_steps=12, ckpt_every=1000, ckpt_dir=str(tmp_path / "c4")))
    assert 7 in rep.straggler_steps


# ------------------------------------------------------ data and launcher

@pytest.mark.parametrize("arch", ["qwen2-7b", "whisper-base", "llava-next-34b"])
@pytest.mark.parametrize("step", [0, 5])
def test_synthetic_tokens_match_jax(arch, step):
    """The port's copy of the pipeline gives the JAX package's batches."""
    shape = ShapeConfig("tiny", seq_len=24, global_batch=3, kind="train")
    got = make_pipeline(get_config(arch).smoke(), shape, seed=4).batch_at(step)
    jshape = jpipeline.ShapeConfig("tiny", seq_len=24, global_batch=3,
                                   kind="train")
    want = jpipeline.make_pipeline(jget_config(arch).smoke(), jshape,
                                   seed=4).batch_at(step)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _launch(*args, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                           "--device", "cpu", *args, "--ckpt-dir",
                           str(tmp_path / "ckpt")], capture_output=True,
                          text=True, timeout=300, cwd=tmp_path, env=env)


def test_train_cli_on_cpu(tmp_path):
    r = _launch("--arch", "qwen2-7b-smoke", "--steps", "3", tmp_path=tmp_path)
    assert r.returncode == 0, r.stderr
    assert "steps_run=3 final_step=3" in r.stdout
    assert ckpt.latest_step(tmp_path / "ckpt") == 3


@pytest.mark.parametrize("arch", ["mamba2-370m-smoke",
                                  "jamba-1.5-large-398b-smoke"])
def test_train_cli_trains_mamba_units(arch, tmp_path):
    """The SSM and the hybrid (with experts) through the launcher; 40
    tokens, a partial chunk of 8."""
    r = _launch("--arch", arch, "--steps", "2", "--seq", "40",
                tmp_path=tmp_path)
    assert r.returncode == 0, r.stderr
    assert "steps_run=2 final_step=2" in r.stdout
    assert ckpt.latest_step(tmp_path / "ckpt") == 2


def test_train_cli_compress_is_not_ported(tmp_path):
    """``--compress`` runs the int8 error-feedback path in the JAX
    launcher's minimal loop, which writes no checkpoint
    (``tests/test_torch_compression.py`` holds the path to JAX)."""
    r = _launch("--compress", "--steps", "1", tmp_path=tmp_path)
    assert r.returncode == 0, r.stderr
    assert "ef_sq" in r.stdout and "done: first5=" in r.stdout
    assert ckpt.latest_step(tmp_path / "ckpt") is None
