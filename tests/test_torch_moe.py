"""The port's MoE slice against the JAX package, on the CPU.

* ``moe_ffn`` against ``repro.models.moe.moe_ffn`` on the same parameters
  (the JAX ``init_moe``) and inputs: at mixtral's smoke widths with a
  capacity that binds (factor 0.5) and the default one (1.25), at 128
  experts with top-1 (llama4's regime, capacity 1), and with logits that
  hold exact ties.  The keep mask equals one built independently from the
  reference's routing (a running count per expert in choice-major order).
* ``route_topk`` against ``jax.lax.top_k`` on logits with ties; ``moe_ffn``
  against the dense oracle at a capacity nothing exceeds;
  ``load_balancing_loss`` and ``capacity``.
* The models ``mixtral-8x22b-smoke``, ``llama4-maverick-400b-a17b-smoke``
  and ``jamba-1.5-large-398b-smoke`` (with experts): prefill and four
  decode steps; the loss, its aux term and every gradient leaf against
  ``jax.grad``; three AdamW steps against JAX's step; the weight-decay rule
  on the MoE leaves; ``from_jax_params`` on a bf16 tree (the router stays
  float32).

Inputs come from numpy with a seed.  Tolerances, float32: ``moe_ffn``'s
output 1e-5 and its router logits 1e-6 (the same sums in another order);
the load-balancing loss 1e-6; the models' logits 1e-4, the loss 1e-5
relative, gradients as in ``tests/test_torch_train.py`` (rtol 1e-4 and 2e-5
of the leaf's largest entry).  The JAX side runs in 32-bit mode: its decode
step mixes int32 and default ints.
"""

import os
import subprocess
import sys
from collections import defaultdict
from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import moe as jmoe
from repro.models import registry as jregistry
from repro.models import transformer as jtf
from repro.optim import adamw as jadamw
from repro.train import state as jstate
from repro.train import step as jstep
from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.kernels import ops
from repro_torch.models import get_model
from repro_torch.models import moe
from repro_torch.models import transformer as ttf
from repro_torch.models.convert import from_jax_params
from repro_torch.optim.adamw import AdamW
from repro_torch.train.state import TrainState
from repro_torch.train.step import make_train_step
from repro_torch.tree import leaves, leaves_with_path

REPO = Path(__file__).resolve().parent.parent
Y_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-6, atol=1e-6)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_RTOL, GRAD_ATOL_OF_MAX = 1e-4, 2e-5
LOSS_RTOL = 1e-5
LR = 1e-3
MIXTRAL, LLAMA4, JAMBA = ("mixtral-8x22b", "llama4-maverick-400b-a17b",
                          "jamba-1.5-large-398b")


@pytest.fixture(autouse=True)
def _jax_32bit():
    with jax.enable_x64(False):
        yield


def _configs(arch, **overrides):
    return (jget_config(arch).smoke(**overrides),
            get_config(arch).smoke(**overrides))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _normal(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _moe_params(jcfg, seed=0) -> dict:
    """The JAX ``init_moe`` as numpy."""
    return jax.tree.map(np.array, jmoe.init_moe(jax.random.PRNGKey(seed),
                                                  jcfg, jnp.float32))


def _reference_keep(top_idx: np.ndarray, C: int) -> np.ndarray:
    """The reference's routing [B, S, k] -> its keep mask in the port's
    order (each row's pairs stably sorted by expert), from a running count
    per expert over the pairs in choice-major order."""
    B, S, k = top_idx.shape
    e_flat = top_idx.transpose(0, 2, 1).reshape(B, k * S)
    keep = np.zeros(e_flat.shape, bool)
    for b in range(B):
        seen = defaultdict(int)
        for t, e in enumerate(e_flat[b]):
            keep[b, t] = seen[e] < C
            seen[e] += 1
    order = np.argsort(e_flat, axis=1, kind="stable")
    return np.take_along_axis(keep, order, axis=1)


def _assert_moe_matches_jax(jcfg, cfg, np_p, x) -> int:
    """moe_ffn on both sides: outputs, logits, keep mask.  Returns the
    number of dropped (token, choice) pairs."""
    jy, jlogits = jmoe.moe_ffn(jax.tree.map(jnp.asarray, np_p),
                               jnp.asarray(x), jcfg)
    p = {k: torch.from_numpy(v) for k, v in np_p.items()}
    y, logits = moe.moe_ffn(p, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(_np(logits), _np(jlogits), **LOGIT_TOL)
    np.testing.assert_allclose(_np(y), _np(jy), **Y_TOL)
    jtop, _ = jmoe.route_topk(jlogits, jcfg)
    keep = moe.route(logits, cfg).keep.numpy()
    want = _reference_keep(np.asarray(jtop), moe.capacity(cfg, x.shape[1]))
    np.testing.assert_array_equal(keep, want)
    return int((~keep).sum())


MOE_CASES = {  # name: (arch, overrides, batch, seq)
    "mixtral-cf0.5": (MIXTRAL, {"capacity_factor": 0.5}, 3, 40),
    "mixtral-cf1.25": (MIXTRAL, {}, 3, 40),
    "e128-top1": (LLAMA4, {"n_experts": 128, "experts_per_token": 1}, 2, 40),
}


@pytest.mark.parametrize("name", list(MOE_CASES))
def test_moe_ffn_matches_jax(name):
    arch, overrides, B, S = MOE_CASES[name]
    jcfg, cfg = _configs(arch, **overrides)
    x = _normal(1, (B, S, cfg.d_model))
    dropped = _assert_moe_matches_jax(jcfg, cfg, _moe_params(jcfg), x)
    if cfg.capacity_factor < 1 or cfg.n_experts == 128:
        assert dropped > 0          # the capacity binds
    if cfg.n_experts == 128:
        assert moe.capacity(cfg, S) == 1


def test_moe_ffn_with_tied_logits_matches_jax():
    """Router columns 1 and 2 equal, inputs and router on a grid where every
    product and sum is exact in float32: experts 1 and 2 tie on every token
    in either framework, and both pick expert 1 first."""
    jcfg, cfg = _configs(MIXTRAL, capacity_factor=0.5)
    rng = np.random.default_rng(3)
    np_p = _moe_params(jcfg)
    router = rng.integers(-2, 3, np_p["router"].shape).astype(np.float32) / 4
    router[:, 2] = router[:, 1]
    np_p["router"] = router
    x = rng.integers(-4, 5, (2, 40, cfg.d_model)).astype(np.float32) / 8
    _assert_moe_matches_jax(jcfg, cfg, np_p, x)
    logits = torch.from_numpy(x) @ torch.from_numpy(router)
    assert torch.equal(logits[..., 1], logits[..., 2])
    idx, probs = moe.route_topk(logits, cfg)
    tied_top = (idx[..., 0] == 1) & (logits[..., 1] == logits.max(-1).values)
    assert bool(tied_top.any()) and bool((idx[..., 1][tied_top] == 2).all())
    assert bool((probs[..., 0][tied_top] == 0.5).all())


@pytest.mark.parametrize("k", [1, 2])
def test_route_topk_breaks_ties_like_jax(k):
    jcfg, cfg = _configs(MIXTRAL, n_experts=8, experts_per_token=k)
    logits = np.random.default_rng(k).integers(0, 3, (2, 16, 8)).astype(
        np.float32)
    jidx, jprobs = jmoe.route_topk(jnp.asarray(logits), jcfg)
    idx, probs = moe.route_topk(torch.from_numpy(logits), cfg)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(_np(probs), _np(jprobs), **LOGIT_TOL)


def test_moe_ffn_matches_dense_reference_at_generous_capacity():
    jcfg, cfg = _configs(MIXTRAL, capacity_factor=16.0)
    np_p = _moe_params(jcfg)
    p = {k: torch.from_numpy(v) for k, v in np_p.items()}
    x = _normal(2, (2, 24, cfg.d_model))
    y, logits = moe.moe_ffn(p, torch.from_numpy(x), cfg)
    assert bool(moe.route(logits, cfg).keep.all())
    y_dense, logits_dense = moe.moe_ffn_dense_reference(p, torch.from_numpy(x),
                                                        cfg)
    np.testing.assert_allclose(_np(y), _np(y_dense), **Y_TOL)
    assert torch.equal(logits, logits_dense)
    jy, _ = jmoe.moe_ffn_dense_reference(jax.tree.map(jnp.asarray, np_p),
                                         jnp.asarray(x), jcfg)
    np.testing.assert_allclose(_np(y_dense), _np(jy), **Y_TOL)


@pytest.mark.parametrize("ties", [False, True])
def test_load_balancing_loss_matches_jax(ties):
    jcfg, cfg = _configs(MIXTRAL)
    shape = (3, 40, cfg.n_experts)
    logits = (np.random.default_rng(4).integers(0, 2, shape).astype(np.float32)
              if ties else _normal(4, shape))
    want = jmoe.load_balancing_loss(jnp.asarray(logits), jcfg)
    got = moe.load_balancing_loss(torch.from_numpy(logits), cfg)
    assert float(got) == pytest.approx(float(want), rel=1e-6, abs=1e-6)


def test_capacity_matches_jax():
    for arch in (MIXTRAL, LLAMA4, JAMBA):
        for cf in (0.5, 1.0, 1.25, 16.0):
            jcfg = replace(jget_config(arch), capacity_factor=cf)
            cfg = replace(get_config(arch), capacity_factor=cf)
            for tokens in (1, 7, 40, 512, 4096):
                assert moe.capacity(cfg, tokens) == jmoe.capacity(jcfg, tokens)


def test_init_moe_matches_the_jax_layout():
    """Shapes and dtypes of a bf16 init, and the fan-in scale of each
    expert's weights."""
    jcfg, cfg = _configs(MIXTRAL, dtype="bfloat16")
    want = jmoe.init_moe(jax.random.PRNGKey(0), jcfg, jnp.bfloat16)
    got = moe.init_moe(torch.Generator().manual_seed(0), cfg, torch.bfloat16,
                       "cpu")
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        assert tuple(got[name].shape) == w.shape, name
        assert str(got[name].dtype).removeprefix("torch.") == w.dtype.name
    assert got["router"].dtype == torch.float32
    for name, fan_in in (("w_gate", cfg.d_model), ("w_down", cfg.d_ff)):
        std = got[name].float().std(dim=(1, 2)) * fan_in ** 0.5
        assert bool(((std > 0.8) & (std < 1.0)).all()), name   # trunc N(0,1)


# ------------------------------------------------------------- the models

MODELS = {"mixtral": (MIXTRAL, {}), "llama4": (LLAMA4, {}),
          "jamba": (JAMBA, {})}
# The models whose loss, aux and gradients are held to JAX's.  jamba: the
# hybrid's Mamba units train through the SSD scan's backward; its AdamW steps
# are held to JAX's, each from JAX's state, in tests/test_torch_train.py, so
# test_train_steps_match_jax runs only the two MoE transformers.
TRAIN_MODELS = ("mixtral", "llama4", "jamba")


def _model_configs(name):
    arch, overrides = MODELS[name]
    return _configs(arch, **overrides)


def _noise(rng, a, base):
    return (base + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)


def _jax_lm_params(jcfg, seed=0) -> dict:
    """The JAX ``init_lm`` as numpy, with seeded noise on the norm scales
    (JAX initialises them to 1)."""
    params = jax.tree.map(np.asarray, jtf.init_lm(jax.random.PRNGKey(seed),
                                                  jcfg))
    rng = np.random.default_rng(seed)
    for sp in params["units"].values():
        for name in ("mixer_norm", "ffn_norm"):
            if name in sp:
                sp[name] = _noise(rng, sp[name], 1.0)
    params["final_norm"] = _noise(rng, params["final_norm"], 1.0)
    return params


@pytest.mark.parametrize("name", list(MODELS))
def test_prefill_and_decode_match_jax(name):
    jcfg, cfg = _model_configs(name)
    assert cfg.dtype == "float32" and cfg.is_moe
    assert any(s["ffn"] == "moe" for s in ttf.unit_layout(cfg))
    np_params = _jax_lm_params(jcfg)
    jparams = jax.tree.map(jnp.asarray, np_params)
    params = from_jax_params(np_params, cfg, device="cpu")
    B, S, steps = 2, 40, 4
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    max_seq = S + steps + 1

    jlogits, jcache = jax.jit(lambda p, t: jtf.prefill(p, t, jcfg, max_seq))(
        jparams, jnp.asarray(tokens))
    logits, cache = ttf.prefill(params, torch.from_numpy(tokens).long(), cfg,
                                max_seq)
    np.testing.assert_allclose(_np(logits), _np(jlogits), **MODEL_TOL)
    jdecode = jax.jit(lambda p, t, c: jtf.decode_step(p, t, c, jcfg))
    for _ in range(steps):
        jtoken = jnp.argmax(jlogits, -1)[:, None].astype(jnp.int32)
        token = logits.argmax(-1, keepdim=True)
        np.testing.assert_array_equal(token.numpy(), np.asarray(jtoken))
        jlogits, jcache = jdecode(jparams, jtoken, jcache)
        logits, cache = ttf.decode_step(params, token, cache, cfg)
        np.testing.assert_allclose(_np(logits), _np(jlogits), **MODEL_TOL)


def test_generate_mixtral_on_cpu_runs_the_plain_path():
    from repro_torch.launch import serve

    cfg = get_config("mixtral-8x22b-smoke")
    model = get_model(cfg, device="cpu")
    params = model.init(0)
    sub = params["units"][0]["sub0"]
    assert "mlp" not in sub and sub["moe"]["router"].dtype == torch.float32
    batch = serve.prompt_batch(cfg, 3, 70, 0, "cpu")
    ops.reset_launch_counts()
    r = serve.generate(model, params, batch, 5)
    assert r["tokens"].shape == (3, 5) and bool(r["finite"])
    assert int(r["tokens"].min()) >= 0
    assert int(r["tokens"].max()) < cfg.vocab_size
    assert not any(ops.launch_counts().values())


def _assert_grad_close(got, want, label=""):
    got, want = _np(got), _np(want)
    atol = GRAD_ATOL_OF_MAX * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=GRAD_RTOL, atol=atol,
                               err_msg=str(label))


def _batch(cfg, batch=2, seq=48, step=0):
    b = SyntheticTokens(cfg, batch=batch, seq=seq, seed=0).batch_at(step)
    b["labels"][0, :5] = -1       # ignored positions
    return b


@pytest.mark.parametrize("name", TRAIN_MODELS)
def test_loss_aux_and_grads_match_jax(name):
    jcfg, cfg = _model_configs(name)
    np_params = _jax_lm_params(jcfg)
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

    assert float(jparts["aux"]) > 0
    for got, want in ((loss, jloss), (parts["ce"], jparts["ce"]),
                      (parts["aux"], jparts["aux"])):
        assert got.item() == pytest.approx(float(want), rel=LOSS_RTOL)
    want = from_jax_params(jax.tree.map(np.asarray, jgrads), cfg, "cpu")
    paths = set()
    for (path, w), g in zip(leaves_with_path(want), grads):
        assert g.shape == w.shape and g.dtype == w.dtype, path
        _assert_grad_close(g, w, path)
        paths.add(path[-1])
    assert {"router", "w_gate", "w_up", "w_down"} <= paths


def _jax_train(jcfg, np_params, batches, opt_kwargs):
    opt = jadamw.AdamW(**opt_kwargs)
    jp = jax.tree.map(jnp.asarray, np_params)
    state = jstate.TrainState(step=jnp.zeros((), jnp.int32), params=jp,
                              opt=opt.init(jp), rng=jax.random.PRNGKey(0))
    step = jax.jit(jstep.make_train_step(jregistry.get_model(jcfg), opt))
    out = []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        out.append((jax.tree.map(np.asarray, state.params),
                    {k: float(v) for k, v in m.items()}))
    return out


@pytest.mark.parametrize("name", ("mixtral", "llama4"))
def test_train_steps_match_jax(name):
    """Three steps of make_train_step on the same params and batches: each
    step's loss, ce, aux and gradient norm, and every parameter within lr
    (AdamW's first update turns float-order noise in a near-zero gradient
    into up to +-lr, as in ``tests/test_torch_train.py``)."""
    jcfg, cfg = _model_configs(name)
    np_params = _jax_lm_params(jcfg)
    batches = [_batch(cfg, batch=4, seq=32, step=i) for i in range(3)]
    opt_kwargs = dict(peak_lr=LR, warmup_steps=1, total_steps=10)
    want = _jax_train(jcfg, np_params, batches, opt_kwargs)

    opt = AdamW(**opt_kwargs)
    params = from_jax_params(np_params, cfg, device="cpu")
    state = TrainState(step=0, params=params, opt=opt.init(params), rng=1)
    step = make_train_step(get_model(cfg, device="cpu"), opt)
    for i, (b, (jparams, jm)) in enumerate(zip(batches, want)):
        state, m = step(state, b)
        assert state.step == i + 1
        for key in ("loss", "ce", "aux", "grad_norm"):
            assert float(m[key]) == pytest.approx(jm[key], rel=LOSS_RTOL), key
        jp = from_jax_params(jparams, cfg, "cpu")
        for (path, w), p in zip(leaves_with_path(jp), leaves(state.params)):
            assert p.dtype == w.dtype, path
            np.testing.assert_allclose(_np(p), _np(w), rtol=LOSS_RTOL,
                                       atol=LR, err_msg=str(path))


def test_weight_decay_follows_jax_rank_for_moe_leaves():
    """One AdamW step with the same gradients as JAX: the router and the
    stacked expert weights are decayed, as JAX's rank rule decays them."""
    jcfg, cfg = _model_configs("mixtral")
    np_params = _jax_lm_params(jcfg)
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
    decays = get_model(cfg, device="cpu").decays
    params, _, _ = opt.update(from_jax_params(np_grads, cfg, "cpu"),
                              opt.init(params), params, decays)
    decayed = set()
    for (path, p), w in zip(leaves_with_path(params), leaves(want)):
        np.testing.assert_allclose(_np(p), _np(w), rtol=1e-6, atol=1e-7,
                                   err_msg=str(path))
        if decays(path, p):
            decayed.add(path[-1])
    assert {"router", "w_gate", "w_up", "w_down"} <= decayed


def test_from_jax_params_keeps_the_router_float32():
    """A bf16 mixtral tree: every leaf takes the JAX init's dtype, the
    router float32 and the rest bf16; the port's own init agrees."""
    jcfg, cfg = _configs(MIXTRAL, dtype="bfloat16")
    tree = jax.tree.map(np.asarray, jtf.init_lm(jax.random.PRNGKey(0), jcfg))
    params = from_jax_params(tree, cfg, device="cpu")
    own = get_model(cfg, device="cpu").init(0)
    jleaves = dict(jax.tree_util.tree_flatten_with_path(tree["units"])[0])
    n_fp32 = 0
    for u in range(ttf.n_units(cfg)):
        for jpath, leaf in jleaves.items():
            path = tuple(k.key for k in jpath)
            got, mine = params["units"][u], own["units"][u]
            for k in path:
                got, mine = got[k], mine[k]
            name = str(got.dtype).removeprefix("torch.")
            assert name == str(mine.dtype).removeprefix("torch.") \
                == leaf.dtype.name, path
            if name == "float32":
                assert path[-2:] == ("moe", "router"), path
                np.testing.assert_array_equal(got.numpy(), leaf[u])
                n_fp32 += 1
            else:
                assert name == "bfloat16", path
    assert n_fp32 == ttf.n_units(cfg)
    for key in ("embed", "lm_head", "final_norm"):
        assert params[key].dtype == torch.bfloat16


def _cli(module, *args, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return subprocess.run([sys.executable, "-m", module, "--device", "cpu",
                           "--arch", "mixtral-8x22b-smoke", *args],
                          capture_output=True, text=True, timeout=300,
                          cwd=tmp_path, env=env)


def test_serve_and_train_cli_run_mixtral_on_cpu(tmp_path):
    r = _cli("repro_torch.launch.serve", "--prompt-len", "40", "--gen", "4",
             tmp_path=tmp_path)
    assert r.returncode == 0, r.stderr
    assert "mixtral-8x22b-smoke: prefill 4x40" in r.stdout
    r = _cli("repro_torch.launch.train", "--steps", "2", "--seq", "32",
             "--ckpt-dir", str(tmp_path / "ckpt"), tmp_path=tmp_path)
    assert r.returncode == 0, r.stderr
    assert "steps_run=2 final_step=2" in r.stdout
