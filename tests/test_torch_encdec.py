"""The port's encoder-decoder family (whisper) against the JAX package, on
the CPU.

A JAX ``init_encdec`` tree, with its norm scales overwritten by seeded
noise (JAX initialises them to 1, which would leave the scales untested),
goes through ``from_jax_params``; the port and ``repro.models.encdec`` then
run on the same numpy frames and tokens:

* ``encode``, ``prefill`` (both caches) and four greedy ``decode_step``s,
  with as many frames as tokens (as the JAX pipeline draws them) and with
  another number, not a multiple of 64 (as whisper serves: 1500 frames
  against a shorter text);
* ``attend_cross`` and ``encode_kv`` alone, with MHA and with GQA and
  biases;
* the loss, every gradient leaf and three AdamW steps against
  ``jax.value_and_grad`` and JAX's train step;
* ``from_jax_params`` (the per-layer split, dtypes), the weight-decay rule
  against JAX's rank rule, ``prompt_batch`` against the JAX launcher's
  draws, and the CLIs.

Tolerances, float32: serving 1e-4 (the same sums in another order over a
few layers), the loss 1e-5 relative, gradients rtol 1e-4 and 2e-5 of the
leaf's largest entry, parameters after AdamW steps within lr (AdamW's first
update turns float-order noise in a near-zero gradient into up to +-lr, as
``tests/test_torch_train.py`` explains).  The JAX side runs in 32-bit mode:
its decode step mixes int32 and default ints.
"""

import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch import serve as jserve
from repro.models import attention as jattn
from repro.models import encdec as jed
from repro.models import registry as jregistry
from repro.optim import adamw as jadamw
from repro.train import state as jstate
from repro.train import step as jstep
from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import attention as tattn
from repro_torch.models import encdec as ted
from repro_torch.models import get_model
from repro_torch.models.convert import from_jax_params
from repro_torch.optim.adamw import AdamW
from repro_torch.train.state import TrainState
from repro_torch.train.step import make_train_step
from repro_torch.tree import leaves, leaves_with_path

REPO = Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_RTOL, GRAD_ATOL_OF_MAX = 1e-4, 2e-5
LOSS_RTOL = 1e-5
LR = 1e-3
BATCH, PROMPT, STEPS = 2, 24, 4
# Frames per row: as many as tokens, and another number (not a multiple of
# 64, more than the tokens).
FRAMES = [PROMPT, 37]


@pytest.fixture(autouse=True)
def _jax_32bit():
    with jax.enable_x64(False):
        yield


def _configs(**overrides):
    return (jget_config("whisper-base").smoke(**overrides),
            get_config("whisper-base").smoke(**overrides))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _jax_params(jcfg, seed=0) -> dict:
    """The JAX init as numpy, every norm scale 1 + seeded noise."""
    params = jax.tree.map(np.asarray, jed.init_encdec(jax.random.PRNGKey(seed),
                                                      jcfg))
    rng = np.random.default_rng(seed)

    def noise(a):
        return (1 + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)

    for name in ("enc_norm", "final_norm"):
        params[name] = noise(params[name])
    for stack, names in (("enc_layers", ("attn_norm", "mlp_norm")),
                         ("dec_layers", ("self_norm", "cross_norm",
                                         "mlp_norm"))):
        for name in names:
            params[stack][name] = noise(params[stack][name])
    return params


def _inputs(cfg, frames, seed=1):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)
    x = rng.standard_normal((BATCH, frames, cfg.d_model)).astype(np.float32)
    return x, tokens


def _assert_grad_close(got, want, label=""):
    got, want = _np(got), _np(want)
    atol = GRAD_ATOL_OF_MAX * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=GRAD_RTOL, atol=atol,
                               err_msg=str(label))


def test_sinusoid_matches_jax():
    for S, D in ((37, 64), (1500, 512)):
        np.testing.assert_allclose(
            ted.sinusoid_pos(S, D, torch.float32).numpy(),
            np.asarray(jed.sinusoid_pos(S, D, jnp.float32)), rtol=0,
            atol=2e-4)
    # the decode step's position, one row of the table
    np.testing.assert_array_equal(
        ted.sinusoid_at(torch.tensor([29]), 64, torch.float32).numpy()[0],
        ted.sinusoid_pos(37, 64, torch.float32).numpy()[29])


@pytest.mark.parametrize("frames", FRAMES)
def test_encode_matches_jax(frames):
    jcfg, cfg = _configs()
    np_params = _jax_params(jcfg)
    x, _ = _inputs(cfg, frames)
    want = jax.jit(lambda p, f: jed.encode(p, f, jcfg))(
        jax.tree.map(jnp.asarray, np_params), jnp.asarray(x))
    got = ted.encode(from_jax_params(np_params, cfg, "cpu"),
                     torch.from_numpy(x), cfg)
    assert got.shape == (BATCH, frames, cfg.d_model)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("frames", FRAMES)
def test_prefill_and_decode_match_jax(frames):
    jcfg, cfg = _configs()
    np_params = _jax_params(jcfg)
    jparams = jax.tree.map(jnp.asarray, np_params)
    params = from_jax_params(np_params, cfg, device="cpu")
    x, tokens = _inputs(cfg, frames)
    max_seq = PROMPT + STEPS + 1

    jlogits, jcache = jax.jit(
        lambda p, f, t: jed.prefill(p, f, t, jcfg, max_seq))(
        jparams, jnp.asarray(x), jnp.asarray(tokens))
    logits, cache = ted.prefill(params, torch.from_numpy(x),
                                torch.from_numpy(tokens).long(), cfg, max_seq)
    np.testing.assert_allclose(_np(logits), _np(jlogits), **TOL)
    for i, (kv, (ck, cv)) in enumerate(zip(cache.kv, cache.cross)):
        assert kv.length == PROMPT
        assert kv.k.shape == (BATCH, max_seq, cfg.n_kv_heads, cfg.hd)
        assert ck.shape == (BATCH, frames, cfg.n_kv_heads, cfg.hd)
        for got, want in ((kv.k, jcache.kv.k[i]), (kv.v, jcache.kv.v[i]),
                          (ck, jcache.cross[0][i]), (cv, jcache.cross[1][i])):
            np.testing.assert_allclose(_np(got), _np(want), **TOL)

    jdecode = jax.jit(lambda p, t, c: jed.decode_step(p, t, c, jcfg))
    for _ in range(STEPS):
        jtoken = jnp.argmax(jlogits, -1)[:, None].astype(jnp.int32)
        token = logits.argmax(-1, keepdim=True)
        np.testing.assert_array_equal(token.numpy(), np.asarray(jtoken))
        jlogits, jcache = jdecode(jparams, jtoken, jcache)
        logits, cache = ted.decode_step(params, token, cache, cfg)
        np.testing.assert_allclose(_np(logits), _np(jlogits), **TOL)
    assert all(kv.length == PROMPT + STEPS for kv in cache.kv)


@pytest.mark.parametrize("overrides", [{}, {"n_kv_heads": 2,
                                            "qkv_bias": True}],
                         ids=["mha", "gqa-bias"])
def test_attend_cross_and_encode_kv_match_jax(overrides):
    jcfg, cfg = _configs(**overrides)
    p = jax.tree.map(np.asarray, jattn.init_cross_attn(
        jax.random.PRNGKey(3), jcfg, jnp.float32))
    if cfg.qkv_bias:
        rng = np.random.default_rng(3)
        for name in ("bq", "bk", "bv"):
            p[name] = (0.1 * rng.standard_normal(p[name].shape)).astype(
                np.float32)
    rng = np.random.default_rng(4)
    enc = rng.standard_normal((BATCH, 37, cfg.d_model)).astype(np.float32)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    jp = jax.tree.map(jnp.asarray, p)
    jkv = jattn.encode_kv(jp, jnp.asarray(enc), jcfg)
    kv = tattn.encode_kv(tp, torch.from_numpy(enc), cfg)
    for got, want in zip(kv, jkv):
        assert got.shape == (BATCH, 37, cfg.n_kv_heads, cfg.hd)
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    for S in (1, PROMPT):     # decode's one query, and a prompt
        x = rng.standard_normal((BATCH, S, cfg.d_model)).astype(np.float32)
        want = jattn.attend_cross(jp, jnp.asarray(x), jkv, jcfg)
        got = tattn.attend_cross(tp, torch.from_numpy(x), kv, cfg)
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


def _batch(cfg, frames, batch=2, seq=PROMPT, step=0):
    """The pipeline's batch (frames as many as tokens), its frames redrawn
    with ``frames`` rows where that differs, and five ignored labels."""
    b = SyntheticTokens(cfg, batch=batch, seq=seq, seed=0).batch_at(step)
    if frames != seq:
        b["frames"] = np.random.default_rng((9, step)).standard_normal(
            (batch, frames, cfg.d_model)).astype(np.float32)
    b["labels"][0, :5] = -1
    return b


@pytest.mark.parametrize("frames", FRAMES)
def test_loss_and_grads_match_jax(frames):
    jcfg, cfg = _configs()
    np_params = _jax_params(jcfg)
    batch = _batch(cfg, frames)
    (jloss, jparts), jgrads = jax.value_and_grad(
        lambda p: jed.loss_fn(p, {k: jnp.asarray(v) for k, v in
                                  batch.items()}, jcfg),
        has_aux=True)(jax.tree.map(jnp.asarray, np_params))

    params = from_jax_params(np_params, cfg, device="cpu")
    for p in leaves(params):
        p.requires_grad_(True)
    loss, parts = get_model(cfg, device="cpu").loss(
        params, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves(params))

    assert loss.item() == pytest.approx(float(jloss), rel=LOSS_RTOL)
    assert parts["ce"].item() == pytest.approx(float(jparts["ce"]),
                                               rel=LOSS_RTOL)
    assert float(parts["aux"]) == float(jparts["aux"]) == 0.0
    want = from_jax_params(jax.tree.map(np.asarray, jgrads), cfg, "cpu")
    paths = set()
    for (path, w), g in zip(leaves_with_path(want), grads):
        assert g.shape == w.shape and g.dtype == w.dtype, path
        _assert_grad_close(g, w, path)
        paths.add(path[:1] + path[2:])
    assert {("dec_layers", "cross_attn", "wk"), ("enc_layers", "attn", "wq"),
            ("dec_layers", "cross_norm"), ("enc_norm",)} <= paths


def test_forward_train_recomputes_each_decoder_layer_once(monkeypatch):
    """Activation checkpointing on the decoder's layers only, as the JAX
    module's jax.checkpoint: the decoder's norms run twice forward (the
    pass and the recompute), the encoder's and the final norm once;
    counted through the plain version."""
    cfg = get_config("whisper-base-smoke")
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
                                  _batch(cfg, 37).items()})
    n_forward = len(calls)
    torch.autograd.grad(loss, leaves(params))
    E, L = cfg.n_enc_layers, cfg.n_layers
    assert n_forward == 2 * E + 1 + 3 * L + 1
    assert len(calls) == 2 * E + 1 + 6 * L + 1


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


def test_train_steps_match_jax():
    """Three steps of make_train_step on the same params and batches (37
    frames against 24 tokens): each step's loss, ce and gradient norm, and
    every parameter within lr."""
    jcfg, cfg = _configs()
    np_params = _jax_params(jcfg)
    batches = [_batch(cfg, 37, batch=4, step=i) for i in range(3)]
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
            assert float(m[key]) == pytest.approx(jm[key], rel=LOSS_RTOL,
                                                  abs=1e-12), key
        jp = from_jax_params(jparams, cfg, "cpu")
        for (path, w), p in zip(leaves_with_path(jp), leaves(state.params)):
            assert p.dtype == w.dtype, path
            np.testing.assert_allclose(_np(p), _np(w), rtol=LOSS_RTOL,
                                       atol=LR, err_msg=str(path))


def test_weight_decay_follows_jax_rank():
    """JAX decays leaves of rank >= 2, and its enc_layers and dec_layers
    leaves are stacked over layers: every layer's norm scales are decayed,
    the top-level enc_norm and final_norm are not.  One AdamW step with the
    same (non-tiny) gradients, against JAX."""
    jcfg, cfg = _configs()
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
    decays = get_model(cfg, device="cpu").decays
    params, _, _ = opt.update(from_jax_params(np_grads, cfg, "cpu"),
                              opt.init(params), params, decays)
    decayed, kept = set(), set()
    for (path, p), w in zip(leaves_with_path(params), leaves(want)):
        np.testing.assert_allclose(_np(p), _np(w), rtol=1e-6, atol=1e-7,
                                   err_msg=str(path))
        (decayed if decays(path, p) else kept).add(path[-1])
    assert kept == {"enc_norm", "final_norm"}
    assert {"attn_norm", "self_norm", "cross_norm", "mlp_norm", "wq",
            "embed", "lm_head"} <= decayed


def test_from_jax_params_splits_layers_and_keeps_dtypes():
    """A bf16 whisper tree: enc_layers and dec_layers become lists of
    per-layer dicts holding the stacked arrays' rows; every leaf, the
    cross-attention's included, takes the config's dtype; the port's own
    init has the same paths, shapes and dtypes."""
    jcfg, cfg = _configs(dtype="bfloat16")
    tree = jax.tree.map(np.asarray, jed.init_encdec(jax.random.PRNGKey(0),
                                                    jcfg))
    params = from_jax_params(tree, cfg, device="cpu")
    own = get_model(cfg, device="cpu").init(0)
    assert len(params["enc_layers"]) == len(own["enc_layers"]) \
        == cfg.n_enc_layers
    assert len(params["dec_layers"]) == len(own["dec_layers"]) == cfg.n_layers
    got, mine = leaves_with_path(params), leaves_with_path(own)
    assert [p for p, _ in got] == [p for p, _ in mine]
    for (path, a), (_, b) in zip(got, mine):
        assert a.dtype == b.dtype == torch.bfloat16, path
        assert a.shape == b.shape, path
        want = tree[path[0]]
        if len(path) > 1 and isinstance(path[1], int):   # a layer's leaf
            for key in path[2:]:
                want = want[key]
            want = want[path[1]]
        np.testing.assert_array_equal(a.float().numpy(),
                                      want.astype(np.float32), str(path))
    assert params["dec_layers"][1]["cross_attn"]["wk"].dtype == torch.bfloat16


def test_init_cache_raises_as_jax_does():
    model = get_model(get_config("whisper-base-smoke"), device="cpu")
    with pytest.raises(NotImplementedError, match="prefill"):
        model.init_cache(2, 16)
    with pytest.raises(NotImplementedError):
        jregistry.get_model(jget_config("whisper-base-smoke")).init_cache(2, 16)


class _Stop(Exception):
    pass


def jax_launcher_batch(monkeypatch, argv: list[str]) -> tuple[dict, int]:
    """The batch and ``max_seq`` that ``repro.launch.serve.main`` builds for
    ``argv``: its model is replaced by one whose prefill records them and
    stops the launcher, and ``jax.jit`` by the identity."""
    seen = {}

    def prefill(params, batch, max_seq):
        seen.update(batch=jax.tree.map(np.asarray, batch), max_seq=max_seq)
        raise _Stop

    fake = types.SimpleNamespace(init=lambda key: {}, prefill=prefill,
                                 decode=None)
    monkeypatch.setattr(jserve, "get_model", lambda cfg: fake)
    monkeypatch.setattr(jax, "jit", lambda fn, **kw: fn)
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    with pytest.raises(_Stop):
        jserve.main()
    return seen["batch"], seen["max_seq"]


@pytest.mark.parametrize("arch", ["whisper-base-smoke",
                                  "llava-next-34b-smoke", "qwen2-7b-smoke"])
def test_prompt_batch_draws_the_jax_launchers(monkeypatch, arch):
    want, _ = jax_launcher_batch(monkeypatch, [
        "--arch", arch, "--batch", "3", "--prompt-len", "20", "--gen", "5",
        "--seed", "7"])
    got = serve.prompt_batch(get_config(arch), 3, 20, 7, "cpu")
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
        if k != "tokens":
            assert got[k].dtype == torch.float32, k
    if arch.startswith("whisper"):    # frames of another length, same draws
        other = serve.prompt_batch(get_config(arch), 3, 20, 7, "cpu",
                                   frames=33)
        np.testing.assert_array_equal(other["tokens"].numpy(),
                                      want["tokens"])
        assert other["frames"].shape == (3, 33, 64)


def test_generate_whisper_on_cpu_runs_the_plain_path():
    cfg = get_config("whisper-base-smoke")
    model = get_model(cfg, device="cpu")
    params = model.init(0)
    batch = serve.prompt_batch(cfg, 3, 20, 0, "cpu", frames=70)
    assert serve.context_len(batch) == 20
    ops.reset_launch_counts()
    r = serve.generate(model, params, batch, 5)
    assert r["tokens"].shape == (3, 5) and r["decode_steps"] == 4
    assert bool(r["finite"]) and r["logits"].shape == (3, cfg.vocab_size)
    assert 0 <= int(r["tokens"].min()) and \
        int(r["tokens"].max()) < cfg.vocab_size
    assert not any(ops.launch_counts().values())


def _cli(module, *args, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return subprocess.run([sys.executable, "-m", module, "--device", "cpu",
                           "--arch", "whisper-base-smoke", *args],
                          capture_output=True, text=True, timeout=300,
                          cwd=tmp_path, env=env)


def test_serve_and_train_cli_run_whisper_on_cpu(tmp_path):
    r = _cli("repro_torch.launch.serve", "--prompt-len", "24", "--frames",
             "50", "--gen", "4", tmp_path=tmp_path)
    assert r.returncode == 0, r.stderr
    assert "whisper-base-smoke: prefill 4x24" in r.stdout
    r = _cli("repro_torch.launch.train", "--steps", "2", "--seq", "32",
             "--ckpt-dir", str(tmp_path / "ckpt"), tmp_path=tmp_path)
    assert r.returncode == 0, r.stderr
    assert "steps_run=2 final_step=2" in r.stdout
