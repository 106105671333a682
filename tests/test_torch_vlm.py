"""The port's VLM family (llava) against the JAX package, on the CPU.

The llava smoke model (8 prefix rows of stub patch embeddings ahead of the
text) and a GQA variant, on a JAX ``init_lm`` tree with seeded noise on its
norm scales, through ``from_jax_params``:

* prefill over prefix + prompt and four greedy decode steps against
  ``repro.models.transformer`` with a cache of prefix + prompt + gen rows;
* the loss over the text positions, every gradient leaf and three AdamW
  steps against ``jax.value_and_grad`` and JAX's train step;
* the reference launcher's cache-sizing fault: ``repro.launch.serve``
  sizes the cache as prompt + gen, leaving out the prefix rows, so the JAX
  model keeps a ring buffer of the last prompt + gen positions and decode
  forgets the image; the port's ``generate`` counts the prefix rows and
  equals the JAX model at that full sizing;
* the CLIs.

Tolerances, float32, as in ``tests/test_torch_encdec.py``: serving 1e-4,
the loss 1e-5 relative, gradients rtol 1e-4 and 2e-5 of the leaf's largest
entry, parameters after AdamW steps within lr.  The JAX side runs in 32-bit
mode.
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
from repro.train import state as jstate
from repro.train import step as jstep
from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import get_model
from repro_torch.models import transformer as ttf
from repro_torch.models.convert import from_jax_params
from repro_torch.optim.adamw import AdamW
from repro_torch.train.state import TrainState
from repro_torch.train.step import make_train_step
from repro_torch.tree import leaves, leaves_with_path
from test_torch_encdec import jax_launcher_batch

REPO = Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_RTOL, GRAD_ATOL_OF_MAX = 1e-4, 2e-5
LOSS_RTOL = 1e-5
LR = 1e-3
MODELS = {"llava": {}, "gqa": {"n_heads": 8, "n_kv_heads": 2}}


@pytest.fixture(autouse=True)
def _jax_32bit():
    with jax.enable_x64(False):
        yield


def _configs(name):
    overrides = MODELS[name]
    return (jget_config("llava-next-34b").smoke(**overrides),
            get_config("llava-next-34b").smoke(**overrides))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _jax_params(jcfg, seed=0) -> dict:
    """The JAX ``init_lm`` as numpy, every norm scale 1 + seeded noise."""
    params = jax.tree.map(np.asarray, jtf.init_lm(jax.random.PRNGKey(seed),
                                                  jcfg))
    rng = np.random.default_rng(seed)

    def noise(a):
        return (1 + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)

    sub = params["units"]["sub0"]
    for name in ("mixer_norm", "ffn_norm"):
        sub[name] = noise(sub[name])
    params["final_norm"] = noise(params["final_norm"])
    return params


def _jax_generate(jcfg, jparams, batch: dict, max_seq: int, gen: int):
    """Greedy decoding of the JAX model: (tokens [B, gen], the logits of
    each step)."""
    jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    logits, cache = jax.jit(lambda p, b: jtf.prefill(
        p, b["tokens"], jcfg, max_seq, prefix=b["prefix"]))(jparams, jb)
    decode = jax.jit(lambda p, t, c: jtf.decode_step(p, t, c, jcfg))
    out, all_logits = [], [logits]
    for _ in range(gen - 1):
        token = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        out.append(token)
        logits, cache = decode(jparams, token, cache)
        all_logits.append(logits)
    out.append(jnp.argmax(logits, -1)[:, None])
    return np.concatenate([np.asarray(t) for t in out], 1), all_logits


@pytest.mark.parametrize("name", list(MODELS))
def test_prefill_and_decode_match_jax(name):
    jcfg, cfg = _configs(name)
    assert cfg.n_prefix_tokens == 8 and cfg.frontend == "vision_patches"
    np_params = _jax_params(jcfg)
    jparams = jax.tree.map(jnp.asarray, np_params)
    params = from_jax_params(np_params, cfg, device="cpu")
    batch = serve.prompt_batch(cfg, 2, 20, 1, "cpu")
    P, S, gen = cfg.n_prefix_tokens, 20, 5
    max_seq = P + S + gen

    want_tokens, want_logits = _jax_generate(jcfg, jparams, batch, max_seq,
                                             gen)
    logits, cache = ttf.prefill(params, batch["tokens"], cfg, max_seq,
                                prefix=batch["prefix"])
    assert all(c.kv[0].length == P + S for c in cache)
    assert cache[0].kv[0].k.shape[1] == max_seq
    np.testing.assert_allclose(_np(logits), _np(want_logits[0]), **TOL)
    for step in range(gen - 1):
        token = logits.argmax(-1, keepdim=True)
        np.testing.assert_array_equal(token.numpy()[:, 0],
                                      want_tokens[:, step])
        logits, cache = ttf.decode_step(params, token, cache, cfg)
        np.testing.assert_allclose(_np(logits), _np(want_logits[step + 1]),
                                   **TOL)


def test_launcher_cache_sizing_forgets_the_image(monkeypatch):
    """The reference launcher sizes the cache as prompt + gen.  With the
    prefix ahead of the prompt that is shorter than the context, so the
    JAX model keeps only the last prompt + gen positions and its decode
    logits move away from those of a cache that holds the whole context;
    the port's ``generate`` sizes the cache as prefix + prompt + gen and
    equals the JAX model at that sizing.  The port's own prefill and decode
    at the launcher's sizing reproduce the JAX model's ring buffer too."""
    jcfg, cfg = _configs("llava")
    P, prompt, gen = cfg.n_prefix_tokens, 6, 4
    _, launcher_max_seq = jax_launcher_batch(monkeypatch, [
        "--arch", "llava-next-34b-smoke", "--batch", "2", "--prompt-len",
        str(prompt), "--gen", str(gen)])
    monkeypatch.undo()
    assert launcher_max_seq == prompt + gen < P + prompt

    np_params = _jax_params(jcfg)
    jparams = jax.tree.map(jnp.asarray, np_params)
    params = from_jax_params(np_params, cfg, device="cpu")
    batch = serve.prompt_batch(cfg, 2, prompt, 0, "cpu")
    _, short = _jax_generate(jcfg, jparams, batch, launcher_max_seq, gen)
    full_tokens, full = _jax_generate(jcfg, jparams, batch, P + prompt + gen,
                                      gen)
    np.testing.assert_allclose(_np(short[0]), _np(full[0]), **TOL)  # prefill
    gap = float(np.abs(_np(short[-1]) - _np(full[-1])).max())
    print(f"launcher sizing moves the last decode logits by up to {gap:.3g} "
          f"(largest |logit| {float(np.abs(_np(full[-1])).max()):.3g})")
    assert gap > 0.1, gap

    r = serve.generate(get_model(cfg, device="cpu"), params, batch, gen)
    np.testing.assert_array_equal(r["tokens"].numpy(), full_tokens)
    np.testing.assert_allclose(_np(r["logits"]), _np(full[-1]), **TOL)

    logits, cache = ttf.prefill(params, batch["tokens"], cfg,
                                launcher_max_seq, prefix=batch["prefix"])
    for step in range(gen - 1):
        logits, cache = ttf.decode_step(params, logits.argmax(-1,
                                                              keepdim=True),
                                        cache, cfg)
    np.testing.assert_allclose(_np(logits), _np(short[-1]), **TOL)


def _batch(cfg, batch=2, seq=24, step=0):
    b = SyntheticTokens(cfg, batch=batch, seq=seq, seed=0).batch_at(step)
    b["labels"][0, :5] = -1       # ignored positions
    return b


def _assert_grad_close(got, want, label=""):
    got, want = _np(got), _np(want)
    atol = GRAD_ATOL_OF_MAX * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=GRAD_RTOL, atol=atol,
                               err_msg=str(label))


@pytest.mark.parametrize("name", list(MODELS))
def test_loss_and_grads_match_jax(name):
    jcfg, cfg = _configs(name)
    np_params = _jax_params(jcfg)
    batch = _batch(cfg)
    assert batch["prefix"].shape == (2, cfg.n_prefix_tokens, cfg.d_model)
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

    assert loss.item() == pytest.approx(float(jloss), rel=LOSS_RTOL)
    assert parts["ce"].item() == pytest.approx(float(jparts["ce"]),
                                               rel=LOSS_RTOL)
    assert float(parts["aux"]) == float(jparts["aux"]) == 0.0
    want = from_jax_params(jax.tree.map(np.asarray, jgrads), cfg, "cpu")
    for (path, w), g in zip(leaves_with_path(want), grads):
        assert g.shape == w.shape and g.dtype == w.dtype, path
        _assert_grad_close(g, w, path)


def test_loss_scores_the_text_positions_only():
    """The loss equals the cross-entropy of ``forward_train``'s logits past
    the prefix, and the prefix's positions reach it only through the
    attention."""
    cfg = get_config("llava-next-34b-smoke")
    model = get_model(cfg, device="cpu")
    params = model.init(0)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    loss, parts = model.loss(params, batch)
    logits, _ = ttf.forward_train(params, batch["tokens"], cfg,
                                  prefix=batch["prefix"])
    assert logits.shape[1] == cfg.n_prefix_tokens + batch["tokens"].shape[1]
    want = ttf.cross_entropy(logits[:, cfg.n_prefix_tokens:], batch["labels"])
    assert loss.item() == pytest.approx(want.item(), rel=1e-6)
    other = dict(batch, prefix=batch["prefix"] + 1.0)
    assert model.loss(params, other)[0].item() != pytest.approx(loss.item())


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


@pytest.mark.parametrize("name", list(MODELS))
def test_train_steps_match_jax(name):
    """Three steps of make_train_step on the same params and batches: each
    step's loss, ce and gradient norm, and every parameter within lr."""
    jcfg, cfg = _configs(name)
    np_params = _jax_params(jcfg)
    batches = [_batch(cfg, batch=4, seq=16, step=i) for i in range(3)]
    opt_kwargs = dict(peak_lr=LR, warmup_steps=1, total_steps=10)
    want = _jax_train(jcfg, np_params, batches, opt_kwargs)

    opt = AdamW(**opt_kwargs)
    params = from_jax_params(np_params, cfg, device="cpu")
    state = TrainState(step=0, params=params, opt=opt.init(params), rng=1)
    step = make_train_step(get_model(cfg, device="cpu"), opt)
    for i, (b, (jparams, jm)) in enumerate(zip(batches, want)):
        state, m = step(state, b)
        assert state.step == i + 1
        for key in ("loss", "ce", "grad_norm"):
            assert float(m[key]) == pytest.approx(jm[key], rel=LOSS_RTOL), key
        jp = from_jax_params(jparams, cfg, "cpu")
        for (path, w), p in zip(leaves_with_path(jp), leaves(state.params)):
            assert p.dtype == w.dtype, path
            np.testing.assert_allclose(_np(p), _np(w), rtol=LOSS_RTOL,
                                       atol=LR, err_msg=str(path))


def test_generate_llava_on_cpu_runs_the_plain_path():
    cfg = get_config("llava-next-34b-smoke")
    model = get_model(cfg, device="cpu")
    params = model.init(0)
    batch = serve.prompt_batch(cfg, 3, 20, 0, "cpu")
    assert serve.context_len(batch) == 20 + cfg.n_prefix_tokens
    ops.reset_launch_counts()
    r = serve.generate(model, params, batch, 5)
    assert r["tokens"].shape == (3, 5) and bool(r["finite"])
    assert 0 <= int(r["tokens"].min()) and \
        int(r["tokens"].max()) < cfg.vocab_size
    assert not any(ops.launch_counts().values())


def _cli(module, *args, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return subprocess.run([sys.executable, "-m", module, "--device", "cpu",
                           "--arch", "llava-next-34b-smoke", *args],
                          capture_output=True, text=True, timeout=300,
                          cwd=tmp_path, env=env)


def test_serve_and_train_cli_run_llava_on_cpu(tmp_path):
    r = _cli("repro_torch.launch.serve", "--prompt-len", "24", "--gen", "4",
             tmp_path=tmp_path)
    assert r.returncode == 0, r.stderr
    assert "llava-next-34b-smoke: prefill 4x24" in r.stdout
    r = _cli("repro_torch.launch.train", "--steps", "2", "--seq", "32",
             "--ckpt-dir", str(tmp_path / "ckpt"), tmp_path=tmp_path)
    assert r.returncode == 0, r.stderr
    assert "steps_run=2 final_step=2" in r.stdout
