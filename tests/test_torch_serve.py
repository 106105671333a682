"""The port's serving slice against the JAX package, on the same weights.

A JAX ``init_lm`` tree, with its QKV biases and norm scales overwritten by
seeded random values (JAX initialises them to 0 and 1, which would leave
those paths untested), goes through ``from_jax_params``; then the port's
``prefill`` and four ``decode_step``s run beside
``repro.models.transformer.prefill``/``decode_step`` on the same prompt.
Float32 on the CPU: logits agree to 1e-4 (the same sums in another order
over a few layers), greedy tokens are equal, and the caches agree after
prefill.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import transformer as jtf
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import get_model
from repro_torch.models import transformer as ttf
from repro_torch.models.convert import from_jax_params

TOL = dict(rtol=1e-4, atol=1e-4)
BATCH, PROMPT, STEPS = 2, 40, 4

CONFIGS = {
    "qwen2-7b-smoke": {},
    "gqa": {"n_kv_heads": 2},
    "sliding-window": {"sliding_window": 32},    # ring buffer: 32 < PROMPT
}


def _configs(name):
    overrides = CONFIGS[name]
    return (jget_config("qwen2-7b").smoke(**overrides),
            get_config("qwen2-7b").smoke(**overrides))


def _perturbed_jax_params(jcfg, seed=0):
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


def _tokens(vocab, seed=1):
    return np.random.default_rng(seed).integers(
        0, vocab, (BATCH, PROMPT)).astype(np.int32)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_prefill_and_decode_match_jax(name):
    # The JAX decode step needs 32-bit mode (its dynamic_update_slice mixes
    # int32 and default ints); another test module may have switched the
    # process to 64-bit mode.
    with jax.enable_x64(False):
        _prefill_and_decode_match_jax(name)


def _prefill_and_decode_match_jax(name):
    jcfg, cfg = _configs(name)
    assert cfg.qkv_bias and cfg.dtype == "float32"
    np_params = _perturbed_jax_params(jcfg)
    jparams = jax.tree.map(jnp.asarray, np_params)
    params = from_jax_params(np_params, cfg, device="cpu")
    tokens = _tokens(cfg.vocab_size)
    max_seq = PROMPT + STEPS + 1

    jprefill = jax.jit(lambda p, t: jtf.prefill(p, t, jcfg, max_seq))
    jdecode = jax.jit(lambda p, t, c: jtf.decode_step(p, t, c, jcfg))
    jlogits, jcache = jprefill(jparams, jnp.asarray(tokens))
    logits, cache = ttf.prefill(params, torch.from_numpy(tokens).long(), cfg,
                                max_seq)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    for kv_name in ("k", "v"):
        got = torch.stack([getattr(c.kv[0], kv_name) for c in cache]).numpy()
        want = np.asarray(getattr(jcache.kv, kv_name))[:, 0]
        np.testing.assert_allclose(got, want, **TOL)
    assert all(c.kv[0].length == PROMPT for c in cache)

    for _ in range(STEPS):
        jtoken = jnp.argmax(jlogits, -1)[:, None].astype(jnp.int32)
        token = logits.argmax(-1, keepdim=True)
        np.testing.assert_array_equal(token.numpy(), np.asarray(jtoken))
        jlogits, jcache = jdecode(jparams, jtoken, jcache)
        logits, cache = ttf.decode_step(params, token, cache, cfg)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    assert all(c.kv[0].length == PROMPT + STEPS for c in cache)


def test_generate_on_cpu_runs_the_plain_path():
    cfg = get_config("qwen2-7b-smoke")
    model = get_model(cfg, device="cpu")
    params = model.init(0)
    assert params["embed"].device.type == "cpu"
    assert len(params["units"]) == cfg.n_layers
    batch = serve.prompt_batch(cfg, 3, 70, 0, "cpu")
    ops.reset_launch_counts()
    r = serve.generate(model, params, batch, 5)
    assert r["tokens"].shape == (3, 5) and r["decode_steps"] == 4
    assert bool(r["finite"]) and r["logits"].shape == (3, cfg.vocab_size)
    assert int(r["tokens"].min()) >= 0
    assert int(r["tokens"].max()) < cfg.vocab_size
    assert not any(ops.launch_counts().values())


def test_generate_mamba_on_cpu_runs_the_plain_path():
    cfg = get_config("mamba2-370m-smoke")
    model = get_model(cfg, device="cpu")
    params = model.init(0)
    assert len(params["units"]) == cfg.n_layers
    assert params["units"][0]["sub0"]["mamba"]["A_log"].dtype == torch.float32
    batch = serve.prompt_batch(cfg, 3, 70, 0, "cpu")
    ops.reset_launch_counts()
    r = serve.generate(model, params, batch, 5)
    assert r["tokens"].shape == (3, 5) and r["decode_steps"] == 4
    assert bool(r["finite"]) and r["logits"].shape == (3, cfg.vocab_size)
    assert int(r["tokens"].min()) >= 0
    assert int(r["tokens"].max()) < cfg.vocab_size
    assert not any(ops.launch_counts().values())


def test_init_cache_shapes():
    cfg = get_config("qwen2-7b").smoke(sliding_window=32)
    cache = get_model(cfg, device="cpu").init_cache(2, 100)
    assert len(cache) == cfg.n_layers
    assert cache[0].kv[0].k.shape == (2, 32, cfg.n_kv_heads, cfg.hd)
    assert cache[0].kv[0].length == 0


def test_loss_waits_for_training_slice():
    """The dense loss came with the training slice, and a model with Mamba
    units trains since the slice with the SSD backward kernel: both give a
    finite loss and its parts (held to JAX in tests/test_torch_train.py)."""
    tokens = torch.zeros(1, 8, dtype=torch.int64)
    batch = {"tokens": tokens, "labels": tokens}
    for arch in ("mamba2-370m-smoke", "qwen2-7b-smoke"):
        model = get_model(get_config(arch), device="cpu")
        loss, parts = model.loss(model.init(0), batch)
        assert bool(torch.isfinite(loss)) and set(parts) == {"ce", "aux"}
