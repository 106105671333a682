"""The port's Mamba-2 serving slice against the JAX package, on the same
inputs.

* The plain SSD scans (``ref.ssd_scan_ref``, the model's chunked scan, and
  ``ref.ssd_ref``, the sequential recurrence) against the Pallas kernel in
  interpret mode, ``repro.kernels.ref.ssd_ref`` and
  ``repro.models.mamba.ssd_scan``, on the cases of ``tests/test_kernels.py``,
  then with a nonzero initial state and ragged lengths.
* ``mamba_forward``/``mamba_decode`` against the JAX mixer, with the
  leaves JAX initialises to zeros and ones (``conv_b``, ``dt_bias``, ``D``,
  ``norm_scale``) and ``A_log`` perturbed by seeded noise.
* ``mamba2-370m-smoke`` and the hybrid ``jamba-1.5-large-398b-smoke``
  without experts: prefill and four decode steps against
  ``repro.models.transformer.prefill``/``decode_step``, with the conv tails,
  SSM states and K/V caches compared after prefill and after decode.
* ``from_jax_params`` keeps the float32 Mamba leaves of a bf16 tree.

Inputs come from numpy with a seed.  Tolerances: float32 2e-4 for the scans
against the Pallas kernel and the sequential recurrence (exp and cumsum
over a chunk in another order, as in ``tests/test_kernels.py``), 1e-4 for
the model paths (the same sums in another order over a few layers), and
bfloat16 3e-2 (the output's rounding).  The JAX model's own scan rounds
x*dt and C.B^T to bf16 where the port's plain scan, the Pallas kernel and
the recurrence keep fp32, so in bf16 it is held to 3e-2 of its largest
output.  The JAX side runs in 32-bit mode: its decode step mixes int32 and
default ints.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels import ref as jref
from repro.kernels import ssd_scan as jssd
from repro.models import mamba as jmb
from repro.models import transformer as jtf
from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.models import get_model
from repro_torch.models import mamba as mb
from repro_torch.models import transformer as ttf
from repro_torch.models.convert import from_jax_params

SCAN_TOLS = {"float32": dict(rtol=2e-4, atol=2e-4),
             "bfloat16": dict(rtol=3e-2, atol=3e-2)}
TOL = dict(rtol=1e-4, atol=1e-4)
# Whole-model SSM states, relative to their largest entry: the chunk's
# cumsum of dt*A reaches -10^2..-10^3 at the model's A, so exp of it carries
# ~1e-4 relative error in either framework's summation order.
STATE_ATOL = 2e-4


@pytest.fixture(autouse=True)
def _jax_32bit():
    with jax.enable_x64(False):
        yield


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _ssd_inputs(B, S, H, P, N, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((B, S, H)), 0).astype(np.float32)
    A = -np.exp(0.5 * rng.standard_normal(H)).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    return x, dt, A, Bm, Cm


def _both(inputs, dtype):
    """The same inputs for the port and for JAX; x, Bm and Cm in ``dtype``
    (both round to nearest even), dt and A in float32."""
    x, dt, A, Bm, Cm = inputs
    tdt = getattr(torch, dtype)
    t = (torch.from_numpy(x).to(tdt), torch.from_numpy(dt), torch.from_numpy(A),
         torch.from_numpy(Bm).to(tdt), torch.from_numpy(Cm).to(tdt))
    jd = jnp.dtype(dtype)
    j = (jnp.asarray(x).astype(jd), jnp.asarray(dt), jnp.asarray(A),
         jnp.asarray(Bm).astype(jd), jnp.asarray(Cm).astype(jd))
    return t, j


# Cases of tests/test_kernels.py::TestSSDScan: (B, S, H, P, N, chunk).
SSD_CASES = {
    "small": (1, 128, 8, 16, 16, 32),
    "mid": (2, 256, 4, 32, 64, 64),
    "model_heads": (1, 64, 16, 64, 128, 64),
}


class TestSSDScan:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("name", list(SSD_CASES))
    def test_plain_matches_pallas_and_jax(self, name, dtype):
        B, S, H, P, N, chunk = SSD_CASES[name]
        (tx, tdt, tA, tB, tC), (jx, jdt, jA, jB, jC) = _both(
            _ssd_inputs(B, S, H, P, N), dtype)
        y, st = ref.ssd_scan_ref(tx, tdt, tA, tB, tC, chunk)
        y_seq, st_seq = ref.ssd_ref(tx, tdt, tA, tB, tC)
        assert y.dtype == tx.dtype and st.dtype == torch.float32
        wants = {
            "pallas": jssd.ssd_scan(jx, jdt, jA, jB, jC, chunk=chunk,
                                    head_block=min(4, H), interpret=True),
            "ssd_ref": jref.ssd_ref(jx, jdt, jA, jB, jC),
            "model": jmb.ssd_scan(jx, jdt, jA, jB, jC, chunk),
        }
        tol = SCAN_TOLS[dtype]
        for label, (jy, jst) in wants.items():
            y_tol = tol
            if label == "model" and dtype == "bfloat16":
                # The JAX model's scan rounds x*dt and C.B^T to bf16: a few
                # bf16 steps of the largest term, wherever the terms cancel.
                y_tol = dict(rtol=3e-2, atol=3e-2 * np.abs(_np(jy)).max())
            np.testing.assert_allclose(_np(y), _np(jy), **y_tol, err_msg=label)
            np.testing.assert_allclose(_np(st), _np(jst), **tol, err_msg=label)
        # The port's sequential recurrence against JAX's: the same fp32 math.
        np.testing.assert_allclose(_np(y_seq), _np(wants["ssd_ref"][0]),
                                   **SCAN_TOLS[dtype])
        np.testing.assert_allclose(_np(st_seq), _np(wants["ssd_ref"][1]),
                                   **SCAN_TOLS["float32"])

    @pytest.mark.parametrize("S,chunk", [(100, 32), (96, 32), (40, 64)])
    def test_initial_state_and_ragged_lengths(self, S, chunk):
        """S 100 shrinks the model's chunk to gcd(100, 32) = 4, S 40 to 40."""
        B, H, P, N = 2, 4, 16, 16
        (tx, tdt, tA, tB, tC), (jx, jdt, jA, jB, jC) = _both(
            _ssd_inputs(B, S, H, P, N, seed=3), "float32")
        init = (0.5 * np.random.default_rng(4).standard_normal(
            (B, H, P, N))).astype(np.float32)
        y, st = ref.ssd_scan_ref(tx, tdt, tA, tB, tC, chunk,
                                 torch.from_numpy(init))
        jy, jst = jmb.ssd_scan(jx, jdt, jA, jB, jC, chunk,
                               initial_state=jnp.asarray(init))
        np.testing.assert_allclose(_np(y), _np(jy), **TOL)
        np.testing.assert_allclose(_np(st), _np(jst), **TOL)
        y_seq, st_seq = ref.ssd_ref(tx, tdt, tA, tB, tC, torch.from_numpy(init))
        jy_seq, jst_seq = jref.ssd_ref(jx, jdt, jA, jB, jC, jnp.asarray(init))
        np.testing.assert_allclose(_np(y_seq), _np(jy_seq), **TOL)
        np.testing.assert_allclose(_np(st_seq), _np(jst_seq), **TOL)
        np.testing.assert_allclose(_np(y), _np(y_seq), **SCAN_TOLS["float32"])

    def test_ops_routes_cpu_tensors_to_plain(self):
        t, _ = _both(_ssd_inputs(2, 70, 4, 16, 16, seed=5), "float32")
        ops.reset_launch_counts()
        y, st = ops.ssd_scan(*t, chunk=32)
        want_y, want_st = ref.ssd_scan_ref(*t, 32)
        torch.testing.assert_close(y, want_y, rtol=0, atol=0)
        torch.testing.assert_close(st, want_st, rtol=0, atol=0)
        assert ops.launch_counts()["ssd_scan"] == 0

    def test_kernel_refuses_cpu_tensors(self):
        t, _ = _both(_ssd_inputs(1, 64, 4, 16, 16), "float32")
        before = tssd.launches
        with pytest.raises(ValueError, match="CUDA tensor"):
            tssd.ssd_scan(*t, chunk=32)
        assert tssd.launches == before


# ------------------------------------------------------------ the mixer

def _mamba_configs():
    return (jget_config("mamba2-370m").smoke(),
            get_config("mamba2-370m").smoke())


def _noise(rng, a, base):
    return (base + 0.1 * rng.standard_normal(np.shape(a))).astype(np.float32)


def _perturb_mamba(p: dict, rng) -> None:
    """Seeded noise on the leaves JAX initialises to constants."""
    p["conv_b"] = _noise(rng, p["conv_b"], 0.0)
    p["dt_bias"] = _noise(rng, p["dt_bias"], 0.0)
    p["D"] = _noise(rng, p["D"], 1.0)
    p["A_log"] = _noise(rng, p["A_log"], 0.0) + p["A_log"]
    p["norm_scale"] = _noise(rng, p["norm_scale"], 1.0)


def _mixer_params(jcfg, seed=0):
    p = jax.tree.map(np.asarray, jmb.init_mamba(jax.random.PRNGKey(seed), jcfg,
                                                jnp.float32))
    _perturb_mamba(p, np.random.default_rng(seed))
    return p, {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


def _random_state(cfg, batch, seed, length):
    rng = np.random.default_rng(seed)
    conv = rng.standard_normal((batch, cfg.ssm_conv - 1,
                                mb.conv_channels(cfg))).astype(np.float32)
    ssm = (0.5 * rng.standard_normal((batch, cfg.ssm_heads, cfg.ssm_head_dim,
                                      cfg.ssm_state))).astype(np.float32)
    return (mb.MambaState(torch.from_numpy(conv), torch.from_numpy(ssm),
                          length),
            jmb.MambaState(jnp.asarray(conv), jnp.asarray(ssm),
                           jnp.asarray(length, jnp.int32)))


def _assert_state(st, jst, length):
    np.testing.assert_allclose(_np(st.conv), _np(jst.conv), **TOL)
    np.testing.assert_allclose(_np(st.ssm), _np(jst.ssm), **TOL)
    assert st.ssm.dtype == torch.float32
    assert st.length == int(jst.length) == length


class TestMixer:
    @pytest.mark.parametrize("with_state", [False, True])
    @pytest.mark.parametrize("S", [40, 64])
    def test_forward_matches_jax(self, S, with_state):
        jcfg, cfg = _mamba_configs()
        jp, p = _mixer_params(jcfg)
        u = np.random.default_rng(1).standard_normal(
            (2, S, cfg.d_model)).astype(np.float32)
        state, jstate = (_random_state(cfg, 2, 2, 7) if with_state
                         else (None, None))
        out, st = mb.mamba_forward(p, torch.from_numpy(u), cfg, state)
        jout, jst = jmb.mamba_forward(jp, jnp.asarray(u), jcfg, jstate)
        np.testing.assert_allclose(_np(out), _np(jout), **TOL)
        _assert_state(st, jst, S + (7 if with_state else 0))
        assert st.conv.is_contiguous()

    def test_decode_matches_jax(self):
        jcfg, cfg = _mamba_configs()
        jp, p = _mixer_params(jcfg, seed=3)
        state, jstate = _random_state(cfg, 3, 4, 11)
        rng = np.random.default_rng(5)
        for step in range(3):
            u = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
            out, state = mb.mamba_decode(p, torch.from_numpy(u), cfg, state)
            jout, jstate = jmb.mamba_decode(jp, jnp.asarray(u), jcfg, jstate)
            np.testing.assert_allclose(_np(out), _np(jout), **TOL)
            _assert_state(state, jstate, 12 + step)


# ------------------------------------------------------------ whole models

MODELS = {
    "mamba2-370m-smoke": ("mamba2-370m", {}),
    "jamba-no-moe": ("jamba-1.5-large-398b", {"n_experts": 0}),
}
BATCH, STEPS = 2, 4


def _model_configs(name):
    arch, overrides = MODELS[name]
    return (jget_config(arch).smoke(**overrides),
            get_config(arch).smoke(**overrides))


def _perturbed_lm_params(jcfg, seed=0):
    params = jax.tree.map(np.asarray, jtf.init_lm(jax.random.PRNGKey(seed),
                                                  jcfg))
    rng = np.random.default_rng(seed)
    for sp in params["units"].values():
        if "mamba" in sp:
            _perturb_mamba(sp["mamba"], rng)
        for name in ("mixer_norm", "ffn_norm"):
            if name in sp:
                sp[name] = _noise(rng, sp[name], 1.0)
    params["final_norm"] = _noise(rng, params["final_norm"], 1.0)
    return params


def _assert_caches(cache, jcache, length):
    if jcache.ssm is not None:
        for field in ("conv", "ssm"):
            got = np.stack([np.stack([_np(getattr(s, field)) for s in c.ssm])
                            for c in cache])
            want = _np(getattr(jcache.ssm, field))
            np.testing.assert_allclose(got, want, rtol=TOL["rtol"],
                                       atol=STATE_ATOL * np.abs(want).max(),
                                       err_msg=field)
        assert all(s.length == length for c in cache for s in c.ssm)
    else:
        assert all(not c.ssm for c in cache)
    if jcache.kv is not None:
        for field in ("k", "v"):
            got = np.stack([np.stack([_np(getattr(kv, field)) for kv in c.kv])
                            for c in cache])
            np.testing.assert_allclose(got, _np(getattr(jcache.kv, field)),
                                       **TOL, err_msg=field)
        assert all(kv.length == length for c in cache for kv in c.kv)
    else:
        assert all(not c.kv for c in cache)


@pytest.mark.parametrize("prompt", [40, 64])
@pytest.mark.parametrize("name", list(MODELS))
def test_prefill_and_decode_match_jax(name, prompt):
    jcfg, cfg = _model_configs(name)
    assert cfg.dtype == "float32" and not cfg.is_moe
    np_params = _perturbed_lm_params(jcfg)
    jparams = jax.tree.map(jnp.asarray, np_params)
    params = from_jax_params(np_params, cfg, device="cpu")
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (BATCH, prompt)).astype(np.int32)
    max_seq = prompt + STEPS + 1

    jlogits, jcache = jax.jit(lambda p, t: jtf.prefill(p, t, jcfg, max_seq))(
        jparams, jnp.asarray(tokens))
    logits, cache = ttf.prefill(params, torch.from_numpy(tokens).long(), cfg,
                                max_seq)
    np.testing.assert_allclose(_np(logits), _np(jlogits), **TOL)
    _assert_caches(cache, jcache, prompt)

    jdecode = jax.jit(lambda p, t, c: jtf.decode_step(p, t, c, jcfg))
    for _ in range(STEPS):
        jtoken = jnp.argmax(jlogits, -1)[:, None].astype(jnp.int32)
        token = logits.argmax(-1, keepdim=True)
        np.testing.assert_array_equal(token.numpy(), np.asarray(jtoken))
        jlogits, jcache = jdecode(jparams, jtoken, jcache)
        logits, cache = ttf.decode_step(params, token, cache, cfg)
        np.testing.assert_allclose(_np(logits), _np(jlogits), **TOL)
    _assert_caches(cache, jcache, prompt + STEPS)


@pytest.mark.parametrize("name", list(MODELS))
def test_init_cache_matches_jax_layout(name):
    jcfg, cfg = _model_configs(name)
    jcache = jtf.init_decode_cache(jcfg, 3, 50)
    cache = get_model(cfg, device="cpu").init_cache(3, 50)
    assert len(cache) == ttf.n_units(cfg)
    if jcache.ssm is not None:
        assert np.shape(jcache.ssm.conv)[2:] == tuple(cache[0].ssm[0].conv.shape)
        assert np.shape(jcache.ssm.ssm)[2:] == tuple(cache[0].ssm[0].ssm.shape)
        assert len(cache[0].ssm) == np.shape(jcache.ssm.ssm)[1]
        assert cache[0].ssm[0].ssm.dtype == torch.float32
    if jcache.kv is not None:
        assert len(cache[0].kv) == np.shape(jcache.kv.k)[1]


def _dtype_name(t) -> str:
    return str(t.dtype).removeprefix("torch.")


def _tree_dtypes(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _tree_dtypes(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("name", list(MODELS))
def test_from_jax_params_keeps_the_jax_dtypes(name):
    """A bf16 tree: A_log, D and dt_bias stay float32, as the JAX init keeps
    them; every other leaf is bf16.  The port's own init agrees."""
    arch, overrides = MODELS[name]
    jcfg = jget_config(arch).smoke(dtype="bfloat16", **overrides)
    cfg = get_config(arch).smoke(dtype="bfloat16", **overrides)
    tree = jax.tree.map(np.asarray, jtf.init_lm(jax.random.PRNGKey(0), jcfg))
    params = from_jax_params(tree, cfg, device="cpu")
    own = get_model(cfg, device="cpu").init(0)
    n_fp32 = 0
    for path, leaf in _tree_dtypes({k: v for k, v in tree.items()
                                    if k != "units"}):
        assert _dtype_name(params[path[0]]) == leaf.dtype.name == "bfloat16"
    for u in range(ttf.n_units(cfg)):
        for path, leaf in _tree_dtypes(tree["units"]):
            got, mine = params["units"][u], own["units"][u]
            for k in path:
                got, mine = got[k], mine[k]
            assert _dtype_name(got) == _dtype_name(mine) == leaf.dtype.name, path
            if leaf.dtype.name == "float32":
                assert path[-2] == "mamba" and path[-1] in mb.FP32_PARAMS
                np.testing.assert_array_equal(got.numpy(), leaf[u])
                n_fp32 += 1
    n_mamba = sum(1 for s in ttf.unit_layout(cfg) if s["mixer"] == "mamba")
    assert n_fp32 == 3 * n_mamba * ttf.n_units(cfg)
