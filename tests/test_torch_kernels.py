"""The port's kernel modules against the JAX package, on the same inputs.

On the CPU the port's ``ops`` run each kernel's plain version; those are
held against the JAX Pallas kernels in interpret mode and against
``repro.kernels.ref``, on the cases of ``tests/test_kernels.py``.  The
CUDA and Triton kernels themselves are held against the plain versions on
the card by ``tests/test_torch_cuda.py``.

Inputs come from numpy with explicit dtypes (another test module may have
switched JAX to 64-bit mode in this process).  Tolerances: float32 2e-5
(the same sums in another order), bfloat16 2e-2 (one bf16 rounding of the
output, and of the attention weights in the plain version), as in
``tests/test_kernels.py``.
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels import flash_attention as jfa
from repro.kernels import ref as jref
from repro.kernels import rmsnorm as jrn
from repro.models import common as jcommon
from repro_torch import configs as tconfigs
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rmsnorm as trn
from repro_torch.models import common

TOLS = {"float32": dict(rtol=2e-5, atol=2e-5),
        "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _normal(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _jax(x: np.ndarray, dtype: str):
    return jnp.asarray(x, jnp.float32).astype(jnp.dtype(dtype))


def _torch(x: np.ndarray, dtype: str, device="cpu"):
    return torch.from_numpy(x).to(device=device, dtype=getattr(torch, dtype))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().cpu().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# Flash-attention cases of tests/test_kernels.py:
# (B, H, KV, Sq, Sk, hd, causal, window)
FLASH_CASES = {
    "mha": (1, 4, 4, 128, 128, 64, True, 0),
    "gqa4": (2, 8, 2, 256, 256, 64, True, 0),
    "mqa": (1, 4, 1, 128, 128, 128, True, 0),
    "window32": (1, 2, 2, 256, 256, 64, True, 32),
    "window128": (1, 2, 2, 256, 256, 64, True, 128),
    "non_causal": (1, 2, 2, 128, 128, 64, False, 0),
    "sq_lt_sk": (1, 2, 2, 64, 256, 64, True, 0),
}
FLASH_PARAMS = [(name, "float32") for name in FLASH_CASES] + [
    (name, "bfloat16") for name in ("mha", "gqa4", "mqa")]


def _flash_inputs(case, seed=0):
    B, H, KV, Sq, Sk, hd, _, _ = case
    return (_normal(seed, (B, H, Sq, hd)), _normal(seed + 1, (B, KV, Sk, hd)),
            _normal(seed + 2, (B, KV, Sk, hd)))


class TestFlashAttention:
    @pytest.mark.parametrize("name,dtype", FLASH_PARAMS)
    def test_plain_matches_pallas_and_jax_ref(self, name, dtype):
        case = FLASH_CASES[name]
        causal, window = case[6], case[7]
        q, k, v = _flash_inputs(case)
        got = ref.flash_attention_ref(_torch(q, dtype), _torch(k, dtype),
                                      _torch(v, dtype), causal=causal,
                                      window=window)
        jq, jk, jv = _jax(q, dtype), _jax(k, dtype), _jax(v, dtype)
        pallas = jfa.flash_attention(jq, jk, jv, causal=causal, window=window,
                                     interpret=True)
        want = jref.flash_attention_ref(jq, jk, jv, causal=causal,
                                        window=window)
        assert got.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(_np(got), _np(pallas), **TOLS[dtype])
        np.testing.assert_allclose(_np(got), _np(want), **TOLS[dtype])

    @pytest.mark.parametrize("name", ["gqa4", "window32", "sq_lt_sk"])
    def test_ops_routes_cpu_tensors_to_plain(self, name):
        """ops takes the model layout [B,S,H,hd] and, for CPU tensors, runs
        the plain version without touching the kernel or its count."""
        case = FLASH_CASES[name]
        q, k, v = (_torch(a, "float32") for a in _flash_inputs(case, seed=5))
        ops.reset_launch_counts()
        got = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), causal=case[6],
                                  window=case[7])
        want = ref.flash_attention_ref(q, k, v, causal=case[6],
                                       window=case[7])
        torch.testing.assert_close(got.transpose(1, 2), want, rtol=0, atol=0)
        assert not any(ops.launch_counts().values())

    def test_kernel_refuses_cpu_tensors(self):
        q = torch.zeros(1, 64, 4, 64)
        k = torch.zeros(1, 64, 2, 64)
        before = tfa.launches
        with pytest.raises(ValueError, match="CUDA tensor"):
            tfa.flash_attention(q, k, k)
        assert tfa.launches == before


class TestRMSNorm:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("shape", [(4, 128), (2, 64, 256), (1, 7, 512)])
    def test_plain_matches_pallas_and_jax_ref(self, shape, dtype):
        x = _normal(0, shape)
        scale = _normal(1, (shape[-1],))
        got = ref.rmsnorm_ref(_torch(x, dtype), _torch(scale, "float32"), 1e-5)
        pallas = jrn.rmsnorm(_jax(x, dtype), _jax(scale, "float32"),
                             interpret=True)
        want = jref.rmsnorm_ref(_jax(x, dtype), _jax(scale, "float32"))
        assert got.dtype == getattr(torch, dtype) and got.shape == shape
        np.testing.assert_allclose(_np(got), _np(pallas), **TOLS[dtype])
        np.testing.assert_allclose(_np(got), _np(want), **TOLS[dtype])

    @pytest.mark.parametrize("eps", [1e-5, 1e-6])
    def test_model_rms_norm_and_ops_match_jax_model(self, eps):
        x = _normal(2, (3, 5, 128))
        scale = _normal(3, (128,))
        want = _np(jcommon.rms_norm(_jax(x, "float32"), _jax(scale, "float32"),
                                    eps))
        ops.reset_launch_counts()
        for got in (common.rms_norm(_torch(x, "float32"),
                                    _torch(scale, "float32"), eps),
                    ops.rmsnorm(_torch(x, "float32"), _torch(scale, "float32"),
                                eps)):
            np.testing.assert_allclose(_np(got), want, rtol=2e-5, atol=2e-5)
        assert ops.launch_counts()["rmsnorm"] == 0

    def test_kernel_refuses_cpu_tensors(self):
        with pytest.raises(ValueError, match="CUDA tensors"):
            trn.rmsnorm(torch.ones(2, 8), torch.ones(8), 1e-5)


class TestModelCommon:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_rotary_matches_jax(self, dtype):
        x = _normal(4, (2, 9, 3, 16))
        pos = np.arange(100, 109, dtype=np.int32)
        jcos, jsin = jcommon.rotary_cos_sin(jnp.asarray(pos), 16, 1e6,
                                            jnp.dtype(dtype))
        want = jcommon.apply_rotary(_jax(x, dtype), jcos, jsin)
        tcos, tsin = common.rotary_cos_sin(torch.from_numpy(pos), 16, 1e6,
                                           getattr(torch, dtype))
        got = common.apply_rotary(_torch(x, dtype), tcos, tsin)
        assert tcos.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(_np(tcos), _np(jcos), **TOLS[dtype])
        np.testing.assert_allclose(_np(got), _np(want), **TOLS[dtype])

    @pytest.mark.parametrize("q_len,kv_len,offset,window",
                             [(8, 8, 0, 3), (4, 12, 8, 5), (5, 5, 2, 1)])
    def test_masks_match_jax(self, q_len, kv_len, offset, window):
        np.testing.assert_array_equal(
            common.causal_mask(q_len, kv_len, offset).numpy(),
            np.asarray(jcommon.causal_mask(q_len, kv_len, offset)))
        np.testing.assert_array_equal(
            common.sliding_mask(q_len, kv_len, offset, window).numpy(),
            np.asarray(jcommon.sliding_mask(q_len, kv_len, offset, window)))

    def test_dense_init_is_truncated_fan_in_normal(self):
        g = torch.Generator().manual_seed(0)
        w = common.dense_init(g, 256, (512,), torch.float32, "cpu")
        e = common.embed_init(g, 300, 64, torch.bfloat16, "cpu")
        assert w.shape == (256, 512) and e.dtype == torch.bfloat16
        for t, std in ((w, 1 / math.sqrt(256)), (e.float(), 1.0)):
            assert t.abs().max() <= 3 * std * (1 + 1e-6)
            # std of a standard normal truncated at +-3 is 0.9866
            assert abs(t.std().item() / std - 0.9866) < 0.02
            assert abs(t.mean().item()) < 0.02 * std


@pytest.mark.parametrize("name", [*jconfigs.ARCH_NAMES, "qwen2-7b-smoke"])
def test_config_registry_matches_jax(name):
    assert (dataclasses.asdict(tconfigs.get_config(name))
            == dataclasses.asdict(jconfigs.get_config(name)))


def test_config_registry_names_and_derived_values():
    assert tconfigs.ARCH_NAMES == jconfigs.ARCH_NAMES
    for name in tconfigs.ARCH_NAMES:
        cfg, jcfg = tconfigs.get_config(name), jconfigs.get_config(name)
        assert tconfigs.param_count(cfg) == jconfigs.param_count(jcfg)
        assert ({k: dataclasses.asdict(v) for k, v in tconfigs.shapes_for(cfg).items()}
                == {k: dataclasses.asdict(v)
                    for k, v in jconfigs.shapes_for(jcfg).items()})
    assert tconfigs.get_config("qwen2-7b").smoke(n_kv_heads=2).n_kv_heads == 2
    with pytest.raises(KeyError):
        tconfigs.get_config("no-such-arch")
