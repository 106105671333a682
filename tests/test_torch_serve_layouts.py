"""Serving under the layouts on four gloo ranks against one process and JAX.

One start of four ranks (``torch.multiprocessing``, a ``file://``
rendezvous in a temporary directory, a time limit of its own) builds two
("data", "model") meshes over the same ranks, (2, 2) and (1, 4), and on
each serves every family's float32 smoke model (qwen2, mixtral, mamba2,
jamba with experts, whisper, llava) from parameters drawn a part at a
time from the seed and laid out by ``param_specs`` (``init_params``):
prefill of a batch of 4 and four greedy decode steps, the logits made
whole before each argmax.  Rank 0 saves what it gathered; the checks run
here against the same model, parameters and prompt in one process:

  * the last logits within 1e-5 of the largest |logit| (sums over heads,
    rows and hidden dimensions split across ranks, and the split softmax,
    add in another order in float32), the greedy tokens equal;
  * the caches after prefill and after every decode step in
    ``cache_specs``' placements (checked as ``serve.generate`` runs);
  * context-parallel decode at batch 1 on (2, 2) (mixtral, whose 43-token
    prompt wraps its 32-row sliding-window ring, and jamba): the same
    limits, and the one process's output within 1e-4 (``test_torch_serve``'s
    limit) of the reference's ``decode_step(context_parallel=True)``;
  * qwen2's tokens and logits on both meshes within 1e-4 of the JAX
    model's own on the same parameters;
  * the new token's K/V written across every shard boundary of the
    cache's sequence (slot ``pos % C`` at ``offset - 1``, ``offset`` and
    ``offset + C/n - 1``), linear and wrapped ring, and a cache length
    that the axes do not divide (``sanitize`` replicates it): the attention
    output within 1e-5, and the caches equal to one process's but for the
    new token's row, which is within 1e-5.

The prompt lengths make the cache length (context + generated tokens) 48
or 56 rows, which both meshes divide, so the sequence-split path runs; the
one that does not divide is 47.
"""

import dataclasses
import functools
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro.configs import get_config as jget_config
from repro.models import transformer as jtf
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import attention as attn
from repro_torch.models import get_model
from repro_torch.models.transformer import STACKED
from repro_torch.tree import leaves, leaves_with_path

WORLD = 4
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
SPAWN_TIMEOUT_S = 300
BATCH, PROMPT, GEN = 4, 43, 5            # four decode steps
FRAMES = 24                             # whisper's encoder frames
TOL_OF_MAX = 1e-5
JAX_TOL = dict(rtol=1e-4, atol=1e-4)     # tests/test_torch_serve.py's
FAMILIES = {
    "qwen2": "qwen2-7b-smoke",
    "mixtral": "mixtral-8x22b-smoke",
    "mamba2": "mamba2-370m-smoke",
    "jamba": "jamba-1.5-large-398b-smoke",
    "whisper": "whisper-base-smoke",
    "llava": "llava-next-34b-smoke",
}
CP_CASES = ("mixtral", "jamba")
UNEVEN_PROMPT = 42                       # cache of 47 rows
SLOT_C = 16                              # the boundary cases' cache length
SLOT_CASES = [(mesh, cp, ring, which)
              for mesh, cp in (("2x2", False), ("2x2", True), ("1x4", False))
              for ring in (False, True)
              for which in ("offset-1", "offset", "offset+n-1")]


def _prompt(arch: str, batch: int, prompt: int) -> dict:
    cfg = get_config(arch)
    return serve.prompt_batch(cfg, batch, prompt, 0, "cpu", frames=FRAMES)


def _serve(arch: str, mesh=None, batch: int = BATCH, prompt: int = PROMPT,
           cp: bool = False) -> dict:
    """``serve.generate`` from the seed's parameters, laid out on ``mesh``
    (``init_params``) or in one process.  On a mesh, ``placements`` lists
    each cache leaf whose placements differ from ``cache_specs``', after
    prefill and after every decode step: (when, path, got, want)."""
    from repro_torch.parallel.sharding import init_params

    cfg = get_config(arch)
    model = get_model(cfg, device="cpu", context_parallel=cp)
    bad = []
    if mesh is None:
        params = model.init(0)
    else:
        model = _checking_placements(model, mesh, cp, bad)
        params = init_params(model, 0, mesh)
    r = serve.generate(model, params, _prompt(arch, batch, prompt), GEN)
    return {"tokens": r["tokens"], "logits": r["logits"], "placements": bad}


def _checking_placements(model, mesh, cp: bool, bad: list):
    """``model`` whose prefill and decode append to ``bad`` each leaf of
    the cache they return that is not laid out as ``cache_specs`` says."""
    from repro_torch.launch.mesh import mesh_shape
    from repro_torch.parallel import axes as ax
    from repro_torch.parallel.sharding import cache_specs

    def checked(when: str, step):
        def run(*args):
            logits, cache = step(*args)
            specs = cache_specs(cache, mesh_shape(mesh), cp)
            for (path, x), spec in zip(leaves_with_path(cache),
                                       leaves(specs)):
                if isinstance(x, torch.Tensor):
                    want = ax.placements(spec, mesh)
                    if tuple(x.placements) != want:
                        bad.append((when, path, str(x.placements),
                                    str(want)))
            return logits, cache
        return run

    return dataclasses.replace(model,
                               prefill=checked("prefill", model.prefill),
                               decode=checked("decode", model.decode))


def _slot_inputs(cfg, ring: bool, cp: bool, n: int, which: str):
    """Seeded attention weights, x [B, 1, D] and a cache of SLOT_C rows
    whose new token goes to the slot named by ``which`` of the second
    shard of ``n`` rows (wrapped once for a ring)."""
    rng = np.random.default_rng(7)
    B = 1 if cp else 2
    slot = {"offset-1": n - 1, "offset": n, "offset+n-1": 2 * n - 1}[which]
    pos = slot + (SLOT_C if ring else 0)
    g = torch.Generator().manual_seed(3)
    p = attn.init_attn(g, cfg, torch.float32, "cpu")
    x = torch.from_numpy(rng.standard_normal((B, 1, cfg.d_model))
                         .astype(np.float32))
    shape = (B, SLOT_C, cfg.n_kv_heads, cfg.hd)
    k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            for _ in range(2))
    return p, x, attn.KVCache(k=k, v=v, length=pos)


def _slot_cfg(ring: bool):
    return get_config("qwen2-7b").smoke(sliding_window=SLOT_C if ring else 0)


def _slot_case(mesh, cp: bool, ring: bool, which: str) -> dict:
    from repro_torch.parallel import axes as ax
    from repro_torch.parallel.sharding import (distribute_batch,
                                               distribute_cache,
                                               distribute_params,
                                               sharding_rules)

    cfg = _slot_cfg(ring)
    split = (mesh.size() if cp else mesh.size(1))
    p, x, cache = _slot_inputs(cfg, ring, cp, SLOT_C // split, which)
    with sharding_rules(mesh):
        y, new = attn.attend_decode(
            ax.fsdp_gather(distribute_params({"attn": p}, mesh)["attn"]),
            distribute_batch({"x": x}, mesh)["x"],
            distribute_cache(cache, mesh, context_parallel=cp), cfg,
            context_parallel=cp)
        return {"y": ax.full(y), "k": new.k.full_tensor(),
                "v": new.v.full_tensor(), "length": new.length,
                "split": any(pl.is_shard(1) for pl in new.k.placements)}


def _rank(rank: int, tmp: str) -> None:
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous",
                            world_size=WORLD, rank=rank)
    try:
        got = {}
        for name, dims in MESHES.items():
            mesh = init_device_mesh("cpu", dims,
                                    mesh_dim_names=("data", "model"))
            for fam, arch in FAMILIES.items():
                got[name, fam] = _serve(arch, mesh)
            got[name, "uneven"] = _serve("qwen2-7b-smoke", mesh,
                                         prompt=UNEVEN_PROMPT)
            for case in SLOT_CASES:
                if case[0] == name:
                    got[case] = _slot_case(mesh, *case[1:])
            if name == "2x2":
                for fam in CP_CASES:
                    got[name, fam, "cp"] = _serve(FAMILIES[fam], mesh,
                                                  batch=1, cp=True)
        if rank == 0:
            torch.save(got, f"{tmp}/got.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def sharded() -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(_rank, args=(tmp,), nprocs=WORLD,
                                 join=False, start_method="spawn")
        deadline = time.monotonic() + SPAWN_TIMEOUT_S
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                pytest.fail(f"ranks still running after {SPAWN_TIMEOUT_S} s")
        return torch.load(f"{tmp}/got.pt")


@pytest.fixture(scope="module")
def single() -> dict:
    out = {fam: _serve(arch) for fam, arch in FAMILIES.items()}
    out["uneven"] = _serve("qwen2-7b-smoke", prompt=UNEVEN_PROMPT)
    for fam in CP_CASES:
        out[fam, "cp"] = _serve(FAMILIES[fam], batch=1, cp=True)
    return out


def _assert_matches(got: dict, want: dict) -> None:
    assert torch.equal(got["tokens"], want["tokens"])
    err = float((got["logits"] - want["logits"]).abs().max())
    assert err <= TOL_OF_MAX * float(want["logits"].abs().max()), err


@pytest.mark.parametrize("fam", list(FAMILIES))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_serving_on_a_mesh_matches_one_process(sharded, single, mesh, fam):
    _assert_matches(sharded[mesh, fam], single[fam])


@pytest.mark.parametrize("fam", list(FAMILIES))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_caches_come_out_in_cache_specs_placements(sharded, mesh, fam):
    assert sharded[mesh, fam]["placements"] == []


@pytest.mark.parametrize("fam", CP_CASES)
def test_context_parallel_decode_matches_one_process(sharded, single, fam):
    _assert_matches(sharded["2x2", fam, "cp"], single[fam, "cp"])
    assert sharded["2x2", fam, "cp"]["placements"] == []


@pytest.mark.parametrize("mesh", list(MESHES))
def test_cache_length_the_axes_do_not_divide(sharded, single, mesh):
    _assert_matches(sharded[mesh, "uneven"], single["uneven"])
    assert sharded[mesh, "uneven"]["placements"] == []


@pytest.mark.parametrize("case", SLOT_CASES, ids=lambda c: "-".join(
    (c[0], "cp" if c[1] else "tp", "ring" if c[2] else "linear", c[3])))
def test_slot_write_across_shard_boundaries(sharded, case):
    _, cp, ring, which = case
    got = sharded[case]
    assert got["split"]
    cfg = _slot_cfg(ring)
    mesh_split = 4 if cp or case[0] == "1x4" else 2
    p, x, cache = _slot_inputs(cfg, ring, cp, SLOT_C // mesh_split, which)
    slot = cache.length % SLOT_C
    y, new = attn.attend_decode(p, x, cache, cfg)
    assert got["length"] == new.length
    for name in ("k", "v"):
        g, w = got[name], getattr(new, name)
        # Every row but the new token's is the cache given; that row holds
        # the new K/V, projected on split weights (sums in another order).
        differ = (g != w).flatten(2).any(-1).any(0).nonzero().flatten()
        assert differ.tolist() in ([], [slot]), (name, differ)
        assert float((g - w).abs().max()) <= TOL_OF_MAX * float(
            w.abs().max())
    err = float((got["y"] - y).abs().max())
    assert err <= TOL_OF_MAX * float(y.abs().max()), err


# ------------------------------------------------------------ against JAX

def _stacked_for_jax(params: dict) -> dict:
    """The port's per-unit lists stacked over units, as the JAX tree."""
    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return jnp.asarray(np.stack([t.numpy() for t in trees]))

    return {k: stack(v) if k in STACKED else jnp.asarray(v.numpy())
            for k, v in params.items()}


@functools.lru_cache(maxsize=None)
def _jax_generate(arch: str, batch: int, cp: bool) -> dict:
    """The JAX model's greedy decode on the port's seed-0 parameters and
    the same prompt, ``decode_step(context_parallel=cp)``."""
    cfg = get_config(arch)
    jcfg = jget_config(arch.removesuffix("-smoke")).smoke()
    params = _stacked_for_jax(get_model(cfg, device="cpu").init(0))
    tokens = jnp.asarray(_prompt(arch, batch, PROMPT)["tokens"].numpy(),
                         jnp.int32)
    max_seq = PROMPT + GEN
    with jax.enable_x64(False):
        logits, cache = jax.jit(lambda p, t: jtf.prefill(
            p, t, jcfg, max_seq))(params, tokens)
        decode = jax.jit(lambda p, t, c: jtf.decode_step(
            p, t, c, jcfg, context_parallel=cp))
        out = [jnp.argmax(logits, -1)[:, None].astype(jnp.int32)]
        for _ in range(GEN - 1):
            logits, cache = decode(params, out[-1], cache)
            out.append(jnp.argmax(logits, -1)[:, None].astype(jnp.int32))
        return {"tokens": np.concatenate([np.asarray(t) for t in out], 1),
                "logits": np.asarray(logits)}


@pytest.mark.parametrize("mesh", list(MESHES))
def test_qwen2_on_a_mesh_is_the_jax_models(sharded, mesh):
    want = _jax_generate(FAMILIES["qwen2"], BATCH, cp=False)
    got = sharded[mesh, "qwen2"]
    np.testing.assert_array_equal(got["tokens"].numpy(), want["tokens"])
    np.testing.assert_allclose(got["logits"].numpy(), want["logits"],
                               **JAX_TOL)


@pytest.mark.parametrize("fam", CP_CASES)
def test_context_parallel_one_process_is_the_references(single, fam):
    want = _jax_generate(FAMILIES[fam], 1, cp=True)
    got = single[fam, "cp"]
    np.testing.assert_array_equal(got["tokens"].numpy(), want["tokens"])
    np.testing.assert_allclose(got["logits"].numpy(), want["logits"],
                               **JAX_TOL)


def test_serve_cli_on_a_mesh():
    """``launch.serve --mesh 2x2`` (four gloo ranks) prints the mesh, the
    prefill and decode lines and the sample tokens from rank 0 alone."""
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve()
                                          .parent.parent / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", "qwen2-7b-smoke", "--mesh", "2x2", "--prompt-len", "11",
         "--gen", "5"],
        env=env, capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout.splitlines()
    assert out[0].startswith("mesh (data=2, model=2) on gloo")
    assert sum(line.startswith("sample token ids:") for line in out) == 1
    assert any(line.startswith("decode: 16 tokens") for line in out)


def test_off_mesh_serving_is_unchanged():
    """Plain tensors take the one-device path: the cache keeps plain
    tensors and ``cache_dims`` names the reference's decode layouts."""
    from repro_torch.parallel import axes as ax

    cfg = get_config("qwen2-7b-smoke")
    model = get_model(cfg, device="cpu")
    logits, cache = model.prefill(model.init(0), _prompt(
        "qwen2-7b-smoke", 2, 9), 12)
    assert not ax.is_dtensor(logits) and not ax.is_dtensor(cache[0].kv[0].k)
    assert attn.cache_dims() == (ax.BATCH, ax.TP, None, None)
    assert attn.cache_dims(True) == (None, ax.CPTP, None, None)
