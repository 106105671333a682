"""The FSDP x TP layouts on four gloo ranks against the single-process port.

One start of four ranks (``torch.multiprocessing``, a ``file://``
rendezvous in ``tmp_path``, a time limit of its own) on a
``("data", "model") = (2, 2)`` mesh runs each family's float32 smoke model
under ``parallel.sharding``'s layout: qwen2 (dense), mixtral with TP within
each expert and with the expert-parallel rules (``moe_ep``), mamba2, the
jamba hybrid, whisper (encoder-decoder) and llava (VLM).  Each rank builds
the state from the seed as DTensors (``distribute_state``), takes its rows
of the global batch (``batch_specs``), and computes the loss and every
gradient through the model's DTensor path (the kernels' plain versions on
local shards), then one step of ``launch.train.make_sharded_step``.  Rank 0
saves what it gathered (``full_tensor``); the checks run here against the
same model, state and batch in one process:

  * the sharded init equals the one-process init bit for bit;
  * the loss within 1e-5 relative; every gradient leaf within 1e-5
    (absolute) and within 1e-4 of its largest entry; the parameters after
    one AdamW step within 1e-5.  Sums over a sharded batch, heads or hidden
    dimension run in another order: the Mamba mixers' A_log and dt_bias,
    sums over every row and head dimension that cancel to ~1e-3 of their
    terms, move by up to ~6e-5 of their largest entry (~8e-7 absolute);
    every other leaf by under 1e-5 of its largest;
  * qwen2's loss within 1e-5 relative of the JAX package's on the same
    parameters and batch.
"""

import dataclasses
import time

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
from repro_torch.launch import train
from repro_torch.models import get_model
from repro_torch.models.transformer import STACKED
from repro_torch.train.state import init_state
from repro_torch.tree import leaves

WORLD, MESH = 4, (2, 2)
SPAWN_TIMEOUT_S = 240
BATCH, SEQ, STEPS = 4, 32, 60    # STEPS sets the warm-up: lr 2.3e-5 at step 1
TOL = 1e-5
GRAD_TOL_OF_MAX = 1e-4
CASES = {
    "qwen2": ("qwen2-7b-smoke", False),
    "mixtral_tp": ("mixtral-8x22b-smoke", False),
    "mixtral_ep": ("mixtral-8x22b-smoke", True),
    "mamba2": ("mamba2-370m-smoke", False),
    "jamba": ("jamba-1.5-large-398b-smoke", False),
    "whisper": ("whisper-base-smoke", False),
    "llava": ("llava-next-34b-smoke", False),
}


def _config(case: str):
    arch, ep = CASES[case]
    return dataclasses.replace(get_config(arch), moe_ep=ep)


def _trainer(case: str, mesh=None):
    return train.setup(_config(case), steps=STEPS, batch=BATCH, seq=SEQ,
                       seed=0, device="cpu", mesh=mesh)


def _run_case(case: str, mesh) -> dict:
    from repro_torch.parallel import axes as ax
    from repro_torch.parallel.sharding import distribute_batch

    t = _trainer(case, mesh)
    state = t.init()
    batch = t.pipeline.batch_at(0)
    params = state.params
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    with train.sharding_rules(mesh):
        loss, parts = t.model.loss(params, distribute_batch(batch, mesh))
        loss = ax.full(loss)
        grads = torch.autograd.grad(loss, flat)
    out = {"placements": [tuple(map(str, p.placements)) for p in flat],
           "init": [p.detach().full_tensor().clone() for p in flat],
           "loss": loss.detach(), "aux": ax.full(parts["aux"]).detach(),
           "grads": [ax.full(g) for g in grads]}
    for p in flat:
        p.requires_grad_(False)
    state, metrics = t.train_step(state, batch)
    out["step_loss"] = metrics["loss"]
    out["params"] = [p.detach().full_tensor() for p in leaves(state.params)]
    return out


def _refused(mesh) -> str:
    """The error of an RMSNorm on a DTensor placed as a strided shard."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.placement_types import _StridedShard

    from repro_torch.kernels import ops

    x = DTensor.from_local(torch.ones(2, 4, 8), mesh,
                           (_StridedShard(0, split_factor=2), Replicate()),
                           run_check=False)
    scale = DTensor.from_local(torch.ones(8), mesh, (Replicate(),) * 2)
    try:
        ops.rmsnorm(x, scale, 1e-5)
    except ValueError as e:
        return str(e)
    return ""


def _rank(rank: int, tmp: str) -> None:
    from repro_torch.launch.mesh import make_test_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous",
                            world_size=WORLD, rank=rank)
    try:
        mesh = make_test_mesh(*MESH, device_type="cpu")
        got = {case: _run_case(case, mesh) for case in CASES}
        got["refused"] = _refused(mesh)
        if rank == 0:
            torch.save(got, f"{tmp}/got.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def sharded(tmp_path_factory) -> dict:
    tmp = str(tmp_path_factory.mktemp("layouts"))
    ctx = mp.start_processes(_rank, args=(tmp,), nprocs=WORLD, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"ranks still running after {SPAWN_TIMEOUT_S} s")
    return torch.load(f"{tmp}/got.pt")


def _single(case: str) -> dict:
    t = _trainer(case)
    state = t.init()
    batch = t.pipeline.batch_at(0)
    flat = leaves(state.params)
    init = [p.detach().clone() for p in flat]
    for p in flat:
        p.requires_grad_(True)
    loss, parts = t.model.loss(state.params, {
        k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, flat)
    for p in flat:
        p.requires_grad_(False)
    state, metrics = t.train_step(state, batch)
    return {"init": init, "loss": loss.detach(), "aux": parts["aux"].detach(),
            "grads": grads, "step_loss": metrics["loss"],
            "params": [p.detach() for p in leaves(state.params)]}


def _close(got, want, label):
    err = float((got - want).abs().max()) if want.numel() else 0.0
    scale = float(want.abs().max()) if want.numel() else 0.0
    assert err <= TOL, (label, err, scale)
    assert err <= GRAD_TOL_OF_MAX * max(scale, 1e-30), (label, err, scale)


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_step_matches_one_process(sharded, case):
    got, want = sharded[case], _single(case)
    for i, (g, w) in enumerate(zip(got["init"], want["init"])):
        assert g.dtype == w.dtype and torch.equal(g, w), ("init", i)
    assert float(got["loss"]) == pytest.approx(float(want["loss"]), rel=TOL)
    assert float(got["step_loss"]) == pytest.approx(float(want["loss"]),
                                                    rel=TOL)
    assert float(got["aux"]) == pytest.approx(float(want["aux"]), rel=TOL,
                                              abs=1e-7)
    assert len(got["grads"]) == len(want["grads"]) == len(want["init"])
    for i, (g, w) in enumerate(zip(got["grads"], want["grads"])):
        assert g.shape == w.shape, ("grad", i)
        _close(g, w, ("grad", i))
    for i, (g, w) in enumerate(zip(got["params"], want["params"])):
        assert g.dtype == w.dtype, ("param", i)
        assert float((g - w).abs().max()) <= TOL, ("param", i)


class _Mesh:
    axis_names, axis_sizes = ("data", "model"), MESH


@pytest.mark.parametrize("case", list(CASES))
def test_state_laid_out_by_the_rules(sharded, case):
    """Each parameter's placements are its sanitized spec's, under the
    expert-parallel rules where the case takes them."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch.specs import params_struct
    from repro_torch.parallel import axes as ax
    from repro_torch.parallel import sharding
    from repro_torch.tree import leaves_with_path

    cfg = _config(case)
    flat = leaves_with_path(params_struct(cfg))
    with sharding.use_moe_ep(cfg.moe_ep):
        want = [ax.placements(sharding.sanitize(sharding.spec_for(path, x),
                                                x.shape, _Mesh), _Mesh)
                for path, x in flat]
    assert sharded[case]["placements"] == [tuple(map(str, pl))
                                           for pl in want]
    if case.startswith("mixtral"):
        got = dict(zip((path for path, _ in flat),
                       sharded[case]["placements"]))
        w_gate = got[("units", 0, "sub0", "moe", "w_gate")]
        # [E, D, F]: experts over model with EP, F over model without
        assert w_gate == tuple(map(str, (Shard(1), Shard(0)) if cfg.moe_ep
                                   else (Shard(1), Shard(2))))
        assert got[("units", 0, "sub0", "mixer_norm")] == \
            (str(Replicate()),) * 2


def _stacked_for_jax(params: dict) -> dict:
    """The port's per-unit lists stacked over units, as the JAX tree."""
    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return jnp.asarray(np.stack([t.numpy() for t in trees]))

    return {k: stack(v) if k in STACKED else jnp.asarray(v.numpy())
            for k, v in params.items()}


def test_qwen2_sharded_loss_matches_jax(sharded):
    cfg = _config("qwen2")
    model = get_model(cfg, device="cpu")
    t = _trainer("qwen2")
    params = init_state(model, t.optimizer, 0).params
    batch = t.pipeline.batch_at(0)
    with jax.enable_x64(False):
        jloss, _ = jtf.loss_fn(_stacked_for_jax(params),
                               {k: jnp.asarray(v) for k, v in batch.items()},
                               jget_config("qwen2-7b").smoke())
    assert float(sharded["qwen2"]["loss"]) == pytest.approx(float(jloss),
                                                            rel=TOL)


def test_parse_mesh():
    import argparse

    assert train.parse_mesh("2x2") == (2, 2)
    assert train.parse_mesh("4X1") == (4, 1)
    for bad in ("2", "2x", "ax2", "0x2", "2x2x2"):
        with pytest.raises(argparse.ArgumentTypeError):
            train.parse_mesh(bad)


def test_cli_trains_on_a_mesh():
    """``launch.train --mesh 1x2`` (two gloo ranks, --moe-ep on the mixtral
    smoke) prints each step's loss and ``done:``."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve()
                                          .parent.parent / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--arch", "mixtral-8x22b-smoke", "--steps", "2", "--batch", "2",
         "--seq", "16", "--mesh", "1x2", "--moe-ep"],
        env=env, capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout.splitlines()
    assert out[0].startswith("mesh (data=1, model=2) on gloo")
    assert sum(line.startswith("step ") for line in out) == 2
    assert out[-1].startswith("done:")


def test_kernel_boundary_refuses_an_unknown_placement(sharded):
    """A placement the kernels' DTensor boundary does not know (a strided
    shard) raises on the ranks instead of running on a misread shard."""
    assert sharded["refused"].startswith("kernel operand placed as")
