"""The port's ordered collectives and its data-parallel train step, on two
gloo ranks on the CPU.

Each test starts its ranks with ``torch.multiprocessing`` (they meet
through a file in ``tmp_path``: no TCP port, so tests may run side by
side) under a time limit of its own, and several checks share one start.
The ranks save what they computed; the checks run here.

  * ``ordered_psum`` and ``ordered_psum_scatter`` against numpy sums (and
    their split), exactly (two float32 or bfloat16 addends sum the same in
    any order).  A wrapper around the collective call records the issue
    order: over buckets of 8, 16, 32 and 64 elements in the order
    [2, 0, 3, 1], the calls carry 32, 8, 64 and 16 elements.
  * The tiny preset's DP step (``launch.train_lm.make_dp_step``), msa and
    flat, three steps with the launcher's optimizer on each rank's half of a
    global batch: one all-reduce per bucket in the bucket order; both
    ranks' parameters bit-equal; parameters within 1e-5 (absolute), and
    losses and gradient norms within 1e-5 relative, of the port's
    single-process step on the global batch and of JAX's
    ``make_train_step`` on it (the halves' mean gradient is the global
    batch's, summed in another order).
"""

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs.base import ShapeConfig
from repro_torch.core.comm_schedule import plan_step_comm
from repro_torch.launch import train_lm
from repro_torch.models import get_model
from repro_torch.optim.adamw import AdamW
from repro_torch.train.state import TrainState
from repro_torch.train.step import make_train_step
from repro_torch.tree import leaves, leaves_with_path

REPO = Path(__file__).resolve().parent.parent
WORLD = 2
SPAWN_TIMEOUT_S = 120
SIZES = (8, 16, 32, 64)
ORDER = [2, 0, 3, 1]
DP_STEPS = 3
# The launcher's optimizer over the tiny preset's 60 steps: each of the three
# steps' learning rates (1.5e-5, 3e-5, 4.5e-5) bounds what Adam's
# normalization can make of float-order noise in a near-zero gradient entry.
OPT = dict(peak_lr=3e-4, warmup_steps=20,
           total_steps=train_lm.PRESETS["tiny"]["steps"])
PARAM_ATOL = 1e-5
LOSS_RTOL = 1e-5


def _spawn(fn, *args) -> None:
    """Run ``fn(rank, *args)`` on WORLD processes; fail the test on a rank's
    error or after SPAWN_TIMEOUT_S."""
    ctx = mp.start_processes(fn, args=args, nprocs=WORLD, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"ranks still running after {SPAWN_TIMEOUT_S} s")


def _init(rank: int, tmp: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous",
                            world_size=WORLD, rank=rank)


def _inputs(rank: int) -> dict:
    """Rank ``rank``'s buckets: float32 leaves of SIZES elements; a mixed
    bucket (two float32 leaves around a bfloat16 one); leaves to scatter."""
    rng = np.random.default_rng(rank)

    def f32(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    return {
        "flat": [f32(n) for n in SIZES],
        "mixed": [{"a": f32(5), "b": f32(3, 2).to(torch.bfloat16),
                   "c": f32(2, 2)}],
        "scatter": [{"w": f32(n // 4, 4)} for n in SIZES],
        "untiled": [{"w": f32(WORLD, 3), "v": f32(WORLD)}],
    }


def _collectives_rank(rank: int, tmp: str) -> None:
    from repro_torch.parallel import collectives as col

    _init(rank, tmp)
    calls = []
    all_reduce, reduce_scatter = dist.all_reduce, col._reduce_scatter

    def recording_all_reduce(t, *args, **kw):
        calls.append(("all_reduce", t.numel(), str(t.dtype)))
        return all_reduce(t, *args, **kw)

    def recording_reduce_scatter(out, inp, group):
        calls.append(("reduce_scatter", inp.numel(), str(inp.dtype)))
        return reduce_scatter(out, inp, group)

    dist.all_reduce = recording_all_reduce
    col._reduce_scatter = recording_reduce_scatter
    try:
        x = _inputs(rank)
        out = {"psum": col.ordered_psum(x["flat"], ORDER)}
        out["psum_calls"], calls[:] = list(calls), []
        out["mixed"] = col.ordered_psum(x["mixed"], [0])
        out["mixed_calls"], calls[:] = list(calls), []
        out["scatter"] = col.ordered_psum_scatter(x["scatter"], ORDER)
        out["scatter_calls"], calls[:] = list(calls), []
        out["untiled"] = col.ordered_psum_scatter(x["untiled"], [0],
                                                  tiled=False)
        out["untiled_calls"], calls[:] = list(calls), []
        errors = []
        for bad in ([0, 1, 2], [0, 0, 1, 2], [0, 1, 2, 4]):
            try:
                col.ordered_psum(x["flat"], bad)
            except ValueError as e:
                errors.append(str(e))
        out["errors"], out["bad_calls"] = errors, list(calls)
        torch.save(out, f"{tmp}/rank{rank}.pt")
    finally:
        dist.all_reduce = all_reduce
        dist.destroy_process_group()


def test_ordered_collectives_two_ranks(tmp_path):
    _spawn(_collectives_rank, str(tmp_path))
    outs = [torch.load(tmp_path / f"rank{r}.pt") for r in range(WORLD)]
    ins = [_inputs(r) for r in range(WORLD)]

    def total(get):
        return sum(get(x).double() for x in ins).float()

    for r, out in enumerate(outs):
        assert [c[1] for c in out["psum_calls"]] == [SIZES[i] for i in ORDER]
        for i in range(len(SIZES)):
            assert torch.equal(out["psum"][i], total(lambda x: x["flat"][i]))
        # one collective per dtype, float32 leaves first (leaf order a, b, c)
        assert out["mixed_calls"] == [("all_reduce", 9, "torch.float32"),
                                      ("all_reduce", 6, "torch.bfloat16")]
        for k in ("a", "b", "c"):
            got, want = out["mixed"][0][k], total(lambda x: x["mixed"][0][k])
            assert got.dtype == ins[r]["mixed"][0][k].dtype
            assert torch.equal(got, want.to(got.dtype)), k
        assert [c[:2] for c in out["scatter_calls"]] == [
            ("reduce_scatter", SIZES[i]) for i in ORDER]
        for i, n in enumerate(SIZES):
            want = total(lambda x: x["scatter"][i]["w"])
            rows = n // 4 // WORLD
            assert torch.equal(out["scatter"][i]["w"],
                               want[r * rows:(r + 1) * rows])
        assert [c[:2] for c in out["untiled_calls"]] == [
            ("reduce_scatter", 3 * WORLD + WORLD)]
        for k in ("w", "v"):
            assert torch.equal(out["untiled"][0][k],
                               total(lambda x: x["untiled"][0][k])[r])
        assert len(out["errors"]) == 3 and out["bad_calls"] == []
        assert all("not a permutation" in e for e in out["errors"])


# ------------------------------------------------------------ the DP step

def _batches(cfg) -> list[dict]:
    from repro_torch.data.pipeline import SyntheticTokens

    p = train_lm.PRESETS["tiny"]
    pipe = SyntheticTokens(cfg, batch=p["batch"] * WORLD, seq=p["seq"])
    return [pipe.batch_at(i) for i in range(DP_STEPS)]


def _dp_rank(rank: int, tmp: str) -> None:
    _init(rank, tmp)
    calls = []
    all_reduce = dist.all_reduce

    def recording_all_reduce(t, *args, **kw):
        calls.append(t.numel())
        return all_reduce(t, *args, **kw)

    dist.all_reduce = recording_all_reduce
    try:
        cfg = train_lm.preset_config("tiny")
        p = train_lm.PRESETS["tiny"]
        shape = ShapeConfig("example", seq_len=p["seq"],
                            global_batch=p["batch"] * WORLD, kind="train")
        model = get_model(cfg, device="cpu")
        batches = _batches(cfg)
        out = {}
        for sync in ("msa", "flat"):
            order, _ = train_lm.sync_order(cfg, shape, WORLD, sync)
            opt = train_lm.make_optimizer(OPT["total_steps"])
            params = torch.load(f"{tmp}/params.pt")
            state = TrainState(step=0, params=params, opt=opt.init(params),
                               rng=1)
            step = train_lm.make_dp_step(model, opt, order)
            losses, norms = [], []
            calls[:] = []
            for b in batches:
                state, m = step(state, train_lm.rank_rows(b, rank, WORLD))
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
            out[sync] = {"order": order, "losses": losses,
                         "grad_norms": norms, "calls": list(calls),
                         "params": [x.detach() for x in leaves(state.params)]}
        torch.save(out, f"{tmp}/rank{rank}.pt")
    finally:
        dist.all_reduce = all_reduce
        dist.destroy_process_group()


def _bucket_sizes(params) -> list[int]:
    from repro_torch.parallel.collectives import unit_grad_buckets

    return [sum(x.numel() for x in leaves(b))
            for b in unit_grad_buckets(params)]


def test_dp_step_two_ranks_matches_single_process_and_jax(tmp_path):
    import jax
    import jax.numpy as jnp

    from repro.configs.base import ModelConfig as JModelConfig
    from repro.models import registry as jregistry
    from repro.models import transformer as jtf
    from repro.optim import adamw as jadamw
    from repro.train import state as jstate
    from repro.train import step as jstep
    from repro_torch.models.convert import from_jax_params

    cfg = train_lm.preset_config("tiny")
    jcfg = JModelConfig(**{f: getattr(cfg, f)
                           for f in ("name", "family", "n_layers", "d_model",
                                     "n_heads", "n_kv_heads", "head_dim",
                                     "d_ff", "vocab_size", "dtype")})
    with jax.enable_x64(False):
        np_params = jax.tree.map(np.asarray,
                                 jtf.init_lm(jax.random.PRNGKey(0), jcfg))
        torch.save(from_jax_params(np_params, cfg, "cpu"),
                   tmp_path / "params.pt")
        _spawn(_dp_rank, str(tmp_path))

        batches = _batches(cfg)
        jopt = jadamw.AdamW(**OPT)
        jp = jax.tree.map(jnp.asarray, np_params)
        jst = jstate.TrainState(step=jnp.zeros((), jnp.int32), params=jp,
                                opt=jopt.init(jp), rng=jax.random.PRNGKey(0))
        jfn = jax.jit(jstep.make_train_step(jregistry.get_model(jcfg), jopt))
        jlosses, jnorms = [], []
        for b in batches:
            jst, jm = jfn(jst, {k: jnp.asarray(v) for k, v in b.items()})
            jlosses.append(float(jm["loss"]))
            jnorms.append(float(jm["grad_norm"]))
        jparams = from_jax_params(jax.tree.map(np.asarray, jst.params), cfg,
                                  "cpu")

    model = get_model(cfg, device="cpu")
    opt = AdamW(**OPT)
    assert opt == train_lm.make_optimizer(OPT["total_steps"])
    params = torch.load(tmp_path / "params.pt")
    state = TrainState(step=0, params=params, opt=opt.init(params), rng=1)
    step = make_train_step(model, opt)
    losses, norms = [], []
    for b in batches:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))

    outs = [torch.load(tmp_path / f"rank{r}.pt") for r in range(WORLD)]
    sizes = _bucket_sizes(params)
    U = len(sizes) - 1
    p = train_lm.PRESETS["tiny"]
    plan = plan_step_comm(cfg, ShapeConfig("example", seq_len=p["seq"],
                                           global_batch=p["batch"] * WORLD,
                                           kind="train"), chips=WORLD)
    for sync, order in (("msa", plan.order + [U]),
                        ("flat", list(range(U + 1)))):
        for out in outs:
            got = out[sync]
            assert got["order"] == order
            # one all-reduce per bucket in ``order``, then the loss's
            assert got["calls"] == DP_STEPS * ([sizes[i] for i in order]
                                               + [1])
            # the synced gradient's norm: the sum over ranks divided by
            # their number is the global batch's mean gradient
            for key, want, jwant in (("losses", losses, jlosses),
                                     ("grad_norms", norms, jnorms)):
                np.testing.assert_allclose(got[key], want, rtol=LOSS_RTOL)
                np.testing.assert_allclose(got[key], jwant, rtol=LOSS_RTOL)
        for a, b in zip(outs[0][sync]["params"], outs[1][sync]["params"]):
            assert torch.equal(a, b)
        for (path, want), got, jwant in zip(
                leaves_with_path(state.params), outs[0][sync]["params"],
                leaves(jparams)):
            np.testing.assert_allclose(got.numpy(), want.detach().numpy(),
                                       rtol=0, atol=PARAM_ATOL,
                                       err_msg=f"{sync} {path}")
            np.testing.assert_allclose(got.numpy(), jwant.numpy(), rtol=0,
                                       atol=PARAM_ATOL,
                                       err_msg=f"{sync} {path} (JAX)")


# ----------------------------------------------------------------- the CLI

def test_train_lm_cli_two_ranks(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="2")

    def launch(steps):
        return subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train_lm",
             "--preset", "tiny", "--dp", str(WORLD), "--device", "cpu",
             "--steps", str(steps), "--ckpt-dir", str(tmp_path / "ckpt")],
            capture_output=True, text=True, timeout=SPAWN_TIMEOUT_S,
            cwd=tmp_path, env=env)

    r = launch(8)
    assert r.returncode == 0, r.stderr
    assert "grad-sync=msa  bucket order: [3, 2, 1, 0, 4]" in r.stdout
    assert "simulated step: msa=" in r.stdout and " flat=" in r.stdout
    assert "resumed_from=None steps_run=8" in r.stdout
    assert "TRAINING OK" in r.stdout
    r = launch(10)   # every rank resumes from rank 0's checkpoint at step 8
    assert "resumed_from=8 steps_run=2" in r.stdout, r.stderr
