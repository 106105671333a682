"""The port's GPipe pipeline against the sequential application of its
stages (the reference test's check, in JAX).

Four gloo ranks (one start, ``torch.multiprocessing``, a ``file://``
rendezvous in ``tmp_path``, a time limit of its own) on a ``("stage",)``
mesh of 4 run ``make_pipelined_fn`` with stage ``relu(h @ W_s)`` on seeded
numpy weights [S, D, D] and microbatches [M, B, D], M in {4, 6}: with the
weights stacked whole on every rank, as DTensors sharded over the stages,
and each rank holding only its own stage's weights.  Every rank's result is
held within 1e-5 to ``jax.nn.relu`` applied stage after stage in JAX to
the same numpy arrays.  One stage (S = 1, no process group) is the
sequential application itself.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.parallel.pipeline import pipeline_apply

S, B, D = 4, 2, 8
MS = (4, 6)
TOL = 1e-5
SPAWN_TIMEOUT_S = 120
FORMS = ("stacked", "dtensor", "own")


def _inputs(M: int, stages: int = S):
    rng = np.random.default_rng(M)
    ws = (rng.standard_normal((stages, D, D)) / np.sqrt(D)).astype(np.float32)
    x = rng.standard_normal((M, B, D)).astype(np.float32)
    return ws, x


def _stage(w: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    return torch.relu(h @ w)


def _jax_sequential(ws: np.ndarray, x: np.ndarray) -> np.ndarray:
    want = jnp.asarray(x)
    for s in range(ws.shape[0]):
        want = jax.nn.relu(want @ jnp.asarray(ws[s]))
    return np.asarray(want)


def _rank(rank: int, tmp: str) -> None:
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard, distribute_tensor

    from repro_torch.parallel.pipeline import make_pipelined_fn

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous",
                            world_size=S, rank=rank)
    try:
        mesh = init_device_mesh("cpu", (S,), mesh_dim_names=("stage",))
        got = {}
        for M in MS:
            ws, x = _inputs(M)
            w, xt = torch.from_numpy(ws), torch.from_numpy(x)
            got[(M, "stacked")] = make_pipelined_fn(_stage, mesh)(w, xt)
            got[(M, "dtensor")] = make_pipelined_fn(_stage, mesh)(
                distribute_tensor(w, mesh, [Shard(0)]), xt)
            got[(M, "own")] = make_pipelined_fn(_stage, mesh, stacked=False)(
                w[rank], xt)
        torch.save(got, f"{tmp}/got{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def piped(tmp_path_factory) -> list[dict]:
    tmp = str(tmp_path_factory.mktemp("pipeline"))
    ctx = mp.start_processes(_rank, args=(tmp,), nprocs=S, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"ranks still running after {SPAWN_TIMEOUT_S} s")
    return [torch.load(f"{tmp}/got{r}.pt") for r in range(S)]


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("M", MS)
def test_pipeline_matches_sequential_jax(piped, M, form):
    ws, x = _inputs(M)
    want = _jax_sequential(ws, x)
    for rank in range(S):
        got = piped[rank][(M, form)].numpy()
        assert got.shape == want.shape
        err = float(np.abs(got - want).max())
        assert err < TOL, f"rank {rank}: pipeline diverges by {err}"


@pytest.mark.parametrize("M", MS)
def test_one_stage_is_the_identity_schedule(M):
    ws, x = _inputs(M, stages=1)
    got = pipeline_apply(_stage, torch.from_numpy(ws[0]), torch.from_numpy(x),
                         n_stages=1, stage=0)
    np.testing.assert_allclose(got.numpy(), _jax_sequential(ws, x),
                               rtol=0, atol=TOL)
