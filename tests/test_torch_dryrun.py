"""The dry run against real ranks, its depth arithmetic, a production cell
and the CLI; the microbatched sharded train step against one process.

``launch.dryrun`` runs a cell's real step on fake tensors as rank 0 of a
fake world (made and destroyed inside each ``dryrun.run``).  One start of
four gloo ranks (``torch.multiprocessing``, a ``file://`` rendezvous, a
time limit of its own) on a (data=2, model=2) mesh runs the same smoke
cells on real tensors (zeros: the counts do not depend on values) through
the same ``cell_step`` and ``measure``, and rank 0's counts must equal the
dry run's exactly: FLOPs, collective bytes of each kind, argument and
output bytes (the train step with two microbatches, prefill, decode, and
the context-parallel decode of ``long_500k``).  The same ranks run one
``make_sharded_step`` with two microbatches, whose loss and parameters
must be within 1e-5 of the one-process step with two microbatches (the
same global rows in each microbatch).

The counts at full depth equal ``extrapolate`` from depths 2 and 4 within
1e-9 relative (every unit runs the same operations); qwen2-7b's
``decode_32k`` runs to ``ok: true`` on the fake 256-rank production mesh
through the CLI, which writes its JSON, and a cell that raises makes the
CLI exit 1 with ``ok: false`` in its file.
"""

import dataclasses
import json
import sys
import tempfile
import time

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import MeshShape
from repro_torch.tree import leaves

WORLD, MESH = 4, MeshShape(("data", "model"), (2, 2))
SPAWN_TIMEOUT_S = 300
MICRO = 2
CELLS = {
    ("qwen2-7b-smoke", "train"): ShapeConfig("train_s", 32, 4, "train"),
    ("qwen2-7b-smoke", "prefill"): ShapeConfig("prefill_s", 32, 4,
                                               "prefill"),
    ("qwen2-7b-smoke", "decode"): ShapeConfig("decode_s", 32, 4, "decode"),
    ("whisper-base-smoke", "decode"): ShapeConfig("decode_s", 16, 4,
                                                  "decode"),
    ("jamba-1.5-large-398b-smoke", "long_500k"): ShapeConfig(
        "long_500k", 64, 1, "decode"),
}
STEP_CASES = ("qwen2-7b-smoke", "mixtral-8x22b-smoke")
STEP_BATCH, STEP_SEQ, STEP_STEPS = 4, 32, 60
TOL = 1e-5
COUNTED = ("flops", "collective", "argument_bytes", "output_bytes")


def _zeros(meta: torch.Tensor) -> torch.Tensor:
    return torch.zeros(meta.shape, dtype=meta.dtype)


def _micro(shape: ShapeConfig) -> int:
    return MICRO if shape.kind == "train" else 1


def _trainer(arch: str, mesh=None):
    from repro_torch.launch import train

    return train.setup(get_config(arch), steps=STEP_STEPS, batch=STEP_BATCH,
                       seq=STEP_SEQ, microbatches=MICRO, seed=0,
                       device="cpu", mesh=mesh)


def _rank(rank: int, tmp: str) -> None:
    from repro_torch.launch.mesh import make_test_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous",
                            world_size=WORLD, rank=rank)
    try:
        mesh = make_test_mesh(*MESH.axis_sizes, device_type="cpu")
        got = {}
        for (arch, kind), shape in CELLS.items():
            cfg = get_config(arch)
            got[arch, kind] = dryrun.measure(*dryrun.cell_step(
                cfg, shape, mesh, dryrun.cell_inputs(cfg, shape, _zeros),
                _micro(shape)))
        for arch in STEP_CASES:
            t = _trainer(arch, mesh)
            state, metrics = t.train_step(t.init(), t.pipeline.batch_at(0))
            got[arch, "step"] = {
                "loss": float(metrics["loss"]), "aux": float(metrics["aux"]),
                "params": [p.full_tensor() for p in leaves(state.params)]}
        if rank == 0:
            torch.save(got, f"{tmp}/got.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def real() -> dict:
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


@pytest.mark.parametrize("cell", list(CELLS), ids="-".join)
def test_dry_run_counts_equal_a_real_rank_zeros(real, cell):
    shape = CELLS[cell]
    fake = dryrun.run(get_config(cell[0]), shape, MESH, _micro(shape))
    assert fake["chips"] == WORLD and fake["microbatches"] == _micro(shape)
    assert fake["flops"] > 0 and fake["argument_bytes"] > 0
    assert sum(fake["collective"].values()) > 0
    for key in COUNTED:
        assert fake[key] == real[cell][key], key


@pytest.mark.parametrize("arch", STEP_CASES)
def test_microbatched_sharded_step_matches_one_process(real, arch):
    t = _trainer(arch)
    state, metrics = t.train_step(t.init(), t.pipeline.batch_at(0))
    got = real[arch, "step"]
    assert got["loss"] == pytest.approx(float(metrics["loss"]), rel=TOL)
    assert got["aux"] == pytest.approx(float(metrics["aux"]), rel=TOL,
                                       abs=1e-7)
    want = leaves(state.params)
    assert len(got["params"]) == len(want)
    for i, (g, w) in enumerate(zip(got["params"], want)):
        assert g.dtype == w.dtype and g.shape == w.shape, i
        assert float((g - w).detach().abs().max()) <= TOL, i


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_full_depth_counts_are_linear_in_depth(kind):
    """Depths 2, 4 and 6 units of the qwen2 smoke: the counts at 6 equal
    ``extrapolate`` from 2 and 4 (one microbatch)."""
    from repro_torch.roofline.analysis import extrapolate

    shape = CELLS["qwen2-7b-smoke", kind]
    cfg = get_config("qwen2-7b-smoke")
    got = {n: dryrun.run(dataclasses.replace(cfg, n_layers=n), shape, MESH,
                         1) for n in (2, 4, 6)}

    def close(pick):
        want = extrapolate(2, pick(got[2]), 4, pick(got[4]), 6)
        assert abs(pick(got[6]) - want) <= 1e-9 * max(abs(want), 1.0)

    close(lambda r: r["flops"])
    for k in got[2]["collective"]:
        close(lambda r: r["collective"][k])
    assert got[6]["flops"] > got[4]["flops"] > got[2]["flops"]


def test_production_cell_runs_through_the_cli(monkeypatch):
    """qwen2-7b ``decode_32k`` on the fake 256-rank (data=32, model=8)
    mesh: ``ok: true``, its JSON written with the reference's keys."""
    with tempfile.TemporaryDirectory() as tmp:
        monkeypatch.setattr(sys, "argv", [
            "dryrun", "--arch", "qwen2-7b", "--shape", "decode_32k",
            "--out-dir", tmp])
        with pytest.raises(SystemExit) as exit_:
            dryrun.main()
        assert exit_.value.code == 0
        with open(f"{tmp}/qwen2-7b__decode_32k__single.json") as f:
            res = json.load(f)
    assert res["ok"] is True and res["mesh"] == "32x8" and res["chips"] == 256
    assert res["microbatches"] == 1 and res["run_s"] > 0
    for key in ("argument_bytes_per_device", "output_bytes_per_device",
                "peak_bytes_per_device"):
        assert res["memory"][key] > 0, key
    assert res["memory"]["peak_bytes_per_device"] >= \
        res["memory"]["argument_bytes_per_device"]
    terms = res["roofline"]
    assert terms["chips"] == 256 and terms["dominant"] in (
        "compute", "memory", "collective")
    assert terms["flops"] == 256 * res["flops_per_device"]
    assert terms["coll_bytes"] == 256 * sum(
        res["collective_bytes_per_device"].values())
    assert res["useful_flops_ratio"] == res["model_flops"] / terms["flops"]


def test_cli_records_a_failed_cell_and_exits_one(monkeypatch):
    def broken(arch, shape_name, multi_pod=False):
        raise RuntimeError("planted")

    with tempfile.TemporaryDirectory() as tmp:
        monkeypatch.setattr(dryrun, "run_cell", broken)
        monkeypatch.setattr(sys, "argv", [
            "dryrun", "--arch", "mamba2-370m", "--shape", "long_500k",
            "--multi-pod", "--out-dir", tmp])
        with pytest.raises(SystemExit) as exit_:
            dryrun.main()
        assert exit_.value.code == 1
        with open(f"{tmp}/mamba2-370m__long_500k__multi.json") as f:
            res = json.load(f)
    assert res["ok"] is False and res["error"] == "RuntimeError: planted"


def _kernel_case(name: str, grad: bool):
    """Seeded operands of one kernel entry point of ``kernels/ops.py``
    (CPU tensors: its plain version runs) and the call."""
    from repro_torch.kernels import ops

    g = torch.Generator().manual_seed(5)

    def r(*shape):
        return torch.randn(*shape, generator=g).requires_grad_(grad)

    if name == "flash_attention":
        args = (r(1, 64, 2, 8), r(1, 64, 1, 8), r(1, 64, 1, 8))
        return args, lambda q, k, v: ops.flash_attention(q, k, v)
    if name == "rmsnorm":
        args = (r(4, 16), r(16))
        return args, lambda x, s: ops.rmsnorm(x, s, 1e-5)
    if name == "fused_cross_entropy":
        args = (r(8, 32), torch.randint(0, 32, (8,), generator=g))
        return args, ops.fused_cross_entropy
    args = (r(1, 32, 2, 4), torch.rand(1, 32, 2, generator=g)
            .requires_grad_(grad), -torch.rand(2, generator=g), r(1, 32, 3),
            r(1, 32, 3))
    return args, lambda x, dt, A, B, C: ops.ssd_scan(x, dt, A, B, C,
                                                     chunk=8)[0]


KERNEL_NAMES = ("flash_attention", "rmsnorm", "fused_cross_entropy",
                "ssd_scan")


@pytest.mark.parametrize("checkpointed", [False, True],
                         ids=["plain", "checkpointed"])
@pytest.mark.parametrize("name", KERNEL_NAMES)
def test_kernel_stand_in_keeps_flops_and_gradients(name, checkpointed):
    """Under ``kernel_footprints`` a plain version runs the same operations
    (FLOPs equal; products only, so RMSNorm and the cross-entropy count
    none) and gives the same outputs and gradients, bit for bit; also
    under activation checkpointing, as the models' units run in training
    (the backward recomputes the forward once, not twice)."""
    from torch.utils.checkpoint import checkpoint

    from repro_torch.roofline.analysis import CollectiveCounter

    def once(footprint: bool):
        args, fn = _kernel_case(name, grad=True)
        counter, live = CollectiveCounter(), dryrun.LiveBytes(args)
        stand_in = (dryrun.kernel_footprints(live, counter) if footprint
                    else torch.enable_grad())
        with counter, live, stand_in:
            if checkpointed:     # a unit: the kernel, then what uses it
                out = checkpoint(lambda *a: fn(*a).float().square(), *args,
                                 use_reentrant=False)
            else:
                out = fn(*args).float().square()
            out.sum().backward()
        grads = [a.grad for a in args if isinstance(a, torch.Tensor)
                 and a.requires_grad]
        return counter.flops, out.detach(), grads

    plain, stood_in = once(False), once(True)
    assert stood_in[0] == plain[0]
    assert (plain[0] > 0) == (name in ("flash_attention", "ssd_scan"))
    assert torch.equal(stood_in[1], plain[1])
    assert len(stood_in[2]) == len(plain[2]) > 0
    for g, w in zip(stood_in[2], plain[2]):
        assert torch.equal(g, w)


@pytest.mark.parametrize("arch", ["qwen2-7b-smoke", "mamba2-370m-smoke"])
def test_kernel_footprints_change_no_count_of_a_train_step(monkeypatch,
                                                           arch):
    """A smoke train step (qwen2: flash, RMSNorm, the cross-entropy;
    mamba2: the SSD scan, RMSNorm, the cross-entropy; 2 units, each
    checkpointed) on the fake (2, 2) world with and without ``kernel_footprints``: FLOPs
    and collective bytes equal, the peak no higher."""
    import contextlib

    cfg = dataclasses.replace(get_config(arch), n_layers=2)
    shape = ShapeConfig("train_s", 16, 2, "train")
    stood_in = dryrun.run(cfg, shape, MESH, 1)
    monkeypatch.setattr(dryrun, "kernel_footprints",
                        lambda live, counter: contextlib.nullcontext())
    plain = dryrun.run(cfg, shape, MESH, 1)
    assert stood_in["flops"] == plain["flops"] > 0
    assert stood_in["collective"] == plain["collective"]
    assert stood_in["peak_bytes"] <= plain["peak_bytes"]


def test_dry_run_peak_holds_a_kernels_footprint():
    """Flash attention's plain version on q [1, 64, 2, 8] and k, v
    [1, 64, 1, 8] (fp32: 4096, 2048 and 2048 bytes) makes 64 x 64 scores a
    head; the kernel makes only its output (4096 bytes), so the measured
    peak is 12288 bytes, where the plain version's intermediates exceed
    it."""
    args, fn = _kernel_case("flash_attention", grad=False)
    got = dryrun.measure(fn, args, args)
    assert got["argument_bytes"] == 8192
    assert got["output_bytes"] == 4096
    assert got["peak_bytes"] == 8192 + 4096
    live = dryrun.LiveBytes(args)
    with live:
        fn(*args)
    assert live.peak > 8192 + 4096 + 2 * 64 * 64 * 4


def test_microbatches_and_data_parallel_follow_the_mesh():
    from repro_torch.launch.mesh import production_shape

    assert dryrun.data_parallel(production_shape()) == 32
    assert dryrun.data_parallel(production_shape(multi_pod=True)) == 64
    # train_4k: 256 x 4096 over 32 ways is 32768 tokens a device: 4 of 8192
    assert dryrun.auto_microbatches(256, 4096, 32) == 4
    assert dryrun.auto_microbatches(256, 4096, 64) == 2
    assert dryrun.auto_microbatches(6, 8192, 1) == 6
    assert dryrun.auto_microbatches(4, 10, 2) == 1
