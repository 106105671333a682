"""Multi-node dry run: every (arch x shape) cell's real step on the
production mesh, on fake tensors in one process.

Port of ``repro.launch.dryrun``.  The reference lowers and compiles each
cell for a 256- or 512-chip TPU mesh that it emulates with host devices;
compile success is its proof that the distribution config is coherent.
The port has no compiler, so for each cell this module:

  1. joins a fake process group of 256 (single-pod) or 512 (multi-pod)
     ranks as rank 0 (``torch.distributed``'s ``fake`` backend, from the
     private ``torch.testing._internal.distributed.fake_pg``) and builds the
     production ``DeviceMesh`` (``launch.mesh.production_shape``: 32 nodes
     x 8 H100s, two pods for multi-pod) on the CPU;
  2. under ``FakeTensorMode`` (tensors with shapes and no storage) lays out
     the cell's parameters or train state, batch and decode cache by the
     reference's spec functions (``param_specs``, ``state_specs``,
     ``batch_specs``, ``cache_specs``, the latter with context parallelism
     for ``long_500k``), as DTensors holding rank 0's shards;
  3. runs the port's real step on them: ``launch.train.make_sharded_step``
     with ``auto_microbatches``, ``Model.prefill``, or ``Model.decode``.
     The tensors are CPU fakes, so ``kernels/ops.py`` sends every kernel
     call to its plain version; the step running to its end on the
     production mesh is the port's counterpart of compile success;
  4. records, per device (rank 0): FLOPs and collective bytes by kind
     (``roofline.analysis.CollectiveCounter``), the arguments' and outputs'
     local bytes, and the peak of live local bytes (``LiveBytes``), where
     each kernel's plain version counts only what its kernel holds in
     memory (``kernel_footprints``: not flash's S x S scores); FLOPs,
     collective and HBM bytes times ``chips`` feed ``RooflineTerms`` on the
     H100 constants, as the reference scales its per-device counts;
  5. writes one JSON per cell to ``experiments/dryrun_torch/``.

Every number is arithmetic on fake tensors, not a measurement.  The HBM
bytes are a lower bound: each argument read once and each output written
once.  The run is eager at full depth, so there are no depth probes
(``extrapolate`` stays as a function).  DTensor's redistributions on a CPU
mesh gather where NCCL would exchange all-to-all, and the counts follow
what the CPU mesh runs.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-7b --shape decode_32k
  python -m repro_torch.launch.dryrun --all                # 33 cells
  python -m repro_torch.launch.dryrun --all --multi-pod    # 2x32x8 sweep
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time
import traceback
import weakref
from pathlib import Path

import torch

from repro_torch.configs import ARCH_NAMES, get_config, shapes_for
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch.mesh import MeshShape, production_shape
from repro_torch.launch.specs import (decode_specs, params_struct,
                                      prefill_specs, state_struct,
                                      train_specs)
from repro_torch.models import get_model
from repro_torch.optim.adamw import AdamW
from repro_torch.roofline.analysis import (CollectiveCounter, RankOps,
                                           RooflineTerms,
                                           model_flops_per_step,
                                           total_collective_bytes)
from repro_torch.tree import leaves, tree_map

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"


def auto_microbatches(B: int, S: int, dp: int, target: int = 8192) -> int:
    """Smallest divisor of B so each microbatch is <= ~target tokens/device."""
    want = max(1, -(-B * S // dp) // target)
    for m in range(want, B + 1):
        if B % m == 0:
            return m
    return B


def data_parallel(mesh: MeshShape) -> int:
    """Ways the batch is split: every axis but ``model``."""
    out = 1
    for name, size in zip(mesh.axis_names, mesh.axis_sizes):
        if name != "model":
            out *= size
    return out


@contextlib.contextmanager
def fake_world(size: int):
    """This process as rank 0 of a fake process group of ``size`` ranks
    (collectives return at once, with outputs of the right shapes); the
    group is destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _local_bytes(tree) -> int:
    from repro_torch.parallel import axes as ax

    return sum(ax.local(x).numel() * x.element_size() for x in leaves(tree)
               if isinstance(x, torch.Tensor))


class LiveBytes(RankOps):
    """The peak of the bytes held by the storages a rank's operations
    create, with the storages of ``args``' local shards counted from the
    start.  A storage counts once, however many views share it, until the
    last tensor on it is freed.  Storages made under ``quiet()`` are not
    counted (``kernel_footprints``: a kernel's work that stays on chip)."""

    def __init__(self, args=()):
        super().__init__()
        from repro_torch.parallel import axes as ax

        self._live: dict[int, int] = {}
        self.now = self.peak = 0
        self.track([ax.local(x) for x in leaves(args)
                    if isinstance(x, torch.Tensor)])

    def track(self, tree) -> None:
        """Count the storages of ``tree``'s tensors from now on."""
        for t in leaves(tree):
            if isinstance(t, torch.Tensor):
                self._track(t)

    def _free(self, key: int) -> None:
        self.now -= self._live.pop(key)

    def _track(self, t: torch.Tensor) -> None:
        s = t.untyped_storage()
        key = id(s)
        if key in self._live:
            return
        self._live[key] = s.nbytes()
        weakref.finalize(s, self._free, key)
        self.now += self._live[key]
        self.peak = max(self.peak, self.now)

    def seen(self, func, args, kwargs, out) -> None:
        self.track(out)


class _AsKernel(torch.autograd.Function):
    """A kernel's plain version ``fn`` with the kernel's footprint and the
    plain version's operations.  Forward: ``fn`` runs unseen by ``live``,
    which then counts its outputs and ``kept(*args, **kwargs)`` (what the
    kernel saves for its backward beyond its inputs and outputs).
    Backward: ``fn`` runs again unseen by ``live`` and ``counter`` (the
    plain version's autograd keeps what this recomputes), then its
    gradient, which ``counter`` sees and ``live`` does not, but for the
    input gradients.  The inputs and ``kept`` go through
    ``save_for_backward``, so activation checkpointing discards and
    recomputes them as it does the plain version's saved tensors."""

    @staticmethod
    def forward(ctx, live, counter, fn, kept, kwargs, *args):
        with live.quiet():
            out = fn(*args, **kwargs)
        live.track(out)
        ctx.is_tensor = [isinstance(a, torch.Tensor) for a in args]
        ctx.save_for_backward(*[a for a in args
                                if isinstance(a, torch.Tensor)],
                              kept(*args, **kwargs))
        ctx.modes, ctx.fn, ctx.kwargs = (live, counter), fn, kwargs
        ctx.others = [None if t else a for a, t in zip(args, ctx.is_tensor)]
        ctx.set_materialize_grads(False)    # an unused output passes None
        return out

    @staticmethod
    def backward(ctx, *grads):
        live, counter = ctx.modes
        saved = iter(ctx.saved_tensors[:-1])
        needs = ctx.needs_input_grad[5:]
        ins = [next(saved).detach().requires_grad_(n) if t else a
               for a, t, n in zip(ctx.others, ctx.is_tensor, needs)]
        with torch.enable_grad(), live.quiet(), counter.quiet():
            out = ctx.fn(*ins, **ctx.kwargs)
        outs = out if isinstance(out, tuple) else (out,)
        pairs = [(o, g) for o, g in zip(outs, grads) if g is not None]
        with live.quiet():
            got = iter(torch.autograd.grad(
                [o for o, _ in pairs], [a for a, n in zip(ins, needs) if n],
                [g for _, g in pairs], allow_unused=True))
        res = [next(got) if n else None for n in needs]
        live.track(res)
        return (None,) * 5 + tuple(res)


def _flash_kept(q, k, v, **_):
    return torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)


def _ce_kept(logits, labels):
    return torch.empty(logits.shape[:1], dtype=torch.float32,
                       device=logits.device)


#: Each kernel's plain version (``kernels.ref``) and what the kernel saves
#: for its backward beyond its inputs and outputs (``kernels/ops.py``'s
#: ``save_for_backward``).
_KERNEL_REFS = {
    "flash_attention_ref": _flash_kept,
    "rmsnorm_ref": lambda *a, **k: None,
    "cross_entropy_ref": _ce_kept,
    "ssd_scan_ref": lambda *a, **k: None,
}


@contextlib.contextmanager
def kernel_footprints(live: LiveBytes, counter: CollectiveCounter):
    """While active, ``kernels/ops.py``'s plain versions count in ``live``
    as their kernels' footprints: inputs, outputs and the tensors the
    kernel saves, not the plain version's intermediates (flash's S x S
    scores, the SSD scan's chunk blocks, the cross-entropy's fp32 logits),
    which the card's kernels keep on chip.  ``counter`` sees the plain
    version's operations as it would without this."""
    from repro_torch.kernels import ref

    def standing_in(fn, kept):
        def call(*args, **kwargs):
            if torch.is_grad_enabled() and any(
                    isinstance(a, torch.Tensor) and a.requires_grad
                    for a in args):
                return _AsKernel.apply(live, counter, fn, kept, kwargs,
                                       *args)
            with live.quiet():
                out = fn(*args, **kwargs)
            live.track(out)
            return out
        return call

    orig = {name: getattr(ref, name) for name in _KERNEL_REFS}
    for name, kept in _KERNEL_REFS.items():
        setattr(ref, name, standing_in(orig[name], kept))
    try:
        yield
    finally:
        for name, fn in orig.items():
            setattr(ref, name, fn)


def cell_inputs(cfg: ModelConfig, shape: ShapeConfig, make) -> tuple:
    """The cell's global inputs as meta structs turned into tensors by
    ``make`` (fake, or real for a run on real ranks): the train state and
    batch, the prefill batch, or the parameters, token and cache."""
    def each(tree):
        return tree_map(lambda x: make(x) if isinstance(x, torch.Tensor)
                        else x, tree)

    if shape.kind == "train":
        return each((state_struct(cfg), train_specs(cfg, shape)))
    params = each(params_struct(cfg))
    if shape.kind == "prefill":
        return params, each(prefill_specs(cfg, shape))
    token, cache = decode_specs(cfg, shape)
    return params, each({"token": token}), each(cache)


def cell_step(cfg: ModelConfig, shape: ShapeConfig, mesh, inputs: tuple,
              microbatches: int = 1):
    """(step, args, held): the cell's real step on ``mesh``, its arguments
    (``inputs`` laid out as DTensors by the reference's spec functions; a
    train step takes the global batch and lays it out itself), and the
    arguments as a rank holds them (the batch laid out)."""
    from repro_torch.launch.train import make_sharded_step
    from repro_torch.parallel.sharding import (distribute_batch,
                                               distribute_cache,
                                               distribute_params,
                                               sharding_rules, state_specs,
                                               use_moe_ep)

    cp = shape.name == "long_500k"
    model = get_model(cfg, device="cpu", context_parallel=cp)
    with use_moe_ep(cfg.moe_ep):
        if shape.kind == "train":
            state, batch = inputs
            step = make_sharded_step(model, AdamW(), mesh, microbatches)
            state = distribute_params(state, mesh, state_specs)
            return step, (state, batch), (state, distribute_batch(batch,
                                                                  mesh))
        params = distribute_params(inputs[0], mesh)

    def under_rules(fn):
        def go(*args):
            with sharding_rules(mesh):
                return fn(*args)
        return go

    if shape.kind == "prefill":
        step = under_rules(lambda p, b: model.prefill(p, b, shape.seq_len))
        args = (params, distribute_batch(inputs[1], mesh))
    else:
        step = under_rules(lambda p, t, c: model.decode(p, t["token"], c))
        args = (params, distribute_batch(inputs[1], mesh),
                distribute_cache(inputs[2], mesh, context_parallel=cp))
    return step, args, args


def measure(step, args, held) -> dict:
    """Run ``step(*args)`` once under the counters: this rank's FLOPs,
    collective bytes by kind, the local bytes of its arguments (``held``)
    and outputs, and its peak live bytes with each kernel's plain version
    counted as the kernel's footprint (``kernel_footprints``)."""
    counter, live = CollectiveCounter(), LiveBytes(held)
    arg_bytes = _local_bytes(held)
    t0 = time.perf_counter()
    with counter, live, kernel_footprints(live, counter):
        out = step(*args)
    return {"flops": counter.flops, "collective": counter.collective,
            "argument_bytes": arg_bytes, "output_bytes": _local_bytes(out),
            "peak_bytes": live.peak, "run_s": time.perf_counter() - t0}


def _fake(meta: torch.Tensor) -> torch.Tensor:
    return torch.empty(meta.shape, dtype=meta.dtype, device="cpu")


def run(cfg: ModelConfig, shape: ShapeConfig, mesh_shape: MeshShape,
        microbatches: int | None = None) -> dict:
    """One cell on a fake world of ``mesh_shape``'s size: rank 0's counts
    (``measure``) and the microbatches (``auto_microbatches`` for a train
    cell unless given)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh

    chips = 1
    for s in mesh_shape.axis_sizes:
        chips *= s
    if microbatches is None:
        microbatches = (auto_microbatches(shape.global_batch, shape.seq_len,
                                          data_parallel(mesh_shape))
                        if shape.kind == "train" else 1)
    with fake_world(chips):
        mesh = init_device_mesh("cpu", mesh_shape.axis_sizes,
                                mesh_dim_names=mesh_shape.axis_names)
        with FakeTensorMode():
            got = measure(*cell_step(cfg, shape, mesh,
                                     cell_inputs(cfg, shape, _fake),
                                     microbatches))
    return {**got, "chips": chips, "microbatches": microbatches}


def run_cell(arch: str, shape_name: str, multi_pod: bool = False) -> dict:
    cfg = get_config(arch)
    shape = shapes_for(cfg)[shape_name]
    mesh = production_shape(multi_pod=multi_pod)
    t0 = time.time()
    got = run(cfg, shape, mesh)
    chips = got["chips"]
    flops = got["flops"] * chips
    coll = total_collective_bytes(got["collective"]) * chips
    hbm = (got["argument_bytes"] + got["output_bytes"]) * chips
    terms = RooflineTerms(flops=flops, hbm_bytes=hbm, coll_bytes=coll,
                          chips=chips)
    mf = model_flops_per_step(cfg, shape)
    return {
        "arch": arch, "shape": shape_name,
        "mesh": "x".join(map(str, mesh.axis_sizes)),
        "chips": chips,
        "run_s": round(time.time() - t0, 1),
        "step_s": round(got["run_s"], 1),
        "microbatches": got["microbatches"],
        "memory": {
            "argument_bytes_per_device": got["argument_bytes"],
            "output_bytes_per_device": got["output_bytes"],
            "peak_bytes_per_device": got["peak_bytes"],
        },
        "flops_per_device": got["flops"],
        "collective_bytes_per_device": got["collective"],
        "roofline": {**terms.as_dict(), "bound_s": terms.bound_s},
        "model_flops": mf,
        "useful_flops_ratio": (mf / flops) if flops else None,
        "ok": True,
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES)
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out-dir", default=str(OUT_DIR))
    args = ap.parse_args()

    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    cells: list[tuple[str, str]] = []
    if args.all:
        for arch in ARCH_NAMES:
            for shape_name in shapes_for(get_config(arch)):
                cells.append((arch, shape_name))
    else:
        if not args.arch or not args.shape:
            ap.error("need --arch and --shape (or --all)")
        cells = [(args.arch, args.shape)]

    mesh_tag = "multi" if args.multi_pod else "single"
    failures = 0
    for arch, shape_name in cells:
        tag = f"{arch}__{shape_name}__{mesh_tag}"
        t0 = time.time()
        try:
            res = run_cell(arch, shape_name, multi_pod=args.multi_pod)
            print(f"[ok]   {tag}: {res['run_s']}s "
                  f"dominant={res['roofline']['dominant']} "
                  f"useful={res['useful_flops_ratio']:.3f}", flush=True)
        except Exception as e:  # noqa: BLE001 — record and continue sweep
            res = {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
                   "ok": False, "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-4000:],
                   "run_s": round(time.time() - t0, 1)}
            failures += 1
            print(f"[FAIL] {tag}: {type(e).__name__}: {e}", flush=True)
        (out_dir / f"{tag}.json").write_text(json.dumps(res, indent=2,
                                                        default=str))
    print(f"\n{len(cells) - failures}/{len(cells)} cells ran "
          f"({mesh_tag}-pod mesh)")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
