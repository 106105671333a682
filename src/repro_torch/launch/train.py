"""Training launcher CLI.

Port of ``repro.launch.train``:

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch qwen2-7b-smoke --steps 100 --ckpt-dir ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch qwen2-7b-smoke --steps 11 --compress
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch mixtral-8x22b-smoke --steps 20 --seq 64 --ckpt-dir ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch whisper-base-smoke --steps 3 --seq 32 --ckpt-dir ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch mamba2-370m-smoke --steps 3 --seq 64 --ckpt-dir ckpt

Runs on the card (``--device cuda``, the default) unless asked for the CPU.
Every family trains: dense, MoE (the load-balancing loss enters the loss
with weight ``AUX_LOSS_WEIGHT``), Mamba-2 and the jamba hybrid with or
without experts, VLM and encoder-decoder.  The synthetic batches carry what
each family takes: ``--seq`` text tokens, plus the VLM's prefix of
``n_prefix_tokens`` patch embeddings, or the encoder's frame embeddings (as
many as tokens, as the JAX pipeline draws them).  The loop is the
fault-tolerant one: auto-resume, SIGTERM checkpointing, straggler
detection, async checkpoints.  ``--compress`` sends the gradients through
int8 quantization with error feedback (``parallel.compression``) in a
minimal local loop without checkpoints, as the JAX launcher does, and
prints the residual energy every 10 steps.  :func:`setup` builds the
model, optimizer, data and step for any ``ModelConfig``, compressed or not
(``chip_smoke.py`` passes depth-cut ``qwen2-7b``, ``mixtral-8x22b`` and
``llava-next-34b``, and ``whisper-base`` and ``mamba2-370m`` at full
depth).

``--mesh DATAxMODEL`` trains under the FSDP x TP layout of
``parallel.sharding`` (the counterpart of lowering the reference's
``make_train_step`` under ``state_specs``/``batch_specs``): it starts
DATA*MODEL ranks (``launch.mesh.run_ranks``: gloo on the CPU, NCCL with
one card a rank), builds the state as DTensors from the seed
(``distribute_state``), splits each global batch's rows over ``data``
(``batch_specs``), in ``--microbatches`` runs of rows where asked, and runs
``make_sharded_step`` in a minimal loop without checkpoints (a sharded
checkpoint is later work); ``--moe-ep`` takes the expert-parallel MoE
rules.  :func:`setup` takes the mesh itself (``mesh=``) for a caller that
has started its ranks.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
from collections.abc import Callable
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.launch.mesh import parse_mesh, run_ranks
from repro_torch.models import get_model
from repro_torch.models.registry import Model
from repro_torch.optim.adamw import AdamW
from repro_torch.parallel.compression import (EFState, init_ef,
                                              make_compressing_step)
from repro_torch.parallel.sharding import local_device, sharding_rules
from repro_torch.train import loop as loop_lib
from repro_torch.train.state import TrainState, init_state
from repro_torch.train.step import make_train_step
from repro_torch.tree import tree_map


class Trainer(NamedTuple):
    model: Model
    optimizer: AdamW
    pipeline: SyntheticTokens
    train_step: Callable
    init: Callable[[], TrainState | tuple[TrainState, EFState]]


def make_sharded_step(model: Model, optimizer: AdamW, mesh,
                      microbatches: int = 1):
    """``make_train_step`` on a state of DTensors (``distribute_state``):
    (state, global batch) -> (state, metrics).

    The batch's rows are split over ``data`` by ``batch_specs``; the loss
    and the metrics come back whole (plain tensors, equal on every rank).
    Each gradient arrives in its parameter's placements: a unit's sharded
    weights through the reduce-scatter that is the backward of their FSDP
    gather, the replicated leaves (norm scales, biases under TP, the Mamba
    mixers' small leaves) through one explicit all-reduce of their pending
    sums, before AdamW runs unchanged on the DTensors.
    ``microbatches > 1`` splits the global batch into runs of rows, as the
    one-device step does, each laid out by ``batch_specs`` (each rank runs
    its rows of each), and accumulates the gradients in fp32 in the
    parameters' placements."""
    from repro_torch.parallel import axes as ax
    from repro_torch.parallel.sharding import distribute_batch

    def loss(params, batch):
        value, parts = model.loss(params, distribute_batch(batch, mesh))
        return ax.full(value), {k: ax.full(v) for k, v in parts.items()}

    target: dict = {}

    def to_param_placements(grads):
        return tree_map(lambda g, pl: g.redistribute(placements=pl),
                        grads, target["placements"])

    inner = make_train_step(dataclasses.replace(model, loss=loss), optimizer,
                            grad_transform=to_param_placements,
                            microbatches=microbatches)

    def step(state: TrainState, batch) -> tuple[TrainState, dict]:
        target["placements"] = tree_map(lambda p: tuple(p.placements),
                                        state.params)
        with sharding_rules(mesh):
            state, metrics = inner(state, batch)
        return state, {k: ax.full(v) if isinstance(v, torch.Tensor) else v
                       for k, v in metrics.items()}

    return step


def setup(cfg: ModelConfig, *, steps: int, batch: int, seq: int,
          lr: float = 3e-4, microbatches: int = 1, seed: int = 0,
          device: str | torch.device = "cuda",
          compress: bool = False, mesh=None) -> Trainer:
    """The launcher's model, optimizer (warm-up over the first fifth of
    ``steps``, at most 20), synthetic data from ``seed`` and train step.
    With ``compress`` the step is ``make_compressing_step``'s and ``init``
    returns its carry, ``(TrainState, EFState)``.  With a ``mesh`` (a
    ``DeviceMesh`` over the running ranks; ``device`` is then each rank's
    own) the step is ``make_sharded_step``'s and ``init`` builds the state
    as DTensors (``distribute_state``)."""
    model = get_model(cfg, device=device)
    opt = AdamW(peak_lr=lr, warmup_steps=min(20, steps // 5 + 1),
                total_steps=steps)
    pipe = SyntheticTokens(cfg, batch=batch, seq=seq, seed=seed)
    if mesh is not None:
        if compress:
            raise ValueError("--mesh does not take --compress")
        from repro_torch.parallel.sharding import distribute_state

        return Trainer(model, opt, pipe,
                       make_sharded_step(model, opt, mesh, microbatches),
                       lambda: distribute_state(model, opt, seed, mesh))
    if compress:
        def init():
            state = init_state(model, opt, seed)
            return state, init_ef(state.params)

        return Trainer(model, opt, pipe,
                       make_compressing_step(model, opt, microbatches), init)
    step = make_train_step(model, opt, microbatches=microbatches)
    return Trainer(model, opt, pipe, step,
                   lambda: init_state(model, opt, seed))


def train_compressed(t: Trainer, steps: int) -> list[float]:
    """The compressed path's minimal loop (no checkpoints): a line with the
    loss and ``ef_residual_sq`` every 10 steps, then the means of the
    first and last five losses."""
    carry = t.init()
    losses = []
    for i in range(steps):
        carry, metrics = t.train_step(carry, t.pipeline.batch_at(i))
        losses.append(float(metrics["loss"]))
        if i % 10 == 0:
            print(f"step {i:5d} loss {losses[-1]:.4f} "
                  f"ef_sq {float(metrics['ef_residual_sq']):.3e}")
    print(f"done: first5={np.mean(losses[:5]):.4f} "
          f"last5={np.mean(losses[-5:]):.4f}")
    return losses


def train_sharded(t: Trainer, steps: int, say=print) -> list[float]:
    """The sharded path's minimal loop (no checkpoints): the loss and
    gradient norm of every step, then the first and last losses."""
    state = t.init()
    losses = []
    for i in range(steps):
        state, metrics = t.train_step(state, t.pipeline.batch_at(i))
        losses.append(float(metrics["loss"]))
        say(f"step {i:5d} loss {losses[-1]:.4f} "
            f"grad_norm {float(metrics['grad_norm']):.4f}", flush=True)
    say(f"done: first={losses[0]:.4f} last={losses[-1]:.4f}", flush=True)
    return losses


def _mesh_rank(rank: int, mesh, args) -> None:
    cfg = get_config(args.arch)
    if args.moe_ep:
        cfg = dataclasses.replace(cfg, moe_ep=True)
    device = local_device(mesh)
    t = setup(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
              lr=args.lr, microbatches=args.microbatches, seed=args.seed,
              device=device, mesh=mesh)
    say = print if rank == 0 else (lambda *a, **k: None)
    say(f"mesh (data={args.mesh[0]}, model={args.mesh[1]}) on "
        f"{'nccl' if device.type == 'cuda' else 'gloo'}: {cfg.name}",
        flush=True)
    losses = train_sharded(t, args.steps, say)
    if rank == 0 and not all(np.isfinite(losses)):
        raise RuntimeError(f"non-finite loss {losses}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b-smoke",
                    help=f"one of {ARCH_NAMES} (append -smoke for CPU)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compress", action="store_true",
                    help="int8 + error-feedback gradient path")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", type=parse_mesh, default=None,
                    help="DATAxMODEL ranks under the FSDP x TP layout")
    ap.add_argument("--moe-ep", action="store_true",
                    help="with --mesh: the expert-parallel MoE rules")
    args = ap.parse_args()
    if args.mesh is not None:
        run_ranks(_mesh_rank, args.mesh, args.device, args)
        return

    t = setup(get_config(args.arch), steps=args.steps, batch=args.batch,
              seq=args.seq, lr=args.lr, microbatches=args.microbatches,
              seed=args.seed, device=args.device, compress=args.compress)
    if args.compress:
        train_compressed(t, args.steps)
        return
    lcfg = loop_lib.LoopConfig(total_steps=args.steps,
                               ckpt_every=args.ckpt_every,
                               ckpt_dir=args.ckpt_dir)
    report = loop_lib.run(t.train_step, t.init, t.pipeline.batch_at, lcfg)
    print(f"resumed_from={report.resumed_from} steps_run={report.steps_run} "
          f"final_step={report.final_step} preempted={report.preempted}")
    if report.losses:
        print(f"loss first5={np.mean(report.losses[:5]):.4f} "
              f"last5={np.mean(report.losses[-5:]):.4f}")
    if report.straggler_steps:
        print(f"stragglers: {report.straggler_steps[:10]}")


if __name__ == "__main__":
    main()
