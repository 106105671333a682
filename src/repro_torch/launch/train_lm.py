"""End-to-end training run: ~100M-parameter LM, a few hundred steps,
optionally data-parallel with the MSA-ordered gradient sync.

Port of the JAX package's ``examples/train_lm.py``:

    PYTHONPATH=src python -m repro_torch.launch.train_lm --device cpu \\
        --preset tiny
    PYTHONPATH=src python -m repro_torch.launch.train_lm --device cpu \\
        --preset tiny --dp 2 --steps 8 [--grad-sync flat]
    PYTHONPATH=src python -m repro_torch.launch.train_lm --dp 4 \\
        --grad-sync msa            # four cards, NCCL

``--preset tiny`` runs on the CPU only: its head_dim of 32 is not one the
flash kernels take (16, 64, 128).

Synthetic pipeline -> train step (activation checkpointing, optional
microbatching) -> AdamW -> async checkpoints -> resume -> straggler
detection.  ``--dp N`` starts N ranks with ``torch.multiprocessing``
(gloo on the CPU, NCCL with one card a rank, meeting through a file in a
temporary directory); each rank takes its contiguous rows of the global
batch, and the step's gradient sync issues one all-reduce per unit bucket
in the order of ``core.comm_schedule.plan_step_comm`` (``--grad-sync
msa``, the default when ``--dp`` exceeds 1), or in unit order
(``flat``), the embeddings' bucket last.  Rank 0 alone writes
checkpoints; every rank resumes from them.  Runs on the card unless asked
for the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs.base import ModelConfig, ShapeConfig, param_count
from repro_torch.core.comm_schedule import plan_step_comm
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.models import get_model
from repro_torch.optim.adamw import AdamW
from repro_torch.parallel.collectives import (merge_unit_buckets,
                                              ordered_psum,
                                              unit_grad_buckets)
from repro_torch.train import loop as loop_lib
from repro_torch.train.state import init_state
from repro_torch.train.step import make_train_step
from repro_torch.tree import leaves

PRESETS = {
    # ~100M params: 16L x d512 x ff2048, vocab 32768 (2 x 16.8M embed)
    "full": dict(n_layers=16, d_model=512, n_heads=8, n_kv_heads=8,
                 head_dim=64, d_ff=2048, vocab_size=32768,
                 steps=300, batch=2, seq=128),
    "tiny": dict(n_layers=4, d_model=128, n_heads=4, n_kv_heads=4,
                 head_dim=32, d_ff=512, vocab_size=1024,
                 steps=60, batch=4, seq=64),
}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=tuple(PRESETS), default="full")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--dp", type=int, default=1,
                    help="data-parallel ranks (one card each with --device "
                         "cuda)")
    ap.add_argument("--grad-sync", choices=("auto", "msa", "flat"),
                    default="auto")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train_lm"))
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--straggle", action="store_true",
                    help="inject data-host stragglers")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def preset_config(preset: str) -> ModelConfig:
    p = PRESETS[preset]
    return ModelConfig(name=f"lm-{preset}", family="dense",
                       n_layers=p["n_layers"], d_model=p["d_model"],
                       n_heads=p["n_heads"], n_kv_heads=p["n_kv_heads"],
                       head_dim=p["head_dim"], d_ff=p["d_ff"],
                       vocab_size=p["vocab_size"], dtype="float32")


def make_optimizer(steps: int) -> AdamW:
    """The launcher's AdamW: peak 3e-4 after 20 warm-up steps, cosine decay
    to ``steps``."""
    return AdamW(peak_lr=3e-4, warmup_steps=20, total_steps=steps)


def sync_order(cfg: ModelConfig, shape: ShapeConfig, dp: int, sync: str):
    """(bucket order, plan): MSA's unit order with the embeddings' bucket
    last, or unit order for ``flat``."""
    plan = plan_step_comm(cfg, shape, chips=dp)
    order = plan.order + [len(plan.order)]  # embeddings bucket last
    if sync == "flat":
        order = list(range(len(order)))     # natural (barrier-ish) order
    return order, plan


def make_dp_step(model, optimizer, order: list[int], group=None,
                 microbatches: int = 1):
    """``make_train_step`` whose gradients are summed over ``group`` one
    unit bucket at a time in ``order`` and divided by the world size
    before the optimizer; the loss in the metrics is the ranks' mean."""
    n = dist.get_world_size(group)

    def sync(grads):
        synced = ordered_psum(unit_grad_buckets(grads), order, group)
        for g in leaves(synced):       # the collectives' own buffers
            g.div_(n)
        return merge_unit_buckets(synced, grads)

    inner = make_train_step(model, optimizer, grad_transform=sync,
                            microbatches=microbatches)

    def step(state, batch):
        state, metrics = inner(state, batch)
        loss = metrics["loss"].clone()
        dist.all_reduce(loss, group=group)
        metrics["loss"] = loss / n
        return state, metrics

    return step


def rank_rows(batch: dict, rank: int, world: int) -> dict:
    """Rank ``rank``'s contiguous rows of a global batch."""
    rows = next(iter(batch.values())).shape[0] // world
    return {k: v[rank * rows:(rank + 1) * rows] for k, v in batch.items()}


def _train(args, rank: int = 0, world: int = 1) -> bool:
    """One rank's run; returns whether the loss went down."""
    say = print if rank == 0 else (lambda *a, **k: None)
    p = PRESETS[args.preset]
    steps = args.steps or p["steps"]
    cfg = preset_config(args.preset)
    say(f"model: {cfg.name}  {param_count(cfg) / 1e6:.1f}M params",
        flush=True)
    device = (torch.device("cuda", rank) if args.device == "cuda"
              else torch.device(args.device))
    model = get_model(cfg, device=device)
    opt = make_optimizer(steps)
    shape = ShapeConfig("example", seq_len=p["seq"],
                        global_batch=p["batch"] * world, kind="train")
    pipe = SyntheticTokens(cfg, batch=shape.global_batch, seq=shape.seq_len,
                           delay_prob=0.05 if args.straggle else 0.0)

    sync = args.grad_sync
    if sync == "auto":
        sync = "msa" if world > 1 else "flat"
    if world > 1:
        order, plan = sync_order(cfg, shape, world, sync)
        say(f"grad-sync={sync}  bucket order: {order}")
        say(f"simulated step: msa={plan.dag_steps['msa']:.4f}s "
            f"flat={plan.dag_steps['flat']:.4f}s "
            f"(overlap {plan.overlap_fraction:.0%})", flush=True)
        train_step = make_dp_step(model, opt, order,
                                  microbatches=args.microbatches)

        def batch_at(i):
            return rank_rows(pipe.batch_at(i), rank, world)
    else:
        train_step = make_train_step(model, opt,
                                     microbatches=args.microbatches)
        batch_at = pipe.batch_at

    lcfg = loop_lib.LoopConfig(total_steps=steps,
                               ckpt_every=max(steps // 4, 1),
                               ckpt_dir=args.ckpt_dir, log_every=10,
                               write_checkpoints=rank == 0)
    report = loop_lib.run(train_step, lambda: init_state(model, opt, 0),
                          batch_at, lcfg)

    say(f"\nresumed_from={report.resumed_from} steps_run={report.steps_run}")
    say(f"loss: first5={np.mean(report.losses[:5]):.4f} "
        f"last5={np.mean(report.losses[-5:]):.4f}")
    if report.straggler_steps:
        say(f"stragglers detected at steps: {report.straggler_steps[:10]}")
    ok = (not report.losses or
          np.mean(report.losses[-5:]) < np.mean(report.losses[:5]))
    say("TRAINING", "OK" if ok else "DID NOT IMPROVE", flush=True)
    return bool(ok)


def _rank(rank: int, args, world: int, rendezvous: str) -> None:
    backend = "nccl" if args.device == "cuda" else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(rank)
    else:   # the ranks share the host's threads
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    dist.init_process_group(backend, init_method=f"file://{rendezvous}",
                            world_size=world, rank=rank)
    try:
        ok = _train(args, rank, world)
        if rank == 0:
            Path(rendezvous + ".ok").write_text("1" if ok else "0")
    finally:
        dist.destroy_process_group()


def main(argv=None) -> None:
    args = parse_args(argv)
    if args.dp < 1:
        raise ValueError(f"--dp {args.dp}: needs at least one rank")
    if args.dp == 1:
        sys.exit(0 if _train(args) else 1)
    if args.device == "cuda" and args.dp > torch.cuda.device_count():
        raise RuntimeError(f"--dp {args.dp} needs {args.dp} cards, "
                           f"{torch.cuda.device_count()} found")
    with tempfile.TemporaryDirectory() as tmp:
        rendezvous = os.path.join(tmp, "rendezvous")
        mp.spawn(_rank, args=(args, args.dp, rendezvous), nprocs=args.dp,
                 join=True)
        ok = Path(rendezvous + ".ok").read_text() == "1"
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
