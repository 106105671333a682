"""Serving launcher CLI: batched prefill + greedy decode with a decode cache.

Port of ``repro.launch.serve`` for every family: dense, MoE, Mamba-2, the
jamba hybrid, the encoder-decoder (whisper, with stub frame embeddings) and
the VLM (llava, with stub patch embeddings as a prefix):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \\
        --batch 4 --prompt-len 512 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-base \\
        --batch 16 --prompt-len 224 --frames 1500 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --arch llava-next-34b-smoke --prompt-len 40 --gen 8

Runs on the card (``--device cuda``, the default) unless asked for the CPU
(``--device cpu``, with a ``-smoke`` arch).  Runs eagerly; the greedy
argmax stays on the device, so the decode loop never waits for the host.
Weights are random, drawn on the device from ``--seed``; so are the prompts
and the frame or patch embeddings (``prompt_batch``).

The JAX launcher sizes the decode cache as prompt + gen, leaving out a
VLM's prefix rows, so its decode attends only to the last prompt + gen
positions and forgets the image (ROADMAP §C).  ``generate`` counts them.

``--mesh DATAxMODEL`` serves under the layouts of ``parallel.sharding``,
as the reference's dry run lowers prefill and decode: it starts DATA*MODEL
ranks (``launch.mesh.run_ranks``: gloo on the CPU, NCCL with one card a
rank), each draws the parameters from the seed a part at a time, keeping
its block under ``param_specs`` (``init_params``: no rank holds the model
whole), and ``generate`` runs on those DTensors: the prompt's rows split
over ``data``, the caches in ``cache_specs``' placements, the logits made
whole before each greedy argmax so that every rank picks the same token
(``get_model(..., context_parallel=True)`` puts the caches' sequence over
``data`` x ``model`` instead, for batch-1 long contexts):

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch qwen2-7b-smoke --mesh 2x2
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import parse_mesh, run_ranks
from repro_torch.models import get_model
from repro_torch.models.registry import Model
from repro_torch.parallel import axes as ax
from repro_torch.spans import span
from repro_torch.tree import leaves


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def prompt_batch(cfg: ModelConfig, batch: int, prompt_len: int, seed: int,
                 device, frames: int | None = None) -> dict:
    """Random prompts [batch, prompt_len] from ``seed``, then the encoder's
    frame embeddings [batch, frames, D] (``frames`` defaults to
    ``prompt_len``) or the VLM's prefix [batch, n_prefix_tokens, D], drawn
    from one generator in the JAX launcher's order, the embeddings in
    float32 as it draws them."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (batch, prompt_len))}
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal(
            (batch, frames or prompt_len, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "vision_patches":
        out["prefix"] = rng.standard_normal(
            (batch, cfg.n_prefix_tokens, cfg.d_model)).astype(np.float32)
    return {k: torch.from_numpy(v).to(device) for k, v in out.items()}


def context_len(batch: dict) -> int:
    """Positions the self-attention cache holds after prefill: the prompt's
    tokens and a VLM's prefix rows (an encoder's frames live in the
    cross-attention's K/V instead)."""
    prefix = batch.get("prefix")
    return batch["tokens"].shape[1] + (0 if prefix is None
                                       else prefix.shape[1])


def generate(model: Model, params, batch: dict, gen: int) -> dict:
    """Prefill ``batch`` (tokens [B, S], and frames or a prefix where the
    family takes them), then greedy-decode until ``gen`` tokens per row
    exist (the first comes from prefill, ``gen - 1`` decode steps), with a
    cache of ``context_len(batch) + gen`` positions.

    Returns the tokens [B, gen], the last logits, a device flag that every
    step's logits were finite, and host-clock seconds for prefill and for
    the decode loop, each ending in a synchronize.  Under a profiler each
    decode step runs in an ``rt.serve.decode_step`` span
    (``repro_torch.spans``).

    DTensor parameters (``init_params``, ``distribute_params``) run under
    their mesh's ``sharding_rules``: the batch is laid out by
    ``batch_specs``, the caches stay DTensors, and the logits are made
    whole (``axes.full``) before each argmax, so the tokens and logits
    returned are plain tensors, the same on every rank.
    """
    mesh = getattr(leaves(params)[0], "device_mesh", None)
    if mesh is None:
        return _generate(model, params, batch, gen)
    from repro_torch.parallel.sharding import (distribute_batch,
                                               sharding_rules)

    with sharding_rules(mesh):
        return _generate(model, params, distribute_batch(batch, mesh), gen)


def _generate(model: Model, params, batch: dict, gen: int) -> dict:
    device = batch["tokens"].device
    max_seq = context_len(batch) + gen
    _sync(device)
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, batch, max_seq)
    logits = ax.full(logits)
    token = logits.argmax(-1, keepdim=True)
    finite = torch.isfinite(logits).all()
    _sync(device)
    t_prefill = time.perf_counter() - t0

    out = [token]
    t0 = time.perf_counter()
    for _ in range(gen - 1):
        with span("rt.serve.decode_step"):
            logits, cache = model.decode(params, token, cache)
            logits = ax.full(logits)
            token = logits.argmax(-1, keepdim=True)
            finite &= torch.isfinite(logits).all()
        out.append(token)
    _sync(device)
    return {"tokens": torch.cat(out, dim=1), "logits": logits,
            "finite": finite, "prefill_s": t_prefill,
            "decode_s": time.perf_counter() - t0, "decode_steps": gen - 1}


def _report(cfg: ModelConfig, args, r: dict, say=print) -> None:
    say(f"{cfg.name}: prefill {args.batch}x{args.prompt_len} "
        f"in {r['prefill_s'] * 1e3:.1f} ms")
    n = args.batch * r["decode_steps"]
    if n:
        say(f"decode: {n} tokens in {r['decode_s'] * 1e3:.1f} ms -> "
            f"{n / r['decode_s']:.1f} tok/s")
    seq = r["tokens"]
    if not bool(r["finite"]):
        raise SystemExit("non-finite logits")
    if not bool(((seq >= 0) & (seq < cfg.vocab_size)).all()):
        raise SystemExit("token ids out of range")
    say("sample token ids:", seq[0, :12].tolist())


def _mesh_rank(rank: int, mesh, args) -> None:
    from repro_torch.parallel.sharding import init_params, local_device

    cfg = get_config(args.arch)
    device = local_device(mesh)
    model = get_model(cfg, device=device)
    params = init_params(model, args.seed, mesh)
    batch = prompt_batch(cfg, args.batch, args.prompt_len, args.seed, device,
                         frames=args.frames)
    say = print if rank == 0 else (lambda *a, **k: None)
    say(f"mesh (data={args.mesh[0]}, model={args.mesh[1]}) on "
        f"{'nccl' if device.type == 'cuda' else 'gloo'}: {cfg.name}",
        flush=True)
    _report(cfg, args, generate(model, params, batch, args.gen), say)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b-smoke",
                    help=f"one of {ARCH_NAMES} (append -smoke for CPU)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--frames", type=int, default=None,
                    help="encoder frames (encdec; default: --prompt-len)")
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", type=parse_mesh, default=None,
                    help="DATAxMODEL ranks under the FSDP x TP layout")
    args = ap.parse_args()
    if args.mesh is not None:
        run_ranks(_mesh_rank, args.mesh, args.device, args)
        return

    cfg = get_config(args.arch)
    device = torch.device(args.device)
    model = get_model(cfg, device=device)
    params = model.init(args.seed)
    batch = prompt_batch(cfg, args.batch, args.prompt_len, args.seed, device,
                         frames=args.frames)
    _report(cfg, args, generate(model, params, batch, args.gen))


if __name__ == "__main__":
    main()
