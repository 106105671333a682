"""Serving launcher CLI: batched prefill + greedy decode with a decode cache.

Port of ``repro.launch.serve`` for the families the port serves (dense,
MoE, Mamba-2, and the jamba hybrid with or without experts):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \\
        --batch 4 --prompt-len 512 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m \\
        --batch 4 --prompt-len 2048 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --arch mixtral-8x22b-smoke --prompt-len 40 --gen 8

Runs on the card (``--device cuda``, the default) unless asked for the CPU
(``--device cpu``, with a ``-smoke`` arch).  Runs eagerly; the greedy
argmax stays on the device, so the decode loop never waits for the host.
Weights are random, drawn on the device from ``--seed``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.models import get_model
from repro_torch.models.registry import Model


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def prompt_tokens(vocab_size: int, batch: int, prompt_len: int, seed: int,
                  device) -> torch.Tensor:
    """Random prompts [batch, prompt_len] from ``seed``, as the JAX
    launcher draws them."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        rng.integers(0, vocab_size, (batch, prompt_len))).to(device)


def generate(model: Model, params, tokens: torch.Tensor, gen: int) -> dict:
    """Prefill ``tokens`` [B, S], then greedy-decode until ``gen`` tokens
    per row exist (the first comes from prefill, ``gen - 1`` decode steps).

    Returns the tokens [B, gen], the last logits, a device flag that every
    step's logits were finite, and host-clock seconds for prefill and for
    the decode loop, each ending in a synchronize.
    """
    device = tokens.device
    max_seq = tokens.shape[1] + gen
    _sync(device)
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, {"tokens": tokens}, max_seq)
    token = logits.argmax(-1, keepdim=True)
    finite = torch.isfinite(logits).all()
    _sync(device)
    t_prefill = time.perf_counter() - t0

    out = [token]
    t0 = time.perf_counter()
    for _ in range(gen - 1):
        logits, cache = model.decode(params, token, cache)
        token = logits.argmax(-1, keepdim=True)
        finite &= torch.isfinite(logits).all()
        out.append(token)
    _sync(device)
    return {"tokens": torch.cat(out, dim=1), "logits": logits,
            "finite": finite, "prefill_s": t_prefill,
            "decode_s": time.perf_counter() - t0, "decode_steps": gen - 1}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b-smoke",
                    help=f"one of {ARCH_NAMES} (append -smoke for CPU)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = get_config(args.arch)
    device = torch.device(args.device)
    model = get_model(cfg, device=device)
    params = model.init(args.seed)
    tokens = prompt_tokens(cfg.vocab_size, args.batch, args.prompt_len,
                           args.seed, device)
    r = generate(model, params, tokens, args.gen)
    print(f"{cfg.name}: prefill {args.batch}x{args.prompt_len} "
          f"in {r['prefill_s'] * 1e3:.1f} ms")
    n = args.batch * r["decode_steps"]
    if n:
        print(f"decode: {n} tokens in {r['decode_s'] * 1e3:.1f} ms -> "
              f"{n / r['decode_s']:.1f} tok/s")
    seq = r["tokens"]
    if not bool(r["finite"]):
        raise SystemExit("non-finite logits")
    if not bool(((seq >= 0) & (seq < cfg.vocab_size)).all()):
        raise SystemExit("token ids out of range")
    print("sample token ids:", seq[0, :12].tolist())


if __name__ == "__main__":
    main()
