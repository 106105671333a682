"""Where the time goes: a ``torch.profiler`` trace of one prefill and of a
few decode steps on the card; ``profile`` traces any other call, as
``chip_smoke.py``'s train phase does for one train step.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve --arch qwen2-7b \\
        --batch 4 --prompt-len 512 --decode-steps 4
    PYTHONPATH=src python -m repro_torch.launch.profile_serve \\
        --arch mamba2-370m --prompt-len 2048

For each phase it prints the host-clock wall time (ending in a
synchronize), the device-busy time (the union of the kernels' intervals in
the trace), the idle share between them, the number of kernels launched,
and the device time per kernel group (each of the port's kernels, matrix
products, the rest).  The phases run after one untraced warm-up pass.
Fails if the trace holds no device events.
"""

from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity
from torch.profiler import profile as profile_

from repro_torch.configs import get_config
from repro_torch.launch.serve import prompt_tokens
from repro_torch.models import get_model


# Kernel-name fragment -> group, first match wins: "flash_fwd" and
# "flash_bwd" cover the float32 and the bf16 kernels of each; "ssd_" the
# float32 SSD kernel and the four bf16 ones (ssd_cb, ssd_chunk_state,
# ssd_state_pass, ssd_chunk_out).
_KERNEL_GROUPS = (("flash_fwd", "flash_attention"),
                  ("flash_bwd", "flash_attention_bwd"),
                  ("ssd_", "ssd_scan"),
                  ("rmsnorm_fwd", "rmsnorm"),
                  ("rmsnorm_bwd", "rmsnorm_bwd"),
                  ("ce_fwd", "fused_cross_entropy"),
                  ("ce_bwd", "fused_cross_entropy_bwd"))


def _group(name: str) -> str:
    for fragment, group in _KERNEL_GROUPS:
        if fragment in name:
            return group
    if any(s in name.lower() for s in ("gemm", "gemv", "xmma", "cutlass",
                                       "nvjet")):
        return "matmul"
    return "other"


def _summary(prof, wall_s: float) -> dict:
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        raise RuntimeError("the trace holds no device events")
    copies = [e for e in events if e.name.startswith(("Memcpy", "Memset"))]
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, cur_start, cur_end = 0.0, *spans[0]
    for start, end in spans[1:]:
        if start > cur_end:
            busy += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy += cur_end - cur_start
    groups: dict[str, float] = defaultdict(float)
    names: dict[str, float] = defaultdict(float)
    for e in events:
        groups[_group(e.name)] += e.time_range.elapsed_us()
        names[e.name[:80]] += e.time_range.elapsed_us()
    top = sorted(names.items(), key=lambda kv: -kv[1])[:8]
    wall_ms, busy_ms = wall_s * 1e3, busy / 1e3
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": max(0.0, 1 - busy_ms / wall_ms),
            "kernels": len(events) - len(copies), "copies": len(copies),
            "device_ms_by_group": {k: v / 1e3 for k, v in sorted(groups.items())},
            "top_kernels_ms": {k: v / 1e3 for k, v in top}}


def profile(fn) -> dict:
    """Trace one call of ``fn`` (which must leave the card idle when it
    returns, e.g. by reading a result) and summarise it."""
    torch.cuda.synchronize()
    with profile_(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return _summary(prof, wall)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--decode-steps", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    cfg = get_config(args.arch)
    model = get_model(cfg, device="cuda")
    params = model.init(args.seed)
    tokens = prompt_tokens(cfg.vocab_size, args.batch, args.prompt_len,
                           args.seed, "cuda")
    max_seq = args.prompt_len + args.decode_steps + 1

    def run_prefill():
        logits, cache = model.prefill(params, {"tokens": tokens}, max_seq)
        return logits.argmax(-1, keepdim=True), cache

    def run_decode(token, cache):
        for _ in range(args.decode_steps):
            logits, cache = model.decode(params, token, cache)
            token = logits.argmax(-1, keepdim=True)
        return token

    run_decode(*run_prefill())                      # warm-up, untraced
    out = {"arch": cfg.name, "batch": args.batch,
           "prompt_len": args.prompt_len, "decode_steps": args.decode_steps,
           "device": torch.cuda.get_device_name(0)}
    prefill_out = {}

    def prefill():
        prefill_out["token"], prefill_out["cache"] = run_prefill()

    out["prefill"] = profile(prefill)
    out["decode"] = profile(lambda: run_decode(prefill_out["token"],
                                               prefill_out["cache"]))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
