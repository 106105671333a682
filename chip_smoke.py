#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from a checkout of the repository; it needs one CUDA card and nvcc
(``/usr/local/cuda``) and builds every kernel from the sources in
``src/repro_torch``.  Phases, each printing its own lines:

1. device    -- the card's name and power limit (nvidia-smi), torch versions;
2. build     -- nvcc for each CUDA source (all started together), Triton
                JIT, build seconds, ptxas register and spill lines; each bf16
                tensor-core kernel's spill bytes (ptxas), its tensor-core
                instructions (HMMA/HGMMA in ``cuobjdump -sass``) and its
                asynchronous copies (LDGSTS, i.e. cp.async), failing on a
                spill or on a kernel without either instruction;
3. kernels   -- each of the seven kernels (four forward, three backward)
                against its plain PyTorch version on the card at the
                serving and training shapes, with the stated tolerance;
                kernel, plain and library times (CUDA events) beside the
                card's bound; the flash and SSD kernels' TFLOP/s and share
                of the bound, the flash forward also at the train shape
                beside SDPA's forward, and two calls of the flash backward
                and of the bf16 SSD scan bit-equal; the SSD scan's CUDA
                kernels per call and each one's device time (a
                ``torch.profiler`` trace of ten calls) and the scratch one
                call allocates (``torch.cuda.max_memory_allocated``);
4. reference -- small float32 models served on the card (kernels) against
                the same models on the CPU (plain versions): equal greedy
                tokens, logits within 1e-3 (dense qwen2, Mamba-2 with the
                real SSD head sizes at a ragged prompt, the jamba hybrid
                without experts); two float32 qwen2 smoke models trained
                three steps on the card and on the CPU from the same
                parameters (gradients, losses, launch counts); the train
                loop on the card, resumed from its checkpoint;
5. serve     -- through ``repro_torch.launch.serve``: qwen2-7b at full width
                (28 layers, bf16, batch 4, prompt 512, 32 tokens), then
                mamba2-370m at full width and depth (48 layers, bf16, batch
                4, prompt 2048, 32 tokens);
6. train     -- through ``repro_torch.launch.train.setup``: qwen2-7b at
                full width cut to 8 of its 28 layers (bf16, AdamW), batch 2
                x 4096 tokens, one warm-up step and three timed steps, then
                one traced step for the device's idle share;
7. engine    -- the lockstep fifo engine (``repro_torch.core.simtorch``) at
                the repo's batched-bench setup: each of the six registered
                scenarios at full size on its registered topology, and
                ``mixed`` on ``fat_tree``, seeds 0-19 as one batch on the
                card (cold and warm walls, host reads per run), held lane
                by lane to the same batch on the CPU (JCT/CCT and makespan
                within 1e-6, equal events); then every one of those cells
                through ``repro_torch.experiments.run_cells_batched`` on
                the card, and one warm ``pipe_serve`` batch traced
                (``torch.profiler``: idle share, kernels per step);
8. the ``{"train": ...}``, ``{"kernels": [...]}`` and ``{"engine": [...]}``
   summary lines, then the ``{"ok": true, ...}`` line.

Each run of a main path (phases 5 and 6) zeroes the kernels' launch counts
just before it and reads them just after.

Any failed check raises, so the script exits non-zero and prints no result
line.  Weights are random, drawn on the card from a fixed seed.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

SRC = Path(__file__).resolve().parent / "src"

# H100 SXM data-sheet peaks (the bound of each kernel is computed from them).
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
FP32_FLOPS = 67e12

SEED = 0
BATCH, GEN = 4, 32
SERVES = (("qwen2-7b", 512), ("mamba2-370m", 2048))   # (arch, prompt)
PROMPT = SERVES[0][1]
RMSNORM_TOL = 2e-2   # bf16: both round one fp32 result to bf16
FLASH_TOL = {torch.bfloat16: 2e-2,   # bf16 output; plain version rounds p
             torch.float32: 2e-5}    # same sums in another order
# SSD scan.  y in bf16: 3e-2 (one rounding of the output; both sides
# compute in fp32).  y in float32: 2e-4, as rtol and times the largest
# |y| as atol: exp of differences of a chunk's cumulative sum of dt*A,
# summed in another order, errs by ~|cumsum| * 2^-24, ~1e-4 of the largest
# term over a 256-row chunk where terms cancel.
SSD_TOL = {torch.bfloat16: 3e-2, torch.float32: 2e-4}
# The fp32 state, as rtol and times its largest entry as atol: a 256-row
# chunk's cumsum reaches ~-1e3 (the tests' A) to ~-3e3 (the model's A, to
# -16); two summation orders differ by ~2.2e-4 of the largest entry
# (measured on the card and on the CPU); 1e-3 leaves a 4x margin.
SSD_STATE_TOL = 1e-3
SSD_LAUNCHES_PER_CALL = 1   # counted launches per call (of the launcher)
REF_LOGIT_TOL = 1e-3  # float32 model, card vs CPU, a few layers
# Backward kernels against autograd through the plain version in float32 on
# the same values, as rtol and times the largest |gradient| as atol: bf16
# 2e-2 (one bf16 rounding of each gradient, and the forward's bf16 output in
# D = rowsum(dO*O)); float32 1e-4 (sums over keys, query rows or rows in
# another order).
BWD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
CE_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}   # per-row NLL, fp32 out
# The forward's fp32 lse against the plain fp32 logsumexp of the same scores
# (from the same bf16 or fp32 inputs), as rtol and atol: sums over the keys
# in another order.
LSE_TOL = 2e-5
# Train path, float32 smoke models, card vs CPU: losses within 1e-4;
# gradients within 1e-4 relative and 1e-4 of the leaf's largest entry.
TRAIN_LOSS_TOL = 1e-4
TRAIN_GRAD_TOL = 1e-4
REF_TRAIN_STEPS = 3
# The full-width train run: qwen2-7b cut to 8 of 28 layers (the state of 28
# layers, 7.6 B parameters at 12 bytes each, exceeds the card's 80 GB),
# batch 2 x 4096 (the repo's train_4k sequence; its global batch of 256 cut
# to 2), a warm-up step and three timed steps.
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 2, 4096, 3
# Copies of a timed kernel's inputs: four prefill-sized sets exceed the L2.
COPIES = {"prefill": 4, "decode": 1}
# The engine phase: the batched-bench setup of the repo's simulator-core
# benchmark (every registered scenario at full size, 20 seeds as one batch),
# plus ``mixed`` on ``fat_tree`` (paths of up to six links).  Card lanes
# against CPU lanes: the CPU tests' tolerance against the numpy core.
ENGINE_SEEDS = 20
ENGINE_EXTRA = (("mixed", "fat_tree"),)
ENGINE_TOL = 1e-6
ENGINE_STEPS_PER_SYNC = 16   # lockstep steps between two reads of the flags


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def time_ms(fn, inputs: list[tuple], iters: int = 20, warmup: int = 3,
            device_only: bool = True) -> float:
    """Milliseconds per call of ``fn(*args)`` between CUDA events around
    ``iters`` calls, ``args`` cycling through ``inputs``.

    Where ``inputs`` holds copies that together exceed the 50 MB L2 cache,
    each call reads its inputs from device memory, as the bound assumes.
    With ``device_only`` the card first spins (``torch.cuda._sleep``) while
    the host enqueues every call, so the events time the kernels back to
    back and not the host's launch rate; without it they time calls as a
    caller issuing them one after another sees them.
    """
    for i in range(warmup):
        fn(*inputs[i % len(inputs)])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if device_only:
        torch.cuda._sleep(200_000_000)   # ~0.1 s: outlasts the enqueueing
    start.record()
    for i in range(iters):
        fn(*inputs[i % len(inputs)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(n_bytes: float, flops: float, peak_flops: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def check(label: str, got: torch.Tensor, want: torch.Tensor, tol: float,
          atol: float | None = None) -> float:
    """allclose with rtol ``tol`` and atol ``atol`` (default ``tol``)."""
    got, want = got.float(), want.float()
    atol = tol if atol is None else atol
    err = (got - want).abs().max().item()
    ok = bool(torch.isfinite(got).all()) and torch.allclose(got, want, rtol=tol,
                                                            atol=atol)
    print(f"  check {label}: max_abs_err={err:.3e} rtol={tol:g} atol={atol:g} "
          f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"{label} disagrees with its plain version")
    return err


def phase_device() -> str:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    if not (SRC / "repro_torch").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print("[1/8] device")
    print(smi)
    print(f"  torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} "
          f"device0 {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    return smi


# Every bf16 tensor-core kernel, by library: its kernels and the template
# arguments of each instantiation as they appear in the mangled name (the
# flash kernels per head_dim, the SSD kernels per (P, N)), and the
# instantiation phase 3 reports with its kernel.
def _bf16_tensor_core_kernels() -> dict[str, tuple]:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd

    flash_args = {f"hd{hd}": f"ILi{hd}E" for hd in fa.HEAD_DIMS}
    ssd_args = {f"P{P}_N{N}": f"ILi{P}ELi{N}E" for P, N in ssd.SHAPES}
    return {"flash_attention": (("flash_fwd_bf16_kernel",), flash_args,
                                "hd128"),
            "flash_attention_bwd": (("flash_bwd_dq_bf16_kernel",
                                     "flash_bwd_dkv_bf16_kernel"),
                                    flash_args, "hd128"),
            "ssd_scan": (("ssd_cb_kernel", "ssd_chunk_state_kernel",
                          "ssd_chunk_out_kernel"), ssd_args, "P64_N128")}


def _ptxas(log: str) -> dict[str, dict]:
    """Registers and spill bytes of each kernel in an ``-Xptxas -v`` log,
    by mangled name."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur is not None:
            cur["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    return out


def _sass_tensor_ops(lib: Path) -> dict[str, dict]:
    """HMMA (mma.sync), HGMMA (wgmma) and LDGSTS (cp.async) instructions of
    each kernel in the library's SASS, by mangled name."""
    from repro_torch.kernels import build

    sass = subprocess.run([str(Path(build._nvcc()).parent / "cuobjdump"),
                           "-sass", str(lib)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    parts = re.split(r"\n\s*Function : (\S+)\n", sass)
    return {name: {"HMMA": len(re.findall(r"\bHMMA\.", body)),
                   "HGMMA": len(re.findall(r"\bHGMMA\.", body)),
                   "LDGSTS": len(re.findall(r"\bLDGSTS\b", body))}
            for name, body in zip(parts[1::2], parts[2::2])}


def _check_bf16_tensor_cores() -> dict[str, dict]:
    """Each bf16 tensor-core kernel at each instantiation: no spill, its
    products on the tensor cores, its loads asynchronous.  Returns the
    reported instantiations' numbers by kernel."""
    from repro_torch.kernels import build

    report = {}
    for lib, (kernels, args, reported) in _bf16_tensor_core_kernels().items():
        ptxas = _ptxas(build.build_log(lib))
        sass = _sass_tensor_ops(build.library_path(lib))
        for kernel in kernels:
            for label, mangled in args.items():
                names = [n for n in ptxas if kernel in n and mangled in n]
                if len(names) != 1 or names[0] not in sass:
                    fail(f"{kernel}<{label}> not found in the ptxas log and "
                         f"the SASS of {lib}")
                info = {**ptxas[names[0]], **sass[names[0]]}
                print(f"  {kernel}<{label}>: {info.get('registers')} "
                      f"registers, {info.get('spill_bytes')} spill bytes, "
                      f"HMMA {info['HMMA']}, HGMMA {info['HGMMA']}, LDGSTS "
                      f"{info['LDGSTS']}")
                if info.get("spill_bytes") != 0:
                    fail(f"{kernel}<{label}> spills ({info.get('spill_bytes')}"
                         " bytes) or ptxas reported nothing")
                if not info["HMMA"] + info["HGMMA"]:
                    fail(f"{kernel}<{label}> runs no tensor-core instruction")
                if not info["LDGSTS"]:
                    fail(f"{kernel}<{label}> has no asynchronous copy")
                if label == reported:
                    report[kernel] = info
    return report


def phase_build() -> dict[str, dict]:
    from repro_torch.kernels import build
    from repro_torch.kernels import fused_ce as ce
    from repro_torch.kernels import rmsnorm as rn

    print("[2/8] build")
    t0 = time.perf_counter()
    build.build()
    t_nvcc = time.perf_counter() - t0
    for name in build.SOURCES:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    # Triton JIT of the four Triton kernels at the model's widths.
    x = torch.ones(1, 3584, device="cuda", dtype=torch.bfloat16)
    rn.rmsnorm(x, x[0], 1e-6)
    rn.rmsnorm_bwd(x, x[0], x, 1e-6)
    logits = torch.ones(1, 152064, device="cuda", dtype=torch.bfloat16)
    labels = torch.zeros(1, dtype=torch.int64, device="cuda")
    _, lse = ce.fused_cross_entropy(logits, labels)
    ce.fused_cross_entropy_bwd(logits, labels, lse, lse)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    print(f"  build_s={total:.2f} (nvcc {t_nvcc:.2f}, triton "
          f"{total - t_nvcc:.2f})")
    return _check_bf16_tensor_cores()


def _rmsnorm_entry(cfg) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    g = torch.Generator(device="cuda").manual_seed(SEED)
    D, eps = cfg.d_model, cfg.norm_eps
    scale = (1 + 0.1 * torch.randn(D, generator=g, device="cuda")).bfloat16()
    entry = {"name": "rmsnorm", "route": "triton",
             "source": "src/repro_torch/kernels/rmsnorm.py",
             "replaces": "src/repro/kernels/rmsnorm.py:25"}
    for rows, key in (((BATCH, PROMPT), "prefill"), ((BATCH, 1), "decode"),
                      ((TRAIN_BATCH, TRAIN_SEQ), "train")):
        x = torch.randn(*rows, D, generator=g, device="cuda").bfloat16()
        err = check(f"rmsnorm {key} {list(x.shape)} bf16",
                    ops.rmsnorm(x, scale, eps), ref.rmsnorm_ref(x, scale, eps),
                    RMSNORM_TOL)
        if key == "train":   # compared only; its time is in the train trace
            continue
        n = x.numel()
        b_ms, b_by = bound(2 * n * x.element_size() + D * 2, 4 * n, FP32_FLOPS)
        args = [(x, scale, eps)] + [(torch.randn_like(x), scale, eps)
                                    for _ in range(COPIES[key] - 1)]
        t = {"max_abs_err": err,
             "ms": time_ms(ops.rmsnorm, args),
             "call_ms": time_ms(ops.rmsnorm, args, device_only=False),
             "plain_ms": time_ms(ref.rmsnorm_ref, args),
             "library_ms": time_ms(
                 lambda x, s, e: F.rms_norm(x, (D,), s, e), args),
             "bound_ms": b_ms, "bound_by": b_by, "shape": list(x.shape)}
        print(f"  time rmsnorm {key} {list(x.shape)}: kernel {t['ms']:.4f} ms "
              f"(per call from the host {t['call_ms']:.4f} ms), plain "
              f"{t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} ms, "
              f"bound {b_ms:.4f} ms ({b_by})")
        if key == "prefill":
            entry.update(t)
        else:
            entry["decode"] = t
    return entry


def _flash_pairs(Sq: int, Sk: int, causal: bool, window: int) -> int:
    qi = torch.arange(Sq)[:, None] + (Sk - Sq)
    kj = torch.arange(Sk)[None, :]
    mask = torch.ones(Sq, Sk, dtype=torch.bool)
    if causal:
        mask &= kj <= qi
    if window:
        mask &= kj > qi - window
    return int(mask.sum())


def _flash_entry(cfg) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)

    def inputs(S, dtype):
        return [torch.randn(BATCH, S, n, hd, generator=g, device="cuda")
                .to(dtype) for n in (H, KV, KV)]

    def plain(q, k, v, window):
        return ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                       v.transpose(1, 2), causal=True,
                                       window=window).transpose(1, 2)

    entry = {"name": "flash_attention", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
             "replaces": "src/repro/kernels/flash_attention.py:86"}
    cases = [(PROMPT, 0, torch.bfloat16), (200, 0, torch.bfloat16),
             (PROMPT, 128, torch.bfloat16), (200, 0, torch.float32)]
    for S, window, dtype in cases:
        q, k, v = inputs(S, dtype)
        label = (f"flash_attention B{BATCH} H{H} KV{KV} S{S} hd{hd} "
                 f"{str(dtype).split('.')[-1]} causal window={window}")
        err = check(label, ops.flash_attention(q, k, v, window=window),
                    plain(q, k, v, window), FLASH_TOL[dtype])
        if (S, window, dtype) != cases[0]:
            continue
        # q, k and v read once, the output (q's shape) written once.
        n_bytes = sum(t.numel() * t.element_size() for t in (q, k, v, q))
        flops = 4 * BATCH * H * hd * _flash_pairs(S, S, True, window)
        b_ms, b_by = bound(n_bytes, flops, BF16_TENSOR_FLOPS)
        args = [(q, k, v)] + [tuple(inputs(S, dtype))
                              for _ in range(COPIES["prefill"] - 1)]
        entry.update(
            max_abs_err=err,
            ms=time_ms(ops.flash_attention, args),
            call_ms=time_ms(ops.flash_attention, args, device_only=False),
            plain_ms=time_ms(lambda q, k, v: plain(q, k, v, 0), args),
            library_ms=time_ms(
                lambda q, k, v: F.scaled_dot_product_attention(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    is_causal=True, enable_gqa=True), args),
            bound_ms=b_ms, bound_by=b_by, shape=list(q.shape))
        entry.update(tflops=flops / entry["ms"] / 1e9,
                     bound_share=b_ms / entry["ms"])
        print(f"  time {label}: kernel {entry['ms']:.4f} ms (per call from "
              f"the host {entry['call_ms']:.4f} ms), plain "
              f"{entry['plain_ms']:.4f} ms, library {entry['library_ms']:.4f} "
              f"ms, bound {b_ms:.4f} ms ({b_by}, {flops / 1e9:.2f} GFLOP, "
              f"{n_bytes / 1e6:.1f} MB); {entry['tflops']:.1f} TFLOP/s, "
              f"{100 * entry['bound_share']:.1f}% of the bound")
    return entry


def _ssd_flops(B: int, S: int, H: int, P: int, N: int, chunk: int) -> int:
    """Operations of one call: C.B^T once per (row, chunk) since B and C are
    shared by the heads, its causal half and diagonal; the decayed scores
    times x*dt per head; the carried-state term and the state update."""
    pairs = sum(q * (q + 1) // 2
                for q in (min(chunk, S - c0) for c0 in range(0, S, chunk)))
    return 2 * B * pairs * (N + H * P) + 4 * B * H * S * N * P


def _ssd_executed_flops(B: int, S: int, H: int, P: int, N: int,
                        chunk: int) -> int:
    """Tensor-core operations the bf16 kernels execute in one call, counted
    from their tiles (``ssd_scan.TILE`` rows, P and N padded to whole
    64-column blocks) with the hi/lo split's second product: C.B^T per
    causal tile pair; the local states (two products); the carried term and
    the dual form per query tile (two products each)."""
    from repro_torch.kernels.ssd_scan import TILE

    PP, NP = max(P, 64), max(N, 64)
    flops = 0
    for c0 in range(0, S, chunk):
        qt = -(-min(chunk, S - c0) // TILE)
        pairs = qt * (qt + 1) // 2
        flops += B * pairs * 2 * TILE * TILE * NP                    # C.B^T
        flops += B * H * qt * 2 * 2 * PP * TILE * NP                 # states
        flops += B * H * (qt * 2 * 2 * TILE * PP * NP                # carried
                          + pairs * 2 * 2 * TILE * TILE * PP)        # dual
    return flops


def _kernels_per_call(fn, inputs: list[tuple], n: int = 10
                      ) -> tuple[float, dict[str, float]]:
    """CUDA kernels launched per call of ``fn(*args)`` and each kernel's
    device microseconds per call, by name, from a ``torch.profiler`` trace
    of ``n`` calls, ``args`` cycling through ``inputs``."""
    from collections import defaultdict

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            fn(*inputs[i % len(inputs)])
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        fail("the profiler traced no device events")
    us: dict[str, float] = defaultdict(float)
    for e in events:
        m = re.search(r"::(\w+)[<(]", e.name)
        us[m.group(1) if m else e.name[:60]] += e.time_range.elapsed_us() / n
    return len(events) / n, dict(sorted(us.items(), key=lambda kv: -kv[1]))


def _ssd_entry() -> dict:
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref

    cfg = get_config("mamba2-370m")
    H, P, N, Q = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_chunk
    d_in = cfg.d_inner
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)

    def inputs(S, dtype, model_a, init):
        # x, Bm and Cm as mamba_forward passes them: views of one conv output.
        xbc = torch.randn(BATCH, S, d_in + 2 * N, generator=g,
                          device="cuda").to(dtype)
        x = xbc[..., :d_in].reshape(BATCH, S, H, P)
        Bm, Cm = xbc[..., d_in:d_in + N], xbc[..., d_in + N:]
        dt = F.softplus(torch.randn(BATCH, S, H, generator=g, device="cuda"))
        A = (-torch.linspace(1.0, 16.0, H, device="cuda") if model_a else
             -torch.exp(0.5 * torch.randn(H, generator=g, device="cuda")))
        st = (0.5 * torch.randn(BATCH, H, P, N, generator=g, device="cuda")
              if init else None)
        return x, dt, A, Bm, Cm, st

    entry = {"name": "ssd_scan", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
             "replaces": "src/repro/kernels/ssd_scan.py:82"}
    S_SERVE = SERVES[1][1]
    # (S, dtype, the model's A (else the test cases' A), initial state).  The
    # serve shape, two ragged lengths (a partial chunk), a nonzero initial
    # state in bf16 and in float32, float32 with the tests' A.
    cases = [(S_SERVE, torch.bfloat16, True, False),
             (200, torch.bfloat16, True, False),
             (300, torch.bfloat16, True, False),
             (300, torch.bfloat16, True, True),
             (512, torch.float32, False, False),
             (300, torch.float32, False, True)]
    for S, dtype, model_a, init in cases:
        x, dt, A, Bm, Cm, st0 = inputs(S, dtype, model_a, init)
        label = (f"ssd_scan B{BATCH} S{S} H{H} P{P} N{N} chunk{Q} "
                 f"{str(dtype).split('.')[-1]} A={'model' if model_a else 'test'}"
                 f"{' initial_state' if init else ''}")
        y, st = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=Q, initial_state=st0)
        want_y, want_st = ref.ssd_scan_ref(x, dt, A, Bm, Cm, Q, st0)
        tol = SSD_TOL[dtype]
        err = check(label + " y", y, want_y, tol, atol=tol * (
            1.0 if dtype == torch.bfloat16 else want_y.abs().max().item()))
        check(label + " state", st, want_st, SSD_STATE_TOL,
              atol=SSD_STATE_TOL * want_st.abs().max().item())
        if dtype == torch.bfloat16 and S in (S_SERVE, 300):
            y2, st2 = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=Q,
                                   initial_state=st0)
            if not (torch.equal(y, y2) and torch.equal(st, st2)):
                fail(f"{label}: two calls on the same inputs differ")
            print(f"  check {label}: a second call's y and state bit-equal ok")
            del y2, st2
        if (S, dtype, model_a, init) != cases[0]:
            continue
        # x, dt, A, B and C read once; y and the fp32 state written once.
        n_bytes = (sum(t.numel() * t.element_size() for t in (x, dt, A, Bm, Cm))
                   + y.numel() * y.element_size() + st.numel() * 4)
        flops = _ssd_flops(BATCH, S, H, P, N, Q)
        b_ms, b_by = bound(n_bytes, flops, BF16_TENSOR_FLOPS)
        args = [(x, dt, A, Bm, Cm)] + [inputs(S, dtype, model_a, init)[:5]
                                       for _ in range(COPIES["prefill"] - 1)]

        def kernel(x, dt, A, Bm, Cm):
            return ops.ssd_scan(x, dt, A, Bm, Cm, chunk=Q)

        def plain(x, dt, A, Bm, Cm):
            return ref.ssd_scan_ref(x, dt, A, Bm, Cm, Q)

        entry.update(
            max_abs_err=err,
            ms=time_ms(kernel, args),
            call_ms=time_ms(kernel, args, device_only=False),
            plain_ms=time_ms(plain, args),
            library_ms=None,   # no single PyTorch call computes an SSD scan
            bound_ms=b_ms, bound_by=b_by, shape=list(x.shape),
            launches_per_call=SSD_LAUNCHES_PER_CALL)
        per_call, us = _kernels_per_call(kernel, args)
        if not any(name.startswith("ssd_") for name in us):
            fail(f"{label}: the trace of the calls holds no ssd_ kernel")
        # Bytes the call allocates beyond its outputs: the workspace.
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        out = kernel(*args[0])
        torch.cuda.synchronize()
        scratch = (torch.cuda.max_memory_allocated() - before
                   - sum(t.numel() * t.element_size() for t in out))
        del out
        executed = _ssd_executed_flops(BATCH, S, H, P, N, Q)
        entry.update(
            cuda_kernels_per_call=per_call, device_us_per_call=us,
            tflops=flops / entry["ms"] / 1e9,
            executed_tflops=executed / entry["ms"] / 1e9,
            bound_share=b_ms / entry["ms"], scratch_bytes=scratch)
        print(f"  time {label}: kernel {entry['ms']:.4f} ms (per call from "
              f"the host {entry['call_ms']:.4f} ms), plain "
              f"{entry['plain_ms']:.4f} ms, library none, bound {b_ms:.4f} ms "
              f"({b_by}, {flops / 1e9:.2f} GFLOP, {n_bytes / 1e6:.1f} MB); "
              f"{entry['tflops']:.1f} TFLOP/s by the bound's count "
              f"({entry['executed_tflops']:.1f} by the {executed / 1e9:.2f} "
              f"GFLOP the tiles execute), "
              f"{100 * entry['bound_share']:.1f}% of the bound; "
              f"{per_call:g} CUDA kernels per call in a trace "
              f"({SSD_LAUNCHES_PER_CALL} counted launch): "
              + ", ".join(f"{k} {v:.1f} us" for k, v in us.items())
              + f"; scratch allocated {scratch / 1e6:.1f} MB")
    return entry


def _grads(fn, inputs: tuple, dout: torch.Tensor, dtype=None) -> tuple:
    """Autograd of ``fn(*inputs)`` against ``dout``, the inputs first cast
    to ``dtype`` (their own where None): the plain version of a backward."""
    xs = tuple((x.detach() if dtype is None else x.detach().to(dtype))
               .requires_grad_(True) for x in inputs)
    return torch.autograd.grad(fn(*xs), xs, dout.to(xs[0].dtype))


def _backward_timer(fn, inputs: tuple, dout: torch.Tensor):
    """A function that runs the backward of one recorded ``fn(*inputs)``
    graph (kept between calls), for timing a plain or library backward."""
    xs = tuple(x.detach().requires_grad_(True) for x in inputs)
    out = fn(*xs)
    return lambda: torch.autograd.grad(out, xs, dout, retain_graph=True)


def _check_grads(label: str, got: tuple, want: tuple, tol: float,
                 names: str) -> float:
    """Each gradient within rtol ``tol`` and ``tol`` times its largest
    entry; returns the largest error."""
    return max(check(f"{label} d{n}", g, w, tol,
                     atol=tol * w.abs().max().item())
               for n, g, w in zip(names, got, want))


def _flash_bwd_entry(cfg, fwd: dict) -> dict:
    """The backward's entry; the forward's train-shape numbers (``*_train``)
    go into ``fwd``, the forward's entry."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    entry = {"name": "flash_attention_bwd", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
             "replaces": "src/repro/kernels/flash_attention.py:86",
             "note": "backward of flash_attention; the TPU kernel is "
                     "forward-only, so this kernel has no TPU counterpart"}

    def plain(q, k, v, window):
        return ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                       v.transpose(1, 2), causal=True,
                                       window=window).transpose(1, 2)

    def plain_lse(q, k, v, window):
        """[B, H, S] fp32 logsumexp of the plain version's scaled, masked
        fp32 scores."""
        S, h, d = q.shape[1], q.shape[2], q.shape[3]
        kx = k.float().repeat_interleave(h // k.shape[2], dim=2)
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kx) / math.sqrt(d)
        qi = torch.arange(S, device=q.device)[:, None]
        kj = torch.arange(S, device=q.device)[None, :]
        mask = (kj <= qi) & ((kj > qi - window) if window else True)
        return torch.logsumexp(s.masked_fill_(~mask, -math.inf), dim=-1)

    # (B, S, H, KV, hd, window, dtype): the train shape, a ragged window, MQA,
    # float32 with GQA and with a window.
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    cases = [(TRAIN_BATCH, TRAIN_SEQ, H, KV, hd, 0, torch.bfloat16),
             (2, 200, H, KV, hd, 32, torch.bfloat16),
             (2, 200, H, 1, hd, 0, torch.bfloat16),
             (2, 200, H, KV, hd, 0, torch.float32),
             (1, 130, 8, 1, 64, 32, torch.float32)]
    for B, S, h, kv, d, window, dtype in cases:
        q, k, v, dout = (torch.randn(B, S, n, d, generator=g, device="cuda")
                         .to(dtype) for n in (h, kv, kv, h))
        label = (f"flash_attention_bwd B{B} S{S} H{h} KV{kv} hd{d} "
                 f"{str(dtype).split('.')[-1]} causal window={window}")
        out, lse = fa.flash_attention(q, k, v, window=window, return_lse=True)
        if not torch.equal(out, fa.flash_attention(q, k, v, window=window)):
            fail(f"{label}: the forward with lse differs from without it")
        check(f"{label} forward out", out, plain(q, k, v, window),
              FLASH_TOL[dtype])
        check(f"{label} forward lse", lse, plain_lse(q, k, v, window), LSE_TOL)
        got = fa.flash_attention_bwd(q, k, v, out, lse, dout, window=window)
        again = fa.flash_attention_bwd(q, k, v, out, lse, dout, window=window)
        if not all(map(torch.equal, got, again)):
            fail(f"{label}: two backward calls on the same inputs differ")
        del again
        want = _grads(lambda q, k, v: plain(q, k, v, window), (q, k, v), dout,
                      torch.float32)
        err = _check_grads(label, got, want, BWD_TOL[dtype], "qkv")
        print(f"  check {label}: a second call's dq, dk, dv bit-equal ok")
        del want
        if (B, S, dtype) != (TRAIN_BATCH, TRAIN_SEQ, torch.bfloat16):
            continue
        # q, k, v, o, dO and lse read once; dq, dk, dv written once; five
        # products of the forward's size (scores, dP, dV, dK, dQ).  The two
        # passes execute seven (S and dP in each): 1.4x this count.
        n_bytes = (sum(t.numel() * t.element_size()
                       for t in (q, k, v, out, dout, q, k, v))
                   + lse.numel() * 4)
        pairs = _flash_pairs(S, S, True, window)
        flops = 10 * B * h * d * pairs
        b_ms, b_by = bound(n_bytes, flops, BF16_TENSOR_FLOPS)
        args = [(q, k, v, out, lse, dout)]
        entry.update(
            max_abs_err=err,
            ms=time_ms(lambda *a: fa.flash_attention_bwd(*a, window=window),
                       args, iters=5, warmup=1),
            plain_ms=time_ms(_backward_timer(
                lambda q, k, v: plain(q, k, v, window), (q, k, v), dout),
                [()], iters=5, warmup=1),
            library_ms=time_ms(_backward_timer(
                lambda q, k, v: F.scaled_dot_product_attention(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    is_causal=True, enable_gqa=True).transpose(1, 2),
                (q, k, v), dout), [()], iters=5, warmup=1),
            bound_ms=b_ms, bound_by=b_by, shape=list(q.shape))
        entry.update(tflops=flops / entry["ms"] / 1e9,
                     executed_tflops=1.4 * flops / entry["ms"] / 1e9,
                     bound_share=b_ms / entry["ms"])
        print(f"  time {label}: kernel {entry['ms']:.3f} ms, plain "
              f"{entry['plain_ms']:.3f} ms, library {entry['library_ms']:.3f} "
              f"ms, bound {b_ms:.4f} ms ({b_by}, {flops / 1e9:.1f} GFLOP, "
              f"{n_bytes / 1e6:.1f} MB); {entry['tflops']:.1f} TFLOP/s by "
              f"the bound's count ({entry['executed_tflops']:.1f} executed), "
              f"{100 * entry['bound_share']:.1f}% of the bound")
        # The forward with lse at this shape, as the train step runs it.
        f_flops = 4 * B * h * d * pairs
        f_ms, f_by = bound(sum(t.numel() * t.element_size()
                               for t in (q, k, v, out)) + lse.numel() * 4,
                           f_flops, BF16_TENSOR_FLOPS)
        fwd.update(
            ms_train=time_ms(
                lambda q, k, v: fa.flash_attention(q, k, v, return_lse=True),
                [(q, k, v)], iters=5, warmup=1),
            library_ms_train=time_ms(
                lambda q, k, v: F.scaled_dot_product_attention(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    is_causal=True, enable_gqa=True), [(q, k, v)], iters=5,
                warmup=1),
            bound_ms_train=f_ms, bound_by_train=f_by,
            shape_train=list(q.shape))
        fwd.update(tflops_train=f_flops / fwd["ms_train"] / 1e9,
                   bound_share_train=f_ms / fwd["ms_train"])
        print(f"  time flash_attention with lse {list(q.shape)}: kernel "
              f"{fwd['ms_train']:.3f} ms, library (SDPA) "
              f"{fwd['library_ms_train']:.3f} ms, bound {f_ms:.4f} ms "
              f"({f_by}); {fwd['tflops_train']:.1f} TFLOP/s, "
              f"{100 * fwd['bound_share_train']:.1f}% of the bound")
    return entry


def _rmsnorm_bwd_entry(cfg) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rn

    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    D, eps = cfg.d_model, cfg.norm_eps
    entry = {"name": "rmsnorm_bwd", "route": "triton",
             "source": "src/repro_torch/kernels/rmsnorm.py",
             "replaces": "src/repro/kernels/rmsnorm.py:25",
             "note": "backward of rmsnorm; the TPU kernel is forward-only, so "
                     "this kernel has no TPU counterpart"}
    cases = [((TRAIN_BATCH, TRAIN_SEQ, D), torch.bfloat16),
             ((3, 100, D), torch.float32), ((7, 256), torch.float32)]
    for shape, dtype in cases:
        x, dy = (torch.randn(*shape, generator=g, device="cuda").to(dtype)
                 for _ in range(2))
        scale = (1 + 0.1 * torch.randn(shape[-1], generator=g,
                                       device="cuda")).to(dtype)
        label = f"rmsnorm_bwd {list(shape)} {str(dtype).split('.')[-1]}"
        got = rn.rmsnorm_bwd(x, scale, dy, eps)
        want = _grads(lambda x, s: ref.rmsnorm_ref(x, s, eps), (x, scale), dy,
                      torch.float32)
        err = _check_grads(label, got, want, BWD_TOL[dtype], ("x", "scale"))
        if shape[:2] != (TRAIN_BATCH, TRAIN_SEQ):
            continue
        # x and dy read, dx written (scale and dscale are 7 KB).
        n = x.numel()
        n_bytes = 3 * n * x.element_size() + 2 * shape[-1] * 2
        b_ms, b_by = bound(n_bytes, 10 * n, FP32_FLOPS)
        entry.update(
            max_abs_err=err,
            ms=time_ms(lambda: rn.rmsnorm_bwd(x, scale, dy, eps), [()]),
            call_ms=time_ms(lambda: rn.rmsnorm_bwd(x, scale, dy, eps), [()],
                            device_only=False),
            plain_ms=time_ms(_backward_timer(
                lambda x, s: ref.rmsnorm_ref(x, s, eps), (x, scale), dy),
                [()]),
            library_ms=time_ms(_backward_timer(
                lambda x, s: F.rms_norm(x, (shape[-1],), s, eps), (x, scale),
                dy), [()]),
            bound_ms=b_ms, bound_by=b_by, shape=list(shape))
        print(f"  time {label}: kernel {entry['ms']:.4f} ms (per call from "
              f"the host {entry['call_ms']:.4f} ms), plain "
              f"{entry['plain_ms']:.4f} ms, library {entry['library_ms']:.4f} "
              f"ms, bound {b_ms:.4f} ms ({b_by}, {n_bytes / 1e6:.1f} MB)")
    return entry


def _ce_entries(cfg) -> list[dict]:
    import torch.nn.functional as F

    from repro_torch.kernels import fused_ce as ce
    from repro_torch.kernels import ref

    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    fwd = {"name": "fused_cross_entropy", "route": "triton",
           "source": "src/repro_torch/kernels/fused_ce.py",
           "replaces": "src/repro/kernels/fused_ce.py:60"}
    bwd = {"name": "fused_cross_entropy_bwd", "route": "triton",
           "source": "src/repro_torch/kernels/fused_ce.py",
           "replaces": "src/repro/kernels/fused_ce.py:60",
           "note": "backward of fused_cross_entropy; the TPU kernel is "
                   "forward-only, so this kernel has no TPU counterpart"}
    T_TRAIN, V = TRAIN_BATCH * TRAIN_SEQ, cfg.vocab_size
    # The train shape, the vocabulary 1000 of tests/test_kernels.py (not a
    # power of two, ragged last block), float32; negative labels in each.
    cases = [(T_TRAIN, V, torch.bfloat16), (300, 1000, torch.bfloat16),
             (300, 1000, torch.float32), (64, V, torch.float32)]
    for T, V_, dtype in cases:
        logits = (2 * torch.randn(T, V_, generator=g, device="cuda")).to(dtype)
        labels = torch.randint(0, V_, (T,), generator=g, device="cuda")
        labels[::7] = -1
        gr = torch.rand(T, generator=g, device="cuda")
        label = f"fused_cross_entropy [{T}, {V_}] {str(dtype).split('.')[-1]}"
        nll, lse = ce.fused_cross_entropy(logits, labels)
        err_f = check(label, nll, ref.cross_entropy_ref(logits, labels),
                      CE_TOL[dtype])
        dx = ce.fused_cross_entropy_bwd(logits, labels, lse, gr)
        (want,) = _grads(lambda x: ref.cross_entropy_ref(x, labels),
                         (logits,), gr, torch.float32)
        err_b = _check_grads(label + " bwd", (dx,), (want,), BWD_TOL[dtype],
                             ("logits",))
        del want
        if (T, V_) != (T_TRAIN, V):
            continue
        n = T * V_
        lab0 = labels.clamp(min=0)    # F.cross_entropy has no label -1
        fb_bytes = n * logits.element_size() + T * (8 + 4 + 4)
        fb_ms, fb_by = bound(fb_bytes, 4 * n, FP32_FLOPS)
        fwd.update(
            max_abs_err=err_f,
            ms=time_ms(ce.fused_cross_entropy, [(logits, labels)], iters=10),
            plain_ms=time_ms(ref.cross_entropy_ref, [(logits, labels)],
                             iters=10),
            library_ms=time_ms(lambda x, y: F.cross_entropy(
                x.float(), y, reduction="none"), [(logits, lab0)], iters=10),
            bound_ms=fb_ms, bound_by=fb_by, shape=[T, V_])
        b_bytes = 2 * n * logits.element_size() + T * (8 + 4 + 4)
        bb_ms, bb_by = bound(b_bytes, 4 * n, FP32_FLOPS)
        bwd.update(
            max_abs_err=err_b,
            ms=time_ms(lambda: ce.fused_cross_entropy_bwd(logits, labels, lse,
                                                          gr), [()], iters=10),
            plain_ms=time_ms(_backward_timer(
                lambda x: ref.cross_entropy_ref(x, labels), (logits,), gr),
                [()], iters=10),
            library_ms=time_ms(_backward_timer(
                lambda x: F.cross_entropy(x.float(), lab0, reduction="none"),
                (logits,), gr), [()], iters=10),
            bound_ms=bb_ms, bound_by=bb_by, shape=[T, V_])
        for e, by in ((fwd, fb_bytes), (bwd, b_bytes)):
            print(f"  time {e['name']} [{T}, {V_}]: kernel {e['ms']:.4f} ms, "
                  f"plain {e['plain_ms']:.4f} ms, library "
                  f"{e['library_ms']:.4f} ms, bound {e['bound_ms']:.4f} ms "
                  f"({e['bound_by']}, {by / 1e9:.3f} GB)")
    return [fwd, bwd]


def phase_kernels(cfg, built: dict[str, dict]) -> list[dict]:
    print("[3/8] kernels against their plain versions")
    fwd = _flash_entry(cfg)
    bwd = _flash_bwd_entry(cfg, fwd)
    fwd["build_hd128"] = {"flash_fwd_bf16_kernel":
                          built["flash_fwd_bf16_kernel"]}
    bwd["build_hd128"] = {k: built[k] for k in ("flash_bwd_dq_bf16_kernel",
                                                "flash_bwd_dkv_bf16_kernel")}
    ssd = _ssd_entry()
    ssd["build_P64_N128"] = {k: built[k] for k in (
        "ssd_cb_kernel", "ssd_chunk_state_kernel", "ssd_chunk_out_kernel")}
    entries = [fwd, bwd, _rmsnorm_entry(cfg), _rmsnorm_bwd_entry(cfg), ssd,
               *_ce_entries(cfg)]
    torch.cuda.empty_cache()
    return entries


def _expected_launches(cfg, steps: int) -> dict[str, int]:
    """Launches of one prefill and ``steps`` decode steps: flash attention
    and the SSD scan on prefill only, RMSNorm on every pass (each layer's
    mixer norm, FFN norm and Mamba gated norm, and the final norm); no
    backward or cross-entropy kernel."""
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import n_units, unit_layout

    layout, U = unit_layout(cfg), n_units(cfg)
    n_attn = U * sum(s["mixer"] == "attn" for s in layout)
    n_mamba = U * sum(s["mixer"] == "mamba" for s in layout)
    n_ffn = U * sum(bool(s["ffn"]) for s in layout)
    return {**dict.fromkeys(ops.KERNELS, 0),
            "flash_attention": n_attn,
            "rmsnorm": (cfg.n_layers + n_ffn + n_mamba + 1) * (1 + steps),
            "ssd_scan": n_mamba * SSD_LAUNCHES_PER_CALL}


def _expected_train_launches(cfg, steps: int) -> dict[str, int]:
    """Launches of ``steps`` train steps of a dense model under per-unit
    activation checkpointing: each layer's flash attention and norms run
    twice forward (the pass and the backward's recompute) and once
    backward, the final norm and the cross-entropy once each way."""
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import n_units, unit_layout

    layout, U = unit_layout(cfg), n_units(cfg)
    n_attn = U * sum(s["mixer"] == "attn" for s in layout)
    n_norms = cfg.n_layers + U * sum(bool(s["ffn"]) for s in layout)
    per_step = {**dict.fromkeys(ops.KERNELS, 0),
                "flash_attention": 2 * n_attn,
                "flash_attention_bwd": n_attn,
                "rmsnorm": 2 * n_norms + 1, "rmsnorm_bwd": n_norms + 1,
                "fused_cross_entropy": 1, "fused_cross_entropy_bwd": 1}
    return {k: v * steps for k, v in per_step.items()}


REFERENCE_MODELS = (  # (arch, smoke overrides, prompt)
    ("qwen2-7b", {"head_dim": 128, "d_model": 256, "n_kv_heads": 2}, 70),
    ("qwen2-7b", {"sliding_window": 32, "n_kv_heads": 2}, 100),
    # the real SSD head sizes; 100 = 64 + a partial chunk of 36
    ("mamba2-370m", {"ssm_head_dim": 64, "ssm_state": 128, "ssm_chunk": 64},
     100),
    ("jamba-1.5-large-398b", {"n_experts": 0}, 70),
)
TRAIN_REFERENCE_MODELS = REFERENCE_MODELS[:2]   # the dense ones


def _to(device):
    return lambda x: x.to(device) if isinstance(x, torch.Tensor) else x


def _loss_grads(model, params, batch: dict, device) -> tuple:
    from repro_torch.tree import leaves

    for p in leaves(params):
        p.requires_grad_(True)
    loss, _ = model.loss(params, {k: torch.from_numpy(v).to(device)
                                  for k, v in batch.items()})
    return torch.autograd.grad(loss, leaves(params))


def _reference_train() -> None:
    """Two float32 qwen2 smoke models: one batch's gradients and three train
    steps on the card (kernels) against the CPU (plain versions), from the
    same parameters."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.tree import tree_map

    for arch, overrides, S in TRAIN_REFERENCE_MODELS:
        cfg = get_config(arch).smoke(**overrides)
        label = f"reference train {cfg.name} {overrides} 2x{S}"
        t_cpu, t_gpu = (train.setup(cfg, steps=REF_TRAIN_STEPS, batch=2,
                                    seq=S, seed=SEED, device=d)
                        for d in ("cpu", "cuda"))
        s_cpu = t_cpu.init()
        s_gpu = tree_map(_to("cuda"), s_cpu)

        batch = t_cpu.pipeline.batch_at(0)
        batch["labels"][0, :5] = -1                  # ignored positions
        g_cpu = _loss_grads(t_cpu.model, s_cpu.params, batch, "cpu")
        ops.reset_launch_counts()
        g_gpu = _loss_grads(t_gpu.model, s_gpu.params, batch, "cuda")
        counts, want = ops.launch_counts(), _expected_train_launches(cfg, 1)
        if counts != want:
            fail(f"{label}: launches of one backward {counts}, expected {want}")
        worst, bad = 0.0, 0
        for gg, gc in zip(g_gpu, g_cpu):
            gg, scale = gg.cpu(), gc.abs().max().item()
            worst = max(worst, (gg - gc).abs().max().item() / max(scale, 1e-30))
            bad += not torch.allclose(gg, gc, rtol=TRAIN_GRAD_TOL,
                                      atol=TRAIN_GRAD_TOL * scale)
        print(f"  check {label} gradients: {len(g_cpu)} leaves, largest error "
              f"{worst:.2e} of the leaf's largest entry, rtol "
              f"{TRAIN_GRAD_TOL:g} {'ok' if not bad else 'MISMATCH'}")
        if bad:
            fail(f"{label}: {bad} gradient leaves disagree with the CPU")

        ops.reset_launch_counts()
        for step in range(REF_TRAIN_STEPS):
            b = t_cpu.pipeline.batch_at(step)
            s_cpu, m_cpu = t_cpu.train_step(s_cpu, b)
            s_gpu, m_gpu = t_gpu.train_step(s_gpu, b)
            lc, lg = float(m_cpu["loss"]), float(m_gpu["loss"])
            ok = abs(lc - lg) <= TRAIN_LOSS_TOL
            print(f"  check {label} step {step}: loss card {lg:.6f} cpu "
                  f"{lc:.6f} |diff| {abs(lc - lg):.2e} "
                  f"{'ok' if ok else 'MISMATCH'}")
            if not ok:
                fail(f"{label}: losses differ at step {step}")
        counts = ops.launch_counts()
        want = _expected_train_launches(cfg, REF_TRAIN_STEPS)
        if counts != want:
            fail(f"{label}: launches {counts}, expected {want}")


def _reference_loop() -> None:
    """The train loop on the card at smoke size: three steps, a checkpoint,
    and a resumed run to six, against six uninterrupted steps."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.train import loop

    arch, overrides, S = TRAIN_REFERENCE_MODELS[0]
    cfg = get_config(arch).smoke(**overrides)
    t = train.setup(cfg, steps=6, batch=2, seq=S, seed=SEED, device="cuda")
    with tempfile.TemporaryDirectory() as d:
        def run(total: int, sub: str):
            return loop.run(t.train_step, t.init, t.pipeline.batch_at,
                            loop.LoopConfig(total_steps=total, ckpt_every=3,
                                            ckpt_dir=f"{d}/{sub}"))
        whole = run(6, "whole")
        first = run(3, "resumed")
        second = run(6, "resumed")
    if (first.final_step, second.resumed_from, second.steps_run) != (3, 3, 3):
        fail(f"loop resume: first run to {first.final_step}, second resumed "
             f"from {second.resumed_from} and ran {second.steps_run} steps")
    resumed = first.losses + second.losses
    diff = max(abs(a - b) for a, b in zip(resumed, whole.losses))
    ok = len(resumed) == 6 and diff <= 1e-6 * max(whole.losses)
    print(f"  check loop on the card {cfg.name}: resumed at step 3 from its "
          f"checkpoint, losses {['%.6f' % x for x in resumed]} against an "
          f"uninterrupted run's: max |diff| {diff:.2e} (bitwise equal: "
          f"{resumed == whole.losses}) {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail("the resumed loop's losses differ from an uninterrupted run's")


def phase_reference() -> None:
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import get_model
    from repro_torch.tree import tree_map

    print("[4/8] reference: float32 models on the card vs the CPU")
    for arch, overrides, S in REFERENCE_MODELS:
        cfg = get_config(arch).smoke(**overrides)
        cpu, gpu = get_model(cfg, device="cpu"), get_model(cfg, device="cuda")
        p_cpu = cpu.init(SEED)
        p_gpu = tree_map(_to("cuda"), p_cpu)
        tokens = torch.randint(0, cfg.vocab_size, (2, S),
                               generator=torch.Generator().manual_seed(SEED))
        max_seq = S + 4
        lc, cc = cpu.prefill(p_cpu, {"tokens": tokens}, max_seq)
        ops.reset_launch_counts()
        lg, cg = gpu.prefill(p_gpu, {"tokens": tokens.cuda()}, max_seq)
        counts, want = ops.launch_counts(), _expected_launches(cfg, 0)
        if counts != want:
            fail(f"{cfg.name} prefill launches {counts}, expected {want}")
        for step in range(4):
            check(f"reference {cfg.name} {overrides} S={S} step {step} "
                  "logits", lg.cpu(), lc, REF_LOGIT_TOL)
            tc, tg = lc.argmax(-1, keepdim=True), lg.argmax(-1, keepdim=True)
            if not torch.equal(tc, tg.cpu()):
                fail(f"{cfg.name}: greedy tokens differ at step {step}")
            lc, cc = cpu.decode(p_cpu, tc, cc)
            lg, cg = gpu.decode(p_gpu, tg, cg)
    _reference_train()
    _reference_loop()


def phase_serve(arch: str, prompt: int) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import get_model
    from repro_torch.tree import leaves

    cfg = get_config(arch)
    print(f"[5/8] serve {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.dtype}, batch {BATCH}, prompt {prompt}, "
          f"gen {GEN}")
    model = get_model(cfg, device="cuda")
    t0 = time.perf_counter()
    params = model.init(SEED)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in leaves(params))
    print(f"  init {n_params / 1e9:.3f} B parameters on the card in "
          f"{time.perf_counter() - t0:.2f} s")
    tokens = serve.prompt_tokens(cfg.vocab_size, BATCH, prompt, SEED, "cuda")
    serve.generate(model, params, tokens, 2)       # warm-up: cuBLAS, allocator

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    r = serve.generate(model, params, tokens, GEN)
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()

    steps = r["decode_steps"]
    stats = {"prompt": prompt,
             "prefill_ms": r["prefill_s"] * 1e3,
             "decode_ms_per_step": r["decode_s"] * 1e3 / steps,
             "decode_tok_s": BATCH * steps / r["decode_s"],
             "peak_mem_gb": peak / 1e9, "launches": counts}
    print(f"  prefill {BATCH}x{prompt}: {stats['prefill_ms']:.2f} ms")
    print(f"  decode: {steps} steps, {stats['decode_ms_per_step']:.3f} ms/step, "
          f"{stats['decode_tok_s']:.1f} tok/s")
    print(f"  peak memory {stats['peak_mem_gb']:.2f} GB; launches {counts}")

    # Flash attention and the SSD scan launch on prefill only, so their
    # totals equal one prefill's: none ran in decode.
    want = _expected_launches(cfg, steps)
    if counts != want:
        fail(f"launch counts {counts}, the path implies {want}")
    seq = r["tokens"]
    if seq.shape != (BATCH, GEN):
        fail(f"tokens shape {tuple(seq.shape)}")
    if not bool(r["finite"]):
        fail("non-finite logits")
    if not bool(((seq >= 0) & (seq < cfg.vocab_size)).all()):
        fail("token ids out of range")
    print(f"  tokens[0, :8] = {seq[0, :8].tolist()}")
    return stats


def _train_model_flops(cfg, n_params: int, embed: int) -> tuple[float, float]:
    """Model FLOPs of one train step: 6 per parameter (all but the input
    embedding, a gather) per token, and three times the forward's causal
    attention (4 * B * H * hd per visible query-key pair per layer).
    Returns (total, attention)."""
    tokens = TRAIN_BATCH * TRAIN_SEQ
    attn = 3 * cfg.n_layers * 4 * TRAIN_BATCH * cfg.n_heads * cfg.hd * (
        _flash_pairs(TRAIN_SEQ, TRAIN_SEQ, True, cfg.sliding_window))
    return 6 * (n_params - embed) * tokens + attn, attn


def phase_train() -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import profile_serve, train
    from repro_torch.tree import leaves, tree_map

    full = get_config("qwen2-7b")
    cfg = dataclasses.replace(full, n_layers=TRAIN_LAYERS)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    print(f"[6/8] train {cfg.name}: {cfg.n_layers} of {full.n_layers} layers, "
          f"d_model {cfg.d_model}, vocab {cfg.vocab_size}, {cfg.dtype}, batch "
          f"{TRAIN_BATCH} x seq {TRAIN_SEQ}, AdamW, {TRAIN_STEPS} timed steps")
    t = train.setup(cfg, steps=TRAIN_STEPS + 2, batch=TRAIN_BATCH,
                    seq=TRAIN_SEQ, seed=SEED, device="cuda")
    t0 = time.perf_counter()
    state = t.init()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in leaves(state.params))
    print(f"  init {n_params / 1e9:.3f} B parameters and fp32 moments on the "
          f"card in {time.perf_counter() - t0:.2f} s")
    batches = [t.pipeline.batch_at(i) for i in range(TRAIN_STEPS + 2)]
    t0 = time.perf_counter()
    state, m = t.train_step(state, batches[0])       # warm-up: cuBLAS, allocator
    losses = [float(m["loss"])]
    print(f"  warm-up step {time.perf_counter() - t0:.2f} s, loss "
          f"{losses[0]:.4f}")

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    step_s = []
    for b in batches[1:TRAIN_STEPS + 1]:
        t0 = time.perf_counter()
        state, m = t.train_step(state, b)
        losses.append(float(m["loss"]))              # waits for the step
        step_s.append(time.perf_counter() - t0)
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()

    def traced_step():
        nonlocal state
        state, m = t.train_step(state, batches[-1])
        losses.append(float(m["loss"]))

    trace = profile_serve.profile(traced_step)
    # The optimizer alone (per-leaf fp32 updates in plain torch), on zero
    # gradients, after the measured steps.
    grads = tree_map(torch.zeros_like, state.params)
    adamw_ms = time_ms(lambda: t.optimizer.update(
        grads, state.opt, state.params, t.model.decays), [()], iters=2,
        warmup=1)
    flops, attn_flops = _train_model_flops(cfg, n_params,
                                           state.params["embed"].numel())
    ms = 1e3 * sum(step_s) / len(step_s)
    stats = {"arch": cfg.name, "n_layers": cfg.n_layers,
             "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
             "params_b": n_params / 1e9,
             "ms_per_step": ms, "step_ms": [1e3 * x for x in step_s],
             "tokens_per_s": tokens / (ms / 1e3),
             "model_tflop_per_step": flops / 1e12,
             "attention_tflop_per_step": attn_flops / 1e12,
             "share_of_bf16_peak": flops / (ms / 1e3) / BF16_TENSOR_FLOPS,
             "peak_mem_gb": peak / 1e9, "losses": losses,
             "adamw_update_ms": adamw_ms,
             "traced_step": trace, "launches": counts}
    print(f"  {ms:.1f} ms/step ({', '.join(f'{x:.1f}' for x in stats['step_ms'])}),"
          f" {stats['tokens_per_s']:.0f} tokens/s")
    print(f"  model FLOPs {flops / 1e12:.1f} TFLOP/step (attention "
          f"{attn_flops / 1e12:.2f}), {100 * stats['share_of_bf16_peak']:.1f}%"
          f" of the 989 TFLOP/s bf16 peak")
    print(f"  peak memory {peak / 1e9:.2f} GB; losses "
          f"{['%.4f' % x for x in losses]}")
    print(f"  traced step: wall {trace['wall_ms']:.1f} ms, device busy "
          f"{trace['device_busy_ms']:.1f} ms, idle share "
          f"{trace['idle_share']:.3f}, {trace['kernels']} kernels; by group "
          + ", ".join(f"{k} {v:.1f} ms"
                      for k, v in trace["device_ms_by_group"].items()))
    print(f"  AdamW update alone (CUDA events): {adamw_ms:.1f} ms")
    print(f"  launches over the timed steps {counts}")
    want = _expected_train_launches(cfg, TRAIN_STEPS)
    if counts != want:
        fail(f"train launch counts {counts}, the path implies {want}")
    if not all(map(math.isfinite, losses)):
        fail(f"non-finite train loss {losses}")
    return stats


def _lane_diff(a, b) -> float:
    """Largest |difference| of two lanes' per-job JCT/CCT and makespans."""
    if set(a.jct) != set(b.jct) or set(a.cct) != set(b.cct):
        fail("lanes with different jobs")
    return max([abs(a.makespan - b.makespan)]
               + [abs(a.jct[n] - b.jct[n]) for n in b.jct]
               + [abs(a.cct[n] - b.cct[n]) for n in b.cct])


def _engine_row(scenario: str, topology: str, lanes: list) -> tuple[dict, list]:
    from repro_torch.core import simtorch

    walls, reads = [], []
    for _ in range(2):                      # cold, then warm
        torch.cuda.synchronize()
        before = simtorch.sync_count()
        t0 = time.perf_counter()
        card = simtorch.run_fifo_batch(
            lanes, steps_per_sync=ENGINE_STEPS_PER_SYNC, device="cuda")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        reads.append(simtorch.sync_count() - before)
    t0 = time.perf_counter()
    cpu = simtorch.run_fifo_batch(
        lanes, steps_per_sync=ENGINE_STEPS_PER_SYNC, device="cpu")
    cpu_wall = time.perf_counter() - t0
    for i, (a, b) in enumerate(zip(card, cpu)):
        if a.events != b.events:
            fail(f"engine {scenario}@{topology} lane {i}: {a.events} events "
                 f"on the card, {b.events} on the CPU")
    diff = max(_lane_diff(a, b) for a, b in zip(card, cpu))
    if not diff <= ENGINE_TOL:
        fail(f"engine {scenario}@{topology}: card lanes differ from the CPU "
             f"by {diff:.3e} > {ENGINE_TOL:g}")
    events = max(r.events for r in card)
    steps = -(-events // ENGINE_STEPS_PER_SYNC) * ENGINE_STEPS_PER_SYNC
    row = {"scenario": scenario, "topology": topology, "lanes": len(lanes),
           "flows_padded": max(p.flow_node.size for p in lanes),
           "max_lane_events": events, "steps_run": steps,
           "card_cold_s": walls[0], "card_warm_s": walls[1],
           "card_warm_ms_per_step": 1e3 * walls[1] / steps,
           "cpu_s": cpu_wall, "host_reads_per_run": reads[1],
           "max_abs_diff_vs_cpu": diff}
    print(f"  {scenario}@{topology}: {len(lanes)} lanes, {row['flows_padded']}"
          f" flows padded, {events} events ({steps} steps); card cold "
          f"{walls[0]:.3f} s, warm {walls[1]:.3f} s "
          f"({row['card_warm_ms_per_step']:.2f} ms/step), CPU {cpu_wall:.3f} s;"
          f" {reads[1]} host reads; max |diff| vs CPU {diff:.3e}")
    return row, cpu


def phase_engine() -> list[dict]:
    from repro_torch.appdag import SCENARIO_TOPOLOGY, SCENARIOS, build_scenario
    from repro_torch.core import simtorch
    from repro_torch.experiments import run_cells_batched
    from repro_torch.launch import profile_serve

    cases = [(name, SCENARIO_TOPOLOGY.get(name, "big_switch"))
             for name in sorted(SCENARIOS)] + list(ENGINE_EXTRA)
    print(f"[7/8] engine: fifo lockstep batches of {ENGINE_SEEDS} seeds at "
          f"full size, card vs CPU (float64)")
    rows, cpu_lanes, packed = [], {}, {}
    for scenario, topology in cases:
        lanes = [simtorch.pack_instance(*build_scenario(
                     scenario, seed=s, topology=topology))
                 for s in range(ENGINE_SEEDS)]
        row, cpu_lanes[scenario, topology] = _engine_row(scenario, topology,
                                                         lanes)
        rows.append(row)
        packed[scenario, topology] = lanes

    # The entry point a sweep calls: every cell above, grouped and batched.
    @dataclasses.dataclass(frozen=True)
    class Cell:
        scenario: str
        policy: str
        topology: str
        seed: int
        fault_intensity: float = 0.0

    cells = [Cell(sc, "fifo", topo, s) for sc, topo in cases
             for s in range(ENGINE_SEEDS)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    recs = run_cells_batched(cells, device="cuda")
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    worst = 0.0
    for cell, rec in zip(cells, recs):
        lane = cpu_lanes[cell.scenario, cell.topology][cell.seed]
        res = rec["result"]
        if (rec["engine"], rec["seed"], rec["scenario"], rec["topology"]) != (
                "simtorch", cell.seed, cell.scenario, cell.topology):
            fail(f"run_cells_batched record out of order: {rec}")
        if res["events"] != lane.events:
            fail(f"run_cells_batched {cell}: {res['events']} events, the CPU "
                 f"lane {lane.events}")
        worst = max(worst, abs(res["makespan"] - lane.makespan),
                    *(abs(res["jct"][n] - lane.jct[n]) for n in lane.jct),
                    *(abs(res["cct"][n] - lane.cct[n]) for n in lane.cct))
    if not worst <= ENGINE_TOL:
        fail(f"run_cells_batched on the card differs from the CPU lanes by "
             f"{worst:.3e}")
    print(f"  run_cells_batched: {len(cells)} cells in {len(cases)} batches "
          f"on the card in {sweep_s:.3f} s (building included); max |diff| "
          f"vs the CPU lanes {worst:.3e}")

    lanes = packed["pipe_serve", "big_switch"]
    trace = profile_serve.profile(lambda: simtorch.run_fifo_batch(
        lanes, steps_per_sync=ENGINE_STEPS_PER_SYNC, device="cuda"))
    row = next(r for r in rows if r["scenario"] == "pipe_serve")
    row["traced_run"] = trace
    row["kernels_per_step"] = trace["kernels"] / row["steps_run"]
    print(f"  traced warm pipe_serve batch: wall {trace['wall_ms']:.1f} ms, "
          f"device busy {trace['device_busy_ms']:.1f} ms, idle share "
          f"{trace['idle_share']:.3f}, {trace['kernels']} kernels "
          f"({row['kernels_per_step']:.1f} per lockstep step) and "
          f"{trace['copies']} copies")
    return rows


def main() -> None:
    phase_device()
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import get_config

    built = phase_build()
    kernels = phase_kernels(get_config("qwen2-7b"), built)
    phase_reference()
    serves = {arch: phase_serve(arch, prompt) for arch, prompt in SERVES}
    torch.cuda.empty_cache()
    train_stats = phase_train()
    engine = phase_engine()
    paths = {**{f"serve {arch}": st["launches"] for arch, st in serves.items()},
             f"train {train_stats['arch']}": train_stats["launches"]}
    for entry in kernels:
        by_path = {path: counts[entry["name"]] for path, counts in paths.items()}
        if not any(by_path.values()):
            fail(f"{entry['name']} launched on no main path")
        entry["launches"] = sum(by_path.values())
        entry["launches_by_path"] = by_path
    print("[8/8] summary")
    print(json.dumps({"serve": serves}))
    print(json.dumps({"train": train_stats}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"engine": engine}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
