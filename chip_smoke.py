#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from a checkout of the repository; it needs one CUDA card and nvcc
(``/usr/local/cuda``) and builds every kernel from the sources in
``src/repro_torch``.  Phases, each printing its own lines:

1. device    -- the card's name and power limit (nvidia-smi), torch versions;
2. build     -- nvcc for each CUDA source (all started together), Triton
                JIT, build seconds, ptxas register and spill lines;
3. kernels   -- each kernel against its plain PyTorch version on the card at
                the serving shapes, with the stated tolerance; kernel, plain
                and library times (CUDA events) beside the card's bound;
4. reference -- small float32 models served on the card (kernels) against
                the same models on the CPU (plain versions): equal greedy
                tokens, logits within 1e-3 (dense qwen2, Mamba-2 with the
                real SSD head sizes at a ragged prompt, the jamba hybrid
                without experts);
5. serve     -- through ``repro_torch.launch.serve``: qwen2-7b at full width
                (28 layers, bf16, batch 4, prompt 512, 32 tokens), then
                mamba2-370m at full width and depth (48 layers, bf16, batch
                4, prompt 2048, 32 tokens), each with the kernels' launch
                counts zeroed just before its run and read just after;
6. the ``{"kernels": [...]}`` summary line, then the ``{"ok": true, ...}``
   line.

Any failed check raises, so the script exits non-zero and prints no result
line.  Weights are random, drawn on the card from a fixed seed.
"""

from __future__ import annotations

import json
import subprocess
import sys
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
SSD_LAUNCHES_PER_CALL = 1
REF_LOGIT_TOL = 1e-3  # float32 model, card vs CPU, a few layers
# Copies of a timed kernel's inputs: four prefill-sized sets exceed the L2.
COPIES = {"prefill": 4, "decode": 1}


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
    print("[1/6] device")
    print(smi)
    print(f"  torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} "
          f"device0 {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    return smi


def phase_build() -> float:
    from repro_torch.kernels import build, ops

    print("[2/6] build")
    t0 = time.perf_counter()
    logs = build.build()
    t_nvcc = time.perf_counter() - t0
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    x = torch.ones(1, 3584, device="cuda", dtype=torch.bfloat16)
    ops.rmsnorm(x, x[0], 1e-6)       # Triton JIT at the model width
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    print(f"  build_s={total:.2f} (nvcc {t_nvcc:.2f}, triton "
          f"{total - t_nvcc:.2f})")
    return total


def _rmsnorm_entry(cfg) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    g = torch.Generator(device="cuda").manual_seed(SEED)
    D, eps = cfg.d_model, cfg.norm_eps
    scale = (1 + 0.1 * torch.randn(D, generator=g, device="cuda")).bfloat16()
    entry = {"name": "rmsnorm", "route": "triton",
             "source": "src/repro_torch/kernels/rmsnorm.py",
             "replaces": "src/repro/kernels/rmsnorm.py:25"}
    for rows, key in (((BATCH, PROMPT), "prefill"), ((BATCH, 1), "decode")):
        x = torch.randn(*rows, D, generator=g, device="cuda").bfloat16()
        err = check(f"rmsnorm {key} {list(x.shape)} bf16",
                    ops.rmsnorm(x, scale, eps), ref.rmsnorm_ref(x, scale, eps),
                    RMSNORM_TOL)
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
        print(f"  time {label}: kernel {entry['ms']:.4f} ms (per call from "
              f"the host {entry['call_ms']:.4f} ms), plain "
              f"{entry['plain_ms']:.4f} ms, library {entry['library_ms']:.4f} "
              f"ms, bound {b_ms:.4f} ms ({b_by}, {flops / 1e9:.2f} GFLOP, "
              f"{n_bytes / 1e6:.1f} MB)")
    return entry


def _ssd_flops(B: int, S: int, H: int, P: int, N: int, chunk: int) -> int:
    """Operations of one call: C.B^T once per (row, chunk) since B and C are
    shared by the heads, its causal half and diagonal; the decayed scores
    times x*dt per head; the carried-state term and the state update."""
    pairs = sum(q * (q + 1) // 2
                for q in (min(chunk, S - c0) for c0 in range(0, S, chunk)))
    return 2 * B * pairs * (N + H * P) + 4 * B * H * S * N * P


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
    # serve shape, two ragged lengths (a partial chunk), float32 with the
    # tests' A, and a nonzero initial state.
    cases = [(S_SERVE, torch.bfloat16, True, False),
             (200, torch.bfloat16, True, False),
             (300, torch.bfloat16, True, False),
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
        print(f"  time {label}: kernel {entry['ms']:.4f} ms (per call from "
              f"the host {entry['call_ms']:.4f} ms), plain "
              f"{entry['plain_ms']:.4f} ms, library none, bound {b_ms:.4f} ms "
              f"({b_by}, {flops / 1e9:.2f} GFLOP, {n_bytes / 1e6:.1f} MB)")
    return entry


def phase_kernels(cfg) -> list[dict]:
    print("[3/6] kernels against their plain versions")
    return [_flash_entry(cfg), _rmsnorm_entry(cfg), _ssd_entry()]


def _expected_launches(cfg, steps: int) -> dict[str, int]:
    """Launches of one prefill and ``steps`` decode steps: flash attention
    and the SSD scan on prefill only, RMSNorm on every pass (each layer's
    mixer norm, FFN norm and Mamba gated norm, and the final norm)."""
    from repro_torch.models.transformer import n_units, unit_layout

    layout, U = unit_layout(cfg), n_units(cfg)
    n_attn = U * sum(s["mixer"] == "attn" for s in layout)
    n_mamba = U * sum(s["mixer"] == "mamba" for s in layout)
    n_ffn = U * sum(bool(s["ffn"]) for s in layout)
    return {"flash_attention": n_attn,
            "rmsnorm": (cfg.n_layers + n_ffn + n_mamba + 1) * (1 + steps),
            "ssd_scan": n_mamba * SSD_LAUNCHES_PER_CALL}


REFERENCE_MODELS = (  # (arch, smoke overrides, prompt)
    ("qwen2-7b", {"head_dim": 128, "d_model": 256, "n_kv_heads": 2}, 70),
    ("qwen2-7b", {"sliding_window": 32, "n_kv_heads": 2}, 100),
    # the real SSD head sizes; 100 = 64 + a partial chunk of 36
    ("mamba2-370m", {"ssm_head_dim": 64, "ssm_state": 128, "ssm_chunk": 64},
     100),
    ("jamba-1.5-large-398b", {"n_experts": 0}, 70),
)


def phase_reference() -> None:
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import get_model

    print("[4/6] reference: float32 models on the card vs the CPU")
    for arch, overrides, S in REFERENCE_MODELS:
        cfg = get_config(arch).smoke(**overrides)
        cpu, gpu = get_model(cfg, device="cpu"), get_model(cfg, device="cuda")
        p_cpu = cpu.init(SEED)
        p_gpu = _tree_map(lambda t: t.cuda(), p_cpu)
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


def phase_serve(arch: str, prompt: int) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import get_model

    cfg = get_config(arch)
    print(f"[5/6] serve {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.dtype}, batch {BATCH}, prompt {prompt}, "
          f"gen {GEN}")
    model = get_model(cfg, device="cuda")
    t0 = time.perf_counter()
    params = model.init(SEED)
    torch.cuda.synchronize()
    n_params = sum(_leaves(_tree_map(lambda t: t.numel(), params)))
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


def _tree_map(fn, tree):
    """``fn`` on every tensor of a parameter tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, list):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


def main() -> None:
    phase_device()
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import get_config

    phase_build()
    kernels = phase_kernels(get_config("qwen2-7b"))
    phase_reference()
    serves = {arch: phase_serve(arch, prompt) for arch, prompt in SERVES}
    for entry in kernels:
        by_path = {arch: st["launches"][entry["name"]]
                   for arch, st in serves.items()}
        if not any(by_path.values()):
            fail(f"{entry['name']} launched on no serve path")
        entry["launches"] = sum(by_path.values())
        entry["launches_by_path"] = by_path
    print("[6/6] summary")
    print(json.dumps({"serve": serves}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
