"""Launchers for the CUDA flash-attention kernels: the forward
(``csrc/flash_attention.cu``) and its backward (``csrc/flash_attention_bwd.cu``).

The forward replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``flash_attention`` / ``_flash_kernel``).  It reads the model layout
q [B, Sq, H, hd], k/v [B, Sk, KV, hd] through strides, handles any sequence
length, and returns [B, Sq, H, hd] in q's dtype, plus the rows' fp32
log-sum-exp when asked.  The backward, which has no TPU counterpart (JAX
differentiates its jnp attention), takes that log-sum-exp and returns dq,
dk, dv for self-attention (Sq == Sk) and for cross-attention without the
causal mask (Sq != Sk).  Their plain version is
``repro_torch.kernels.ref.flash_attention_ref`` and autograd through it;
``ops.flash_attention`` picks between the two by the device of the tensors.

Each C entry point picks its kernel by dtype: bfloat16 runs on the tensor
cores (``wgmma`` on bf16 tiles in shared memory loaded by ``cp.async``),
which copy rows in 16-byte chunks, so a bfloat16 tensor needs a 16-byte
aligned base and batch, sequence and head strides in multiples of 8 elements
(``_check`` raises otherwise); float32 runs the CUDA-core kernels, since TF32
products would not hold float32's tolerance.  Nothing falls back from one to
the other.  The tile walks of the bf16 kernels are mirrored below
(``key_tiles``, ``query_tiles``, ``tile_needs_mask``) for the CPU tests.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 64, 128)
# Tiles of the bf16 kernels, as (rows per block, rows per streamed tile):
# the forward's query rows and key tile (Bf16Fwd in csrc/flash_attention.cu);
# the backward's dQ pass (query rows, key tile) and dK/dV pass (key rows,
# query tile) (Bf16Bwd in csrc/flash_attention_bwd.cu).
FWD_TILES = (128, 128)
BWD_DQ_TILES = (128, 128)
BWD_DKV_TILES = (128, 64)

#: Kernel launches in this process (forward, backward);
#: ``ops.reset_launch_counts`` zeroes them.  One backward launch runs two
#: grids, the dQ pass and then the dK/dV pass.
launches = 0
bwd_launches = 0

# C entry point -> (source in csrc/, pointer arguments, int shape arguments):
# the forward takes q, k, v, o, lse and B, H, KV, Sq, Sk, head_dim; the
# backward q, k, v, o, dout, lse, delta, dq, dk, dv and B, H, KV, Sq, Sk,
# head_dim.
_ENTRY_POINTS = {"flash_attention_fwd": ("flash_attention", 5, 6),
                 "flash_attention_bwd": ("flash_attention_bwd", 10, 6)}
_fns: dict = {}


def _kernel(entry: str = "flash_attention_fwd"):
    """The C entry point ``entry``, its library loaded (built) on first use."""
    if entry not in _fns:
        source, n_ptrs, n_ints = _ENTRY_POINTS[entry]
        fn = getattr(build.load(source), entry)
        # dtype, pointers, shape, strides, scale, causal, window, stream
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * n_ptrs
                       + [ctypes.c_int] * n_ints
                       + [ctypes.POINTER(ctypes.c_int64), ctypes.c_float,
                          ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[entry] = fn
    return _fns[entry]


def key_tiles(q0: int, bq: int, bk: int, Sq: int, Sk: int, causal: bool,
              window: int) -> range:
    """Key tiles of ``bk`` rows that hold a live key of query rows
    ``[q0, q0 + bq)``, as ``Mask::key_tiles`` in ``csrc/flash_mma.cuh``
    walks them (queries right-aligned at offset ``Sk - Sq``)."""
    off = Sk - Sq
    q_last = min(q0 + bq, Sq) - 1
    k_lo = max(0, q0 + off - window + 1) if window else 0
    k_hi = min(Sk - 1, q_last + off) if causal else Sk - 1
    lo = k_lo // bk
    return range(lo, k_hi // bk + 1 if k_hi >= k_lo else lo)


def query_tiles(k0: int, bk: int, bq: int, Sq: int, Sk: int, causal: bool,
                window: int) -> range:
    """Query tiles of ``bq`` rows holding a row that sees a key of
    ``[k0, k0 + bk)``, as ``Mask::query_tiles`` walks them (the dK/dV pass;
    queries right-aligned at offset ``Sk - Sq``)."""
    off = Sk - Sq
    k_last = min(k0 + bk, Sk) - 1
    q_lo = max(0, k0 - off) if causal else 0
    q_hi = min(Sq - 1, k_last - off + window - 1) if window else Sq - 1
    lo = q_lo // bq
    return range(lo, q_hi // bq + 1 if q_hi >= q_lo else lo)


def tile_needs_mask(q0: int, bq: int, k0: int, bk: int, Sq: int, Sk: int,
                    causal: bool, window: int) -> bool:
    """Whether query rows ``[q0, q0 + bq)`` x keys ``[k0, k0 + bk)`` hold a
    pair that is not live, so the kernel applies its per-element mask
    (``Mask::needs_mask``); the other visited tiles skip it."""
    off = Sk - Sq
    q_last = min(q0 + bq, Sq) - 1
    return (k0 + bk > Sk or q0 + bq > Sq
            or (causal and k0 + bk - 1 > q0 + off)
            or bool(window and k0 <= q_last + off - window))


def _check_aligned(name: str, t: torch.Tensor) -> None:
    """The bf16 kernels copy rows in 16-byte chunks (``cp.async``)."""
    if t.dtype == torch.bfloat16 and (
            t.data_ptr() % 16
            or any(st % 8 for n, st in zip(t.shape[:3], t.stride()[:3])
                   if n > 1)):
        raise ValueError(f"flash_attention: bfloat16 {name} needs 16-byte "
                         f"aligned rows (base pointer, and batch, sequence "
                         f"and head strides in multiples of 8 elements), got "
                         f"pointer {t.data_ptr():#x} strides {t.stride()}")


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: int) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"flash_attention: {name} must be a CUDA tensor "
                             f"on {q.device}, got {t.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} is {t.dtype}, "
                             f"q is {q.dtype}")
        if t.ndim != 4:
            raise ValueError(f"flash_attention: {name} must be 4-D "
                             f"[B, S, heads, hd], got {tuple(t.shape)}")
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name} needs a contiguous "
                             f"head_dim, got strides {t.stride()}")
    if q.dtype not in DTYPES:
        raise ValueError(f"flash_attention: dtype {q.dtype} not in "
                         f"{tuple(DTYPES)}")
    B, Sq, H, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in {HEAD_DIMS}")
    KV = k.shape[2]
    if H % KV:
        raise ValueError(f"H={H} not divisible by KV={KV}")
    if Sq == 0 or k.shape[1] == 0 or B == 0:
        raise ValueError("flash_attention: empty batch or sequence")
    if window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_aligned(name, t)


def _strides(*tensors: torch.Tensor):
    """The (batch, sequence, head) strides of each tensor, as a C array."""
    flat = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_int64 * len(flat))(*flat)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    return_lse: bool = False):
    """Launch the kernel on the current stream: q [B,Sq,H,hd], k/v
    [B,Sk,KV,hd] CUDA tensors -> [B,Sq,H,hd], or with ``return_lse`` (out,
    lse [B,H,Sq] fp32) for the backward.  Raises ``ValueError`` on any input
    the kernel does not take and ``RuntimeError`` if the launch fails."""
    global launches
    _check(q, k, v, window)
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                out.data_ptr(), None if lse is None else lse.data_ptr(),
                B, H, KV, Sq, Sk, hd, _strides(q, k, v, out),
                1.0 / math.sqrt(hd), int(causal), int(window), stream)
    if rc:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error {rc}")
    launches += 1
    return (out, lse) if return_lse else out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True,
                        window: int = 0):
    """Launch the backward on the current stream: the forward's inputs, its
    output ``out`` and ``lse`` (from ``return_lse``), and the upstream
    gradient ``dout`` [B,Sq,H,hd] -> (dq, dk, dv) shaped and typed like q,
    k, v.  A causal mask needs Sq == Sk (``ValueError`` otherwise); without
    one Sk may differ from Sq."""
    global bwd_launches
    _check(q, k, v, window)
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if causal and Sk != Sq:
        raise ValueError(f"flash_attention_bwd: a causal mask needs Sq == Sk, "
                         f"got Sq={Sq} Sk={Sk}")
    for name, t in (("out", out), ("dout", dout)):
        if (t.shape != q.shape or t.dtype != q.dtype or t.device != q.device
                or t.stride(-1) != 1):
            raise ValueError(f"flash_attention_bwd: {name} must be like q "
                             f"{tuple(q.shape)} {q.dtype} with a contiguous "
                             f"head_dim, got {tuple(t.shape)} {t.dtype} "
                             f"strides {t.stride()}")
        _check_aligned(name, t)
    if (lse.shape != (B, H, Sq) or lse.dtype != torch.float32
            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError(f"flash_attention_bwd: lse must be a contiguous "
                         f"[{B}, {H}, {Sq}] float32 tensor, got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    fn = _kernel("flash_attention_bwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                B, H, KV, Sq, Sk, hd,
                _strides(q, k, v, out, dout, dq, dk, dv),
                1.0 / math.sqrt(hd), int(causal), int(window), stream)
    if rc:
        raise RuntimeError(f"flash_attention_bwd launch failed: CUDA error {rc}")
    bwd_launches += 1
    return dq, dk, dv
