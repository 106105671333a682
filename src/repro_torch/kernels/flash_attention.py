"""Launcher for the CUDA flash-attention kernel (``csrc/flash_attention.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``flash_attention`` / ``_flash_kernel``).  The kernel reads the model layout
q [B, Sq, H, hd], k/v [B, Sk, KV, hd] through strides, handles any sequence
length, and returns [B, Sq, H, hd] in q's dtype.  Its plain version is
``repro_torch.kernels.ref.flash_attention_ref``; ``ops.flash_attention``
picks between the two by the device of the tensors.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 64, 128)

#: Kernel launches in this process; ``ops.reset_launch_counts`` zeroes it.
launches = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("flash_attention").flash_attention_fwd
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.POINTER(ctypes.c_int64),
                       ctypes.c_float, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Launch the kernel on the current stream: q [B,Sq,H,hd], k/v
    [B,Sk,KV,hd] CUDA tensors -> [B,Sq,H,hd].  Raises ``ValueError`` on any
    input the kernel does not take and ``RuntimeError`` if the launch
    fails."""
    global launches
    _check(q, k, v, window)
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_int64 * 12)(*(s for t in (q, k, v, out)
                                      for s in t.stride()[:3]))
    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                out.data_ptr(), B, H, KV, Sq, Sk, hd, strides,
                1.0 / math.sqrt(hd), int(causal), int(window), stream)
    if rc:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error {rc}")
    launches += 1
    return out
