"""Launcher for the CUDA SSD chunked-scan kernel (``csrc/ssd_scan.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/ssd_scan.py`` (``ssd_scan`` /
``_ssd_kernel`` / ``_segsum``).  The kernel reads x [B, S, H, P] and
Bm/Cm [B, S, N] through their strides (the model passes slices of its conv
output, uncopied), dt [B, S, H] fp32 by strides, A [H] fp32, and an
optional fp32 initial state [B, H, P, N]; it returns y like x and the fp32
final state.  Any S is taken: the kernel masks a partial last chunk.  Its
plain version is ``repro_torch.kernels.ref.ssd_scan_ref``;
``ops.ssd_scan`` picks between the two by the device of the tensors.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: (head_dim P, state N) pairs the kernel is built for.
SHAPES = ((16, 16), (32, 64), (64, 128))
#: Longest chunk: the chunk's dt and cumulative sum sit in shared memory.
MAX_CHUNK = 4096

#: Kernel launches in this process; ``ops.reset_launch_counts`` zeroes it.
launches = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("ssd_scan").ssd_scan_fwd
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 8 + [
            ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int64),
                                 ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(x, dt, A, Bm, Cm, initial_state, chunk: int) -> None:
    tensors = {"x": x, "dt": dt, "A": A, "Bm": Bm, "Cm": Cm}
    if initial_state is not None:
        tensors["initial_state"] = initial_state
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"ssd_scan: {name} must be a CUDA tensor on "
                             f"{x.device}, got {t.device}")
    if x.dtype not in DTYPES:
        raise ValueError(f"ssd_scan: dtype {x.dtype} not in {tuple(DTYPES)}")
    for name, t in (("Bm", Bm), ("Cm", Cm)):
        if t.dtype != x.dtype:
            raise ValueError(f"ssd_scan: {name} is {t.dtype}, x is {x.dtype}")
    for name, t in tensors.items():
        if name in ("dt", "A", "initial_state") and t.dtype != torch.float32:
            raise ValueError(f"ssd_scan: {name} must be float32, got {t.dtype}")
    if x.ndim != 4:
        raise ValueError(f"ssd_scan: x must be 4-D [B, S, H, P], got "
                         f"{tuple(x.shape)}")
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    if (dt.shape != (B, S, H) or A.shape != (H,) or Bm.shape != (B, S, N)
            or Cm.shape != (B, S, N)):
        raise ValueError(f"ssd_scan: shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, Bm "
                         f"{tuple(Bm.shape)}, Cm {tuple(Cm.shape)} disagree")
    if (P, N) not in SHAPES:
        raise ValueError(f"ssd_scan: (head_dim, state) {(P, N)} not in "
                         f"{SHAPES}")
    for name, t in (("x", x), ("Bm", Bm), ("Cm", Cm)):
        if t.stride(-1) != 1:
            raise ValueError(f"ssd_scan: {name} needs a contiguous last "
                             f"dimension, got strides {t.stride()}")
    if not A.is_contiguous():
        raise ValueError("ssd_scan: A must be contiguous")
    if initial_state is not None and (
            initial_state.shape != (B, H, P, N)
            or not initial_state.is_contiguous()):
        raise ValueError(f"ssd_scan: initial_state must be a contiguous "
                         f"{(B, H, P, N)}, got {tuple(initial_state.shape)}")
    if B == 0 or S == 0 or H == 0:
        raise ValueError("ssd_scan: empty batch, sequence or heads")
    if not 1 <= min(chunk, S) <= MAX_CHUNK:
        raise ValueError(f"ssd_scan: chunk {chunk} outside [1, {MAX_CHUNK}]")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int,
             initial_state: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on the current stream: CUDA tensors as in the module
    docstring -> (y [B,S,H,P] like x, final state [B,H,P,N] fp32).  Raises
    ``ValueError`` on any input the kernel does not take and
    ``RuntimeError`` if the launch fails."""
    global launches
    _check(x, dt, A, Bm, Cm, initial_state, chunk)
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    y = torch.empty((B, S, H, P), dtype=x.dtype, device=x.device)
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    strides = (ctypes.c_int64 * 10)(*x.stride()[:3], *dt.stride(),
                                    *Bm.stride()[:2], *Cm.stride()[:2])
    init = None if initial_state is None else initial_state.data_ptr()
    fn = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(DTYPES[x.dtype], x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                Bm.data_ptr(), Cm.data_ptr(), init, y.data_ptr(),
                state.data_ptr(), B, S, H, P, N, min(chunk, S), strides,
                stream)
    if rc:
        raise RuntimeError(f"ssd_scan_fwd launch failed: CUDA error {rc}")
    launches += 1
    return y, state
