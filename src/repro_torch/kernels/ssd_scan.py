"""Launcher for the CUDA SSD chunked-scan kernel (``csrc/ssd_scan.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/ssd_scan.py`` (``ssd_scan`` /
``_ssd_kernel`` / ``_segsum``).  The kernel reads x [B, S, H, P] and
Bm/Cm [B, S, N] through their strides (the model passes slices of its conv
output, uncopied), dt [B, S, H] fp32 by strides, A [H] fp32, and an
optional fp32 initial state [B, H, P, N]; it returns y like x and the fp32
final state.  Any S is taken: the kernel masks a partial last chunk.  Its
plain version is ``repro_torch.kernels.ref.ssd_scan_ref``;
``ops.ssd_scan`` picks between the two by the device of the tensors.

The C entry point picks its kernels by dtype.  bfloat16 runs the SSD
algorithm's chunk-parallel steps on the tensor cores (C.B^T once per row and
chunk, the chunks' local states, the state passing, the outputs: four CUDA
kernels per call) over a scratch workspace this launcher allocates; its bf16 tiles are loaded by 16-byte ``cp.async``, so
x, Bm and Cm need 16-byte aligned rows (``_check`` raises otherwise).
float32 runs the CUDA-core kernel of the first port, one launch, since
bf16 or TF32 products would not hold float32's tolerance.  Nothing falls
back from one to the other.  :func:`ssd_scan_phases` mirrors the bf16
kernels' steps and roundings in plain torch for the CPU tests.
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

#: Rows of the bf16 kernels' query and key tiles inside a chunk (``KT`` in
#: ``csrc/ssd_scan.cu``).
TILE = 64

#: Calls that launched the kernels in this process;
#: ``ops.reset_launch_counts`` zeroes it.
launches = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("ssd_scan").ssd_scan_fwd
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 8 + [
            ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int64),
                                 ctypes.c_void_p, ctypes.c_int64,
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
    if x.dtype == torch.bfloat16:
        _check_aligned(x, Bm, Cm, initial_state)
        if -(-S // min(chunk, S)) > 65535:
            raise ValueError(f"ssd_scan: {S} rows in chunks of "
                             f"{min(chunk, S)} exceed 65535 chunks")


def _check_aligned(x, Bm, Cm, initial_state) -> None:
    """The bf16 kernels copy rows in 16-byte chunks (``cp.async``) and read
    the initial state as float4."""
    for name, t in (("x", x), ("Bm", Bm), ("Cm", Cm)):
        strides = [st for n, st in zip(t.shape[:-1], t.stride()[:-1]) if n > 1]
        if t.data_ptr() % 16 or any(st % 8 for st in strides):
            raise ValueError(f"ssd_scan: bfloat16 {name} needs 16-byte aligned "
                             f"rows (base pointer, and strides in multiples of "
                             f"8 elements), got pointer {t.data_ptr():#x} "
                             f"strides {t.stride()}")
    if initial_state is not None and initial_state.data_ptr() % 16:
        raise ValueError("ssd_scan: initial_state needs a 16-byte aligned base")


def workspace_bytes(B: int, S: int, H: int, P: int, N: int,
                    chunk: int) -> int:
    """Scratch of one bf16 call (``Workspace`` in ``csrc/ssd_scan.cu``,
    which checks the size it is given): the chunks' local states, later the
    states entering them, [B, nc, H, P, N] fp32; the chunks' totals
    [B, nc, H] fp32; C.B^T [B, nc, QT, QT] tiles of 64 x 64 fp32, with
    ``chunk`` as the kernel sees it (``min(chunk, S)``)."""
    def align(n):
        return -(-n // 256) * 256
    nc, qt = -(-S // chunk), -(-chunk // TILE)
    return (align(4 * B * nc * H * P * N) + align(4 * B * nc * H)
            + 4 * B * nc * qt * qt * TILE * TILE)


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
    Q = min(chunk, S)
    ws, n_ws = None, 0
    if x.dtype == torch.bfloat16:
        n_ws = workspace_bytes(B, S, H, P, N, Q)
        ws = torch.empty(n_ws, dtype=torch.uint8, device=x.device)
    fn = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(DTYPES[x.dtype], x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                Bm.data_ptr(), Cm.data_ptr(), init, y.data_ptr(),
                state.data_ptr(), B, S, H, P, N, Q, strides,
                None if ws is None else ws.data_ptr(), n_ws, stream)
    if rc:
        raise RuntimeError(f"ssd_scan_fwd launch failed: CUDA error {rc}")
    launches += 1
    return y, state


def _split(v: torch.Tensor, rounding: str) -> torch.Tensor:
    """What a product sees of the fp32 operand ``v``: ``"hi_lo"`` the bf16
    pair hi = bf16(v), lo = bf16(v - hi) (two products into one fp32
    accumulator, hi + lo exact in fp32), as the kernels run it; ``"bf16"``
    one rounding to bf16, which misses the tolerances (tests)."""
    hi = v.bfloat16().float()
    if rounding == "bf16":
        return hi
    if rounding != "hi_lo":
        raise ValueError(f"rounding {rounding!r} not in ('hi_lo', 'bf16')")
    return hi + (v - hi).bfloat16().float()


def ssd_scan_phases(x, dt, A, Bm, Cm, chunk: int, initial_state=None,
                    rounding: str = "hi_lo"):
    """The bf16 kernels' steps in plain torch, for the CPU tests: chunks of
    ``min(chunk, S)`` rows with the partial last chunk masked, 64-row tiles
    inside a chunk, and the hi/lo split of each fp32 operand where the
    kernels apply it (the weighted x of the local states, the state entering
    a chunk, and M = C.B^T o L o dt).  Not on any path.  Shapes as in
    ``ref.ssd_ref``; returns (y in x's dtype, final state fp32)."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    xf, Bf, Cf = x.float(), Bm.float(), Cm.float()
    chunks = [(c0, min(Q, S - c0)) for c0 in range(0, S, Q)]
    # Step 1: each chunk's cumulative sum, total and local state.
    cums, totals, locals_ = [], [], []
    for c0, n in chunks:
        cs = (dt[:, c0:c0 + n] * A).cumsum(1)                   # [B, n, H]
        total = cs[:, -1]                                       # [B, H]
        w = dt[:, c0:c0 + n] * torch.exp(total[:, None] - cs)   # [B, n, H]
        local = torch.zeros(Bsz, H, P, N)
        for k0 in range(0, n, TILE):
            k1 = min(k0 + TILE, n)
            v = _split(xf[:, c0 + k0:c0 + k1] * w[:, k0:k1, :, None], rounding)
            local = local + torch.einsum("bjhp,bjn->bhpn", v,
                                         Bf[:, c0 + k0:c0 + k1])
        cums.append(cs)
        totals.append(total)
        locals_.append(local)
    # Step 2: the states entering the chunks, and the final state.
    run = (torch.zeros(Bsz, H, P, N) if initial_state is None
           else initial_state.float())
    states_in = []
    for total, local in zip(totals, locals_):
        states_in.append(_split(run, rounding))
        run = run * torch.exp(total)[..., None, None] + local
    # Step 3: the outputs, 64 query rows at a time.
    ys = []
    for (c0, n), cs, st in zip(chunks, cums, states_in):
        for q0 in range(0, n, TILE):
            q1 = min(q0 + TILE, n)
            C_q = Cf[:, c0 + q0:c0 + q1]
            y = (torch.einsum("bin,bhpn->bihp", C_q, st)
                 * torch.exp(cs[:, q0:q1])[..., None])
            for k0 in range(0, q1, TILE):
                k1 = min(k0 + TILE, n)
                G = torch.einsum("bin,bjn->bij", C_q, Bf[:, c0 + k0:c0 + k1])
                i = torch.arange(q0, q1)[:, None]
                j = torch.arange(k0, k1)[None, :]
                diff = cs[:, q0:q1, None, :] - cs[:, None, k0:k1, :]
                M = torch.where((j <= i)[None, :, :, None],
                                G[..., None] * torch.exp(diff)
                                * dt[:, None, c0 + k0:c0 + k1], 0.0)
                y = y + torch.einsum("bijh,bjhp->bihp", _split(M, rounding),
                                     xf[:, c0 + k0:c0 + k1])
            ys.append(y.to(x.dtype))
    return torch.cat(ys, dim=1), run

