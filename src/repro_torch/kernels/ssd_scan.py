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

:func:`ssd_scan_bwd` launches the backward (``csrc/ssd_scan_bwd.cu``, its
own library): the gradients of x, dt, A, Bm, Cm and of the initial state
from dy and an optional d(final state), over a scratch workspace.  Its C
entry point picks its kernels by dtype too: bfloat16 runs every product on
the tensor cores (seven CUDA kernels per call: the local states, the state
passes, dC's pairs by head group, dC's carried-state term, dB and dx with
the end of d(dt*A), the head groups' sums, dA), with the fp32 operands
split hi/lo as the forward's, and needs 16-byte aligned rows as the
forward's bf16 kernels do; float32 runs six CUDA-core kernels.  The Pallas
kernel is forward-only (JAX differentiates the model's jnp scan), so this
one has no TPU counterpart; its plain version is autograd through
``ref.ssd_scan_ref``, and :func:`ssd_scan_bwd_phases` mirrors its steps and
splits in plain torch for the CPU tests.
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
#: Heads whose dB and dC one block of the bf16 backward sums (``HG`` in
#: ``csrc/ssd_scan_bwd.cu``), and the threads of its state pass
#: (``PASS_THREADS``), each owning 8 entries of a state.
HEAD_GROUP = 8
PASS_THREADS = 256

#: Calls that launched the forward's kernels in this process, and the
#: backward's (``csrc/ssd_scan_bwd.cu``); ``ops.reset_launch_counts`` zeroes
#: both.
launches = 0
bwd_launches = 0

_fn = None
_bwd_fn = None


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


def _bwd_kernel():
    """The backward library's (launch, workspace size) functions."""
    global _bwd_fn
    if _bwd_fn is None:
        lib = build.load("ssd_scan_bwd")
        fn = lib.ssd_scan_bwd
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 14 + [
            ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int64),
                                 ctypes.c_void_p, ctypes.c_int64,
                                 ctypes.c_void_p]
        fn.restype = ctypes.c_int
        ws = lib.ssd_scan_bwd_workspace_bytes
        ws.argtypes = [ctypes.c_int] * 7
        ws.restype = ctypes.c_int64
        _bwd_fn = fn, ws
    return _bwd_fn


def _check(x, dt, A, Bm, Cm, initial_state, chunk: int) -> None:
    """What both the forward and the backward kernels take."""
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


def _check_chunks(S: int, chunk: int) -> None:
    """The chunk-parallel kernels run a block row per chunk (gridDim.y)."""
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
    if x.dtype == torch.bfloat16:
        _check_aligned(x, Bm, Cm, initial_state)
        _check_chunks(x.shape[1], chunk)
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


def bwd_workspace_bytes(B: int, S: int, H: int, P: int, N: int,
                        chunk: int, dtype: torch.dtype = torch.float32) -> int:
    """Scratch of one backward call, with ``chunk`` as the kernel sees it
    (``min(chunk, S)``), as the CUDA library's
    ``ssd_scan_bwd_workspace_bytes`` gives it (the launcher asks the
    library; the card tests hold the two equal).

    float32 (``BwdWorkspace``): C.B^T [B, nc, QT, QT] tiles of 64 x 64; the
    states and their gradients [B, nc, H, P, N]; the chunks' totals and
    shares of dA [B, nc, H]; the heads' partial dB and dC [B, S, H, N]; all
    fp32.  bfloat16 (``TcWorkspace``): per (row, head, chunk) rows padded to
    whole tiles, the cumulative sums of dt*A (fp64), dt and three fp32 parts
    of d(dt*A); the totals, <S_in, dS_out> per block of the state pass and
    the shares of dA [B, nc, H]; the states and their gradients [B, nc, H,
    P, N] fp32; the head groups' partial dB and dC [B, S, ceil(H / 8), N]
    fp32."""
    def align(n):
        return -(-n // 256) * 256
    nc, qt = -(-S // chunk), -(-chunk // TILE)
    states = 2 * align(4 * B * nc * H * P * N)
    if dtype == torch.float32:
        return (align(4 * B * nc * qt * qt * TILE * TILE) + states
                + 2 * align(4 * B * nc * H) + align(4 * B * S * H * N)
                + 4 * B * S * H * N)
    rows = B * H * nc * qt * TILE
    G = -(-H // HEAD_GROUP)
    npb = -(-(P * N // 8) // PASS_THREADS)
    return (align(8 * rows) + 4 * align(4 * rows) + 2 * align(4 * B * nc * H)
            + align(4 * B * nc * H * npb) + states + align(4 * B * S * G * N)
            + 4 * B * S * G * N)


def ssd_scan_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor, dy: torch.Tensor, *,
                 chunk: int, initial_state: torch.Tensor | None = None,
                 dfinal: torch.Tensor | None = None):
    """Launch the backward kernels on the current stream: the forward's
    inputs as in the module docstring, dy [B,S,H,P] like x (contiguous) and
    an optional fp32 d(final state) [B,H,P,N] (contiguous; zero where None)
    -> (dx like x, ddt [B,S,H] fp32, dA [H] fp32, dBm and dCm [B,S,N] like
    x, d(initial state) fp32 where an initial state was given, else None).
    Raises ``ValueError`` on any input the kernel does not take and
    ``RuntimeError`` if the launch fails."""
    global bwd_launches
    _check(x, dt, A, Bm, Cm, initial_state, chunk)
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    _check_chunks(S, chunk)
    if B > 65535:
        raise ValueError(f"ssd_scan_bwd: batch {B} exceeds 65535")
    if (dy.device != x.device or dy.dtype != x.dtype or dy.shape != x.shape
            or not dy.is_contiguous()):
        raise ValueError(f"ssd_scan_bwd: dy must be a contiguous "
                         f"{tuple(x.shape)} {x.dtype} on {x.device}, got "
                         f"{tuple(dy.shape)} {dy.dtype} on {dy.device}")
    if dfinal is not None and (
            dfinal.device != x.device or dfinal.dtype != torch.float32
            or dfinal.shape != (B, H, P, N) or not dfinal.is_contiguous()):
        raise ValueError(f"ssd_scan_bwd: dfinal must be a contiguous float32 "
                         f"{(B, H, P, N)} on {x.device}, got "
                         f"{tuple(dfinal.shape)} {dfinal.dtype}")
    if x.dtype == torch.bfloat16:
        _check_aligned(x, Bm, Cm, initial_state)
        for name, t in (("dy", dy), ("dfinal", dfinal)):
            if t is not None and t.data_ptr() % 16:
                raise ValueError(f"ssd_scan_bwd: bfloat16 needs a 16-byte "
                                 f"aligned {name}, got {t.data_ptr():#x}")
    dev = x.device
    dx = torch.empty((B, S, H, P), dtype=x.dtype, device=dev)
    ddt = torch.empty((B, S, H), dtype=torch.float32, device=dev)
    dA = torch.empty((H,), dtype=torch.float32, device=dev)
    dBm = torch.empty((B, S, N), dtype=x.dtype, device=dev)
    dCm = torch.empty((B, S, N), dtype=x.dtype, device=dev)
    dinit = (None if initial_state is None else
             torch.empty((B, H, P, N), dtype=torch.float32, device=dev))
    strides = (ctypes.c_int64 * 10)(*x.stride()[:3], *dt.stride(),
                                    *Bm.stride()[:2], *Cm.stride()[:2])
    Q = min(chunk, S)
    fn, ws_bytes = _bwd_kernel()
    n_ws = ws_bytes(DTYPES[x.dtype], B, S, H, P, N, Q)
    ws = torch.empty(n_ws, dtype=torch.uint8, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(DTYPES[x.dtype], x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                Bm.data_ptr(), Cm.data_ptr(), ptr(initial_state),
                dy.data_ptr(), ptr(dfinal), dx.data_ptr(), ddt.data_ptr(),
                dA.data_ptr(), dBm.data_ptr(), dCm.data_ptr(), ptr(dinit),
                B, S, H, P, N, Q, strides, ws.data_ptr(), n_ws, stream)
    if rc:
        raise RuntimeError(f"ssd_scan_bwd launch failed: CUDA error {rc}")
    bwd_launches += 1
    return dx, ddt, dA, dBm, dCm, dinit


def _split(v: torch.Tensor, rounding: str) -> torch.Tensor:
    """What a product sees of the fp32 operand ``v``: ``"hi_lo"`` the bf16
    pair hi = bf16(v), lo = bf16(v - hi) (two products into one fp32
    accumulator, hi + lo exact in fp32), as the kernels run it; ``"bf16"``
    one rounding to bf16, which misses the tolerances (tests); ``"fp32"``
    ``v`` itself, as the float32 kernels use it."""
    if rounding == "fp32":
        return v
    hi = v.bfloat16().float()
    if rounding == "bf16":
        return hi
    if rounding != "hi_lo":
        raise ValueError(f"rounding {rounding!r} not in ('hi_lo', 'bf16', "
                         f"'fp32')")
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



def ssd_scan_bwd_phases(x, dt, A, Bm, Cm, dy, chunk: int, initial_state=None,
                        dfinal=None, rounding: str = "fp32"):
    """The backward kernels' steps (``csrc/ssd_scan_bwd.cu``) in plain
    torch, for the CPU tests: chunks of ``min(chunk, S)`` rows with the
    partial last chunk masked, 64-row tiles inside a chunk, products in
    fp32, the cumulative sums of dt*A and their reverse in fp64 with every
    exp taken of an fp64 difference, as the kernels keep them.  Not on any
    path.  Shapes as in :func:`ssd_scan_bwd`; returns (dx, ddt, dA, dBm,
    dCm, d initial state or None).

    ``rounding`` is what the products see of their fp32 operands
    (:func:`_split`): ``"fp32"`` the values, as the float32 kernels use
    them; ``"hi_lo"`` the bf16 hi/lo pair where the bf16 tensor-core
    kernels split (the weighted x and dy of the local states and the
    weighted x of dB's leaving-state term, the states entering and the
    gradients leaving the chunks in their products, W summed over each
    group of ``HEAD_GROUP`` heads for dC, W per head for dB, G o L for w);
    ``"bf16"`` one bf16 rounding at the same places, which misses the 1e-3
    limit of ddt, dA or d(initial state) (tests).  <S_in, dS_out>, E = G o
    W and the sums of d(dt*A) stay fp32 in every mode.

    Per chunk, with cs the cumulative sum of dt*A, total its last valid
    row, L_ij = exp(cs_i - cs_j) for j <= i, G = C.B^T, D_ij = dy_i.x_j,
    W = L o dt_j o D and S_in / dS_out the states entering and leaving:
      dC_i  = sum_j W_ij B_j + exp(cs_i) S_in^T dy_i            (per head)
      dB_j  = sum_i W_ij C_i + exp(total - cs_j) dt_j dS_out^T x_j
      w_j   = sum_i (G o L)_ij dy_i + exp(total - cs_j) dS_out B_j
      dx_j  = dt_j w_j
      da_t  = sum_{j < t <= i} E_ij + sum_{t' >= t} dcs_t', with E = G o W,
      dcs_t = exp(cs_t) dy_t.(S_in C_t) - exp(total - cs_t) dt_t
              x_t.(dS_out B_t) (+ d total = <S_in, dS_out> exp(total) +
              sum_j exp(total - cs_j) dt_j x_j.(dS_out B_j) on the last row)
      ddt_t = A da_t + x_t.w_t
    and dA sums da_t dt_t over the rows and the batch.  The pairs' part of
    da is summed over the pairs that straddle t, not as a row sum less a
    column sum, which cancel (the kernels' "stable" form)."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    xf, Bf, Cf, dyf = x.float(), Bm.float(), Cm.float(), dy.float()
    chunks = [(c0, min(Q, S - c0)) for c0 in range(0, S, Q)]
    groups = [(h0, min(h0 + HEAD_GROUP, H)) for h0 in range(0, H, HEAD_GROUP)]

    def exp(e):
        return torch.exp(e.float())

    def split(v):
        return _split(v, rounding)

    # Step 1: each chunk's cumulative sum and total, its local state
    # sum_j (dt_j exp(total - cs_j) x_j)^T B_j and its local d(state)
    # sum_i (exp(cs_i) dy_i)^T C_i.
    cums, totals, locals_, dlocals = [], [], [], []
    for c0, n in chunks:
        cs = (dt[:, c0:c0 + n] * A).double().cumsum(1)          # [B, n, H]
        total = cs[:, -1]
        wx = xf[:, c0:c0 + n] * (dt[:, c0:c0 + n]
                                 * exp(total[:, None] - cs))[..., None]
        wdy = dyf[:, c0:c0 + n] * exp(cs)[..., None]
        cums.append(cs)
        totals.append(total)
        locals_.append(torch.einsum("bjhp,bjn->bhpn", split(wx),
                                    Bf[:, c0:c0 + n]))
        dlocals.append(torch.einsum("bihp,bin->bhpn", split(wdy),
                                    Cf[:, c0:c0 + n]))
    # Step 2: the states entering the chunks (forward), and the gradients
    # of the states leaving them (in reverse); d(initial state) last.
    run = (torch.zeros(Bsz, H, P, N) if initial_state is None
           else initial_state.float())
    s_in = []
    for total, local in zip(totals, locals_):
        s_in.append(run)
        run = run * exp(total)[..., None, None] + local
    run = torch.zeros(Bsz, H, P, N) if dfinal is None else dfinal.float()
    ds_out = [None] * len(chunks)
    for c in reversed(range(len(chunks))):
        ds_out[c] = run
        run = run * exp(totals[c])[..., None, None] + dlocals[c]
    dinit = None if initial_state is None else run
    # Step 3: per chunk, pass A over query tiles I (dC, summed over heads,
    # and the rows' part of d cs), pass B over key tiles J (dB, dx and the
    # columns' part).
    dx = torch.zeros(Bsz, S, H, P)
    ddt = torch.zeros(Bsz, S, H)
    dB_part = torch.zeros(Bsz, S, H, N)
    dCm = torch.zeros(Bsz, S, N)
    dA = torch.zeros(H, dtype=torch.float64)
    for (c0, n), cs, total, st, dst in zip(chunks, cums, totals, s_in,
                                           ds_out):
        tiles = [(t0, min(t0 + TILE, n)) for t0 in range(0, n, TILE)]
        st_s, dst_s = split(st), split(dst)

        def pair(i0, i1, j0, j1):
            """L, G and D of the tile pair (rows i, columns j)."""
            i = torch.arange(i0, i1)[:, None]
            j = torch.arange(j0, j1)[None, :]
            diff = cs[:, i0:i1, None, :] - cs[:, None, j0:j1, :]
            L = torch.where((j <= i)[None, :, :, None],
                            exp(torch.where((j <= i)[None, :, :, None],
                                            diff, 0.0)), 0.0)
            G = torch.einsum("bin,bjn->bij", Cf[:, c0 + i0:c0 + i1],
                             Bf[:, c0 + j0:c0 + j1])
            D = torch.einsum("bihp,bjhp->bijh", dyf[:, c0 + i0:c0 + i1],
                             xf[:, c0 + j0:c0 + j1])
            return L, G[..., None], D

        # dcs: the state terms of d cs; da_pairs: the pairs' part of da,
        # sum_{j < t <= i} E_ij, summed directly (no cancellation of a row
        # sum against a column sum).
        dcs = torch.zeros(Bsz, n, H)
        da_pairs = torch.zeros(Bsz, n, H)
        for q0, q1 in tiles:                                   # pass A
            dC = torch.zeros(Bsz, q1 - q0, N)
            carry = torch.zeros(Bsz, q1 - q0, H)    # sum of E_ij, earlier j
            i = torch.arange(q0, q1)[:, None]
            for k0, k1 in tiles:
                if k0 > q0:
                    break
                L, G, D = pair(q0, q1, k0, k1)
                W = L * dt[:, None, c0 + k0:c0 + k1] * D
                for h0, h1 in groups:
                    dC = dC + torch.einsum("bij,bjn->bin",
                                           split(W[..., h0:h1].sum(-1)),
                                           Bf[:, c0 + k0:c0 + k1])
                E = G * W
                below = carry[:, :, None] + E.cumsum(2) - E   # sum_{j < t}
                t = torch.arange(k0, k1)[None, :]
                da_pairs[:, k0:k1] += torch.where(
                    (t <= i)[None, :, :, None], below, 0.0).sum(1)
                carry = carry + E.sum(2)
            Z = torch.einsum("bihp,bhpn->bihn", dyf[:, c0 + q0:c0 + q1], st_s)
            e = exp(cs[:, q0:q1])
            dC = dC + (e[..., None] * Z).sum(2)
            r = (Z * Cf[:, c0 + q0:c0 + q1, None]).sum(-1)
            dcs[:, q0:q1] = e * r
            dCm[:, c0 + q0:c0 + q1] = dC
        xw = torch.zeros(Bsz, n, H)
        dtotal = exp(total) * (st * dst).sum((-1, -2))          # [B, H]
        for k0, k1 in tiles:                                   # pass B
            dB = torch.zeros(Bsz, k1 - k0, H, N)
            u = torch.zeros(Bsz, k1 - k0, H, P)
            for q0, q1 in tiles:
                if q1 <= k0:
                    continue
                L, G, D = pair(q0, q1, k0, k1)
                W = L * dt[:, None, c0 + k0:c0 + k1] * D
                dB = dB + torch.einsum("bijh,bin->bjhn", split(W),
                                       Cf[:, c0 + q0:c0 + q1])
                u = u + torch.einsum("bijh,bihp->bjhp", split(G * L),
                                     dyf[:, c0 + q0:c0 + q1])
            xJ = xf[:, c0 + k0:c0 + k1]
            dtJ = dt[:, c0 + k0:c0 + k1]
            v = torch.einsum("bhpn,bjn->bjhp", dst_s, Bf[:, c0 + k0:c0 + k1])
            e = exp(total[:, None] - cs[:, k0:k1])              # [B, j, H]
            w = u + e[..., None] * v
            dx[:, c0 + k0:c0 + k1] = dtJ[..., None] * w
            xw[:, k0:k1] = (xJ * w).sum(-1)
            dB = dB + torch.einsum("bhpn,bjhp->bjhn", dst_s,
                                   split((e * dtJ)[..., None] * xJ))
            dB_part[:, c0 + k0:c0 + k1] = dB
            q = e * dtJ * (xJ * v).sum(-1)
            dcs[:, k0:k1] -= q
            dtotal = dtotal + q.sum(1)
        dcs[:, n - 1] += dtotal
        da = (dcs.double().flip(1).cumsum(1).flip(1) + da_pairs).float()
        ddt[:, c0:c0 + n] = da * A + xw
        dA = dA + (da.double() * dt[:, c0:c0 + n]).sum((0, 1))
    # Step 4: dB's sum over heads.
    return (dx.to(x.dtype), ddt, dA.float(), dB_part.sum(2).to(Bm.dtype),
            dCm.to(Cm.dtype), dinit)
