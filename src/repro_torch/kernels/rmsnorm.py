"""Launchers for the CUDA RMSNorm kernels (``csrc/rmsnorm.cu``): the forward
and its backward.

The forward replaces the Pallas TPU kernel ``repro/kernels/rmsnorm.py``
(``rmsnorm`` / ``_rmsnorm_kernel``): per row, ``x * rsqrt(mean(x^2) + eps) *
scale`` with fp32 accumulation, output in x's dtype, over any leading shape.
The backward has no TPU counterpart (JAX differentiates the jnp norm); it is
the backward of the port's ``autograd.Function`` (``ops.rmsnorm``).  With x̂
= x·rstd and g the upstream gradient it writes ``dx = rstd·(g·s -
x̂·mean(g·s·x̂))`` in x's dtype and ``dscale = Σ_rows g·x̂`` in the scale's.

Both read each row once and write it once, so the memory rate bounds them;
the source says how each is laid out for that (bf16 and fp16 a warp a row up
to D 2048, a block a row above; float32 a block a row in the replaced Triton
kernel's order of operations; the backward persistent, its rows brought into
shared memory by bulk asynchronous copies).  The backward's dscale is summed in a
fixed order: each block folds its rows' fp32 partials into one row of a
``[blocks, D]`` scratch, and a second kernel of the same library sums those
rows per column; two calls give bit-equal results.  :func:`rmsnorm_bwd_blocked`
mirrors that order in plain torch for the tests, at the grid :func:`bwd_grid`
reports.

x, dy and the scale are float32, bfloat16 or float16 (x and dy of one
dtype), 1 <= D <= 16384; x's rows may be strided (``h[:, -1:]``), its last
dimension contiguous; a dy whose last dimension is not contiguous is copied.
Rows whose base or width is not a multiple of 16 bytes take the kernels'
plain-load path.  ``ValueError`` past those limits; nothing falls back to the
plain version, ``repro_torch.kernels.ref.rmsnorm_ref`` (autograd through it
for the backward), which ``ops.rmsnorm`` takes for CPU tensors.  The library
is built (``build.py``) at the first launch, never when this module is
imported.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MAX_D = 16384
# csrc/rmsnorm.cu: the most backward blocks a SM (the scratch holds a row for
# each), and the dscale sum's strided row groups.
BWD_CTAS_PER_SM = 2
DSCALE_GROUPS = 32

#: Kernel launches in this process (forward, backward; a backward launch runs
#: its kernel and then the dscale sum); ``ops.reset_launch_counts`` zeroes
#: them.
launches = 0
bwd_launches = 0

_P, _I, _I64, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
# C entry point -> argument types (the stream last).
_ARGTYPES = {
    "rmsnorm_fwd": [_I, _I, _P, _P, _P, _I64, _I, _I64, _F, _P],
    "rmsnorm_bwd": [_I, _I, _P, _P, _P, _P, _P, _P, _I, _I64, _I, _I64, _I64,
                    _F, _I, _P],
    "rmsnorm_empty": [_P],
    "rmsnorm_bwd_grid": [_I, _I, _P, _P, _P, _P, _I64, _I, _I64, _I64, _I,
                         ctypes.POINTER(_I)],
}
_fns: dict = {}
_sms: dict[int, int] = {}


def _fn(name: str):
    """The C entry point ``name``, its library loaded (built) on first use."""
    if name not in _fns:
        fn = getattr(build.load("rmsnorm"), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def _call(name: str, device: torch.device, *args) -> None:
    """``name(*args, stream)`` on ``device``'s current stream.  Decode calls
    the forward ~60 times a step and is host-bound, so the current device is
    not switched when it is already ``device``, and the stream is read raw."""
    fn = _fn(name)
    current = torch.cuda.current_device()
    if device.index is None or device.index == current:
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(current))
    else:
        with torch.cuda.device(device):
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(device.index))
    if rc:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def _check(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Validate x [..., D] and scale [D]; returns x as [rows, D]."""
    for name, t in (("x", x), ("scale", scale)):
        if t.dtype not in DTYPES:
            raise ValueError(f"rmsnorm: {name} must be float32, bfloat16 or "
                             f"float16, got {t.dtype}")
    D = x.shape[-1] if x.ndim else 0
    if not 1 <= D <= MAX_D:
        raise ValueError(f"rmsnorm: D must be in [1, {MAX_D}], got shape "
                         f"{tuple(x.shape)}")
    if scale.shape != (D,) or not scale.is_contiguous():
        raise ValueError(f"rmsnorm: scale must be a contiguous [{D}], got "
                         f"{tuple(scale.shape)}")
    if D > 1 and x.stride(-1) != 1:
        raise ValueError(f"rmsnorm: last dimension must be contiguous, got "
                         f"strides {x.stride()}")
    if x.device.type != "cuda" or scale.device != x.device:
        raise ValueError(f"rmsnorm: x and scale must be CUDA tensors on one "
                         f"device, got {x.device} and {scale.device}")
    x2 = x.reshape(-1, D)
    if x2.shape[0] >= 2**31:
        raise ValueError(f"rmsnorm: at most 2**31 - 1 rows, got {x2.shape[0]}")
    return x2


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """Launch the forward on the current stream: x [..., D], scale [D] CUDA
    tensors -> like x.  Raises ``ValueError`` on input it does not take and
    ``RuntimeError`` if the launch fails."""
    global launches
    x2 = _check(x, scale)
    rows, D = x2.shape
    out = torch.empty((rows, D), dtype=x.dtype, device=x.device)
    if rows:
        _call("rmsnorm_fwd", x.device, DTYPES[x.dtype], DTYPES[scale.dtype],
              x2.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, D,
              x2.stride(0), eps)
        launches += 1
    return out.reshape(x.shape)


def _sm_count(device: torch.device) -> int:
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    if index not in _sms:
        _sms[index] = torch.cuda.get_device_properties(index)\
            .multi_processor_count
    return _sms[index]


def _bwd_operands(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward's x and dy as [rows, D] (dy's last dimension made
    contiguous) and its dx, after the checks."""
    x2 = _check(x, scale)
    rows, D = x2.shape
    if dy.shape != x.shape or dy.device != x.device or dy.dtype != x.dtype:
        raise ValueError(f"rmsnorm_bwd: dy must be like x {tuple(x.shape)} "
                         f"{x.dtype}, got {tuple(dy.shape)} {dy.dtype} on "
                         f"{dy.device}")
    dy2 = dy.reshape(-1, D)
    if D > 1 and dy2.stride(-1) != 1:
        dy2 = dy2.contiguous()
    return x2, dy2, torch.empty((rows, D), dtype=x.dtype, device=x.device)


def rmsnorm_bwd(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the backward on the current stream: the forward's x and scale
    and the upstream gradient ``dy`` (like x) -> (dx like x, dscale like
    scale)."""
    global bwd_launches
    x2, dy2, dx = _bwd_operands(x, scale, dy)
    rows, D = x2.shape
    if not rows:
        return dx.reshape(x.shape), torch.zeros_like(scale)
    work_rows = BWD_CTAS_PER_SM * _sm_count(x.device)
    work = torch.empty((work_rows, D), dtype=torch.float32, device=x.device)
    dscale = torch.empty_like(scale)
    _call("rmsnorm_bwd", x.device, DTYPES[x.dtype], DTYPES[scale.dtype],
          x2.data_ptr(), scale.data_ptr(), dy2.data_ptr(), dx.data_ptr(),
          dscale.data_ptr(), work.data_ptr(), work_rows, rows, D,
          x2.stride(0), dy2.stride(0), eps, _sm_count(x.device))
    bwd_launches += 1
    return dx.reshape(x.shape), dscale


def bwd_grid(x: torch.Tensor, scale: torch.Tensor,
             dy: torch.Tensor) -> tuple[int, int]:
    """The grid :func:`rmsnorm_bwd` launches on these inputs, (blocks, teams
    a block), launching nothing: the ``ctas`` and ``warps`` with which
    :func:`rmsnorm_bwd_blocked` repeats its dscale (a card test)."""
    x2, dy2, dx = _bwd_operands(x, scale, dy)
    rows, D = x2.shape
    grid = (_I * 2)()
    rc = _fn("rmsnorm_bwd_grid")(
        DTYPES[x.dtype], DTYPES[scale.dtype], x2.data_ptr(), scale.data_ptr(),
        dy2.data_ptr(), dx.data_ptr(), rows, D, x2.stride(0), dy2.stride(0),
        _sm_count(x.device), grid)
    if rc:
        raise RuntimeError(f"rmsnorm_bwd_grid failed: CUDA error {rc}")
    return grid[0], grid[1]


def empty_launch(device: torch.device | str = "cuda") -> None:
    """Launch the library's empty kernel (not counted): the launch floor that
    ``chip_smoke.py`` times the decode rows against."""
    _call("rmsnorm_empty", torch.device(device))


def rmsnorm_bwd_blocked(x: torch.Tensor, scale: torch.Tensor,
                        dy: torch.Tensor, eps: float, ctas: int,
                        warps: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """The backward kernel's order in plain torch, for the tests; not on any
    path (a card test holds the kernel's dscale to it at :func:`bwd_grid`).  Rows go to ``ctas`` blocks by a fixed stride (block c takes
    rows c, c + ctas, ...) and a block's i-th row to its team ``i % warps``;
    each team sums its rows' ``g·x̂`` in fp32 in row order, a block its teams
    in order, and the blocks' rows are summed per column as
    ``rmsnorm_dscale_kernel`` sums them: DSCALE_GROUPS strided groups, each in
    order, then the groups in order.  dx as the kernel computes it, in fp32,
    then in x's dtype.  Returns (dx like x, dscale like scale)."""
    D = x.shape[-1]
    xf = x.reshape(-1, D).float()
    gf = dy.reshape(-1, D).float()
    sf = scale.float()
    rows = xf.shape[0]
    rstd = torch.rsqrt(xf.square().sum(-1, keepdim=True) / D + eps)
    c = (gf * sf * xf).sum(-1, keepdim=True) * rstd / D
    xh = xf * rstd
    dx = rstd * (gf * sf - xh * c)
    # Row r = k * (ctas * warps) + w * ctas + c is team (c, w)'s k-th row.
    teams = ctas * warps
    steps = -(-rows // teams)
    gxh = torch.zeros(steps * teams, D, dtype=torch.float32)
    gxh[:rows] = gf * xh
    gxh = gxh.reshape(steps, warps, ctas, D)
    part = torch.zeros(warps, ctas, D, dtype=torch.float32)
    for k in range(steps):
        part = part + gxh[k]
    block = part[0]
    for w in range(1, warps):
        block = block + part[w]
    groups = []
    for g in range(min(DSCALE_GROUPS, ctas)):
        acc = torch.zeros(D, dtype=torch.float32)
        for i in range(g, ctas, DSCALE_GROUPS):
            acc = acc + block[i]
        groups.append(acc)
    dscale = groups[0]
    for acc in groups[1:]:
        dscale = dscale + acc
    return dx.to(x.dtype).reshape(x.shape), dscale.to(scale.dtype)
