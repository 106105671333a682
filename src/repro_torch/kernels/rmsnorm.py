"""RMSNorm kernels in Triton: the forward and its backward.

Replaces the Pallas TPU kernel ``repro/kernels/rmsnorm.py`` (``rmsnorm`` /
``_rmsnorm_kernel``): per row, ``x * rsqrt(mean(x^2) + eps) * scale`` with
fp32 accumulation, output in x's dtype, over any leading shape.

Bound: one read of x and one write of the output (the scale is 7 KB), a
few operations per element, so memory bandwidth bounds it; at the prefill
shape [4*512, 3584] bf16 that is ~29 MB, ~9 us on an H100 SXM (3.35 TB/s).
The design is the one pass that bound asks for: one program per row holds
the whole row in registers (the next power of two of D), reduces it and
writes the scaled row, so x is read from device memory once.  The TPU
kernel's 256-row blocks were VMEM tiling and have no counterpart here.

The backward has no TPU counterpart (JAX differentiates the jnp norm); it
is the backward of the port's ``autograd.Function`` (``ops.rmsnorm``).
With x̂ = x·rstd and g the upstream gradient, it writes
``dx = rstd·(g·s - x̂·mean(g·s·x̂))`` in x's dtype and
``dscale = Σ_rows g·x̂``.  Each program walks every P-th row (P = four programs
per SM, 528 on an H100), recomputes rstd from x (cheaper than storing it), writes dx and sums
its rows' ``g·x̂`` in fp32 registers; it writes that partial to a
[P, D] fp32 buffer, and a ``.sum(0)`` over the P partials (7.6 MB at the
train width) gives dscale.  Bound: reads of x and dy and a write of dx;
at the train shape [8192, 3584] bf16 176 MB, 0.053 ms.

``triton`` is imported when a kernel is first launched, never when this
module is imported, so the module imports on hosts without Triton.  The
plain version is ``repro_torch.kernels.ref.rmsnorm_ref`` (autograd through
it for the backward); ``ops.rmsnorm`` picks between the two by the device
of the tensor.
"""

import torch

#: Kernel launches in this process (forward, backward);
#: ``ops.reset_launch_counts`` zeroes them.
launches = 0
bwd_launches = 0

#: Backward programs per SM.
BWD_PROGRAMS_PER_SM = 4

_kernel = None
_bwd_kernel = None


def _jit():
    # ``tl`` is bound as a module global: the jitted bodies resolve names
    # through this module's globals.
    global _kernel, _bwd_kernel, tl
    if _kernel is None:
        import triton
        import triton.language as tl

        @triton.jit
        def rmsnorm_fwd(x_ptr, s_ptr, o_ptr, x_row_stride, o_row_stride, D,
                        eps, BLOCK_D: tl.constexpr):
            row = tl.program_id(0).to(tl.int64)
            cols = tl.arange(0, BLOCK_D)
            mask = cols < D
            x = tl.load(x_ptr + row * x_row_stride + cols, mask=mask,
                        other=0.0).to(tl.float32)
            var = tl.sum(x * x, axis=0) / D
            s = tl.load(s_ptr + cols, mask=mask, other=0.0).to(tl.float32)
            y = x * tl.rsqrt(var + eps) * s
            tl.store(o_ptr + row * o_row_stride + cols,
                     y.to(o_ptr.dtype.element_ty), mask=mask)

        @triton.jit
        def rmsnorm_bwd(x_ptr, s_ptr, dy_ptr, dx_ptr, ds_ptr, x_row_stride,
                        dy_row_stride, dx_row_stride, n_rows, D, eps,
                        BLOCK_D: tl.constexpr):
            cols = tl.arange(0, BLOCK_D)
            mask = cols < D
            s = tl.load(s_ptr + cols, mask=mask, other=0.0).to(tl.float32)
            dscale = tl.zeros([BLOCK_D], dtype=tl.float32)
            for row in range(tl.program_id(0), n_rows, tl.num_programs(0)):
                r = row.to(tl.int64)
                x = tl.load(x_ptr + r * x_row_stride + cols, mask=mask,
                            other=0.0).to(tl.float32)
                g = tl.load(dy_ptr + r * dy_row_stride + cols, mask=mask,
                            other=0.0).to(tl.float32)
                rstd = tl.rsqrt(tl.sum(x * x, axis=0) / D + eps)
                xh = x * rstd
                gs = g * s
                dx = rstd * (gs - xh * (tl.sum(gs * xh, axis=0) / D))
                tl.store(dx_ptr + r * dx_row_stride + cols,
                         dx.to(dx_ptr.dtype.element_ty), mask=mask)
                dscale += g * xh
            tl.store(ds_ptr + tl.program_id(0) * D + cols, dscale, mask=mask)

        _kernel = rmsnorm_fwd
        _bwd_kernel = rmsnorm_bwd
    return _kernel


def _check(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Validate x [..., D] and scale [D]; returns x as [rows, D]."""
    if x.device.type != "cuda" or scale.device != x.device:
        raise ValueError(f"rmsnorm: x and scale must be CUDA tensors on one "
                         f"device, got {x.device} and {scale.device}")
    if not (x.is_floating_point() and scale.is_floating_point()):
        raise ValueError(f"rmsnorm: float tensors required, got {x.dtype} "
                         f"and {scale.dtype}")
    D = x.shape[-1]
    if scale.shape != (D,) or not scale.is_contiguous():
        raise ValueError(f"rmsnorm: scale must be a contiguous [{D}], got "
                         f"{tuple(scale.shape)}")
    x2 = x.reshape(-1, D)
    if x2.stride(-1) != 1:
        raise ValueError(f"rmsnorm: last dimension must be contiguous, got "
                         f"strides {x.stride()}")
    return x2


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """Launch the kernel on the current stream: x [..., D], scale [D] CUDA
    tensors -> like x.  Raises ``ValueError`` on input it does not take."""
    global launches
    x2 = _check(x, scale)
    D = x.shape[-1]
    out = torch.empty(x2.shape, dtype=x.dtype, device=x.device)
    if x2.shape[0]:
        block = 1 << (D - 1).bit_length()
        with torch.cuda.device(x.device):
            _jit()[(x2.shape[0],)](x2, scale, out, x2.stride(0), out.stride(0),
                                   D, eps, BLOCK_D=block,
                                   num_warps=8 if block >= 2048 else 4)
        launches += 1
    return out.reshape(x.shape)


def rmsnorm_bwd(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the backward on the current stream: the forward's x and scale
    and the upstream gradient ``dy`` (like x) -> (dx like x, dscale like
    scale)."""
    global bwd_launches
    x2 = _check(x, scale)
    D = x.shape[-1]
    if dy.shape != x.shape or dy.device != x.device:
        raise ValueError(f"rmsnorm_bwd: dy must be like x {tuple(x.shape)}, "
                         f"got {tuple(dy.shape)} on {dy.device}")
    dy2 = dy.reshape(-1, D)
    if dy2.stride(-1) != 1:
        dy2 = dy2.contiguous()
    dx = torch.empty(x2.shape, dtype=x.dtype, device=x.device)
    rows = x2.shape[0]
    if not rows:
        return dx.reshape(x.shape), torch.zeros_like(scale)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    programs = min(rows, BWD_PROGRAMS_PER_SM * sms)
    partial = torch.empty((programs, D), dtype=torch.float32, device=x.device)
    block = 1 << (D - 1).bit_length()
    with torch.cuda.device(x.device):
        _jit()
        _bwd_kernel[(programs,)](x2, scale, dy2, dx, partial, x2.stride(0),
                                 dy2.stride(0), dx.stride(0), rows, D, eps,
                                 BLOCK_D=block,
                                 num_warps=8 if block >= 2048 else 4)
    bwd_launches += 1
    return dx.reshape(x.shape), partial.sum(0).to(scale.dtype)
