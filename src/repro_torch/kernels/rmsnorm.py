"""RMSNorm kernel in Triton.

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

``triton`` is imported when the kernel is first launched, never when this
module is imported, so the module imports on hosts without Triton.  Its
plain version is ``repro_torch.kernels.ref.rmsnorm_ref``; ``ops.rmsnorm``
picks between the two by the device of the tensor.
"""

import torch

#: Kernel launches in this process; ``ops.reset_launch_counts`` zeroes it.
launches = 0

_kernel = None


def _jit():
    # ``tl`` is bound as a module global: the jitted body resolves names
    # through this module's globals.
    global _kernel, tl
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

        _kernel = rmsnorm_fwd
    return _kernel


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """Launch the kernel on the current stream: x [..., D], scale [D] CUDA
    tensors -> like x.  Raises ``ValueError`` on input it does not take."""
    global launches
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
    out = torch.empty(x2.shape, dtype=x.dtype, device=x.device)
    if x2.shape[0]:
        block = 1 << (D - 1).bit_length()
        with torch.cuda.device(x.device):
            _jit()[(x2.shape[0],)](x2, scale, out, x2.stride(0), out.stride(0),
                                   D, eps, BLOCK_D=block,
                                   num_warps=8 if block >= 2048 else 4)
        launches += 1
    return out.reshape(x.shape)
