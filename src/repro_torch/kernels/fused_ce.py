"""Fused cross-entropy kernels in Triton: the forward and its backward.

Replaces the Pallas TPU kernel ``repro/kernels/fused_ce.py``
(``fused_cross_entropy`` / ``_ce_kernel``): per row of logits [T, V], the
NLL ``logsumexp(x) - x[max(label, 0)]`` in fp32, streaming V in blocks with
an online max and sum so that no softmax or full-row exponential is ever
written.  Logits may be bf16 or fp32 and V any size (the last block is
masked).  A negative label is clamped to 0, as the TPU kernel does, so its
row gives ``lse - x[row, 0]``; the model's masked mean gives such rows a
zero upstream gradient.

Forward.  One program per row walks V in ``BLOCK_V`` blocks (one block
max, one exponential per element, one sum), then gathers the label logit
with one load.  It writes the NLL and the row's lse [T] fp32, which the
backward reuses.  Bound: one read of the logits, so bytes; at the train
shape [8192, 152064] bf16 that is 2.49 GB, 0.744 ms on an H100 SXM
(3.35 TB/s).  The TPU kernel's (T, V) grid with VMEM scratch carried along
V becomes the loop inside the program; rows run in parallel.

Backward.  One program per (row, V block) writes
``dlogits = (exp(x - lse) - onehot(max(label, 0))) * g[row]`` in the
logits' dtype: one elementwise pass, one read of the logits and one write,
4.97 GB at the train shape, 1.487 ms.  The TPU kernel has no backward (JAX
differentiates the jnp loss); this is its counterpart for the port's
``autograd.Function`` (``ops.fused_cross_entropy``).

``triton`` is imported at the first launch, never when this module is
imported, so the module imports on hosts without Triton.  The plain
version is ``repro_torch.kernels.ref.cross_entropy_ref`` (autograd through
it for the backward).
"""

import torch

#: Kernel launches in this process (forward, backward);
#: ``ops.reset_launch_counts`` zeroes them.
launches = 0
bwd_launches = 0

BLOCK_V = 4096
_kernels = None


def _jit():
    # ``tl`` is bound as a module global: the jitted bodies resolve names
    # through this module's globals.
    global _kernels, tl
    if _kernels is None:
        import triton
        import triton.language as tl

        @triton.jit
        def ce_fwd(x_ptr, lab_ptr, nll_ptr, lse_ptr, x_row_stride, V,
                   BLOCK: tl.constexpr):
            row = tl.program_id(0).to(tl.int64)
            base = x_ptr + row * x_row_stride
            cols = tl.arange(0, BLOCK)
            # The first block seeds the running max and sum, so both are
            # reduction results from the start.
            x = tl.load(base + cols, mask=cols < V,
                        other=float("-inf")).to(tl.float32)
            m = tl.max(x, axis=0)
            s = tl.sum(tl.exp(x - m), axis=0)
            for v0 in range(BLOCK, V, BLOCK):
                idx = v0 + cols
                x = tl.load(base + idx, mask=idx < V,
                            other=float("-inf")).to(tl.float32)
                m_new = tl.maximum(m, tl.max(x, axis=0))
                s = s * tl.exp(m - m_new) + tl.sum(tl.exp(x - m_new), axis=0)
                m = m_new
            lse = tl.log(tl.maximum(s, 1e-30)) + m
            lab = tl.maximum(tl.load(lab_ptr + row).to(tl.int64), 0)
            pick = tl.load(base + lab, mask=lab < V, other=0.0).to(tl.float32)
            tl.store(nll_ptr + row, lse - pick)
            tl.store(lse_ptr + row, lse)

        @triton.jit
        def ce_bwd(x_ptr, lab_ptr, lse_ptr, g_ptr, dx_ptr, x_row_stride,
                   dx_row_stride, V, BLOCK: tl.constexpr):
            row = tl.program_id(0).to(tl.int64)
            idx = tl.program_id(1) * BLOCK + tl.arange(0, BLOCK)
            mask = idx < V
            x = tl.load(x_ptr + row * x_row_stride + idx, mask=mask,
                        other=0.0).to(tl.float32)
            lse = tl.load(lse_ptr + row)
            g = tl.load(g_ptr + row)
            lab = tl.maximum(tl.load(lab_ptr + row).to(tl.int64), 0)
            d = (tl.exp(x - lse) - tl.where(idx == lab, 1.0, 0.0)) * g
            tl.store(dx_ptr + row * dx_row_stride + idx,
                     d.to(dx_ptr.dtype.element_ty), mask=mask)

        _kernels = (ce_fwd, ce_bwd)
    return _kernels


def _check(logits: torch.Tensor, labels: torch.Tensor) -> None:
    if logits.device.type != "cuda" or labels.device != logits.device:
        raise ValueError(f"fused_cross_entropy: logits and labels must be "
                         f"CUDA tensors on one device, got {logits.device} "
                         f"and {labels.device}")
    if logits.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_cross_entropy: logits dtype {logits.dtype} "
                         f"not float32 or bfloat16")
    if logits.ndim != 2 or logits.stride(-1) != 1:
        raise ValueError(f"fused_cross_entropy: logits must be [T, V] with a "
                         f"contiguous last dimension, got shape "
                         f"{tuple(logits.shape)} strides {logits.stride()}")
    if (labels.shape != logits.shape[:1] or labels.is_floating_point()
            or labels.is_complex()):
        raise ValueError(f"fused_cross_entropy: labels must be integer [T], "
                         f"got {labels.dtype} {tuple(labels.shape)}")
    if logits.shape[1] == 0:
        raise ValueError("fused_cross_entropy: empty vocabulary")


def _block(V: int) -> int:
    return min(BLOCK_V, 1 << (V - 1).bit_length())


def fused_cross_entropy(logits: torch.Tensor, labels: torch.Tensor):
    """Launch the forward on the current stream: logits [T, V], labels [T]
    -> (nll [T] fp32, lse [T] fp32).  A label at or past V picks 0, as in
    the TPU kernel.  Raises ``ValueError`` on input it does not take."""
    global launches
    _check(logits, labels)
    T, V = logits.shape
    labels = labels.contiguous()
    nll = torch.empty(T, dtype=torch.float32, device=logits.device)
    lse = torch.empty(T, dtype=torch.float32, device=logits.device)
    if T:
        with torch.cuda.device(logits.device):
            _jit()[0][(T,)](logits, labels, nll, lse, logits.stride(0), V,
                            BLOCK=_block(V), num_warps=8)
        launches += 1
    return nll, lse


def fused_cross_entropy_bwd(logits: torch.Tensor, labels: torch.Tensor,
                            lse: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Launch the backward on the current stream: the forward's logits,
    labels and lse, and the upstream gradient ``g`` [T] of the NLL ->
    dlogits [T, V] in the logits' dtype."""
    global bwd_launches
    _check(logits, labels)
    T, V = logits.shape
    for name, t in (("lse", lse), ("g", g)):
        if t.shape != (T,) or t.device != logits.device:
            raise ValueError(f"fused_cross_entropy_bwd: {name} must be [{T}] "
                             f"on {logits.device}, got {tuple(t.shape)} on "
                             f"{t.device}")
    labels = labels.contiguous()
    lse = lse.float().contiguous()
    g = g.float().contiguous()
    dx = torch.empty((T, V), dtype=logits.dtype, device=logits.device)
    if T:
        block = _block(V)
        with torch.cuda.device(logits.device):
            _jit()[1][(T, -(-V // block))](
                logits, labels, lse, g, dx, logits.stride(0), dx.stride(0), V,
                BLOCK=block, num_warps=8)
        bwd_launches += 1
    return dx
