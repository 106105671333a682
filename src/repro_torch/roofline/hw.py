"""NVIDIA H100 SXM constants, per GPU.

Every value is the H100 SXM data sheet's, not a measurement:
``chip_smoke.py`` measures the card's HBM copy rate and bf16 matmul rate
and prints them beside these.  They take the place of the reference's TPU
v5e constants (``repro.roofline.analysis``) in the port's kernel bounds and
in ``core.comm_schedule``'s step-DAG plan.
"""

from __future__ import annotations

from typing import NamedTuple

# H100 SXM data sheet: dense bf16 tensor-core FLOP/s (without sparsity).
PEAK_FLOPS = 989e12
# H100 SXM data sheet: fp32 FLOP/s on the CUDA cores.
FP32_FLOPS = 67e12
# H100 SXM data sheet: HBM3 bytes/s.
HBM_BW = 3.35e12
# H100 SXM data sheet: NVLink bytes/s per direction per GPU (900 GB/s
# both ways).  Data parallelism beyond one node crosses InfiniBand
# instead, ~50e9 B/s per GPU with one 400 Gb/s NIC each.
LINK_BW = 450e9


class Chip(NamedTuple):
    """What the step-DAG plan needs of a device: its peak FLOP/s, its
    memory rate and its per-device link rate, in bytes/s."""

    peak_flops: float = PEAK_FLOPS
    hbm_bw: float = HBM_BW
    link_bw: float = LINK_BW


H100 = Chip()
