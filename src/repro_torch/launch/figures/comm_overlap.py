"""Metaflow scheduling applied to our own training step (the framework
integration table): for every assigned arch at train_4k, the simulated
step time under MSA-ordered bucket sync vs varys/fifo/flat-barrier, and
the fraction of gradient-sync traffic hidden under backward compute.

The port of the reference's ``benchmarks/comm_overlap.py``, on the port's
``core.comm_schedule.plan_step_comm`` (numpy, host only).  The table is a
model, not a measurement: it plans a 256-device data-parallel step from a
device's peak FLOP/s, memory rate and link rate.  It plans the reference's
device, a TPU v5e (``REFERENCE_CHIP``, the reference's
``repro.roofline.analysis`` constants), so the rows are the reference's
table; ``plan_step_comm``'s own default plans the H100.
"""

from __future__ import annotations

import time

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.configs.base import LM_SHAPES
from repro_torch.core.comm_schedule import plan_step_comm
from repro_torch.roofline.hw import Chip

# The reference's TPU v5e constants (bf16 FLOP/s, HBM bytes/s, ICI bytes/s
# per link): the device its framework-integration table was planned for.
REFERENCE_CHIP = Chip(peak_flops=197e12, hbm_bw=819e9, link_bw=50e9)


def run(quick: bool = False) -> list[tuple]:
    rows = []
    archs = ARCH_NAMES[:4] if quick else ARCH_NAMES
    for arch in archs:
        cfg = get_config(arch)
        if cfg.family == "encdec":
            continue   # enc-dec uses the same machinery via decoder units
        t0 = time.perf_counter()
        plan = plan_step_comm(cfg, LM_SHAPES["train_4k"], chip=REFERENCE_CHIP)
        us = (time.perf_counter() - t0) * 1e6
        s = plan.dag_steps
        rows.append((
            f"comm_overlap/{arch}", us,
            f"msa_s={s['msa']:.4f};varys_s={s['varys']:.4f};"
            f"fifo_s={s['fifo']:.4f};flat_s={s['flat']:.4f};"
            f"flat_over_msa={s['flat'] / s['msa']:.3f};"
            f"overlap={plan.overlap_fraction:.3f};"
            f"bucket_mb={plan.bucket_bytes / 1e6:.2f}"))
    return rows


def check(rows) -> list[str]:
    errs = []
    for name, _, derived in rows:
        parts = dict(kv.split("=") for kv in derived.split(";"))
        if float(parts["msa_s"]) > float(parts["flat_s"]) + 1e-9:
            errs.append(f"{name}: MSA worse than flat barrier")
        if float(parts["msa_s"]) > float(parts["varys_s"]) + 1e-9:
            errs.append(f"{name}: MSA worse than varys")
    return errs
