"""Metaflow/MSA bridge to the training step: DAG-aware gradient-sync order.

Port of ``repro.core.comm_schedule``.  The training step of an L-unit
model is itself a distributed-application DAG in the paper's sense:

  compute tasks:  bwd_U -> bwd_{U-1} -> ... -> bwd_1   (backward, reverse
                  layer order), then opt_u per unit (optimizer shard update)
  metaflows:      g_u = the gradient bucket of unit u, produced by bwd_u,
                  consumed by opt_u

Every g_u is *direct* in MSA terms (it alone unlocks opt_u), so MSA ranks
buckets by opt_load / remaining_bytes and keeps re-ranking as buckets
drain: the priority-bucket overlap schedule, derived from the paper's
abstraction.

The fabric is the per-device link (all data-parallel peers are
symmetric): one egress/ingress pair whose capacity is the link bandwidth;
a ring reduce-scatter of ``bytes`` pushes ~``bytes`` through each device's
link.

Outputs:
  * a static bucket priority order, which ``parallel.collectives`` issues
    as the order of the step's collectives, and
  * simulated step times under msa / varys / fifo / flat-barrier sync.

The plan runs on the port's copies of the numpy simulator and the policy
registry.  Where the reference reads TPU v5e module constants, every
function here takes ``chip`` (``roofline.hw.H100`` by default); given the
reference's constants it gives the reference's plan exactly
(``tests/test_torch_comm_schedule.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import (ModelConfig, ShapeConfig,
                                      active_param_count, param_count)
from repro_torch.core.metaflow import JobDAG
from repro_torch.core.sched import make_scheduler
from repro_torch.core.simulator import simulate
from repro_torch.models.transformer import n_units
from repro_torch.roofline.hw import H100, Chip


def _embed_params(cfg: ModelConfig) -> int:
    return cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2)


def unit_param_bytes(cfg: ModelConfig) -> float:
    """Parameter bytes of one unit (bf16), excluding embeddings."""
    return 2.0 * (param_count(cfg) - _embed_params(cfg)) / n_units(cfg)


def unit_bwd_seconds(cfg: ModelConfig, shape: ShapeConfig, chips: int = 256,
                     chip: Chip = H100) -> float:
    """Roofline estimate of one unit's backward+recompute time per step."""
    active = active_param_count(cfg) - _embed_params(cfg)
    tokens = shape.global_batch * shape.seq_len
    # bwd + recompute ~ 6 flops/param/token of the unit's active params
    flops = 6.0 * (active / n_units(cfg)) * tokens
    return flops / (chips * chip.peak_flops)


@dataclass
class StepCommPlan:
    order: list[int]              # unit indices, highest priority first
    dag_steps: dict[str, float]   # policy -> simulated step seconds
    bucket_bytes: float           # per-device bytes per bucket
    overlap_fraction: float       # comm hidden by MSA vs flat barrier


def build_train_dag(cfg: ModelConfig, shape: ShapeConfig, chips: int = 256,
                    chip: Chip = H100, flat: bool = False,
                    opt_ratio: float = 0.15) -> JobDAG:
    """The training-step DAG on a 2-port per-device link.

    Sizes are in seconds-at-unit-capacity (flow size = transfer seconds at
    full link rate; compute load = seconds).  ``flat=True`` builds the
    barrier variant: one metaflow carrying every bucket, all optimizer
    updates gated on it (the classic end-of-step all-reduce).
    """
    U = n_units(cfg)
    bwd = unit_bwd_seconds(cfg, shape, chips, chip)
    bytes_u = unit_param_bytes(cfg) / chips        # FSDP shard per device
    xfer = bytes_u / chip.link_bw                  # ring RS ~ bytes once
    opt_load = opt_ratio * xfer + bytes_u * 6 / chip.hbm_bw  # memory-bound

    job = JobDAG(name=f"{cfg.name}-{shape.name}")
    # Backward chain: unit U-1 (top) runs first.
    prev = None
    for u in reversed(range(U)):
        deps = [prev] if prev else []
        job.add_task(f"bwd{u}", load=bwd, deps=deps)
        prev = f"bwd{u}"
    if flat:
        job.add_metaflow("g_all", flows=[(0, 1, xfer * U)], deps=["bwd0"])
        for u in range(U):
            job.add_task(f"opt{u}", load=opt_load, deps=["g_all"])
    else:
        for u in range(U):
            job.add_metaflow(f"g{u}", flows=[(0, 1, xfer)],
                             deps=[f"bwd{u}"])
            job.add_task(f"opt{u}", load=opt_load, deps=[f"g{u}"])
    job.validate()
    return job


def plan_step_comm(cfg: ModelConfig, shape: ShapeConfig, chips: int = 256,
                   chip: Chip = H100) -> StepCommPlan:
    """MSA's bucket order for one step, and the step simulated under msa,
    varys, fifo and the flat barrier."""
    U = n_units(cfg)
    steps: dict[str, float] = {}
    for policy in ("msa", "varys", "fifo"):
        job = build_train_dag(cfg, shape, chips, chip)
        res = simulate([job], make_scheduler(policy), n_ports=2)
        steps[policy] = res.avg_jct
        if policy == "msa":
            # The policy's realized transfer order, read straight off the
            # scheduler's Decisions (first-service order).
            order = [int(name[1:]) for _, name in res.mf_service_order]
    job = build_train_dag(cfg, shape, chips, chip, flat=True)
    steps["flat"] = simulate([job], make_scheduler("msa"), n_ports=2).avg_jct

    denom = max(steps["flat"] - steps["msa"], 0.0)
    comm = U * unit_param_bytes(cfg) / chips / chip.link_bw
    overlap = min(denom / comm, 1.0) if comm > 0 else 0.0
    return StepCommPlan(order=order, dag_steps=steps,
                        bucket_bytes=unit_param_bytes(cfg) / chips,
                        overlap_fraction=overlap)
