"""Plan extractors: model config x parallelism axes -> per-step JobDAG.

The port's copy of ``repro.appdag.plans`` (plain Python, no JAX), on the
port's own ``configs`` and ``core.metaflow``.

Each extractor walks a ``ModelConfig`` plus a ``PlanAxes`` (DP/TP/PP/EP
sizes) and emits the communication DAG of one training step (or one
serving request) with compute nodes between the collectives, lowering
every logical collective through ``appdag.lowering``:

  ``dense_train_dag``    backward chain with TP activation-grad
                         all-reduces, inter-stage activation p2p, per-unit
                         DP gradient all-reduce, optimizer updates.
  ``moe_train_dag``      the dense skeleton plus, per MoE unit, the two
                         expert-parallel all-to-alls (combine-grad before
                         the unit's backward, dispatch-grad after) and the
                         expert-gradient all-reduce over the dp/ep replica
                         groups.
  ``pipeline_serve_dag`` GPipe-style pipelined prefill: the (stage x
                         microbatch) compute grid with per-boundary
                         activation p2p metaflows.

Port-numbering convention (DESIGN.md §9): one fabric port per device,
``rank(pp_i, dp_i, tp_i) = port_base + (pp_i * dp + dp_i) * tp + tp_i``,
so a plan occupies the contiguous span ``[port_base, port_base + world)``
and the arrival mixer places jobs by choosing ``port_base``.  This is the
same "one contended port per participant" convention ``core/workload.py``
uses for mappers/reducers.

Sizes are in seconds-at-unit-capacity (flow size = transfer seconds at
full link rate, compute load = seconds).  All analytics are derived from
the config alone.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.appdag.lowering import add_lowered, lower_grouped
from repro_torch.configs.base import (ModelConfig, ShapeConfig,
                                      active_param_count, param_count)
from repro_torch.core.metaflow import JobDAG

# The scenarios' own parameters: the compute rate (FLOP/s), memory rate and
# link rate (bytes/s) by which the extractors turn a plan's FLOPs and bytes
# into the modelled jobs' compute loads and transfer sizes.  Equal to the
# reference's (``tests/test_torch_scenarios.py``); changing one regenerates
# every scenario.
PEAK_FLOPS = 197e12
HBM_BW = 819e9
LINK_BW = 50e9


@dataclass(frozen=True)
class PlanAxes:
    """Parallelism degrees.  ``world = dp * tp * pp``; ``ep`` partitions
    each DP group into expert shards (``ep`` must divide ``dp``)."""

    dp: int = 1
    tp: int = 1
    pp: int = 1
    ep: int = 1

    def __post_init__(self) -> None:
        for ax, v in (("dp", self.dp), ("tp", self.tp), ("pp", self.pp),
                      ("ep", self.ep)):
            if v < 1:
                raise ValueError(f"{ax} must be >= 1, got {v}")
        if self.dp % self.ep:
            raise ValueError(f"ep={self.ep} must divide dp={self.dp}")

    @property
    def world(self) -> int:
        return self.dp * self.tp * self.pp

    # ----------------------------------------------------------- port maps
    def rank(self, pp_i: int, dp_i: int, tp_i: int, port_base: int = 0) -> int:
        return port_base + (pp_i * self.dp + dp_i) * self.tp + tp_i

    def dp_groups(self, pp_i: int, port_base: int = 0) -> list[tuple[int, ...]]:
        """One group per tp index at stage ``pp_i`` (gradient sync peers)."""
        return [tuple(self.rank(pp_i, d, t, port_base) for d in range(self.dp))
                for t in range(self.tp)]

    def tp_groups(self, pp_i: int, port_base: int = 0) -> list[tuple[int, ...]]:
        """One group per dp index at stage ``pp_i`` (activation sync peers)."""
        return [tuple(self.rank(pp_i, d, t, port_base) for t in range(self.tp))
                for d in range(self.dp)]

    def ep_groups(self, pp_i: int, port_base: int = 0) -> list[tuple[int, ...]]:
        """EP groups: each DP group split into ``dp/ep`` chunks of ``ep``."""
        out = []
        for g in self.dp_groups(pp_i, port_base):
            out.extend(tuple(g[c:c + self.ep])
                       for c in range(0, self.dp, self.ep))
        return out

    def ep_replica_groups(self, pp_i: int,
                          port_base: int = 0) -> list[tuple[int, ...]]:
        """Expert-gradient sync peers: same expert shard across the dp/ep
        EP chunks of one DP group."""
        reps = self.dp // self.ep
        out = []
        for g in self.dp_groups(pp_i, port_base):
            for j in range(self.ep):
                out.append(tuple(g[c * self.ep + j] for c in range(reps)))
        return out


# ------------------------------------------------------------ config math
def n_units(cfg: ModelConfig) -> int:
    """Scan-unit count, from the config alone (mirrors the model's unit
    layout)."""
    if cfg.family == "hybrid":
        unit_len = cfg.attn_layer_period
    elif cfg.is_moe and cfg.moe_layer_period > 1:
        unit_len = cfg.moe_layer_period
    else:
        unit_len = 1
    return max(1, cfg.n_layers // unit_len)


def _embed_params(cfg: ModelConfig) -> int:
    return cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2)


def unit_grad_bytes(cfg: ModelConfig) -> float:
    """bf16 gradient bytes of one scan unit (embeddings excluded)."""
    return 2.0 * (param_count(cfg) - _embed_params(cfg)) / n_units(cfg)


def unit_bwd_seconds(cfg: ModelConfig, tokens: float, world: int) -> float:
    """Roofline backward+recompute seconds for one unit's step share."""
    active = active_param_count(cfg) - _embed_params(cfg)
    flops = 6.0 * (active / n_units(cfg)) * tokens
    return flops / (world * PEAK_FLOPS)


def _stage_of(u: int, n_units_: int, pp: int) -> int:
    """Contiguous unit->stage assignment (stage s owns a block of units)."""
    return u * pp // n_units_


# ------------------------------------------------------------- extractors
def _train_dag(cfg: ModelConfig, shape: ShapeConfig, plan: PlanAxes,
               default_name: str, algorithm: str, max_units: int | None,
               link_bw: float, port_base: int, name: str | None,
               arrival: float, opt_ratio: float) -> JobDAG:
    """Shared training-step emitter (backward runs top unit first).

    Per unit ``u`` (stage ``s(u)``), in DAG order:
      * MoE unit: combine-grad all-to-all ``a2a_c{u}`` over the EP groups
        *before* the unit's backward (the backward of combine is a
        dispatch),
      * compute ``bwd{u}`` (deps: the previous unit's backward gate),
      * MoE unit: dispatch-grad all-to-all ``a2a_d{u}`` after it,
      * TP > 1: activation-grad all-reduce ``tpar{u}`` over the stage's TP
        groups (merged rounds — SPMD lockstep), gating the next unit,
      * stage boundary: activation-grad p2p ``act{u}`` to the stage below,
      * gradient sync consumed by ``opt{u}`` (memory-bound update):
        dense/shared grads ``g{u}`` all-reduced over the stage's DP
        groups; expert grads ``ge{u}`` over the dp/ep replica groups —
        independent buckets unlocking the same optimizer shard.

    Dense configs are the degenerate case: no MoE units, so only the
    ``bwd``/``tpar``/``act``/``g``/``opt`` skeleton is emitted.

    ``max_units`` truncates the emitted unit count (a model slab) while
    keeping per-unit sizes those of the full model — benchmark DAGs stay
    tractable without distorting per-bucket arithmetic.
    """
    U_full = n_units(cfg)
    U = min(U_full, max_units) if max_units else U_full
    tokens = shape.global_batch * shape.seq_len
    bwd = unit_bwd_seconds(cfg, tokens, plan.world)

    # Split the unit's grads into expert vs dense(shared) buckets; both
    # are zero-expert for dense configs.  TP shards every bucket
    # ``tp``-ways; experts additionally shard over EP.
    D, F = cfg.d_model, cfg.d_ff
    moe_layers = sum(1 for i in range(cfg.n_layers) if cfg.is_moe_layer(i))
    # With ep == 1 experts are DP-replicated like any other param, so they
    # stay in the dense bucket (and the expert bucket is empty).
    expert_params_unit = ((moe_layers * cfg.n_experts * 3 * D * F) / U_full
                          if plan.ep > 1 else 0.0)
    dense_grad_bytes = max(unit_grad_bytes(cfg) - 2.0 * expert_params_unit,
                           0.0) / plan.tp
    expert_grad_bytes = 2.0 * expert_params_unit / (plan.ep * plan.tp)
    g_xfer = dense_grad_bytes / link_bw
    ge_xfer = expert_grad_bytes / link_bw
    opt_load = (opt_ratio * (g_xfer + ge_xfer)
                + (dense_grad_bytes + expert_grad_bytes) * 6 / HBM_BW)
    # Routed-token payload per rank for one unit's all-to-all, and the
    # activation(-grad) buffer of this rank's batch shard (bf16).
    a2a_xfer = (2.0 * (tokens / plan.dp) * D * cfg.experts_per_token
                / plan.tp / link_bw)
    act_xfer = 2.0 * (tokens / plan.dp) * D / plan.tp / link_bw

    job = JobDAG(name=name or default_name, arrival=arrival)
    gate: str | None = None          # what the next (lower) unit waits on
    for u in reversed(range(U)):
        s = _stage_of(u, U, plan.pp)
        moe_unit = plan.ep > 1 and cfg.is_moe_layer(
            (u + 1) * (cfg.n_layers // U_full) - 1)
        bwd_deps = [gate] if gate else []
        if moe_unit:
            a2a_c = lower_grouped("all_to_all", plan.ep_groups(s, port_base),
                                  a2a_xfer, algorithm)
            last = add_lowered(job, f"a2a_c{u}", a2a_c, deps=bwd_deps)
            bwd_deps = [last] if last else bwd_deps
        job.add_task(f"bwd{u}", load=bwd,
                     machine=plan.rank(s, 0, 0, port_base), deps=bwd_deps)
        gate = f"bwd{u}"
        if moe_unit:
            a2a_d = lower_grouped("all_to_all", plan.ep_groups(s, port_base),
                                  a2a_xfer, algorithm)
            last = add_lowered(job, f"a2a_d{u}", a2a_d, deps=[gate])
            gate = last or gate
        if plan.tp > 1:
            tpar = lower_grouped("all_reduce", plan.tp_groups(s, port_base),
                                 act_xfer, algorithm)
            last = add_lowered(job, f"tpar{u}", tpar, deps=[gate])
            gate = last or gate
        if u > 0:
            s_next = _stage_of(u - 1, U, plan.pp)
            if s_next != s:
                flows = [(plan.rank(s, d, t, port_base),
                          plan.rank(s_next, d, t, port_base), act_xfer)
                         for d in range(plan.dp) for t in range(plan.tp)]
                job.add_metaflow(f"act{u}", flows=flows, deps=[gate])
                gate = f"act{u}"
        opt_deps: list[str] = []
        if plan.dp > 1 and g_xfer > 0:
            g = lower_grouped("all_reduce", plan.dp_groups(s, port_base),
                              g_xfer, algorithm)
            last = add_lowered(job, f"g{u}", g, deps=[f"bwd{u}"])
            if last:
                opt_deps.append(last)
        if moe_unit and plan.dp // plan.ep > 1 and ge_xfer > 0:
            ge = lower_grouped("all_reduce",
                               plan.ep_replica_groups(s, port_base),
                               ge_xfer, algorithm)
            last = add_lowered(job, f"ge{u}", ge, deps=[f"bwd{u}"])
            if last:
                opt_deps.append(last)
        job.add_task(f"opt{u}", load=opt_load,
                     machine=plan.rank(s, 0, 0, port_base),
                     deps=opt_deps or [f"bwd{u}"])
    job.validate()
    return job


def dense_train_dag(cfg: ModelConfig, shape: ShapeConfig, plan: PlanAxes,
                    *, algorithm: str = "ring", max_units: int | None = None,
                    link_bw: float = LINK_BW, port_base: int = 0,
                    name: str | None = None, arrival: float = 0.0,
                    opt_ratio: float = 0.15) -> JobDAG:
    """One training step of a dense model under ``plan`` (see
    ``_train_dag`` for the emitted structure)."""
    return _train_dag(cfg, shape, plan,
                      f"{cfg.name}-{shape.name}-"
                      f"dp{plan.dp}tp{plan.tp}pp{plan.pp}",
                      algorithm, max_units, link_bw, port_base, name,
                      arrival, opt_ratio)


def moe_train_dag(cfg: ModelConfig, shape: ShapeConfig, plan: PlanAxes,
                  *, algorithm: str = "ring", max_units: int | None = None,
                  link_bw: float = LINK_BW, port_base: int = 0,
                  name: str | None = None, arrival: float = 0.0,
                  opt_ratio: float = 0.15) -> JobDAG:
    """One training step of an MoE model with expert parallelism: the
    dense skeleton plus per-MoE-unit all-to-alls and the split
    dense/expert gradient buckets (see ``_train_dag``)."""
    if not cfg.is_moe:
        raise ValueError(f"{cfg.name} is not an MoE config")
    return _train_dag(cfg, shape, plan,
                      f"{cfg.name}-{shape.name}-dp{plan.dp}ep{plan.ep}",
                      algorithm, max_units, link_bw, port_base, name,
                      arrival, opt_ratio)


def pipeline_serve_dag(cfg: ModelConfig, plan: PlanAxes, *,
                       n_microbatches: int = 4, tokens_per_mb: float = 2048,
                       link_bw: float = LINK_BW, port_base: int = 0,
                       name: str | None = None,
                       arrival: float = 0.0) -> JobDAG:
    """One pipelined prefill request: the GPipe (stage x microbatch) grid.

    Compute ``c{s}m{m}`` (stage s, microbatch m) depends on the stage's
    previous microbatch (the stage is busy) and on the activation p2p
    metaflow ``x{s}m{m}`` from stage s-1 (one flow per TP rank pair; DP in
    serving means independent replicas, so use ``dp=1`` per request).
    Intra-stage TP all-reduces are folded into the compute load — they ride
    the stage-internal mesh, not the inter-stage fabric this DAG contends
    for.
    """
    if plan.pp < 1:
        raise ValueError("pipeline_serve_dag needs pp >= 1")
    active = active_param_count(cfg)
    # Forward-only: ~2 flops/param/token, stage share, TP split.
    stage_load = (2.0 * (active / plan.pp) * tokens_per_mb
                  / (plan.tp * PEAK_FLOPS))
    act_xfer = 2.0 * tokens_per_mb * cfg.d_model / plan.tp / link_bw

    job = JobDAG(name=name or f"{cfg.name}-serve-pp{plan.pp}",
                 arrival=arrival)
    for m in range(n_microbatches):
        for s in range(plan.pp):
            deps: list[str] = []
            if m > 0:
                deps.append(f"c{s}m{m - 1}")
            if s > 0:
                flows = [(plan.rank(s - 1, d, t, port_base),
                          plan.rank(s, d, t, port_base), act_xfer)
                         for d in range(plan.dp) for t in range(plan.tp)]
                job.add_metaflow(f"x{s}m{m}", flows=flows,
                                 deps=[f"c{s - 1}m{m}"])
                deps.append(f"x{s}m{m}")
            job.add_task(f"c{s}m{m}", load=stage_load,
                         machine=plan.rank(s, 0, 0, port_base), deps=deps)
    job.validate()
    return job
