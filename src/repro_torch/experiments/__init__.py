"""Monte-Carlo experiment harness (DESIGN.md §12): the port's copy of
``repro.experiments``.

Declarative sweep specs over (scenarios x policies x topologies x
seeds), compiled into shards, executed process-parallel with resumable
per-shard JSON outputs, and aggregated into mean/95%-CI metrics,
normalized-slowdown CDFs, and the paper's headline metaflow-vs-coflow
ratio — the machinery behind ``repro_torch.launch.sweep``.  Fifo,
fault-free cells can also run lockstep-batched on the port's engine
(``run_cells_batched``, on the card by default).
"""

from repro_torch.experiments.aggregate import (
    aggregate,
    check,
    fingerprint,
    mean_ci95,
    quantiles,
    t_crit95,
)
from repro_torch.experiments.resilience import (
    RESILIENCE_INTENSITIES,
    aggregate_resilience,
    check_resilience,
    resilience_spec,
)
from repro_torch.experiments.runner import (
    batchable,
    load_shard,
    run_cell,
    run_cells_batched,
    run_sweep,
    scenario_rows,
    shard_path,
)
from repro_torch.experiments.spec import (
    DEFAULT_TOPOLOGY,
    Cell,
    SweepSpec,
    resolve_topology,
    topology_arg,
    validate_topology_spec,
)

__all__ = [
    "Cell",
    "DEFAULT_TOPOLOGY",
    "RESILIENCE_INTENSITIES",
    "SweepSpec",
    "aggregate",
    "aggregate_resilience",
    "batchable",
    "check",
    "check_resilience",
    "fingerprint",
    "load_shard",
    "mean_ci95",
    "quantiles",
    "resilience_spec",
    "resolve_topology",
    "run_cell",
    "run_cells_batched",
    "run_sweep",
    "scenario_rows",
    "shard_path",
    "t_crit95",
    "topology_arg",
    "validate_topology_spec",
]
