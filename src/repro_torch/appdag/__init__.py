"""The port's copy of ``repro.appdag``: ML parallelism plans compiled into
metaflow DAGs, and the registered scenarios built from them.

  ``lowering``  logical collectives -> per-port flow rounds,
  ``plans``     model config x ``PlanAxes`` -> per-step communication DAG,
  ``mixer``     job templates x arrival process -> mixed-cluster
                scenarios (``SCENARIOS``, ``build_scenario``).
"""

from repro_torch.appdag.lowering import (ALGORITHMS, COLLECTIVES,
                                         LoweredCollective, add_lowered,
                                         lower_collective, lower_grouped)
from repro_torch.appdag.mixer import (SCENARIO_TOPOLOGY, SCENARIOS,
                                      JobTemplate, build_scenario,
                                      mixed_templates, poisson_mix)
from repro_torch.appdag.plans import (PlanAxes, dense_train_dag,
                                      moe_train_dag, n_units,
                                      pipeline_serve_dag, unit_grad_bytes)

__all__ = [
    "ALGORITHMS", "COLLECTIVES", "JobTemplate", "LoweredCollective",
    "PlanAxes", "SCENARIOS", "SCENARIO_TOPOLOGY", "add_lowered",
    "build_scenario", "dense_train_dag", "lower_collective",
    "lower_grouped", "mixed_templates", "moe_train_dag", "n_units",
    "pipeline_serve_dag", "poisson_mix", "unit_grad_bytes",
]
