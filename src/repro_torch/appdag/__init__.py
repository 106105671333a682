"""The port's copy of ``repro.appdag``: ML parallelism plans compiled into
metaflow DAGs, and the registered scenarios built from them.

  ``lowering``  logical collectives -> per-port flow rounds,
  ``plans``     model config x ``PlanAxes`` -> per-step communication DAG,
  ``mixer``     job templates x arrival process -> mixed-cluster
                scenarios (``SCENARIOS``, ``build_scenario``).
"""

from repro_torch.appdag.mixer import (SCENARIO_TOPOLOGY, SCENARIOS,
                                      build_scenario)

__all__ = ["SCENARIOS", "SCENARIO_TOPOLOGY", "build_scenario"]
