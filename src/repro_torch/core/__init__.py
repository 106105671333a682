"""The port's scheduling core: its copies of the JobDAG model, the fabric
and the FB workload synth (``metaflow``, ``fabric``, ``workload``), and the
lockstep fifo engine in torch (``simtorch``).

The copies hold what the scenario builder and ``simtorch.pack_instance``
reach and nothing else: a scenario is built and packed here, and the run
state lives in the engine's tensors, never in the job objects.
``tests/test_torch_scenarios.py`` holds every packed scenario equal to the
JAX package's.
"""

from repro_torch.core.fabric import Fabric, make_topology
from repro_torch.core.metaflow import EPS, JobDAG

__all__ = ["EPS", "Fabric", "JobDAG", "make_topology"]
