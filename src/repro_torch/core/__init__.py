"""The port's scheduling core: its copies of the JobDAG model, the fabric,
the FB workload synth, the numpy event simulator and the five registered
policies (``metaflow``, ``fabric``, ``workload``, ``simulator``, ``sched``),
and the lockstep fifo engine in torch (``simtorch``).

The copies are the reference's modules with the port's imports:
``tests/test_torch_scenarios.py`` holds every packed scenario equal to the
JAX package's, and ``tests/test_torch_comm_schedule.py`` every simulation
of the copied simulator and policies equal to the reference's.
"""

from repro_torch.core.fabric import Fabric, make_topology
from repro_torch.core.metaflow import EPS, JobDAG
from repro_torch.core.sched import available_policies, make_scheduler
from repro_torch.core.simulator import SimResult, Simulator, simulate

__all__ = ["EPS", "Fabric", "JobDAG", "SimResult", "Simulator",
           "available_policies", "make_scheduler", "make_topology",
           "simulate"]
