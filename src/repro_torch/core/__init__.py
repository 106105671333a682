"""The port's scheduling core: its copies of the JobDAG model, the fabric,
the FB workload synth, the numpy event simulator, its run summary and the
five registered policies (``metaflow``, ``fabric``, ``workload``,
``simulator``, ``results``, ``sched``), and the lockstep fifo engine in
torch (``simtorch``).

The copies are the reference's modules with the port's imports:
``tests/test_torch_scenarios.py`` holds every packed scenario equal to the
JAX package's, and ``tests/test_torch_comm_schedule.py`` every simulation
of the copied simulator and policies equal to the reference's.
"""

from repro_torch.core.fabric import Fabric, make_topology
from repro_torch.core.metaflow import EPS, JobDAG
from repro_torch.core.sched import available_policies, make_scheduler
from repro_torch.core.results import RunResult
from repro_torch.core.simulator import (FAULT_KINDS, FaultEvent,
                                        RetransmitPolicy, SimResult,
                                        Simulator, fault_key, simulate)

__all__ = ["EPS", "FAULT_KINDS", "Fabric", "FaultEvent", "JobDAG",
           "RetransmitPolicy", "RunResult", "SimResult", "Simulator",
           "available_policies", "fault_key", "make_scheduler",
           "make_topology", "simulate"]
