"""The port's scheduling core: its copies of the JobDAG model, the fabric,
the FB workload synth and trace reader, the numpy event simulator, the
frozen pre-compaction simulator, object-level MADD, its run summary and
the five registered policies (``metaflow``, ``fabric``, ``workload``,
``simulator``, ``simref``, ``madd``, ``results``, ``sched``), and the
lockstep fifo engine in torch (``simtorch``).

The copies are the reference's modules with the port's imports:
``tests/test_torch_scenarios.py`` holds every packed scenario equal to the
JAX package's, ``tests/test_torch_comm_schedule.py`` every simulation of
the copied simulator and policies equal to the reference's, and
``tests/test_torch_simref.py`` the frozen core, MADD and the FB synth and
trace reader.  This package exports the names the reference's
``repro.core`` exports, so a script ported from the reference keeps its
import lines with ``repro`` replaced by ``repro_torch``.
"""

from repro_torch.core.fabric import (BigSwitch, Fabric, FatTree, LeafSpine,
                                     Topology, big_switch, fat_tree,
                                     leaf_spine, make_topology)
from repro_torch.core.metaflow import (EPS, ComputeTask, Flow, JobDAG,
                                       Metaflow, figure1_jobs, figure2_job)
from repro_torch.core.results import RunResult
from repro_torch.core.sched import (CriticalPathScheduler, Decision,
                                    FairScheduler, FifoScheduler,
                                    MSAScheduler, Scheduler, VarysScheduler,
                                    available_policies, make_scheduler,
                                    metaflow_priorities, register)
from repro_torch.core.simref import (ReferenceSimulator,
                                     UnsupportedTopologyError,
                                     simulate_reference)
from repro_torch.core.simulator import (FAULT_KINDS, FaultEvent,
                                        Perturbation, RetransmitPolicy,
                                        SimResult, Simulator, fault_key,
                                        simulate)

__all__ = [
    "BigSwitch", "ComputeTask", "CriticalPathScheduler", "Decision", "EPS",
    "FAULT_KINDS", "Fabric", "FairScheduler", "FatTree", "FaultEvent",
    "FifoScheduler", "Flow", "JobDAG",
    "LeafSpine", "MSAScheduler", "Metaflow", "Perturbation",
    "ReferenceSimulator", "RetransmitPolicy", "RunResult", "Scheduler",
    "SimResult", "Simulator",
    "Topology", "UnsupportedTopologyError",
    "VarysScheduler", "available_policies", "big_switch", "fat_tree",
    "fault_key", "figure1_jobs", "figure2_job", "leaf_spine",
    "make_scheduler", "make_topology", "metaflow_priorities", "register",
    "simulate", "simulate_reference",
]
