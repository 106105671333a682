"""Unified scheduling-policy API.

The port's copy of ``repro.core.sched`` (its own registry, the five
policies); only the imports differ.

The policy surface of the reproduction: the ``Scheduler`` contract with
its event-driven lifecycle, the ``Decision`` it produces (rates + explicit
metaflow priority order), the string-keyed registry every entry point
resolves policies through, and the built-in policy family:

    msa    — the paper's Metaflow Scheduling Algorithm (Algorithm 1)
    varys  — coflow SEBF + MADD (Varys, SIGCOMM'14)
    fifo   — coflow FIFO by job arrival (Baraat-style)
    fair   — per-flow max-min fairness
    cpath  — DAG-critical-path-first (Sincronia-style ordered policy)

Worked example — resolve a policy by name and run it::

    >>> from repro_torch.core import JobDAG, simulate
    >>> from repro_torch.core.sched import available_policies, make_scheduler
    >>> available_policies()
    ('cpath', 'fair', 'fifo', 'msa', 'varys')
    >>> job = JobDAG("j0")
    >>> _ = job.add_metaflow("m0", [(0, 1, 8.0)])
    >>> res = simulate([job], make_scheduler("fifo"), n_ports=2)
    >>> res.jct["j0"]                   # 8 bytes over a unit-cap link
    8.0

Adding a policy is a decorator away (it then resolves everywhere —
sweeps, benchmarks, CLIs — by its string key)::

    @register("my_policy")
    class MyScheduler(Scheduler):
        ...

See DESIGN.md §3 ("The scheduling-policy contract") for the caching
semantics, the ``Decision`` invariants, and the lifecycle hooks; see
DESIGN.md §17 for the extra contract a policy must satisfy to run on
the batched JAX engine.
"""

from repro_torch.core.sched.base import Decision, Scheduler
from repro_torch.core.sched.baselines import (FairScheduler, FifoScheduler,
                                        VarysScheduler)
from repro_torch.core.sched.critical_path import CriticalPathScheduler
from repro_torch.core.sched.msa import (MetaflowPriority, MSAScheduler,
                                  metaflow_priorities)
from repro_torch.core.sched.registry import (available_policies, make_scheduler,
                                       register)

__all__ = [
    "CriticalPathScheduler", "Decision", "FairScheduler", "FifoScheduler",
    "MSAScheduler", "MetaflowPriority", "Scheduler", "VarysScheduler",
    "available_policies", "make_scheduler", "metaflow_priorities",
    "register",
]
