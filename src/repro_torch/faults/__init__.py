"""repro_torch.faults — seeded, declarative fault injection (DESIGN.md §15);
the port's copy of ``repro.faults``.

The :class:`FaultSpec` DSL compiles scheduled hard failures
(:class:`LinkFailure`/:class:`HostFailure`) and seeded renewal processes
(:class:`FlakyLinks` degrade storms, :class:`StragglerBurst`) into the
deterministic :class:`~repro_torch.core.simulator.FaultEvent` stream the
simulator executes, strict-linted by ``repro_torch.analysis.lint.lint_faults``.
:func:`chaos_spec` is the intensity-scaled scenario family behind the
resilience sweep (``repro_torch.launch.resilience``).

Worked example — one scheduled link-failure window, compiled to the
deterministic event stream the simulator consumes::

    >>> from repro_torch.core import make_topology
    >>> from repro_torch.faults import FaultSpec, LinkFailure
    >>> spec = FaultSpec(horizon=10.0,
    ...                  failures=(LinkFailure(link=0, at=2.0,
    ...                                        repair_at=4.0),))
    >>> [(e.time, e.kind, e.target)
    ...  for e in spec.compile(make_topology("big_switch", 2))]
    [(2.0, 'fail_link', 0), (4.0, 'repair_link', 0)]

Quickstart for the intensity-scaled chaos family::

    from repro_torch.core import simulate
    from repro_torch.faults import chaos_spec

    spec = chaos_spec(fabric, jobs, intensity=1.0, seed=0)
    res = simulate(jobs, scheduler, fabric=fabric,
                   faults=spec.compile(fabric.topology),
                   retransmit=spec.retransmit)
"""

from repro_torch.faults.spec import (
    FAULT_STREAM,
    FaultSpec,
    FlakyLinks,
    HostFailure,
    LinkFailure,
    StragglerBurst,
    chaos_spec,
    mean_flow_size,
    workload_horizon,
)

__all__ = [
    "FAULT_STREAM",
    "FaultSpec",
    "FlakyLinks",
    "HostFailure",
    "LinkFailure",
    "StragglerBurst",
    "chaos_spec",
    "mean_flow_size",
    "workload_horizon",
]
