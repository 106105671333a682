"""Static analysis over the metaflow pipeline (DESIGN.md §13, §16): the
port's copy of ``repro.analysis``.

Five layers, all LP- and simulation-free:

* :mod:`repro_torch.analysis.lint` — named checks over ``JobDAG`` batches and
  compiled scenarios, returning structured ``Finding``s;
* :mod:`repro_torch.analysis.bounds` — per-metaflow CCT and per-job JCT lower
  bounds (link bound x DAG critical path, composed per node into the
  load+chain bound), the optimality-gap denominator;
* :mod:`repro_torch.analysis.contention` — the cross-job contention graph and
  certified batch-level makespan/CCT bounds;
* :mod:`repro_torch.analysis.structure` — the static workload characterizer:
  spectrum metrics (flow↔metaflow↔coflow), per-scenario classification
  and the predicted MSA-advantage ranking;
* :mod:`repro_torch.analysis.sanitize` — the ``Decision`` invariant engine
  behind ``Simulator(debug_checks=True)`` and post-hoc trace audits.

Worked example — a certified lower bound, no simulation run::

    >>> from repro_torch.core import JobDAG, make_topology
    >>> from repro_torch.analysis import job_lower_bounds
    >>> job = JobDAG("j0")
    >>> _ = job.add_metaflow("m0", [(0, 1, 6.0), (0, 2, 2.0)])
    >>> job_lower_bounds(job, make_topology("big_switch", 3))
    (8.0, 8.0)

(8 bytes leave host 0's unit-capacity up-link, so no schedule finishes
the job before t=8; ``run_cell(analyze=True)`` asserts every simulated
JCT/CCT respects these bounds.)

``python -m repro_torch.analysis`` (:mod:`repro_torch.analysis.cli`) fronts lint
and structure-check as the CI analyze gate::

    python -m repro_torch.analysis                  # lint every scenario
    python -m repro_torch.analysis --structure      # + spectrum/bound checks
    python -m repro_torch.analysis --json           # machine-readable findings

It exits 1 only on error-severity findings (see DESIGN.md §16).
"""

from repro_torch.analysis.bounds import (assert_bounds_hold, flow_link_bytes,
                                   job_lower_bounds, link_seconds, mean_gap,
                                   mf_cct_lower_bound,
                                   scenario_lower_bounds)
from repro_torch.analysis.contention import (BatchBounds, LinkContention,
                                       assert_batch_bounds_hold,
                                       batch_bounds, contention_graph,
                                       link_load_bound)
from repro_torch.analysis.lint import (Finding, LintError, available_checks,
                                 check, expected_wire_bytes, lint_faults,
                                 lint_jobs, lint_lowered, lint_scenario,
                                 strict)
from repro_torch.analysis.sanitize import (DecisionRecord, InvariantViolation,
                                     RecordingScheduler,
                                     available_invariants, audit_decision,
                                     audit_record, audit_trace, invariant)
from repro_torch.analysis.structure import (SPECTRUM, JobStructure,
                                      ScenarioStructure, job_structure,
                                      predicted_ranking, rank_agreement,
                                      scenario_structure)

__all__ = [
    "SPECTRUM", "BatchBounds", "DecisionRecord", "Finding",
    "InvariantViolation", "JobStructure", "LinkContention", "LintError",
    "RecordingScheduler", "ScenarioStructure", "assert_batch_bounds_hold",
    "assert_bounds_hold", "audit_decision", "audit_record", "audit_trace",
    "available_checks", "available_invariants", "batch_bounds", "check",
    "contention_graph", "expected_wire_bytes", "flow_link_bytes",
    "invariant", "job_lower_bounds", "job_structure", "link_load_bound",
    "link_seconds", "lint_faults", "lint_jobs", "lint_lowered",
    "lint_scenario", "mean_gap", "mf_cct_lower_bound",
    "predicted_ranking", "rank_agreement", "scenario_lower_bounds",
    "scenario_structure", "strict",
]
