"""Declarative sweep specs: (scenarios x policies x topologies x seeds).

The port's copy of ``repro.experiments.spec``: equal specs give equal
``spec_hash`` in both packages (``tests/test_torch_experiments.py``).

A ``SweepSpec`` names *what* to measure; ``cells()`` compiles it into
the flat list of independent measurement cells (one simulation each),
and ``shards()`` chunks those cells into the resumable execution units
``repro_torch.experiments.runner`` runs process-parallel.

Seed discipline (DESIGN.md §12): seed index ``k`` of a sweep uses
workload seed ``seed0 + k`` — the *same* seed across every policy of
one (scenario, topology, seed) group, so policy comparisons are paired
on bit-identical workloads, and seed 0 of the default spec is exactly
the workload the reference's single-seed benchmark gates
(``benchmarks/ml_workloads``) run, keeping the two trajectories
cross-checkable.  Every cell is independently reproducible: rebuilding
it outside the sweep via ``build_scenario(scenario, seed=seed,
topology=topology)`` gives the bit-identical result (asserted in
``tests/test_experiments.py`` for the reference, whose records the
port's equal).

Worked example — compile a spec into its paired cells::

    >>> from repro_torch.experiments import SweepSpec
    >>> spec = SweepSpec(scenarios=("pipe_serve",),
    ...                  policies=("fifo", "msa"), n_seeds=2)
    >>> [c.seed for c in spec.cells()]  # policies adjacent per workload
    [0, 0, 1, 1]
    >>> spec.cells()[0]                 # doctest: +NORMALIZE_WHITESPACE
    Cell(scenario='pipe_serve', policy='fifo', topology='big_switch',
         seed=0, fault_intensity=0.0)
    >>> len(spec.shards())              # 4 cells fit one default shard
    1

``repro_torch.experiments.run_sweep`` executes those shards process-parallel
and resumably; ``run_cells_batched`` routes the fifo fault-free subset
through the port's lockstep engine (``repro_torch.core.simtorch``)
instead (DESIGN.md §17).
"""

from __future__ import annotations

import argparse
import hashlib
import json
from dataclasses import dataclass

from repro_torch.appdag.mixer import SCENARIO_TOPOLOGY, SCENARIOS
from repro_torch.core.fabric import make_topology
from repro_torch.core.sched import available_policies

#: Sentinel topology meaning "the scenario's registered default".
DEFAULT_TOPOLOGY = "default"


def validate_topology_spec(spec: str, allow_default: bool = False) -> str:
    """Fail fast on an unknown topology spec, naming the valid forms.

    Parses via ``make_topology`` against a probe port count, so the
    accepted grammar can never drift from the builder's."""
    if allow_default and spec == DEFAULT_TOPOLOGY:
        return spec
    try:
        make_topology(spec, 8)
    except ValueError:
        forms = "big_switch, leaf_spine_<R>to1 (e.g. leaf_spine_3to1), fat_tree"
        if allow_default:
            forms = f"{DEFAULT_TOPOLOGY}, {forms}"
        msg = f"unknown topology spec {spec!r}; valid forms: {forms}"
        raise ValueError(msg) from None
    return spec


def topology_arg(spec: str) -> str:
    """``argparse`` type= adapter for ``--topology`` flags: unknown specs
    abort argument parsing with the list of valid forms."""
    try:
        return validate_topology_spec(spec)
    except ValueError as e:
        raise argparse.ArgumentTypeError(str(e)) from None


def resolve_topology(scenario: str, topology: str | None) -> str:
    """Concrete topology spec for one cell: an explicit spec wins,
    ``None``/``"default"`` falls back to the scenario's registered
    default (big-switch when unregistered)."""
    if topology is None or topology == DEFAULT_TOPOLOGY:
        return SCENARIO_TOPOLOGY.get(scenario, "big_switch")
    return topology


@dataclass(frozen=True)
class Cell:
    """One measurement: a single (scenario, policy, topology, seed) run.

    ``topology`` is always concrete (``default`` is resolved when the
    spec is compiled), so shard files and aggregates are
    self-describing."""

    scenario: str
    policy: str
    topology: str
    seed: int
    #: Chaos fault intensity (``repro_torch.faults.chaos_spec``); 0 = fault-free.
    fault_intensity: float = 0.0


@dataclass(frozen=True)
class SweepSpec:
    """The declarative experiment sweep the harness executes."""

    scenarios: tuple[str, ...]
    policies: tuple[str, ...]
    n_seeds: int
    topologies: tuple[str, ...] = (DEFAULT_TOPOLOGY,)
    seed0: int = 0
    quick: bool = False
    cells_per_shard: int = 10
    #: Baseline policy for normalized-slowdown CDFs and speedup ratios.
    baseline: str = "varys"
    #: (scenario, policy, baseline) of the headline ratio — the paper's
    #: metaflow-vs-coflow claim is MSA vs varys/SEBF on the mixed cluster.
    headline: tuple[str, str, str] = ("mixed", "msa", "varys")
    #: Chaos fault-intensity axis (``repro_torch.faults.chaos_spec``).  The
    #: default ``(0.0,)`` is the fault-free sweep and serializes to
    #: nothing, so the spec hash of every existing sweep is unchanged.
    fault_intensities: tuple[float, ...] = (0.0,)

    def __post_init__(self):
        known_scen = sorted(SCENARIOS)
        for s in self.scenarios:
            if s not in SCENARIOS:
                raise ValueError(f"unknown scenario {s!r}; valid: {known_scen}")
        known_pol = available_policies()
        named = (*self.policies, self.baseline, self.headline[1], self.headline[2])
        for p in named:
            if p not in known_pol:
                raise ValueError(f"unknown policy {p!r}; valid: {known_pol}")
        for t in self.topologies:
            validate_topology_spec(t, allow_default=True)
        for scen in self.scenarios:
            resolved = [resolve_topology(scen, t) for t in self.topologies]
            if len(set(resolved)) != len(resolved):
                msg = (
                    f"topologies {list(self.topologies)} resolve to duplicate "
                    f"concrete specs {resolved} for scenario {scen!r} — every "
                    "cell would run twice and the aggregate would reject it"
                )
                raise ValueError(msg)
        if self.n_seeds < 1:
            raise ValueError(f"n_seeds must be >= 1, got {self.n_seeds}")
        if self.cells_per_shard < 1:
            msg = f"cells_per_shard must be >= 1, got {self.cells_per_shard}"
            raise ValueError(msg)
        if not self.scenarios or not self.policies or not self.topologies:
            msg = "scenarios, policies and topologies must all be non-empty"
            raise ValueError(msg)
        if not self.fault_intensities:
            raise ValueError("fault_intensities must be non-empty")
        for x in self.fault_intensities:
            if not (x >= 0 and x == x and x != float("inf")):
                msg = f"fault intensity must be finite and >= 0, got {x!r}"
                raise ValueError(msg)
        if len(set(self.fault_intensities)) != len(self.fault_intensities):
            msg = f"duplicate fault intensities {list(self.fault_intensities)}"
            raise ValueError(msg)

    # ---------------------------------------------------- serialization
    def to_json(self) -> dict:
        doc = {
            "scenarios": list(self.scenarios),
            "policies": list(self.policies),
            "topologies": list(self.topologies),
            "n_seeds": self.n_seeds,
            "seed0": self.seed0,
            "quick": self.quick,
            "cells_per_shard": self.cells_per_shard,
            "baseline": self.baseline,
            "headline": list(self.headline),
        }
        # Omitted at the fault-free default so the spec hash (and every
        # existing shard/aggregate artifact keyed by it) is unchanged.
        if self.fault_intensities != (0.0,):
            doc["fault_intensities"] = list(self.fault_intensities)
        return doc

    @classmethod
    def from_json(cls, doc: dict) -> SweepSpec:
        return cls(
            scenarios=tuple(doc["scenarios"]),
            policies=tuple(doc["policies"]),
            topologies=tuple(doc["topologies"]),
            n_seeds=doc["n_seeds"],
            seed0=doc["seed0"],
            quick=doc["quick"],
            cells_per_shard=doc["cells_per_shard"],
            baseline=doc["baseline"],
            headline=tuple(doc["headline"]),
            fault_intensities=tuple(doc.get("fault_intensities", (0.0,))),
        )

    def spec_hash(self) -> str:
        """Stable digest of the spec — stamped into every shard file so
        resume never mixes shards from two different sweeps."""
        canon = json.dumps(self.to_json(), sort_keys=True, separators=(",", ":"))
        return hashlib.sha256(canon.encode()).hexdigest()[:16]

    # ----------------------------------------------------- compilation
    def cells(self) -> list[Cell]:
        """The flat cell list, in deterministic order: scenario, then
        topology, then fault intensity, then seed, then policy — all
        policies of one workload are adjacent (paired-comparison
        locality within a shard)."""
        out = []
        for scen in self.scenarios:
            for topo in self.topologies:
                concrete = resolve_topology(scen, topo)
                for inten in self.fault_intensities:
                    for k in range(self.n_seeds):
                        seed = self.seed0 + k
                        for pol in self.policies:
                            out.append(Cell(scen, pol, concrete, seed, inten))
        return out

    def shards(self) -> list[list[Cell]]:
        cells = self.cells()
        k = self.cells_per_shard
        return [cells[i : i + k] for i in range(0, len(cells), k)]
