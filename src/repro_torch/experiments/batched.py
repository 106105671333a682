"""Sweep routing: measurement cells -> the lockstep engine, batched.

The port of ``repro.experiments.runner.batchable`` and
``run_cells_batched``.  Fifo, fault-free cells are grouped by
``(scenario, topology)`` and each group's seeds run as one
``repro_torch.core.simtorch.run_fifo_batch`` batch on the caller's device;
every other cell goes to the caller's ``fallback``.

Cells are duck-typed: anything with ``scenario``, ``policy``,
``topology``, ``seed`` and ``fault_intensity`` (the JAX package's
``repro.experiments.Cell`` is one).  The port has no numpy simulator, so a
sweep that holds cells the engine cannot run passes the reference's
``run_cell`` as ``fallback``; the JAX package's runner imports no JAX.
"""

from __future__ import annotations

import time
from typing import Callable, Sequence

import torch

from repro_torch.appdag import build_scenario
from repro_torch.core.simtorch import pack_instance, run_fifo_batch


def batchable(cell) -> bool:
    """True iff ``run_cells_batched`` can run this cell on the lockstep
    engine: fifo policy, fault-free."""
    return cell.policy == "fifo" and not cell.fault_intensity


def run_cells_batched(cells: Sequence, quick: bool = False, *,
                      fallback: Callable | None = None,
                      device: str | torch.device = "cuda") -> list[dict]:
    """Execute cells, lockstep-batching the fifo fault-free ones.

    Each ``(scenario, topology)`` group is built by the port's
    ``build_scenario`` and runs as one batch on ``device``.  A
    non-batchable cell runs as ``fallback(cell, quick)``, in order, and
    raises without one.  Records come back in input-cell order, in the
    reference ``run_cell`` record shape (``RunResult.to_json`` keys), with
    the reference's two deviations on batched records: an ``"engine":
    "simtorch"`` marker, and ``events`` counting lockstep steps while
    ``sched_full``/``sched_refresh`` are 0 (the engine re-decides every
    step; nothing is cached to count).  ``wall_s`` is the group's wall,
    building included, over its lanes.
    """
    records: dict[int, dict] = {}
    groups: dict[tuple[str, str], list[int]] = {}
    rest: list[int] = []
    for ix, cell in enumerate(cells):
        if batchable(cell):
            groups.setdefault((cell.scenario, cell.topology), []).append(ix)
        else:
            rest.append(ix)
    if rest and fallback is None:
        raise ValueError(
            f"{len(rest)} cells are not batchable (first: {cells[rest[0]]}) "
            "and no fallback was given")

    for (scen, topo), ixs in sorted(groups.items()):
        t0 = time.perf_counter()
        built = [build_scenario(scen, seed=cells[ix].seed, quick=quick,
                                topology=topo) for ix in ixs]
        lanes = [pack_instance(fabric, jobs) for fabric, jobs in built]
        results = run_fifo_batch(lanes, device=device)
        wall = (time.perf_counter() - t0) / len(ixs)
        for ix, (_, jobs), lane in zip(ixs, built, results):
            if len(lane.jct) != len(jobs):
                raise AssertionError(
                    f"{scen}/fifo/seed{cells[ix].seed}: "
                    f"{len(lane.jct)} JCTs for {len(jobs)} jobs")
            n = max(len(lane.jct), 1)
            records[ix] = {
                "scenario": scen,
                "policy": "fifo",
                "topology": topo,
                "seed": cells[ix].seed,
                "engine": "simtorch",
                "result": {
                    "n_jobs": len(lane.jct),
                    "avg_jct": sum(lane.jct.values()) / n,
                    "avg_cct": sum(lane.cct.values()) / n,
                    "makespan": lane.makespan,
                    "events": lane.events,
                    "sched_full": 0,
                    "sched_refresh": 0,
                    "jct": dict(lane.jct),
                    "cct": dict(lane.cct),
                    "wall_s": wall,
                },
            }

    for ix in rest:
        records[ix] = fallback(cells[ix], quick)
    return [records[ix] for ix in range(len(cells))]
