"""Shard executor: cells -> process-parallel, resumable JSON outputs.

The port's copy of ``repro.experiments.runner``, on the port's numpy
simulator, policies and scenario builder; ``run_cells_batched`` runs its
batches on the port's lockstep engine (``repro_torch.core.simtorch``) on
the caller's device.  ``tests/test_torch_experiments.py`` holds its
records, shards and fingerprints equal to the reference's.

``run_cell`` is the one place a measurement cell becomes a simulation —
the seed-threaded helper every harness shares (the experiment sweep,
``scenario_rows``, smoke gates), so a cell rebuilt anywhere reproduces
bit-identically.

``run_sweep`` executes a ``SweepSpec`` shard-by-shard: each shard is an
independent unit of ``spec.cells_per_shard`` simulations, run in a
worker process and written atomically to ``<shard_dir>/shard_NNNN.json``
(tmp + ``os.replace``, so a killed sweep never leaves a torn file).
Re-running the same spec skips every shard whose file already exists
and carries the matching ``spec_hash`` — resuming after a kill costs
only the shards that never landed.
"""

from __future__ import annotations

import json
import multiprocessing
import os
import time
from concurrent.futures import ProcessPoolExecutor, as_completed
from pathlib import Path

from repro_torch.appdag import build_scenario
from repro_torch.core import make_scheduler, simulate
from repro_torch.core.results import RunResult
from repro_torch.experiments.spec import Cell, SweepSpec, resolve_topology


def run_cell(
    cell: Cell,
    quick: bool = False,
    debug_checks: bool = False,
    analyze: bool = False,
    trace_dir: str | Path | None = None,
) -> dict:
    """Execute one measurement cell; returns its JSON record.

    A cell with ``fault_intensity > 0`` runs under the chaos fault
    family (``repro_torch.faults.chaos_spec`` at the cell's workload seed):
    the compiled fault stream and its retransmission policy are passed
    to ``simulate`` and the record carries a ``fault_intensity`` key.
    Fault-free cells take the exact pre-existing path and emit
    byte-identical records.

    ``analyze=True`` additionally computes the LP-free per-job lower
    bounds (``repro_torch.analysis.bounds``, tight load+chain composition)
    and the certified cross-job batch bound
    (``repro_torch.analysis.contention``), asserts the achieved JCT/CCT/
    makespan never beat them, and carries them in the result record —
    opt-in so default artifacts stay byte-identical.

    ``trace_dir`` runs the cell with a ``repro_torch.obs.MemoryTracer``
    attached (results stay bit-identical), writes
    ``<dir>/<scenario>_<policy>_<topology>_seed<seed>.trace.json``
    (Chrome ``trace_event`` JSON, Perfetto-loadable), and carries the
    scheduler-counter summary as ``trace_counters`` on the result —
    opt-in for the same byte-identity reason (the counter summary
    includes nondeterministic policy wall times)."""
    t0 = time.perf_counter()
    fabric, jobs = build_scenario(
        cell.scenario,
        seed=cell.seed,
        quick=quick,
        topology=cell.topology,
    )
    faults = None
    retransmit = None
    if cell.fault_intensity:
        # Deferred import: repro_torch.faults builds on repro_torch.core; fault-free
        # cells (every pre-existing sweep) never touch it.
        from repro_torch.faults import chaos_spec

        fault_spec = chaos_spec(fabric, jobs, cell.fault_intensity, seed=cell.seed)
        faults = fault_spec.compile(fabric.topology)
        retransmit = fault_spec.retransmit
    jct_b = cct_b = batch_b = None
    if analyze:
        from repro_torch.analysis.bounds import scenario_lower_bounds
        from repro_torch.analysis.contention import batch_bounds

        jct_b, cct_b = scenario_lower_bounds(jobs, fabric.topology)
        batch_b = batch_bounds(jobs, fabric.topology)
    tracer = None
    if trace_dir is not None:
        # Deferred import: repro_torch.obs builds on repro_torch.core; the traced
        # path is opt-in, same layering rule as analyze/debug_checks.
        from repro_torch.obs import MemoryTracer

        tracer = MemoryTracer()
    res = simulate(
        jobs,
        make_scheduler(cell.policy),
        fabric=fabric,
        debug_checks=debug_checks,
        tracer=tracer,
        faults=faults,
        retransmit=retransmit,
    )
    wall = time.perf_counter() - t0
    if len(res.jct) != len(jobs):
        msg = (
            f"{cell.scenario}/{cell.policy}/seed{cell.seed}: "
            f"{len(res.jct)} JCTs for {len(jobs)} jobs"
        )
        raise AssertionError(msg)
    if analyze:
        from repro_torch.analysis.bounds import assert_bounds_hold
        from repro_torch.analysis.contention import assert_batch_bounds_hold

        what = f"{cell.scenario}/{cell.policy}/seed{cell.seed} jct"
        assert_bounds_hold(res.jct, jct_b, what)
        assert_bounds_hold(res.cct, cct_b, what[:-3] + "cct")
        # Fault-perturbed fabrics only lose capacity, so the nominal-
        # topology batch bound stays a valid lower bound there too.
        arrivals = {j.name: j.arrival for j in jobs}
        assert_batch_bounds_hold(batch_b, res.makespan, res.cct, arrivals, what[:-4])
    counters = None
    if tracer is not None:
        from repro_torch.obs import scheduler_counters, write_chrome_trace

        counters = scheduler_counters(tracer)
        out_dir = Path(trace_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        stem = f"{cell.scenario}_{cell.policy}_{cell.topology}_seed{cell.seed}"
        write_chrome_trace(tracer, out_dir / f"{stem}.trace.json")
    rec = {
        "scenario": cell.scenario,
        "policy": cell.policy,
        "topology": cell.topology,
        "seed": cell.seed,
        "result": RunResult.from_sim(
            res,
            wall_s=wall,
            jct_bound=jct_b,
            cct_bound=cct_b,
            makespan_bound=batch_b.makespan_lb if batch_b else None,
            trace_counters=counters,
        ).to_json(),
    }
    # Key present only on chaos cells, so fault-free records (and every
    # pinned artifact built from them) are byte-identical to before.
    if cell.fault_intensity:
        rec["fault_intensity"] = cell.fault_intensity
    return rec


def batchable(cell: Cell) -> bool:
    """True iff ``run_cells_batched`` can run this cell on the lockstep
    engine: fifo policy, fault-free.  Everything else (ordered-rate
    policies, chaos cells) needs the numpy core's Python scheduler
    lifecycle — see DESIGN.md §17 for the porting contract."""
    return cell.policy == "fifo" and not cell.fault_intensity


def run_cells_batched(
    cells: list[Cell],
    quick: bool = False,
    workers: int | None = None,
    progress=None,
    *,
    device="cuda",
) -> list[dict]:
    """Execute cells, lockstep-batching the fifo fault-free ones.

    Batchable cells (``batchable``) are grouped by ``(scenario,
    topology)`` — lanes in a group share one padded batch shape, so one
    ``repro_torch.core.simtorch.run_fifo_batch`` call on ``device``
    advances all of a group's seeds together.  Every other cell runs
    through ``run_cell``, process-parallel when ``workers`` allows.
    Records come back in input-cell order and in the ``run_cell`` shape,
    with two documented deviations on batched records: an ``"engine":
    "simtorch"`` marker, and a result whose ``events`` counts lockstep
    steps while ``sched_full``/``sched_refresh`` are 0 (the engine
    re-decides every step; nothing is cached to count).  ``wall_s`` is
    the group's wall, building included, over its lanes.  Per-job
    JCT/CCT agree with the numpy core within float tolerance (1e-6), not
    bit-exactly — use ``run_cell``/``run_sweep`` for fingerprint-pinned
    artifacts.  Cells are duck-typed (``scenario``, ``policy``,
    ``topology``, ``seed``, ``fault_intensity``).
    """
    # Deferred import: the engine imports torch; the numpy sweep path
    # (and its spawned workers) never does.
    from repro_torch.core.simtorch import pack_instance, run_fifo_batch

    records: dict[int, dict] = {}
    groups: dict[tuple[str, str], list[int]] = {}
    rest: list[int] = []
    for ix, cell in enumerate(cells):
        if batchable(cell):
            groups.setdefault((cell.scenario, cell.topology), []).append(ix)
        else:
            rest.append(ix)

    for (scen, topo), ixs in sorted(groups.items()):
        t0 = time.perf_counter()
        built = [
            build_scenario(scen, seed=cells[ix].seed, quick=quick,
                           topology=topo)
            for ix in ixs
        ]
        lanes = [pack_instance(fabric, jobs) for fabric, jobs in built]
        results = run_fifo_batch(lanes, device=device)
        wall = (time.perf_counter() - t0) / len(ixs)
        for ix, (fabric, jobs), lane in zip(ixs, built, results):
            if len(lane.jct) != len(jobs):
                raise AssertionError(
                    f"{scen}/fifo/seed{cells[ix].seed}: "
                    f"{len(lane.jct)} JCTs for {len(jobs)} jobs"
                )
            rr = RunResult(
                n_jobs=len(lane.jct),
                avg_jct=sum(lane.jct.values()) / max(len(lane.jct), 1),
                avg_cct=sum(lane.cct.values()) / max(len(lane.cct), 1),
                makespan=lane.makespan,
                events=lane.events,
                sched_full=0,
                sched_refresh=0,
                jct=dict(lane.jct),
                cct=dict(lane.cct),
                wall_s=wall,
            )
            records[ix] = {
                "scenario": scen,
                "policy": "fifo",
                "topology": topo,
                "seed": cells[ix].seed,
                "engine": "simtorch",
                "result": rr.to_json(),
            }
        if progress:
            progress(f"batched {scen}@{topo}: {len(ixs)} lanes")

    if rest and (workers is None or workers > 1):
        workers = workers or os.cpu_count() or 1
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(max_workers=min(workers, len(rest)),
                                 mp_context=ctx) as pool:
            futs = {pool.submit(run_cell, cells[ix], quick): ix
                    for ix in rest}
            for fut in as_completed(futs):
                ix = futs[fut]
                records[ix] = fut.result()
                if progress:
                    progress(f"fallback cell {ix} done")
    else:
        for ix in rest:
            records[ix] = run_cell(cells[ix], quick=quick)
            if progress:
                progress(f"fallback cell {ix} done")
    return [records[ix] for ix in range(len(cells))]


def scenario_rows(
    scenarios,
    policies,
    seed: int = 0,
    quick: bool = False,
    topology: str | None = None,
    debug_checks: bool = False,
    analyze: bool = False,
    trace_dir: str | Path | None = None,
) -> list[tuple]:
    """Harness rows — the shared, seed-threaded row emission behind
    the reference's ``benchmarks/ml_workloads`` (and anything else
    reporting per-scenario policy sweeps): one ``(name, us_per_call, derived,
    extra)`` row per scenario, ``derived = "<policy>=<jct>/<cct>;..."``
    plus ``fifo_over_msa`` / ``fair_over_msa`` ratios when those
    policies ran.  ``extra`` is a dict of analyze-mode fields
    (``jct_lower_bound``, per-policy ``optimality_gap``); it is empty
    unless ``analyze=True``, so derived strings and row fingerprints
    are unchanged by default.  Rows on any non-big-switch network
    (override or scenario default) are named ``ml/<scenario>@<spec>``
    so JSON trajectories are tagged accurately per row."""
    rows = []
    for scen in scenarios:
        concrete = resolve_topology(scen, topology)
        t0 = time.perf_counter()
        cells = []
        gaps: dict[str, float] = {}
        bound_mean = None
        for pname in policies:
            cell = Cell(scen, pname, concrete, seed)
            rec = run_cell(
                cell,
                quick=quick,
                debug_checks=debug_checks,
                analyze=analyze,
                trace_dir=trace_dir,
            )
            result = rec["result"]
            cells.append((pname, result["avg_jct"], result["avg_cct"]))
            if analyze and result.get("jct_bound"):
                from repro_torch.analysis.bounds import mean_gap

                gap = mean_gap(result["jct"], result["jct_bound"])
                if gap is not None:
                    gaps[pname] = round(gap, 4)
                bounds = result["jct_bound"]
                bound_mean = round(sum(bounds.values()) / len(bounds), 4)
        us = (time.perf_counter() - t0) * 1e6
        derived = ";".join(f"{p}={j:.3f}/{c:.3f}" for p, j, c in cells)
        jct = {p: j for p, j, _ in cells}
        if "msa" in jct:
            for p in ("fifo", "fair"):
                if p in jct:
                    derived += f";{p}_over_msa={jct[p] / jct['msa']:.3f}"
        extra: dict = {}
        if gaps:
            extra = {"jct_lower_bound": bound_mean, "optimality_gap": gaps}
            derived += ";gap=" + ",".join(f"{p}:{g:.3f}" for p, g in gaps.items())
        name = f"ml/{scen}" if concrete == "big_switch" else f"ml/{scen}@{concrete}"
        rows.append((name, us, derived, extra))
    return rows


def _run_shard(
    spec_json: str,
    shard_ix: int,
    analyze: bool = False,
    trace_dir: str | None = None,
    verbose: bool = False,
) -> dict:
    """Worker entry point (module-level for pickling): one shard doc.

    ``verbose`` prints a heartbeat line after every cell (shard id,
    cells done, elapsed) so long sweeps are not silent for minutes —
    off by default, ``--verbose`` on ``repro_torch.launch.sweep``."""
    spec = SweepSpec.from_json(json.loads(spec_json))
    cells = spec.shards()[shard_ix]
    t0 = time.perf_counter()
    out = []
    for k, c in enumerate(cells):
        out.append(run_cell(c, quick=spec.quick, analyze=analyze, trace_dir=trace_dir))
        if verbose:
            elapsed = time.perf_counter() - t0
            print(
                f"  [shard {shard_ix:04d}] {k + 1}/{len(cells)} cells, "
                f"{elapsed:.1f}s elapsed",
                flush=True,
            )
    return {
        "shard": shard_ix,
        "spec_hash": spec.spec_hash(),
        "n_cells": len(cells),
        "cells": out,
    }


def shard_path(shard_dir: str | Path, shard_ix: int) -> Path:
    return Path(shard_dir) / f"shard_{shard_ix:04d}.json"


def _write_shard(shard_dir: Path, doc: dict) -> None:
    """Atomic write: a shard file either exists complete or not at all."""
    path = shard_path(shard_dir, doc["shard"])
    tmp = path.with_suffix(".json.tmp")
    with open(tmp, "w") as fh:
        json.dump(doc, fh, indent=1, sort_keys=True, allow_nan=False)
        fh.write("\n")
    os.replace(tmp, path)


def load_shard(shard_dir: str | Path, shard_ix: int, spec: SweepSpec) -> dict | None:
    """A previously-written shard doc, or ``None`` when absent, torn, or
    written by a different spec (stale shards are recomputed, never
    silently mixed in)."""
    path = shard_path(shard_dir, shard_ix)
    if not path.exists():
        return None
    try:
        with open(path) as fh:
            doc = json.load(fh)
    except (json.JSONDecodeError, OSError):
        return None
    if doc.get("spec_hash") != spec.spec_hash() or doc.get("shard") != shard_ix:
        return None
    if len(doc.get("cells", ())) != doc.get("n_cells"):
        return None
    return doc


def run_sweep(
    spec: SweepSpec,
    shard_dir: str | Path,
    workers: int | None = None,
    resume: bool = True,
    stop_after: int | None = None,
    progress=None,
    analyze: bool = False,
    trace_dir: str | None = None,
    verbose: bool = False,
) -> list[dict]:
    """Execute (or finish) a sweep; returns completed shard docs sorted
    by shard index.

    ``workers=1`` runs in-process (no pool); ``stop_after=k`` stops
    after ``k`` *newly computed* shards land, simulating a killed run —
    the resume test re-invokes without it and must produce the
    bit-identical aggregate.  The returned list is complete iff its
    length equals ``len(spec.shards())``.

    ``analyze=True`` makes every cell carry its LP-free lower bounds
    (see ``run_cell``).  ``trace_dir`` makes every cell write a Chrome
    trace and carry ``trace_counters`` (see ``run_cell``); ``verbose``
    turns on per-cell worker heartbeats.  All three are runner knobs,
    not part of the ``SweepSpec`` — ``spec_hash`` (and thus every
    existing fingerprint) is unaffected; resuming a plain sweep with
    them only affects the shards that still need computing."""
    shard_dir = Path(shard_dir)
    shard_dir.mkdir(parents=True, exist_ok=True)
    n_shards = len(spec.shards())
    done: dict[int, dict] = {}
    missing: list[int] = []
    for ix in range(n_shards):
        doc = load_shard(shard_dir, ix, spec) if resume else None
        if doc is not None:
            done[ix] = doc
        else:
            missing.append(ix)
    if stop_after is not None:
        keep = max(stop_after, 0)
        missing = missing[:keep]
    spec_json = json.dumps(spec.to_json())

    if workers == 1:
        for ix in missing:
            doc = _run_shard(spec_json, ix, analyze, trace_dir, verbose)
            _write_shard(shard_dir, doc)
            done[ix] = doc
            if progress:
                progress(f"shard {ix} done ({len(done)}/{n_shards} on disk)")
    elif missing:
        workers = workers or os.cpu_count() or 1
        # Spawn, not fork: the parent may have imported torch
        # (multithreaded) via other entry points or tests, and forking a
        # threaded process can deadlock.  Workers only import the numpy
        # sim stack, so spawn stays cheap.
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as pool:
            futs = {
                pool.submit(_run_shard, spec_json, ix, analyze, trace_dir, verbose): ix
                for ix in missing
            }
            for fut in as_completed(futs):
                doc = fut.result()
                _write_shard(shard_dir, doc)
                done[doc["shard"]] = doc
                if progress:
                    progress(f"shard {doc['shard']} done ({len(done)}/{n_shards})")
    return [done[ix] for ix in sorted(done)]
