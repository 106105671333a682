"""Replay one scenario x policy cell with tracing on and report on it
(the port's copy of ``python -m repro.obs``).

Usage:
  PYTHONPATH=src python -m repro_torch.obs --scenario mixed --policy msa \\
      [--topology SPEC] [--seed N] [--quick] [-o trace.json] \\
      [--jsonl PATH] [--top K] [--no-audit] [--verify]

Runs the cell with a ``MemoryTracer`` (and a ``RecordingScheduler``
wrapper so decision records exist), prints the derived report
(scheduler counters, top-K link utilization, mean job-phase
decomposition, the static structure summary and certified batch bound
from ``repro_torch.analysis``), audits the trace-derived per-link
busy-seconds against an independent integration of the decision records,
and optionally
writes the Chrome ``trace_event`` JSON (``-o``, open in Perfetto or
chrome://tracing) and/or the JSONL stream (``--jsonl``).

``--verify`` is the CI smoke mode: additionally re-runs the cell
untraced and asserts bit-identical results (avg JCT/CCT, metaflow
service order, event count), and validates the exported Chrome JSON
(round-trips through ``json.loads``, monotone ``ts`` per track).
Exits 1 on any audit or verify failure.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from repro_torch.analysis.contention import batch_bounds
from repro_torch.analysis.sanitize import RecordingScheduler
from repro_torch.analysis.structure import scenario_structure
from repro_torch.appdag import SCENARIOS, build_scenario
from repro_torch.core import make_scheduler, simulate
from repro_torch.core.sched import available_policies
from repro_torch.experiments import topology_arg
from repro_torch.obs import (
    MemoryTracer,
    audit_link_seconds,
    job_phases,
    link_utilization,
    scheduler_counters,
    write_chrome_trace,
    write_jsonl,
)

AUDIT_TOL = 1e-6


def chrome_track_errors(doc: dict) -> list[str]:
    """Validate a Chrome trace document: every track's ``ts`` monotone
    non-decreasing, all values finite.  Counter tracks are keyed by
    (pid, name); slice/instant tracks by (pid, tid)."""
    errs: list[str] = []
    last: dict[tuple, float] = {}
    for ev in doc.get("traceEvents", ()):
        if ev.get("ph") == "M":
            continue
        ts = ev.get("ts")
        if ts is None or not np.isfinite(ts):
            errs.append(f"non-finite ts in {ev!r}")
            continue
        if ev.get("ph") == "C":
            key = (ev["pid"], "C", ev["name"])
        else:
            key = (ev["pid"], ev.get("tid"))
        if ts < last.get(key, float("-inf")):
            errs.append(f"track {key}: ts went backwards ({ts} after {last[key]})")
        last[key] = ts
    if not last:
        errs.append("trace has no timestamped events")
    return errs


def report(trace: MemoryTracer, res, label: str, top: int) -> None:
    usage = link_utilization(trace)
    counters = scheduler_counters(trace)
    print(f"== {label} ==")
    print(
        f"jobs {len(res.jct)}  events {res.events}  "
        f"makespan {res.makespan:.4g}  avg_jct {res.avg_jct:.4g}  "
        f"avg_cct {res.avg_cct:.4g}"
    )
    hit = counters["cache_hit_ratio"]
    print(
        f"scheduler: {counters['sched_full']} full / "
        f"{counters['sched_refresh']} refresh "
        f"(cache hit {hit:.1%}), {counters['sched_wall_s'] * 1e3:.1f}ms "
        f"in policy code"
    )
    reasons = ", ".join(f"{k}={v}" for k, v in counters["full_reasons"].items())
    print(f"full-schedule reasons: {reasons}")
    if counters["n_perturbations"]:
        print(f"perturbations applied: {counters['n_perturbations']}")
    span = usage.span or 1.0
    order = np.argsort(usage.busy_s)[::-1][:top]
    print(f"per-link utilization (top {top} by busy seconds):")
    print(f"  {'link':<18}{'busy%':>8}{'util%':>8}{'peak':>8}{'bytes':>12}")
    for link in order:
        if usage.busy_s[link] <= 0:
            break
        print(
            f"  {usage.name(int(link)):<18}"
            f"{100 * usage.busy_s[link] / span:>8.1f}"
            f"{100 * usage.util[link]:>8.1f}"
            f"{usage.peak[link]:>8.2f}"
            f"{usage.bytes[link]:>12.1f}"
        )
    phases = job_phases(trace)
    if phases:
        keys = ("net_serviced_s", "net_blocked_s", "compute_s", "idle_s")
        spans = sum(d["span_s"] for d in phases.values()) or 1.0
        parts = {k: sum(d[k] for d in phases.values()) for k in keys}
        print(f"job phase decomposition (aggregate over {len(phases)} jobs):")
        print(
            f"  network-serviced {parts['net_serviced_s'] / spans:.1%}  "
            f"network-blocked {parts['net_blocked_s'] / spans:.1%}  "
            f"compute {parts['compute_s'] / spans:.1%}  "
            f"idle {parts['idle_s'] / spans:.1%}"
        )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs", description=__doc__.splitlines()[0]
    )
    ap.add_argument("--scenario", required=True, choices=sorted(SCENARIOS))
    ap.add_argument(
        "--policy", required=True, choices=available_policies(), metavar="NAME"
    )
    ap.add_argument(
        "--topology",
        default=None,
        metavar="SPEC",
        type=topology_arg,
        help="override the scenario's registered topology",
    )
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quick", action="store_true", help="quick scenario size")
    ap.add_argument(
        "-o",
        "--out",
        default=None,
        metavar="PATH",
        help="write Chrome trace_event JSON (open in Perfetto)",
    )
    ap.add_argument(
        "--jsonl", default=None, metavar="PATH", help="write JSONL event stream"
    )
    ap.add_argument("--top", type=int, default=8, help="links in the utilization table")
    ap.add_argument(
        "--no-audit",
        action="store_true",
        help="skip the decision-record audit (cheaper on big cells)",
    )
    ap.add_argument(
        "--verify",
        action="store_true",
        help="CI smoke: re-run untraced, assert bit-identical results and "
        "exporter validity (exit 1 on failure)",
    )
    args = ap.parse_args(argv)

    fabric, jobs = build_scenario(
        args.scenario, seed=args.seed, quick=args.quick, topology=args.topology
    )
    sched = make_scheduler(args.policy)
    recording = not args.no_audit
    if recording:
        sched = RecordingScheduler(sched)
    trace = MemoryTracer()
    res = simulate(jobs, sched, fabric=fabric, tracer=trace)

    topo = args.topology or "default"
    label = f"{args.scenario} / {args.policy} (topology {topo}, seed {args.seed})"
    report(trace, res, label, args.top)

    # Static structure + certified batch bound (repro_torch.analysis): reads
    # template state only, so computing it post-simulation is sound.
    struct = scenario_structure(args.scenario, jobs, fabric.topology)
    bb = batch_bounds(jobs, fabric.topology)
    print(
        f"structure: {struct.classification}  "
        f"(msa-advantage score {struct.msa_advantage_score:.3f}, "
        f"barrier density {struct.barrier_density:.2f}, "
        f"comm fraction {struct.comm_fraction:.2f}, "
        f"mf depth {struct.mf_depth:.1f}, fan-out {struct.fan_out:.1f})"
    )
    if bb.makespan_lb > 0:
        print(
            f"certified batch bound: makespan >= {bb.makespan_lb:.4g}  "
            f"(achieved {res.makespan:.4g}, gap "
            f"{res.makespan / bb.makespan_lb:.3f}x, "
            f"bottleneck {bb.bottleneck})"
        )

    errs: list[str] = []
    if recording:
        trace_busy = link_utilization(trace).busy_s
        audit_busy, _ = audit_link_seconds(sched.records, trace.n_links)
        delta = float(np.abs(trace_busy - audit_busy).max())
        if delta > AUDIT_TOL:
            errs.append(
                f"trace busy-seconds diverge from decision-record audit "
                f"(max |delta| {delta:.3g})"
            )
        else:
            print(
                f"audit: per-link busy-seconds match {len(sched.records)} "
                f"decision records (max |delta| {delta:.3g})"
            )

    if args.out:
        doc = write_chrome_trace(trace, args.out)
        print(f"wrote {args.out} ({len(doc['traceEvents'])} trace events)")
    if args.jsonl:
        n = write_jsonl(trace, args.jsonl)
        print(f"wrote {args.jsonl} ({n} lines)")

    if args.verify:
        fabric2, jobs2 = build_scenario(
            args.scenario,
            seed=args.seed,
            quick=args.quick,
            topology=args.topology,
        )
        res2 = simulate(jobs2, make_scheduler(args.policy), fabric=fabric2)
        for field in ("avg_jct", "avg_cct", "makespan", "events"):
            a, b = getattr(res, field), getattr(res2, field)
            if a != b:
                errs.append(f"traced vs untraced {field}: {a!r} != {b!r}")
        if res.mf_service_order != res2.mf_service_order:
            errs.append("traced vs untraced mf_service_order differ")
        if args.out:
            with open(args.out) as fh:
                errs.extend(chrome_track_errors(json.load(fh)))
        if not errs:
            print(
                "verify: traced run bit-identical to untraced; "
                "exported trace valid"
            )

    for e in errs:
        print(f"CHECK-FAIL[obs]: {e}", file=sys.stderr)
    return 1 if errs else 0


if __name__ == "__main__":
    raise SystemExit(main())
