"""One run of one cell: its driver, its metrics, its check and its last
line."""

from __future__ import annotations

import argparse
import importlib
import json
import sys

import torch

from benchlib import compare, spec
from benchlib.record import Context, Outcome

#: Top-level module names the process may not hold once the window has
#: closed: JAX and the JAX package (``repro``, which ``repro_torch`` is not).
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules=None) -> list[str]:
    """The forbidden top-level names among ``modules`` (default
    ``sys.modules``), each name compared whole."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None
                                          else modules)}
    return sorted(names & set(FORBIDDEN))


def driver(mix: dict):
    return importlib.import_module(f"benchlib.drivers.{mix['kind']}")


def result(bench: dict, entry: dict, out: Outcome, trace: bool,
           limits: dict, device: torch.device) -> dict:
    """The last line: ``correct``, ``attempted``, ``failed``, the cell's
    metrics, ``device``, the traced run's ``breakdown``, and, last, each
    number compared beside its limit."""
    metrics = {}
    for m in spec.metrics_for(bench, entry["name"], trace):
        value = spec.reader(m["name"])(out.run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = compare.held(out.numbers, limits)
    ok = (compare.correct(checks) and set(limits) <= set(out.numbers)
          and out.failed == 0 and out.attempted > 0)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": entry["chips"],
           "memory_peak_bytes": out.run.peak_bytes}
    line = {"correct": ok, "attempted": out.attempted, "failed": out.failed,
            "metrics": metrics, "device": dev}
    if trace:
        t0, t1 = out.run.trace.window()
        dev["busy_s"] = out.run.trace.busy_s(t0, t1)
        dev["window_s"] = t1 - t0
        line["breakdown"] = out.run.trace.breakdown()
    line["checks"] = checks
    return line


def run_cell(bench: dict, name: str, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: float, **fault) -> dict:
    entry = spec.workload(bench, name)
    cfg, mix = spec.config(entry["config"]), spec.traffic(entry["traffic"])
    ctx = Context(cfg, mix, seed, seconds, trace, device, t_start)
    out = driver(mix).run(ctx, **fault)
    return result(bench, entry, out, trace, spec.limits(name), device)


def main(argv: list[str], t_start: float) -> int:
    ap = argparse.ArgumentParser(description="Run one cell of the "
                                 "benchmark once and print its result line.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = spec.benchmark()
    entry = spec.workload(bench, args.workload)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < entry["chips"]:
        print(f"{args.workload} needs {entry['chips']} CUDA device(s); "
              f"found {found}", file=sys.stderr)
        return 2
    line = run_cell(bench, args.workload, args.seed, args.seconds,
                    bool(args.trace), torch.device("cuda"), t_start)
    bad = forbidden_modules()
    if bad:
        print(f"the process holds {bad} after the window", file=sys.stderr)
        return 3
    for k, c in line["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
