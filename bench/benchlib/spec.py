"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic mix;
each lives in a file of its own:

    bench/configs/<config>.json     the configuration as it is run
    bench/traffic/<traffic>.json    the traffic mix (read by the driver of
                                    its ``kind``, ``benchlib/drivers``)
    bench/limits/<workload>.json    the limits of the numbers compared
    bench/metrics/<metric>.py       a metric's reader: ``read(run)``

So a configuration, a mix, a cell or a metric is added by adding files and
entries, without editing a file that is there.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _entry(entries: list[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r}; known: "
                   f"{sorted(e['name'] for e in entries)}")


def workload(bench: dict, name: str) -> dict:
    return _entry(bench["workloads"], name, "workload")


def _json(kind: str, name: str) -> dict:
    return json.loads((BENCH / kind / f"{name}.json").read_text())


def config(name: str) -> dict:
    return _json("configs", name)


def traffic(name: str) -> dict:
    return _json("traffic", name)


def limits(workload_name: str) -> dict:
    return _json("limits", workload_name)


def reader(metric: str):
    """The ``read(run)`` function of ``bench/metrics/<metric>.py``."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def metrics_for(bench: dict, workload_name: str, trace: bool) -> list[dict]:
    """The metrics a run of the cell reports: its end-to-end metrics, or
    with ``trace`` its per-layer ones.  A metric with a ``workloads`` key
    belongs to those cells only; a per-layer metric without one belongs
    to every cell that reports the end-to-end metric it moves."""
    e2e = [m for m in bench["end_to_end"]
           if workload_name in m.get("workloads", [workload_name])]
    if not trace:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (workload_name in m["workloads"] if "workloads" in m
                else m["moves"] in reported)]
