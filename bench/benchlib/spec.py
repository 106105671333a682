"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic mix;
each lives in a file of its own:

    bench/configs/<config>.json     the configuration as it is run
    bench/traffic/<traffic>.json    the traffic mix (read by the driver of
                                    its ``kind``, ``benchlib/drivers``)
    bench/limits/<workload>.json    the limits of the numbers compared
    bench/metrics/<metric>.py       a metric's reader: ``read(run)``

A configuration's ``reference`` key names, by its path from the root of
the checkout, its architecture module (``architecture``): the one place
the harness learns an architecture from.  The module states the entries
of ``ARCHITECTURE`` (``benchlib/reference.py`` says what each is); the
rest, the same for every architecture, is ``Architecture``'s.

So a configuration, an architecture, a mix, a cell or a metric is added by
adding files and entries, without editing a file that is there.
"""

from __future__ import annotations

import functools
import importlib
import importlib.util
import json
from pathlib import Path

from benchlib import counts, reference

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

#: What an architecture module states.
ARCHITECTURE = ("leaves", "mixers", "port_config", "Model")


class Architecture:
    """An architecture module's entries, and what the harness works out
    from them alike for every architecture: the float32 reference's walks
    run the module's ``Model`` on its leaves, and the model-level counts
    are ``counts``' arithmetic on its leaves and mixers."""

    def __init__(self, module):
        self.module = module
        self.leaves, self.mixers, self.port_config, self.Model = (
            getattr(module, name) for name in ARCHITECTURE)

    def train_readings(self, cfg: dict, mix: dict, seed: int, device,
                       **kw) -> dict:
        return reference.train_readings_on(self.leaves(cfg), cfg, mix, seed,
                                           device, model=self.Model, **kw)

    def serve_logits(self, cfg: dict, seed: int, requests: list[dict],
                     device, lowp_too: str | None = None) -> list:
        return reference.serve_logits_on(self.leaves(cfg), cfg, seed,
                                         requests, device, lowp_too,
                                         model=self.Model)

    def train_flops(self, cfg: dict, B: int, S: int) -> float:
        return counts.train_flops(cfg, self.leaves(cfg), self.mixers(cfg), B,
                                  S)

    def prefill_flops(self, cfg: dict, B: int, S: int) -> float:
        return counts.prefill_flops(cfg, self.leaves(cfg), self.mixers(cfg),
                                    B, S)

    def decode_bytes(self, cfg: dict, B: int, context: int) -> float:
        return counts.decode_bytes(cfg, self.leaves(cfg), self.mixers(cfg),
                                   B, context)


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


@functools.cache
def _architecture(path: Path) -> Architecture:
    if not path.is_file():
        raise FileNotFoundError(f"architecture module {path} does not exist")
    lib = (BENCH / "benchlib").resolve()
    if path.is_relative_to(lib):     # a module of the package: import it once
        module = importlib.import_module(".".join(
            ("benchlib",) + path.relative_to(lib).with_suffix("").parts))
    else:
        spec = importlib.util.spec_from_file_location(
            "bench_arch_" + "".join(c if c.isalnum() else "_"
                                    for c in str(path)), path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    missing = [n for n in ARCHITECTURE if not callable(getattr(module, n,
                                                               None))]
    if missing:
        raise AttributeError(f"architecture module {path} states no "
                             f"{', '.join(missing)}")
    return Architecture(module)


def architecture(cfg: dict) -> Architecture:
    """The architecture of the module that the configuration's
    ``reference`` key names (a path from the root), which states every
    entry of ``ARCHITECTURE``; loaded once a process."""
    if "reference" not in cfg:
        raise KeyError(f"configuration {cfg.get('name')!r} names no "
                       "architecture module (its 'reference' key)")
    return _architecture((ROOT / cfg["reference"]).resolve())


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
