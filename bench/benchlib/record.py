"""What a driver hands back, and what the metric readers read."""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field

import torch


@dataclass
class Context:
    """One run: the configuration and traffic files, the seed, the window,
    whether it is traced, the device and the process's start (host
    clock, ``time.perf_counter``)."""

    cfg: dict
    mix: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float


@dataclass
class Run:
    """A driver's record of its window.

    ``steps``: train, one entry a step ({"t1", "tokens", "loss"}); serve,
    one a batch ({"length", "t0", "t_first", "t1", "requests", "gen"}).
    ``trace`` and ``launches`` (the port's launch counters over the traced
    window) exist in a traced run only."""

    kind: str
    cfg: dict
    mix: dict
    setup_s: float
    window_s: float
    peak_bytes: int
    steps: list = field(default_factory=list)
    trace: object = None
    launches: dict | None = None


@dataclass
class Outcome:
    run: Run
    attempted: int
    failed: int
    numbers: dict          # the numbers compared, by name


def port_config(cfg: dict):
    """The port's ``ModelConfig`` of a configuration file: the file's keys
    that are the dataclass's fields."""
    from repro_torch.configs.base import ModelConfig

    names = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: v for k, v in cfg.items() if k in names})


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device: torch.device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def release(device: torch.device) -> None:
    """Give the program's freed memory back before the reference runs."""
    import gc

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def nearest_rank(values: list[float], q: float) -> float:
    """The ``q`` quantile of ``values`` by nearest rank."""
    s = sorted(values)
    return s[max(0, math.ceil(q * len(s)) - 1)]
