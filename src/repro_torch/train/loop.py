"""Fault-tolerant training loop.

Port of ``repro.train.loop`` (its elastic reshard belongs to the parallel
slice):
  * auto-resume from the latest committed checkpoint (crash / preemption),
  * SIGTERM/SIGINT -> checkpoint-then-exit (preemption notice handling),
  * periodic async checkpoints (I/O overlapped with training),
  * straggler detection: a step slower than ``straggler_factor`` times
    the median wall time of the run's previous ``STRAGGLER_WINDOW`` steps
    is flagged in the report.  The first step of a run (after a start or a
    resume) is left out: it warms up kernels, caches and the allocator,
    and can take many times a steady step.  A median, unlike a running
    mean, forgets a few slow steps (a busy host at start-up, a flagged
    straggler) as soon as they are fewer than half its window.
"""

from __future__ import annotations

import signal
import statistics
import time
from collections import deque
from collections.abc import Callable
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

from repro_torch.checkpoint import ckpt as ckpt_lib
from repro_torch.train.state import TrainState

#: The previous steps whose median wall time a step is compared with.
STRAGGLER_WINDOW = 8


@dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = "checkpoints"
    log_every: int = 10
    keep: int = 3
    straggler_factor: float = 2.5   # step > factor * median -> flagged
    # False on every data-parallel rank but the first: the ranks hold equal
    # states, one writes them and every rank resumes from what it wrote.
    write_checkpoints: bool = True


@dataclass
class LoopReport:
    steps_run: int = 0
    resumed_from: int | None = None
    final_step: int = 0
    losses: list[float] = field(default_factory=list)
    straggler_steps: list[int] = field(default_factory=list)
    preempted: bool = False


def run(train_step: Callable, init_state: Callable[[], TrainState],
        batch_at: Callable[[int], Any], cfg: LoopConfig,
        install_signals: bool = True) -> LoopReport:
    """Run (or resume) training to cfg.total_steps."""
    report = LoopReport()
    ckpt_dir = Path(cfg.ckpt_dir)
    saver = ckpt_lib.AsyncCheckpointer(ckpt_dir, keep=cfg.keep)

    state = init_state()
    latest = ckpt_lib.latest_step(ckpt_dir)
    if latest is not None:
        state, _ = ckpt_lib.restore(ckpt_dir, state, step=latest)
        report.resumed_from = latest

    stop = {"now": False}

    def _handler(signum, frame):  # preemption notice
        stop["now"] = True

    if install_signals:
        prev_term = signal.signal(signal.SIGTERM, _handler)
        prev_int = signal.signal(signal.SIGINT, _handler)

    recent: deque[float] = deque(maxlen=STRAGGLER_WINDOW)
    try:
        step = int(state.step)
        while step < cfg.total_steps:
            t0 = time.perf_counter()
            state, metrics = train_step(state, batch_at(step))
            loss = float(metrics["loss"])   # waits for the step
            dt = time.perf_counter() - t0

            # Straggler detection, from the run's second step: the first
            # is the warm-up.
            if report.steps_run > 0:
                if recent and dt > cfg.straggler_factor * statistics.median(
                        recent):
                    report.straggler_steps.append(step)
                recent.append(dt)

            step += 1
            report.steps_run += 1
            report.losses.append(loss)

            if cfg.write_checkpoints and (step % cfg.ckpt_every == 0
                                          or step == cfg.total_steps):
                saver.save(step, state)
            if stop["now"]:
                saver.wait()
                if cfg.write_checkpoints:
                    ckpt_lib.save(ckpt_dir, step, state)   # sync final save
                report.preempted = True
                break
        report.final_step = step
    finally:
        saver.wait()
        if install_signals:
            signal.signal(signal.SIGTERM, prev_term)
            signal.signal(signal.SIGINT, prev_int)
    return report
