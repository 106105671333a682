"""Readings that the limits of ``correct`` are set from (not run by the
benchmark's own runs):

    python3 bench/calibrate.py --workload <name> --seeds 1 2 ... \\
        [--control-seeds 7 8 9] [--fault-seeds 7 8 9] \\
        [--controls int8 fp8 bf16] [--seconds 5]

Prints one JSON line a reading, each with its numbers held to the cell's
committed limits (``held``, ``correct``).  A train cell: for each of
``--seeds`` the program's numbers against the reference (its set-up and
checked steps, no window); for each of ``--control-seeds`` those of the
reference in each of ``--controls`` put in the program's place (``int8``
is the control; ``fp8`` and ``bf16`` are read for the look); for each of
``--fault-seeds`` those of the reference trained on half of each batch's
rows (the mean over the rest).  A serve cell: for each seed, a window of
one cycle (at least ``--seconds``) and the check, the program's numbers
beside the first control's on the same requests, and on the
``--control-seeds`` beside each control's.
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]

import torch  # noqa: E402

from benchlib import compare, reference, spec  # noqa: E402
from benchlib.drivers import serve_grouped, train  # noqa: E402
from benchlib.record import Context, release  # noqa: E402


def say(**kw) -> None:
    print(json.dumps(kw), flush=True)


def worst(prog: dict, ref: dict, n: int = 6) -> list:
    """The leaves of the largest gaps (for the look at the numbers)."""
    import statistics
    med = statistics.median(ref.values())
    gaps = sorted(((abs(prog[k] - ref[k]) / max(ref[k], med), "/".join(
        map(str, k)), prog[k], ref[k]) for k in ref), reverse=True)
    return [[round(g, 6), k, p, r] for g, k, p, r in gaps[:n]] + [
        ["median gap", statistics.median(g[0] for g in gaps)]]


def held(numbers: dict, limits: dict) -> dict:
    checks = compare.held(numbers, limits)
    return {"held": checks, "correct": compare.correct(checks)}


def detail(prog: dict, ref: dict, limits: dict) -> dict:
    numbers = compare.train_numbers(prog, ref)
    return {"step_loss_gaps": [abs(p - r) / abs(r) for p, r in
                               zip(prog["losses"], ref["losses"])],
            "losses": prog["losses"], "reference_losses": ref["losses"],
            "grad_worst": worst(prog["first_grad"], ref["first_grad"]),
            "change_worst": worst(prog["change"], ref["change"]),
            **numbers, **held(numbers, limits)}


def train_cell(cfg, mix, limits, args, device) -> None:
    for seed in args.seeds:
        ctx = Context(cfg, mix, seed, 0.0, False, device, time.perf_counter())
        t, state = train.build(ctx)
        state, prog = train.checked_steps(ctx, t, state)
        del t, state
        release(device)
        t0 = time.perf_counter()
        ref = reference.train_readings(cfg, mix, seed, device)
        say(side="program", seed=seed, reference_s=time.perf_counter() - t0,
            **detail(prog, ref, limits))
        release(device)
    for seed in args.control_seeds:
        ref = reference.train_readings(cfg, mix, seed, device)
        for control in args.controls:
            low = reference.train_readings(cfg, mix, seed, device,
                                           lowp=control)
            say(side="control", control=control, seed=seed,
                **detail(low, ref, limits))
            release(device)
    for seed in args.fault_seeds:
        ref = reference.train_readings(cfg, mix, seed, device)
        half = reference.train_readings(cfg, mix, seed, device,
                                        rows=slice(0, mix["batch"] // 2))
        say(side="half_batch", seed=seed, **detail(half, ref, limits))
        release(device)


def serve_cell(cfg, mix, limits, args, device) -> None:
    for seed in args.seeds:
        ctx = Context(cfg, mix, seed, args.seconds, False, device,
                      time.perf_counter())
        *_, batches, _, _, _ = serve_grouped.program(ctx)
        release(device)
        controls = (args.controls if seed in args.control_seeds
                    else args.controls[:1])
        for control in controls:
            t0 = time.perf_counter()
            out = serve_grouped.check(ctx, batches, lowp_too=control)
            gaps, low, margins = (out.pop(k) for k in (
                "gaps", "control_gaps", "margins"))
            top = sorted(range(len(gaps)), key=lambda i: -gaps[i])[:16]
            ctl = {k[len("control."):]: v for k, v in out.items()
                   if k.startswith("control.")}
            say(side="program+control", control=control, seed=seed,
                batches=len(batches), check_s=time.perf_counter() - t0,
                positions=len(gaps),
                program_top=[[gaps[i], margins[i] if margins else None]
                             for i in top],
                control_top=sorted(low, reverse=True)[:8],
                margin_quantiles=(sorted(margins)[::max(1, len(margins) // 10)]
                                  if margins else None),
                **out, **held(out, limits),
                control_held=held(ctl, limits))
            release(device)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--controls", nargs="+", default=["int8"],
                    choices=sorted(reference.LOWP))
    args = ap.parse_args()
    entry = spec.workload(spec.benchmark(), args.workload)
    cfg, mix = spec.config(entry["config"]), spec.traffic(entry["traffic"])
    device = torch.device("cuda")
    {"train": train_cell, "serve_grouped": serve_cell}[mix["kind"]](
        cfg, mix, spec.limits(args.workload), args, device)


if __name__ == "__main__":
    main()
