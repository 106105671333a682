"""The numbers that decide ``correct``, each held to its limit.

A cell's limits file (``bench/limits/<cell>.json``) names the numbers it
holds; the others are computed, printed by the calibration and not held.

Training (the program's first steps against the reference's), a leaf's gap
being |the program's norm - the reference's| over the larger of the
reference's norm of that leaf and of the median leaf:

- ``loss_gap.step1``: |loss - reference loss| / |reference loss| at the
  first step; ``loss_gap.steps`` the largest over the checked steps;
- ``grad_gap.median_leaf`` and ``grad_gap.worst_leaf``: the median and the
  largest leaf gap of the first clipped gradient (the program's AdamW
  first moment after step 1, over 1 - b1);
- ``change_gap.worst_leaf`` and ``change_gap.median_leaf``: the same of
  each leaf's change over the checked steps.

Leaves whose reference gradient is under ``ZERO_GRAD`` of the median
leaf's move under Adam by round-off alone; they are left out of the leaf
gaps (none in the benchmark's models so far).

Serving, over the served tokens of the sampled requests, a token's gap
being the reference's best logit at its position minus the reference's
logit of the token: ``logit_gap.widest``, ``logit_gap.mean``, and
``miss_share``, the share of tokens that are not the reference's best.
"""

from __future__ import annotations

import statistics

ZERO_GRAD = 1e-3


def _leaf_gaps(prog: dict, ref: dict, keep) -> list[float]:
    med = statistics.median(ref[k] for k in keep)
    return [abs(prog[k] - ref[k]) / max(ref[k], med) if max(ref[k], med)
            else 0.0 for k in keep]


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref``: {"losses", "first_grad", "change"} (the last
    two by leaf path)."""
    med = statistics.median(ref["first_grad"].values())
    keep = [k for k, g in ref["first_grad"].items() if g >= ZERO_GRAD * med]
    loss = [abs(p - r) / abs(r) for p, r in
            zip(prog["losses"], ref["losses"], strict=True)]
    grad = _leaf_gaps(prog["first_grad"], ref["first_grad"], keep)
    change = _leaf_gaps(prog["change"], ref["change"], keep)
    return {"loss_gap.step1": loss[0], "loss_gap.steps": max(loss),
            "grad_gap.median_leaf": statistics.median(grad),
            "grad_gap.worst_leaf": max(grad),
            "change_gap.worst_leaf": max(change),
            "change_gap.median_leaf": statistics.median(change)}


def logit_gaps(ref_logits, chosen) -> list[float]:
    """Per position: the reference's best logit minus its logit of the
    chosen token.  ``ref_logits`` [n, V], ``chosen`` [n]."""
    best = ref_logits.max(-1).values
    got = ref_logits.gather(-1, chosen.long().to(ref_logits.device)[:, None])
    return (best - got[:, 0]).tolist()


def serve_numbers(gaps: list[float]) -> dict:
    return {"logit_gap.widest": max(gaps),
            "logit_gap.mean": sum(gaps) / len(gaps),
            "miss_share": sum(g > 0 for g in gaps) / len(gaps)}


def held(numbers: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}} for every number that has a limit."""
    return {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()
            if k in limits}


def correct(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
