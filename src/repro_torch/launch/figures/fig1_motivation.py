"""Paper Figure 1: the motivating example, exact arithmetic.

The port of the reference's ``benchmarks/fig1_motivation.py``: the same
rows and the same ``check()``, on the port's numpy simulator (host only).

Expected (paper):
  Varys (CCT-optimal): CCTs (3,4) avg 3.5 | JCTs (6,10) avg 8
  MSA   (DAG-aware)  : CCTs (4,4) avg 4.0 | JCTs (7,7)  avg 7
"""

from __future__ import annotations

import time

from repro_torch.core import figure1_jobs, make_scheduler, simulate

DEFAULT_POLICIES = ("msa", "varys", "fair")


def run(quick: bool = False, policies=None) -> list[tuple]:
    policies = tuple(policies) if policies else DEFAULT_POLICIES
    rows = []
    for pname in policies:
        sched = make_scheduler(pname)
        t0 = time.perf_counter()
        res = simulate(figure1_jobs(), sched, n_ports=3)
        us = (time.perf_counter() - t0) * 1e6
        rows.append((f"fig1/{pname}", us,
                     f"avg_jct={res.avg_jct:.3f};avg_cct={res.avg_cct:.3f};"
                     f"jct_J1={res.jct['J1']:.1f};jct_J2={res.jct['J2']:.1f}"))
    return rows


def check(rows) -> list[str]:
    errs = []
    vals = {r[0]: r[2] for r in rows}
    # Paper ground truth only binds the policies it defines.
    if "fig1/msa" in vals and "avg_jct=7.000" not in vals["fig1/msa"]:
        errs.append(f"MSA avg JCT != 7: {vals['fig1/msa']}")
    if "fig1/varys" in vals and "avg_jct=8.000" not in vals["fig1/varys"]:
        errs.append(f"Varys avg JCT != 8: {vals['fig1/varys']}")
    return errs
