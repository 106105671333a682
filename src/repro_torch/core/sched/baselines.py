"""Baseline schedulers the paper compares against (and per-flow fairness).

The port's copy of ``repro.core.sched.baselines``.

* ``VarysScheduler`` — coflow-based SEBF + MADD + backfill (Varys,
  SIGCOMM'14).  Coflow = all active flows of one job (no DAG knowledge).
* ``FairScheduler``  — per-flow max-min fairness via progressive filling
  (the classic flow-level baseline the coflow literature improves on).
* ``FifoScheduler``  — coflow FIFO by job arrival (Baraat-style), for
  additional context in benchmarks.

Decision-caching behaviour (see sched/base.py):

* Varys/Fifo group flows per job — structure that only changes when the
  active set does, so compute-task finishes are *clean* for them
  (``on_node_finish`` returns False) and ``refresh`` reuses the cached
  grouping.  Varys still re-sorts by effective bottleneck every event
  (remaining bytes drift); Fifo re-sorts too, but by static arrival keys,
  so the sort is trivially cheap.
* Fair redistributes on every remaining-bytes change, so it declares every
  event dirty and never caches.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.metaflow import EPS
from repro_torch.core.sched.base import Decision, Scheduler
from repro_torch.core.sched.registry import register


def _per_job_structure(view) -> tuple[list[tuple[str, np.ndarray]],
                                      dict[str, list]]:
    """Per job with active metaflows: (job_name, concatenated flow
    indices) groups plus the job's active records in activation order —
    everything the coflow policies derive from the active set (the
    records feed the walk's port-mask skip and the order expansion)."""
    ix_of: dict[str, list[np.ndarray]] = {}
    recs_of: dict[str, list] = {}
    for rec in view.active:
        ix_of.setdefault(rec.job.name, []).append(rec.view_ix)
        recs_of.setdefault(rec.job.name, []).append(rec)
    groups = [(name, np.concatenate(chunks))
              for name, chunks in ix_of.items()]
    return groups, recs_of


class _CoflowScheduler(Scheduler):
    """Shared machinery: cache the per-job grouping, order it per policy."""

    def __init__(self) -> None:
        self._structure = None

    def on_node_finish(self, job, name: str) -> bool:
        return False      # coflow grouping is DAG-blind

    def _ordered(self, view, groups) -> list[tuple[str, np.ndarray]]:
        raise NotImplementedError

    def _decide(self, view) -> Decision:
        groups, recs_of = self._structure
        ordered = self._ordered(view, groups)
        rates = self.ordered_rates(view, [ix for _, ix in ordered],
                                   [recs_of[name] for name, _ in ordered])
        # A coflow covers all of its job's active metaflows equally; expand
        # the job order into (job, metaflow) pairs in activation order.
        order = tuple((name, rec.name) for name, _ in ordered
                      for rec in recs_of[name]) if view.want_order else ()
        return Decision(rates=rates, order=order)

    def schedule(self, view) -> Decision:
        self._structure = _per_job_structure(view)
        return self._decide(view)

    def refresh(self, view, prev: Decision) -> Decision:
        if self._structure is None:
            return self.schedule(view)
        return self._decide(view)


@register("varys")
class VarysScheduler(_CoflowScheduler):
    """Smallest-Effective-Bottleneck-First over coflows, MADD rates.

    The SEBF key memoizes in the view's per-job scratch: a coflow's
    effective bottleneck only moves when the job's bytes (or the port
    capacities) do, and the simulator invalidates exactly then — cache
    hits return the identical float, so the order is unchanged."""

    def _ordered(self, view, groups):
        scratch = view.job_scratch
        if scratch is None:
            return sorted(groups,
                          key=lambda kv: (view.bottleneck_time(kv[1]), kv[0]))
        keyed = []
        for group in groups:
            name, ix = group
            d = scratch.get(name)
            if d is None:
                d = scratch[name] = {}
            b = d.get("sebf")
            if b is None:
                b = view.bottleneck_time(ix)
                d["sebf"] = b
            keyed.append(((b, name), group))
        keyed.sort()
        return [g for _, g in keyed]


@register("fifo")
class FifoScheduler(_CoflowScheduler):
    """Coflows served in job-arrival order, MADD within a coflow."""

    def _ordered(self, view, groups):
        arrival = {j.name: (j.arrival, j.name) for j in view.jobs}
        return sorted(groups, key=lambda kv: arrival[kv[0]])


@register("fair")
class FairScheduler(Scheduler):
    """Per-flow max-min fairness (progressive filling / water-filling).

    Redistributes whenever any flow's remaining bytes change, so every
    event is a full reschedule (no cacheable structure, no meaningful
    priority order)."""

    def on_node_finish(self, job, name: str) -> bool:
        return True

    def on_flow_finish(self, job, mf_name: str) -> bool:
        return True

    def schedule(self, view) -> Decision:
        all_ix = np.concatenate([rec.view_ix for rec in view.active])
        all_ix = all_ix[view.rem[all_ix] > EPS]
        rates = np.zeros_like(view.rem)
        if all_ix.size == 0:
            return Decision(rates=rates)
        res = view.link_cap.copy()
        links, cnt = view.row_entries(all_ix)
        if np.isscalar(cnt):
            cnt = np.full(all_ix.size, cnt, dtype=np.int64)
        starts = np.zeros(all_ix.size, dtype=np.int64)
        np.cumsum(cnt[:-1], out=starts[1:])
        alive = np.ones(all_ix.size, dtype=bool)
        # Progressive filling: each round saturates >=1 link, so the loop
        # runs at most n_links rounds.
        for _ in range(view.n_links + 1):
            if not alive.any():
                break
            n_l = np.bincount(links[np.repeat(alive, cnt)],
                              minlength=view.n_links)
            with np.errstate(divide="ignore", invalid="ignore"):
                inc = np.where(n_l > 0, res / np.maximum(n_l, 1),
                               np.inf).min()
            if not np.isfinite(inc):
                break
            if inc > EPS:
                rates[all_ix[alive]] += inc
                res -= n_l * inc
                np.clip(res, 0.0, None, out=res)
            # Freeze flows crossing an exhausted link.
            saturated = np.logical_or.reduceat(res[links] <= EPS, starts)
            newly = alive & saturated
            if not newly.any() and inc <= EPS:
                break
            alive &= ~saturated
        return Decision(rates=rates)
