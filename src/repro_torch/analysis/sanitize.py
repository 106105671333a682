"""Schedule sanitizer: one pluggable invariant engine over ``Decision``s.

The scheduler contract (DESIGN.md, "The scheduling-policy contract") was
enforced in three scattered places: the simulator's debug-only capacity
bincount, the test-only ``_conserving`` policy wrapper in
``tests/test_topology.py``, and nothing at all for order coverage or
work conservation.  This module promotes all of it into one registry of
named invariants over a :class:`DecisionRecord` — an immutable snapshot
of ``(SchedView, Decision)`` — so the same code runs

* **in-sim**, behind the existing ``Simulator(debug_checks=True)`` flag
  (raising :class:`InvariantViolation` at the offending event), and
* **post-hoc**, over a trace captured by :class:`RecordingScheduler`
  and replayed through :func:`audit_trace`.

Invariants (``available_invariants()``):

* ``link_capacity`` — summed rates crossing any link stay within its
  capacity (via the flow->links CSR; tolerance 1e-6, matching the
  historical debug check).
* ``active_rates`` — no negative rates, and no rate above EPS on a
  drained flow (``remaining <= EPS``): rate is only spent on live work.
* ``order_coverage`` — when a policy emits a priority order, every live
  metaflow appears in it (an ordered policy silently dropping a live
  metaflow starves it until the next structural event).  Skipped for
  empty orders: per-flow fairness has no meaningful order, and policies
  may skip building one when ``view.want_order`` is False.
* ``work_conservation`` — no live flow has residual capacity along its
  *entire* path (MADD + backfill, and progressive filling, both
  guarantee every live flow is bottlenecked somewhere; headroom on a
  full path means the decision left feasible work on the table).  The
  tolerance scales with the live-flow count: progressive filling stops
  when the next increment is below EPS, which can strand up to
  ``EPS * n_live`` residual on a shared link.
"""

from __future__ import annotations

from collections.abc import Callable, Iterable, Iterator
from typing import Any
from dataclasses import dataclass

import numpy as np
import numpy.typing as npt

from repro_torch.analysis.lint import Finding
from repro_torch.core.metaflow import EPS

#: Absolute per-link tolerance of the capacity invariant (historical).
CAP_TOL = 1e-6


class InvariantViolation(AssertionError):
    """An error-severity invariant finding, raised in fail-fast contexts.

    Subclasses ``AssertionError``: the historical ``debug_checks``
    capacity check raised that, and its consumers assert on it.
    """

    def __init__(self, findings: list[Finding]):
        self.findings = findings
        errors = [f for f in findings if f.severity == "error"]
        super().__init__("; ".join(str(f) for f in errors[:4])
                         + (f" (+{len(errors) - 4} more)"
                            if len(errors) > 4 else ""))


@dataclass(frozen=True)
class DecisionRecord:
    """Immutable snapshot of one scheduling round: everything the
    invariants need, copied out of the live view so post-hoc audits see
    the state the policy actually decided on."""

    t: float
    rem: npt.NDArray[np.float64]       # [F] remaining bytes per view flow
    rates: npt.NDArray[np.float64]     # [F] the decision's dense rate vector
    lp: npt.NDArray[np.int_]           # flow->links CSR offsets
    li: npt.NDArray[np.int_]           # flow->links CSR link ids
    link_cap: npt.NDArray[np.float64]  # [L] current link capacities
    n_links: int
    order: tuple[tuple[str, str], ...]
    live_pairs: tuple[tuple[str, str], ...]   # live (job, metaflow) pairs
    link_names: tuple[str, ...] | None = None

    @classmethod
    def from_view(cls, view: Any, decision: Any) -> DecisionRecord:
        live = tuple((rec.pair or (rec.job.name, rec.name))
                     for rec in view.active
                     if view.mf_remaining(rec) > EPS)
        return cls(
            t=float(view.t),
            rem=np.array(view.rem, dtype=np.float64),
            rates=np.array(decision.rates, dtype=np.float64),
            lp=np.array(view.lp), li=np.array(view.li),
            link_cap=np.array(view.link_cap, dtype=np.float64),
            n_links=int(view.n_links),
            order=tuple(decision.order),
            live_pairs=live,
            link_names=(tuple(view.link_names)
                        if view.link_names else None))

    def link_load(self) -> npt.NDArray[np.float64]:
        """Per-link summed rate, via the flow->links CSR."""
        cnt = np.diff(self.lp)
        return np.bincount(self.li, weights=np.repeat(self.rates, cnt),
                           minlength=self.n_links)

    def _link_label(self, link: int) -> str | int:
        return self.link_names[link] if self.link_names else link


InvariantFn = Callable[[DecisionRecord], Iterator[Finding]]
_INVARIANTS: dict[str, InvariantFn] = {}


def invariant(name: str) -> Callable[[InvariantFn], InvariantFn]:
    """Register a named invariant (registration order is run order)."""
    def deco(fn: InvariantFn) -> InvariantFn:
        if name in _INVARIANTS:
            raise ValueError(f"duplicate invariant {name!r}")
        _INVARIANTS[name] = fn
        return fn
    return deco


def available_invariants() -> tuple[str, ...]:
    return tuple(_INVARIANTS)


# -------------------------------------------------------------- invariants
@invariant("link_capacity")
def _link_capacity(rec: DecisionRecord) -> Iterator[Finding]:
    if rec.rates.size != rec.rem.size:
        yield Finding("link_capacity", "error",
                      f"rate vector has {rec.rates.size} entries for "
                      f"{rec.rem.size} view flows (t={rec.t:.6g})")
        return
    load = rec.link_load()
    over = load > rec.link_cap + CAP_TOL
    if over.any():
        bad = np.nonzero(over)[0].tolist()
        names = [rec._link_label(b) for b in bad]
        excess = float((load - rec.link_cap)[bad].max())
        yield Finding("link_capacity", "error",
                      f"link(s) {names} oversubscribed by up to "
                      f"{excess:.3g} (t={rec.t:.6g})")


@invariant("active_rates")
def _active_rates(rec: DecisionRecord) -> Iterator[Finding]:
    if rec.rates.size != rec.rem.size:
        return                          # link_capacity already reported
    neg = np.nonzero(rec.rates < -1e-12)[0]
    if neg.size:
        yield Finding("active_rates", "error",
                      f"negative rate on flow(s) {neg.tolist()} "
                      f"(t={rec.t:.6g})")
    dead = np.nonzero((rec.rates > EPS) & (rec.rem <= EPS))[0]
    if dead.size:
        yield Finding("active_rates", "error",
                      f"rate granted to drained flow(s) {dead.tolist()} "
                      f"(t={rec.t:.6g})")


@invariant("order_coverage")
def _order_coverage(rec: DecisionRecord) -> Iterator[Finding]:
    if not rec.order:
        return                 # unordered policy (fair) / order skipped
    listed = set(rec.order)
    for pair in rec.live_pairs:
        if pair not in listed:
            yield Finding("order_coverage", "error",
                          f"live metaflow {pair[0]}/{pair[1]} missing "
                          f"from the priority order (t={rec.t:.6g})",
                          job=pair[0], node=pair[1])


@invariant("work_conservation")
def _work_conservation(rec: DecisionRecord) -> Iterator[Finding]:
    if rec.rates.size != rec.rem.size or rec.li.size == 0:
        return
    live = rec.rem > EPS
    n_live = int(live.sum())
    if n_live == 0:
        return
    residual = np.maximum(rec.link_cap - rec.link_load(), 0.0)
    # Per-flow min residual along its path (CSR segments; every flow
    # crosses >= 2 links, so the segment starts are strictly increasing).
    path_min = np.minimum.reduceat(residual[rec.li], rec.lp[:-1])
    tol = CAP_TOL + EPS * n_live
    idle = np.nonzero(live & (path_min > tol))[0]
    if idle.size:
        head = float(path_min[idle].max())
        yield Finding("work_conservation", "error",
                      f"{idle.size} live flow(s) (e.g. {idle.tolist()[:4]}) "
                      f"have >= {head:.3g} residual capacity along their "
                      f"whole path (t={rec.t:.6g})")


# -------------------------------------------------------------- front ends
def audit_record(rec: DecisionRecord,
                 invariants: Iterable[str] | None = None) -> list[Finding]:
    """Run the named invariants (default: all) over one snapshot."""
    names = list(invariants) if invariants is not None else list(_INVARIANTS)
    out: list[Finding] = []
    for name in names:
        if name not in _INVARIANTS:
            raise KeyError(f"unknown invariant {name!r}; known: "
                           f"{available_invariants()}")
        out.extend(_INVARIANTS[name](rec))
    return out


def audit_decision(view: Any, decision: Any,
                   invariants: Iterable[str] | None = None,
                   raise_on_error: bool = True) -> list[Finding]:
    """Snapshot and audit one live ``(view, decision)`` pair — the
    ``Simulator(debug_checks=True)`` entry point."""
    findings = audit_record(DecisionRecord.from_view(view, decision),
                            invariants)
    if raise_on_error and any(f.severity == "error" for f in findings):
        raise InvariantViolation(findings)
    return findings


def audit_trace(records: Iterable[DecisionRecord],
                invariants: Iterable[str] | None = None) -> list[Finding]:
    """Audit a recorded decision trace post-hoc (never raises — the
    caller decides what a violation means)."""
    out: list[Finding] = []
    for rec in records:
        out.extend(audit_record(rec, invariants))
    return out


class RecordingScheduler:
    """Delegating policy wrapper that snapshots every decision.

    Wrap any policy, run a simulation, then hand ``.records`` to
    :func:`audit_trace` — the post-hoc twin of ``debug_checks=True``
    (and the replacement for the test-only auditor that used to live in
    ``tests/test_topology.py``).
    """

    def __init__(self, inner: Any):
        self.inner = inner
        self.name = f"recorded({inner.name})"
        self.records: list[DecisionRecord] = []

    # lifecycle ------------------------------------------------------
    def attach(self, fabric: Any, jobs: Any) -> None:
        self.records.clear()            # attach resets run state
        self.inner.attach(fabric, jobs)

    def on_job_arrival(self, job: Any) -> bool:
        return self.inner.on_job_arrival(job)

    def on_node_finish(self, job: Any, name: str) -> bool:
        return self.inner.on_node_finish(job, name)

    def on_flow_finish(self, job: Any, mf_name: str) -> bool:
        return self.inner.on_flow_finish(job, mf_name)

    def on_perturbation(self, perturbation: Any) -> bool:
        return self.inner.on_perturbation(perturbation)

    # decisions ------------------------------------------------------
    def schedule(self, view: Any) -> Any:
        decision = self.inner.schedule(view)
        self.records.append(DecisionRecord.from_view(view, decision))
        return decision

    def refresh(self, view: Any, prev: Any) -> Any:
        decision = self.inner.refresh(view, prev)
        self.records.append(DecisionRecord.from_view(view, decision))
        return decision
