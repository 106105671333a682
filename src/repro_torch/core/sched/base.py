"""Scheduling-policy API: the ``Scheduler`` contract and its ``Decision``.

The port's copy of ``repro.core.sched.base``.

Every policy answers one question — *given the current fabric state, which
metaflows transfer at what rates?* — but the work splits into two layers
with very different invalidation behaviour:

  * **structure** — direct/indirect classification, gain numerators,
    consumer requirement masks, coflow groupings, DAG adjacency.  Changes
    only on *structural* events: a job arrives, a node (metaflow or compute
    task) finishes, a metaflow activates, a port degrades.
  * **keys + rates** — anything derived from remaining bytes.  Changes
    continuously as flows drain, so it must be recomputed at every
    simulator event to stay exact (priorities can cross between events).

The API mirrors this split:

  * ``schedule(view) -> Decision`` rebuilds structure, keys, and rates —
    the full (expensive) path.
  * ``refresh(view, prev) -> Decision`` recomputes keys and rates from the
    structure cached by the last ``schedule()`` call.  Policies guarantee
    ``refresh`` is *bit-identical* to ``schedule`` whenever no structural
    event occurred in between; the default falls back to ``schedule``.
  * lifecycle hooks (``attach``, ``on_job_arrival``, ``on_node_finish``,
    ``on_flow_finish``, ``on_perturbation``) let the simulator ask each
    policy which events dirty its cached structure.  Hooks return ``True``
    when the event invalidates the structure.  The simulator additionally
    forces a full ``schedule()`` whenever the *active set* or the fabric
    capacities change, whatever the hooks say — rate feasibility is not a
    policy choice.

``Decision`` carries the dense per-flow rate vector *plus* the explicit
metaflow priority order, so downstream consumers (``comm_schedule``'s
bucket planner, benchmarks, the timeline) read the order directly instead
of reverse-engineering it from finish timestamps.  The rate vector is
dense over the *view's flow arrays* (``SchedView.src/dst/rem``): in the
compacted simulator those hold only the flows of active metaflows, and
each active record's ``view_ix`` gives its indices into them — policies
address flows exclusively through ``view_ix``, never ``flow_ix``.

See DESIGN.md ("The scheduling-policy contract") for the full contract.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.metaflow import EPS


@dataclass
class Decision:
    """One scheduling round's output.

    ``rates``  — dense per-flow rate vector (same indexing as the flow
                 table in the ``SchedView``).
    ``order``  — explicit metaflow priority order, highest first, as
                 ``(job_name, metaflow_name)`` pairs.  Empty for policies
                 with no meaningful order (per-flow fairness).
    """

    rates: np.ndarray
    order: tuple[tuple[str, str], ...] = field(default=())


class Scheduler(abc.ABC):
    """Base class every scheduling policy implements.

    Policies are attached to one simulation at a time (``attach`` resets
    all run state), receive lifecycle notifications, and produce
    ``Decision``s.  Conservative defaults: every structural event dirties
    the cached structure, and ``refresh`` falls back to ``schedule``, so a
    minimal policy only has to implement ``schedule``.
    """

    name: str = "?"

    # ------------------------------------------------------------ lifecycle
    def attach(self, fabric, jobs) -> None:
        """Bind to a simulation run.  Called once before the event loop;
        must reset any per-run cached structure (policies are reused
        across runs by benchmarks)."""
        self._structure = None

    def on_job_arrival(self, job) -> bool:
        """A job was admitted.  Return True if the cached structure is
        invalidated."""
        return True

    def on_node_finish(self, job, name: str) -> bool:
        """A DAG node (compute task or metaflow) finished."""
        return True

    def on_flow_finish(self, job, mf_name: str) -> bool:
        """A flow finished without finishing its metaflow (backfill
        artifact).  Remaining-byte drift is handled by ``refresh``, so the
        default is clean."""
        return False

    def on_perturbation(self, perturbation) -> bool:
        """A fabric port degraded.  The simulator always forces a full
        reschedule for feasibility; the hook exists so stateful policies
        can also invalidate derived structure."""
        return True

    # ------------------------------------------------------------- decide
    @abc.abstractmethod
    def schedule(self, view) -> Decision:
        """Full decision: rebuild structure, compute keys, assign rates."""

    def refresh(self, view, prev: Decision) -> Decision:
        """Cheap decision between structural events: recompute the
        remaining-bytes-dependent keys and rates from cached structure.
        Must equal ``schedule(view)`` exactly when no structural event
        occurred since the last full call."""
        return self.schedule(view)

    # ------------------------------------------------- shared rate helper
    @staticmethod
    def ordered_rates(view, groups, owners=None) -> np.ndarray:
        """MADD each flow-index group (``view_ix`` arrays) in priority
        order on the residual capacities, then work-conserving backfill —
        the bandwidth assignment shared by every ordered policy (paper
        Algorithm 1 step 3 and Varys' MADD).

        ``owners`` aligns with ``groups``: the ActiveMF record (or list of
        records, for coflow groups) owning each group.  When given, the
        walk keeps a bitmask of exhausted links and skips any group whose
        live-link mask intersects it with one integer AND — exactly the
        groups whose MADD would return without granting (it refuses when
        any required link is exhausted, and residuals only shrink during
        the walk), so the skip is bit-exact while capping the expensive
        MADD calls at O(links) per decision however long the priority
        list is."""
        rates = np.zeros_like(view.rem)
        if view.legacy_walk:
            # Frozen walk of the earlier core (reference-simulator baseline).
            res_eg = view.egress.copy()
            res_in = view.ingress.copy()
            for ix in groups:
                view.madd_legacy(ix, res_eg, res_in, rates)
            if groups:
                view.backfill_legacy(np.concatenate(groups), res_eg,
                                     res_in, rates)
            return rates
        res = view.link_cap.copy()
        if owners is None:
            for ix in groups:
                view.madd(ix, res, rates)
        else:
            ex = view.exhausted_mask(res)
            mask_of = view.link_mask
            for ix, owner in zip(groups, owners):
                if type(owner) is list:
                    pm = 0
                    for rec in owner:
                        o = rec.pm
                        pm |= mask_of(rec) if o is None else o
                else:
                    pm = owner.pm
                    if pm is None:
                        pm = mask_of(owner)
                if pm & ex:
                    continue          # some required link is exhausted
                ex |= view.madd(ix, res, rates)
        # Backfill needs residual along a whole path, and every path
        # enters through a host up-link and leaves through a host
        # down-link; when either block is fully exhausted no flow can
        # receive a grant, so the whole sweep (and its concatenate) is
        # skipped — exact, and the common case under a deep backlog.
        nh = view.n_hosts
        if groups and (res[:nh] > EPS).any() and (res[nh:2 * nh] > EPS).any():
            ordered = np.concatenate(groups)
            view.backfill(ordered, res, rates)
        return rates
