"""Event-driven fluid flow-level simulator over a routed link fabric.

The port's copy of ``repro.core.simulator``: only the imports and one
comment differ.  ``debug_checks=True`` runs the port's invariant engine
(``repro_torch.analysis.sanitize``).  ``tests/test_torch_comm_schedule.py``
holds its JCT, CCT and service order equal to the reference's, and
``tests/test_torch_analysis.py`` its debug-checked runs.

The paper evaluates MSA with a flow-level simulator; this is that simulator,
generalized to multi-stage DAGs (metaflows may have producer compute tasks),
multi-job arrival processes, and arbitrary :class:`repro_torch.core.fabric.
Topology` fabrics — every rate primitive resolves flows against the
topology's capacitated links through a flow->links CSR incidence
(DESIGN.md §11), with the paper's big switch as the degenerate
two-links-per-flow case (bit-identical to the pre-topology port
formulation).

Fluid model: between events, every flow transfers at a constant rate chosen
by the pluggable scheduling policy and every runnable compute task
progresses at the machine speed.  Events: job arrival, flow/metaflow
completion, compute completion, and fabric perturbations (straggler
injection).

Scheduling is event-driven through the ``repro_torch.core.sched`` lifecycle:
policies are ``attach``-ed once, notified of arrivals / node finishes /
perturbations, and asked for a full ``schedule()`` only on events that
dirty their cached structure — the paper's Algorithm-1 trigger ("metaflow
arrives or finishes") generalized per policy.  On clean events the
previous ``Decision``'s structure is reused via the cheap ``refresh()``
path, which recomputes only remaining-bytes-dependent keys and rates; the
two paths are bit-identical by the policy contract, so caching never
changes results (``cache_decisions=False`` forces the full path every
event and is asserted equivalent in tests).

Implementation notes (perf — the compacted core, DESIGN.md §10): per-event
work is O(active flows), never O(total flows).  The event loop maintains
*compacted* flow arrays (src / dst / remaining / owning-metaflow) holding
exactly the flows of currently-active metaflows, rebuilt only on
activation / finish events (which already force a full ``schedule()``, so
decision caching and compaction invalidate together).  Policies see the
compacted arrays through the ``SchedView``; each active record carries
``view_ix``, its indices into them, and ``Decision.rates`` is dense over
the same compacted universe.  Inactive metaflows never enter the arrays:
their remaining bytes are frozen scalars (flows only drain while active)
and their per-port demands are cached on first use, so MSA attribute sums
and critical-path bottlenecks cost O(1) per inactive metaflow.  The
next-event horizon is computed analytically per metaflow group
(``np.minimum.reduceat`` over the group slices — under MADD all flows of
a metaflow finish together, so a whole group retires in one batched event
rather than F flow events).  The per-flow Python backfill loop is replaced
by an exact dedupe: only the first live flow per (src, dst) port pair can
receive a backfill grant (the grant zeroes the smaller of the two
residuals), so the sequential sweep runs over distinct port pairs, not
flows.  Decision invariants (capacity conservation, rates only on live
flows, order coverage, work conservation) are debug-only
(``debug_checks=True``), delegated per event to the pluggable engine in
``repro_torch.analysis.sanitize``.  The reference's ``repro.core.simref``
keeps the pre-compaction core verbatim as the equivalence and perf
baseline; results are bit-identical (asserted exactly in
tests/test_sim_core_equiv.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from time import perf_counter

import numpy as np

from repro_torch.core.fabric import Fabric, Topology
from repro_torch.core.metaflow import EPS, ComputeTask, JobDAG, Metaflow

_MISS = object()   # _inactive_dems cache sentinel (None is a valid hit)


def _csr_gather(lp: np.ndarray, li: np.ndarray, rows: np.ndarray
                ) -> tuple[np.ndarray, np.ndarray]:
    """(entries, cnt): concatenated CSR rows (``li[lp[r]:lp[r+1]]`` for
    each r in ``rows``, in order) plus per-row lengths.  One vectorized
    pass: entry positions are a cumsum of ones with a jump correction at
    each row boundary — shared by every flow->links row gather so the
    non-obvious arithmetic lives in exactly one place."""
    cnt = lp[rows + 1] - lp[rows]
    total = int(cnt.sum())
    if total == 0:
        return li[:0], cnt
    step = np.ones(total, dtype=np.int64)
    step[0] = lp[rows[0]]
    ends = np.cumsum(cnt[:-1])
    step[ends] = lp[rows[1:]] - (lp[rows[:-1]] + cnt[:-1]) + 1
    return li[np.cumsum(step)], cnt


@dataclass
class SimResult:
    """Everything one ``simulate`` run produced: per-job JCT/CCT maps
    (both measured from each job's arrival), per-metaflow/task finish
    instants, the realized metaflow service order, event/decision
    counts, and the fault/perturbation accounting."""

    jct: dict[str, float]                 # job -> completion time (since arrival)
    cct: dict[str, float]                 # job -> last-flow completion (since arrival)
    mf_finish: dict[tuple[str, str], float]
    task_finish: dict[tuple[str, str], float]
    makespan: float
    events: int
    timeline: list[tuple[float, str]] = field(default_factory=list)
    sched_full: int = 0                   # full schedule() computations
    sched_refresh: int = 0                # cheap refresh() reuses
    # Metaflows in first-service order (first positive rate), priority-
    # ordered within one decision — the policy's realized transfer order.
    mf_service_order: list[tuple[str, str]] = field(default_factory=list)
    n_perturbations: int = 0              # applied degrade/restore events
    # ---- resilience telemetry (all zero on fault-free runs) -------------
    n_faults: int = 0                     # applied hard fail/repair events
    retransmitted_bytes: float = 0.0      # in-flight bytes re-added on failure
    stall_s: float = 0.0                  # seconds >= 1 live flow crossed a down link
    flow_stall_s: float = 0.0             # integral of stalled-flow count (flow-seconds)
    recovery_lag_s: float = 0.0           # makespan minus the last repair time

    @property
    def avg_jct(self) -> float:
        return sum(self.jct.values()) / max(len(self.jct), 1)

    @property
    def avg_cct(self) -> float:
        return sum(self.cct.values()) / max(len(self.cct), 1)


@dataclass
class Perturbation:
    """Degrade a port's capacity at a given time (straggler injection).

    ``factor=None`` restores the port to its nominal capacity instead
    (``Fabric.restore``) — pair a degrade with a later restore to model a
    transient straggler."""

    time: float
    port: int
    factor: float | None


#: Every fault-event kind the simulator applies.  ``degrade_port`` /
#: ``restore_port`` are the normalized form of :class:`Perturbation`
#: (soft capacity scaling); ``degrade_link`` / ``restore_link`` are their
#: single-link analogs; the ``fail_*`` / ``repair_*`` kinds are hard
#: failures (capacity 0, reroute/retransmit semantics).
FAULT_KINDS = frozenset({
    "fail_link", "repair_link", "fail_host", "repair_host",
    "degrade_link", "restore_link", "degrade_port", "restore_port",
})

# Deterministic same-timestamp tie-break (see ``fault_key``): repairs
# first, then restores, then degrades, then failures — capacity-raising
# before capacity-lowering, so back-to-back windows on one target
# (repair at t immediately followed by a new failure at t) compose
# instead of tripping the Fabric's already-down/not-down contracts.
_KIND_RANK = {
    "repair_link": 0, "repair_host": 1,
    "restore_link": 2, "restore_port": 3,
    "degrade_link": 4, "degrade_port": 5,
    "fail_link": 6, "fail_host": 7,
}


@dataclass(frozen=True)
class FaultEvent:
    """One scheduled fabric fault/repair event.

    ``target`` is a link id for the ``*_link`` kinds and a port id for
    the ``*_port`` / ``*_host`` kinds.  ``factor`` is required (> 0) for
    the degrade kinds and must be None for every other kind."""

    time: float
    kind: str
    target: int
    factor: float | None = None

    @property
    def port(self) -> int | None:
        """Port-compatibility view for ``Scheduler.on_perturbation``
        listeners written against :class:`Perturbation` (None when the
        event targets a single link, not a port)."""
        if self.kind.endswith(("_port", "_host")):
            return self.target
        return None


def fault_key(ev: FaultEvent) -> tuple:
    """Total order over fault events — THE deterministic tie-break.

    Sorted by (time, kind rank, target, factor): same-timestamp events
    apply repairs/restores before degrades before failures (see
    ``_KIND_RANK``), then by target id, then by factor, so any stream —
    however generated or sharded — replays in exactly one order."""
    return (ev.time, _KIND_RANK[ev.kind], ev.target,
            -1.0 if ev.factor is None else ev.factor)


@dataclass(frozen=True)
class RetransmitPolicy:
    """What happens to in-flight bytes when a link hard-fails.

    * ``none``   — fluid bytes survive the failure (delivery is
      checkpointed continuously; the default).
    * ``window`` — each affected flow loses ``min(delivered, window)``
      bytes: an un-acked transport window's worth is re-added to the
      flow's remaining bytes.
    * ``full``   — every affected flow restarts from zero delivered
      (no partial-delivery checkpoint).
    """

    mode: str = "none"
    window: float = 0.0

    def __post_init__(self) -> None:
        if self.mode not in ("none", "window", "full"):
            raise ValueError(f"unknown retransmit mode {self.mode!r}")
        if self.mode == "window" and not self.window > 0:
            raise ValueError(
                f"window mode needs a positive window, got {self.window}")


@dataclass
class ActiveMF:
    """One schedulable metaflow: producers finished, flows outstanding."""

    job: JobDAG
    mf: Metaflow
    name: str
    ordinal: int          # global metaflow index
    flow_ix: np.ndarray   # indices into the simulator's full flow table
    bit: int = -1         # job-local metaflow bit (JobDAG.mf_bit)
    # Global deterministic tiebreak: the record's position in the sorted
    # (job.name, metaflow name) order — comparing ranks is exactly
    # comparing the name pair, without per-decision string compares.
    rank: int = -1
    pair: tuple[str, str] | None = None   # (job.name, name), for Decision.order
    # Per-record policy scratch: MSA's (scheduler, job_version,
    # classification) entry and its (scheduler, version, rem_obj,
    # attr_map_obj, key) cached sort key — the identity of the memoized
    # floats/dicts proves the inputs unchanged, and the scheduler
    # identity keeps two MSA instances (e.g. different gain modes) from
    # reusing each other's entries.
    msa_ent: tuple | None = None
    msa_key: tuple | None = None
    # Indices of this record's flows in the SchedView's flow arrays.  Set
    # by the owner of the view: the compacted simulator assigns compact
    # slots while the metaflow is active (None when inactive); full-table
    # contexts (the reference simulator, hand-built views in tests and
    # microbenchmarks) set ``view_ix = flow_ix``.
    view_ix: np.ndarray | None = None
    # Live-link bitmask (links crossed by flows with remaining > EPS),
    # cached by SchedView.link_mask and invalidated by the simulator
    # whenever one of this record's flows completes.
    pm: int | None = None


@dataclass
class SchedView:
    """Everything a rate-assignment policy may look at for one round.

    Owned by the simulator and updated incrementally.  ``src``/``dst``/
    ``rem`` are the view's *flow arrays*: in the compacted simulator they
    hold exactly the flows of active metaflows (record ``view_ix`` indexes
    into them); the reference simulator and hand-built views use the full
    flow table with ``view_ix = flow_ix``.  ``Decision.rates`` is dense
    over the same arrays.  ``jobs``/``mf_records`` track admissions and
    retirements, ``active`` changes only on activation/finish events, and
    the capacity vectors refresh on perturbations.

    Inactive metaflows (present in ``mf_records`` but not ``active``) are
    served from O(1) caches instead of the flow arrays: ``mf_rem_frozen``
    holds their remaining bytes (flows only drain while active, so the
    value is the initial size until activation and 0.0 after finish) and
    ``inactive_dems`` lazily yields their per-port demand vectors for
    ``bottleneck_of``.  Both are None in hand-built full-table views,
    which fall back to indexing the arrays with ``flow_ix``.
    """

    t: float
    n_ports: int
    src: np.ndarray        # int32 [F] — view flow arrays (see above)
    dst: np.ndarray        # int32 [F]
    rem: np.ndarray        # float64 [F] — remaining bytes per flow
    egress: np.ndarray     # float64 [P] — full port capacities
    ingress: np.ndarray
    active: list[ActiveMF]
    jobs: list[JobDAG]     # live (arrived, unfinished) jobs
    mf_records: dict[str, list[ActiveMF]]  # live job name -> ALL its records
    mf_rem_frozen: np.ndarray | None = None   # float64 [n_mfs], by ordinal
    inactive_dems: object | None = None       # ordinal -> (dem_out, dem_in)
    # Cross-event memoization, owned and invalidated by the compacted
    # simulator: per-ordinal remaining sums and per-job bit-remaining
    # dicts stay valid until one of the job's flows actually drains (an
    # event only drains *flowing* metaflows — the blocked backlog keeps
    # its sums).  The cached floats are the exact slice sums, so hits are
    # bit-identical to recomputation.  None in hand-built views.
    mf_rem_cache: dict[int, float] | None = None
    bitrem_cache: dict[str, dict[int, float]] | None = None
    # Per-job MSA attribute memo (mask -> summed remaining), invalidated
    # together with bitrem_cache — attributes only move when the job's
    # remaining bytes do.
    attr_cache: dict[str, dict[int, float]] | None = None
    # Per-job policy scratch for capacity-dependent keys (Varys' SEBF
    # bottleneck, cpath's critical paths): invalidated like bitrem_cache
    # PLUS whenever the job's compute advances, and cleared wholesale on
    # perturbations (capacities enter these keys).
    job_scratch: dict[str, dict] | None = None
    # False when the owning simulator won't read Decision.order this
    # round (no unserved metaflow) — policies may then skip building it.
    want_order: bool = True
    # True on reference-simulator views: Scheduler.ordered_rates then runs
    # the frozen pre-compaction walk (madd_legacy on every group, the
    # per-flow backfill_legacy sweep) so the perf baseline measures the
    # old primitives, not this PR's.
    legacy_walk: bool = False
    # ---- link incidence (DESIGN.md §11): every rate primitive resolves
    # flows against the topology's capacitated links.  ``lp``/``li`` are
    # the flow->links CSR over the view's flow arrays (flow i crosses
    # ``li[lp[i]:lp[i+1]]``), ``link_cap`` the full current capacities,
    # ``pathid`` a per-flow deterministic-route key (equal iff two flows
    # cross the identical link tuple — the backfill dedupe class).
    # ``uniform2`` marks the degenerate all-paths-are-(up, down) case
    # (any big-switch view), which the hot paths special-case.  When
    # ``lp`` is omitted the view derives the big-switch incidence from
    # ``src``/``dst``/``egress``/``ingress`` (hand-built and
    # reference-simulator views).
    link_cap: np.ndarray | None = None
    n_links: int = 0
    n_hosts: int = 0       # size of the host up/down link blocks
    lp: np.ndarray | None = None
    li: np.ndarray | None = None
    pathid: np.ndarray | None = None
    uniform2: bool = False
    link_names: list[str] | None = None

    def __post_init__(self) -> None:
        if self.lp is None:
            # Degenerate big-switch incidence: up(src) then down(dst).
            nh = int(self.egress.size)
            self.n_hosts = nh
            self.n_links = 2 * nh
            self.link_cap = np.concatenate(
                [np.asarray(self.egress, dtype=np.float64),
                 np.asarray(self.ingress, dtype=np.float64)])
            n = self.src.size
            li = np.empty(2 * n, dtype=np.int32)
            li[0::2] = self.src
            li[1::2] = self.dst + nh
            self.li = li
            self.lp = np.arange(n + 1, dtype=np.int64) * 2
            self.pathid = self.src.astype(np.int64) * nh + self.dst
            self.uniform2 = True

    def mf_remaining(self, a: ActiveMF) -> float:
        if a.view_ix is not None:
            c = self.mf_rem_cache
            if c is None:
                return float(self.rem[a.view_ix].sum())
            v = c.get(a.ordinal)
            if v is None:
                v = float(self.rem[a.view_ix].sum())
                c[a.ordinal] = v
            return v
        if self.mf_rem_frozen is not None:
            return float(self.mf_rem_frozen[a.ordinal])
        return float(self.rem[a.flow_ix].sum())

    def job_bit_remaining(self, job: JobDAG) -> dict[int, float]:
        """Remaining bytes per metaflow *bit* for one job (active or not) —
        the quantities MSA's indirect attributes sum over.  Callers must
        treat the dict as read-only (it may be a shared cache entry)."""
        c = self.bitrem_cache
        if c is not None:
            out = c.get(job.name)
            if out is not None:
                return out
        out = {}
        for rec in self.mf_records[job.name]:
            bit = rec.bit if rec.bit >= 0 else job.mf_bit(rec.name)
            out[bit] = self.mf_remaining(rec)
        if c is not None:
            c[job.name] = out
        return out

    # ---------------------------------------------------- shared primitives
    def row_entries(self, flow_ix: np.ndarray
                    ) -> tuple[np.ndarray, np.ndarray | int]:
        """(links, cnt): concatenated path-link ids of the given flows
        plus per-flow path lengths (the scalar 2 when every path is the
        degenerate up/down pair).  Contiguous index ranges — every
        single-metaflow group — resolve to one CSR slice."""
        lp = self.lp
        n = flow_ix.size
        if n and int(flow_ix[n - 1]) - int(flow_ix[0]) + 1 == n \
                and (n == 1 or bool((np.diff(flow_ix) == 1).all())):
            # The span test alone false-positives on unsorted index sets
            # (e.g. fair's activation-order concat over a full table), so
            # ascending contiguity is confirmed before trusting the slice.
            i0 = int(flow_ix[0])
            i1 = int(flow_ix[n - 1])
            links = self.li[lp[i0]:lp[i1 + 1]]
            if self.uniform2:
                return links, 2
            return links, lp[i0 + 1:i1 + 2] - lp[i0:i1 + 1]
        if self.uniform2:
            out = np.empty(2 * n, dtype=self.li.dtype)
            out[0::2] = self.src[flow_ix]
            out[1::2] = self.dst[flow_ix] + self.n_hosts
            return out, 2
        return _csr_gather(lp, self.li, flow_ix)

    def link_mask(self, rec: ActiveMF) -> int:
        """Bitmask of the links crossed by the record's *live* flows.
        Cached on the record; the owning simulator clears the cache
        whenever one of the record's flows completes (the only event
        that shrinks the live set)."""
        pm = rec.pm
        if pm is None:
            ix = rec.view_ix
            live_ix = ix[self.rem[ix] > EPS]
            pm = 0
            if live_ix.size:
                links, _ = self.row_entries(live_ix)
                for link in np.unique(links).tolist():
                    pm |= 1 << link
            rec.pm = pm
        return pm

    @staticmethod
    def exhausted_mask(res: np.ndarray) -> int:
        """Bitmask of links with no residual capacity (walk entry state)."""
        ex = 0
        for link in np.nonzero(res <= EPS)[0].tolist():
            ex |= 1 << link
        return ex

    def madd(self, flow_ix: np.ndarray, res: np.ndarray,
             rates: np.ndarray) -> int:
        """Vectorized MADD on the residual link capacities; writes into
        ``rates`` and deducts from ``res`` in place.  No-op when any
        required link is exhausted (the metaflow waits; backfill may
        still run).  ``flow_ix`` indexes the view's flow arrays
        (``view_ix`` space).  Returns a bitmask of the links the grant
        newly exhausted, so walk loops can maintain their exhausted-link
        state incrementally.

        Small groups (most metaflows — collective rounds, narrow
        shuffles) take a scalar path: ~25 numpy calls of fixed overhead
        cost more than the arithmetic for a handful of flows.  The scalar
        path accumulates per-link sums in the same flow order as
        ``bincount``, so every float result is bit-identical."""
        n = flow_ix.size
        if n == 0:
            return 0
        if n <= 16:
            return self._madd_small(flow_ix, res, rates)
        # Contiguous groups (every single-metaflow group is) read the
        # arrays through views instead of fancy-gather copies.  Ascending
        # contiguity is confirmed (not just the span — see row_entries)
        # so the slice pairing agrees with the link gather for any input.
        i0 = int(flow_ix[0])
        i1 = int(flow_ix[n - 1])
        contig = i1 - i0 + 1 == n \
            and bool((np.diff(flow_ix) == 1).all())
        rem = self.rem[i0:i1 + 1] if contig else self.rem[flow_ix]
        live = rem > EPS
        n_live = int(live.sum())
        if n_live == 0:
            return 0
        full = n_live == n
        if full:
            ix = flow_ix
        else:
            ix = flow_ix[live]
            rem = rem[live]
        links, cnt = self.row_entries(ix)
        w = np.repeat(rem, cnt)
        dem = np.bincount(links, weights=w, minlength=self.n_links)
        used = dem > 0
        if (res[used] <= EPS).any():
            return 0
        gamma = (dem[used] / res[used]).max(initial=0.0)
        if gamma <= EPS:
            return 0
        r = rem / gamma
        if contig and full:
            rates[i0:i1 + 1] += r
        else:
            rates[ix] += r
        res -= np.bincount(links, weights=np.repeat(r, cnt),
                           minlength=self.n_links)
        np.clip(res, 0.0, None, out=res)
        sat = 0
        for link in np.nonzero(used & (res <= EPS))[0].tolist():
            sat |= 1 << link
        return sat

    def _madd_small(self, flow_ix: np.ndarray, res: np.ndarray,
                    rates: np.ndarray) -> int:
        """Scalar MADD for small groups — bit-identical to the vectorized
        path (per-link accumulation in flow order == bincount; x-0 and
        single-element clips are exact)."""
        ix_l = flow_ix.tolist()
        rem_l = self.rem[flow_ix].tolist()
        if self.uniform2:
            nh = self.n_hosts
            rows = list(zip(self.src[flow_ix].tolist(),
                            (self.dst[flow_ix] + nh).tolist()))
        else:
            lp = self.lp
            li = self.li
            rows = [li[lp[i]:lp[i + 1]].tolist() for i in ix_l]
        dem: dict[int, float] = {}
        live: list[int] = []
        for k, r in enumerate(rem_l):
            if r > EPS:
                live.append(k)
                for link in rows[k]:
                    dem[link] = dem.get(link, 0.0) + r
        if not live:
            return 0
        gamma = 0.0
        for link, d in dem.items():
            cap = res[link]
            if cap <= EPS:
                return 0
            g = d / cap
            if g > gamma:
                gamma = g
        if gamma <= EPS:
            return 0
        grant: dict[int, float] = {}
        for k in live:
            rr = rem_l[k] / gamma
            rates[ix_l[k]] += rr
            for link in rows[k]:
                grant[link] = grant.get(link, 0.0) + rr
        sat = 0
        for link, g in grant.items():
            v = res[link] - g
            if v < 0.0:
                v = 0.0
            res[link] = v
            if v <= EPS:
                sat |= 1 << link
        return sat

    # ------------------------------------------------ frozen old primitives
    # Verbatim implementations of the earlier core, used only when
    # ``legacy_walk`` is set (reference-simulator views): the perf
    # baseline must pay the old costs — full MADD on every group and the
    # O(flows) per-flow backfill sweep.  Results are identical to the
    # fast paths (asserted by tests/test_sim_core_equiv.py).

    def madd_legacy(self, flow_ix: np.ndarray, res_eg: np.ndarray,
                    res_in: np.ndarray, rates: np.ndarray) -> None:
        rem = self.rem[flow_ix]
        live = rem > EPS
        if not live.any():
            return
        ix = flow_ix[live]
        rem = rem[live]
        s = self.src[ix]
        d = self.dst[ix]
        dem_out = np.bincount(s, weights=rem, minlength=self.n_ports)
        dem_in = np.bincount(d, weights=rem, minlength=self.n_ports)
        used_out = dem_out > 0
        used_in = dem_in > 0
        if (res_eg[used_out] <= EPS).any() or (res_in[used_in] <= EPS).any():
            return
        gamma = max(
            (dem_out[used_out] / res_eg[used_out]).max(initial=0.0),
            (dem_in[used_in] / res_in[used_in]).max(initial=0.0))
        if gamma <= EPS:
            return
        r = rem / gamma
        rates[ix] += r
        res_eg -= np.bincount(s, weights=r, minlength=self.n_ports)
        res_in -= np.bincount(d, weights=r, minlength=self.n_ports)
        np.clip(res_eg, 0.0, None, out=res_eg)
        np.clip(res_in, 0.0, None, out=res_in)

    def backfill_legacy(self, ordered_ix: np.ndarray, res_eg: np.ndarray,
                        res_in: np.ndarray, rates: np.ndarray) -> None:
        rem = self.rem
        src = self.src
        dst = self.dst
        eg = res_eg
        ing = res_in
        for i in ordered_ix:
            if rem[i] <= EPS:
                continue
            h = eg[src[i]]
            hi = ing[dst[i]]
            if hi < h:
                h = hi
            if h > EPS:
                rates[i] += h
                eg[src[i]] -= h
                ing[dst[i]] -= h

    def backfill(self, ordered_ix: np.ndarray, res: np.ndarray,
                 rates: np.ndarray) -> None:
        """Work-conserving backfill in priority order.

        Exact vectorized form of the sequential per-flow sweep: a grant
        ``h = min over the flow's links of res`` zeroes the smallest
        residual on the path, so any later flow on the *identical route*
        (same ``pathid``) sees ``min = 0`` and can never receive a grant
        (residuals only shrink).  Only the *first* live flow per distinct
        route is therefore a candidate; the sequential loop runs over
        those representatives — O(distinct routes), not O(flows)."""
        if ordered_ix.size == 0:
            return
        rem = self.rem
        live = ordered_ix[rem[ordered_ix] > EPS]
        if live.size == 0:
            return
        _, first = np.unique(self.pathid[live], return_index=True)
        reps = live[np.sort(first)]
        li = self.li
        if self.uniform2:
            src = self.src
            dst = self.dst
            nh = self.n_hosts
            for i in reps:
                a = src[i]
                b = nh + dst[i]
                h = res[a]
                hb = res[b]
                if hb < h:
                    h = hb
                if h > EPS:
                    rates[i] += h
                    res[a] -= h
                    res[b] -= h
            return
        lp = self.lp
        for i in reps:
            row = li[lp[i]:lp[i + 1]]
            h = float(res[row].min())
            if h > EPS:
                rates[i] += h
                res[row] -= h

    def bottleneck_time(self, flow_ix: np.ndarray) -> float:
        """Varys' effective bottleneck on full link capacities (SEBF key).
        ``flow_ix`` indexes the view's flow arrays."""
        rem = self.rem[flow_ix]
        live = rem > EPS
        if not live.any():
            return 0.0
        ix = flow_ix[live]
        rem = rem[live]
        links, cnt = self.row_entries(ix)
        dem = np.bincount(links, weights=np.repeat(rem, cnt),
                          minlength=self.n_links)
        return self._bottleneck_from_dems(dem)

    def _bottleneck_from_dems(self, dem: np.ndarray) -> float:
        with np.errstate(divide="ignore", invalid="ignore"):
            g = np.where(dem > 0, dem / self.link_cap, 0.0)
        return float(g.max(initial=0.0))

    def bottleneck_of(self, rec: ActiveMF) -> float:
        """Effective bottleneck for any record, active or not.  Inactive
        metaflows resolve from the frozen per-ordinal caches (their flows
        are untouched until activation and zero after finish)."""
        if rec.view_ix is not None:
            return self.bottleneck_time(rec.view_ix)
        if self.mf_rem_frozen is not None:
            if self.mf_rem_frozen[rec.ordinal] == 0.0:
                return 0.0
            if self.inactive_dems is not None:
                dem = self.inactive_dems(rec.ordinal)
                if dem is None:
                    return 0.0
                return self._bottleneck_from_dems(dem)
        return self.bottleneck_time(rec.flow_ix)


class Simulator:
    """The event-driven fluid simulator (compacted core, DESIGN.md §10).

    Advances (jobs, scheduler, fabric) through admission / activation /
    finish events with piecewise-constant rates between them; per-event
    work is O(active flows).  Most callers want the :func:`simulate`
    wrapper; construct directly to thread perturbations, faults, a
    tracer, or ``debug_checks`` through one run."""

    def __init__(self, fabric: Fabric, jobs: list[JobDAG], scheduler,
                 machine_speed: float = 1.0,
                 perturbations: list[Perturbation] | None = None,
                 faults: list[FaultEvent] | None = None,
                 retransmit: RetransmitPolicy | None = None,
                 record_timeline: bool = False,
                 max_events: int = 5_000_000,
                 cache_decisions: bool = True,
                 debug_checks: bool = False,
                 tracer=None) -> None:
        for j in jobs:
            j.validate()
        names = [j.name for j in jobs]
        if len(set(names)) != len(names):
            raise ValueError("job names must be unique")
        self.fabric = fabric
        self.jobs = sorted(jobs, key=lambda j: (j.arrival, j.name))
        self.scheduler = scheduler
        self.machine_speed = machine_speed
        self.perturbations = sorted(perturbations or [], key=lambda p: p.time)
        # Normalize legacy Perturbations into FaultEvents and merge with
        # the declared fault stream under the one documented tie-break
        # (``fault_key``), so mixed streams replay deterministically.
        merged = [FaultEvent(p.time,
                             "restore_port" if p.factor is None
                             else "degrade_port",
                             p.port, p.factor)
                  for p in (perturbations or [])]
        merged.extend(faults or [])
        for ev in merged:
            self._check_fault_event(ev)
        self.fault_events = sorted(merged, key=fault_key)
        self.retransmit = retransmit
        self.record_timeline = record_timeline
        self.max_events = max_events
        self.cache_decisions = cache_decisions
        self.debug_checks = debug_checks
        # Telemetry sink (repro_torch.obs.Tracer, a layer above the core)
        # or None.  Mirrors the debug_checks pattern: every hook site in
        # run() sits behind one `if tr is not None` check, so the
        # default path pays no tracing cost.
        self.tracer = tracer
        if debug_checks:
            # Deferred import: the invariant engine lives a layer above
            # the core (repro_torch.analysis builds on repro_torch.core), so
            # the dependency only materializes on the debug path.
            from repro_torch.analysis.sanitize import audit_decision
            self._audit_decision = audit_decision
        self._build_tables()
        scheduler.attach(fabric, self.jobs)

    def _check_fault_event(self, ev: FaultEvent) -> None:
        """Fail-fast validation (the richer structured report lives in
        ``repro_torch.analysis.lint.lint_faults``)."""
        if ev.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {ev.kind!r}")
        if not (np.isfinite(ev.time) and ev.time >= 0.0):
            raise ValueError(f"fault time must be finite >= 0, got {ev.time}")
        if ev.kind.startswith("degrade"):
            if ev.factor is None or not (np.isfinite(ev.factor)
                                         and ev.factor > 0):
                raise ValueError(
                    f"{ev.kind} needs a finite factor > 0, got {ev.factor}")
        elif ev.factor is not None:
            raise ValueError(f"{ev.kind} must not carry a factor")
        if ev.kind.endswith("_link"):
            hi = self.fabric.n_links
            what = "link"
        else:
            hi = self.fabric.n_ports
            what = "port"
        if not (0 <= ev.target < hi):
            raise ValueError(
                f"{ev.kind} targets {what} {ev.target} outside 0..{hi - 1}")

    # ------------------------------------------------------------- tables
    def _build_tables(self) -> None:
        src: list[int] = []
        dst: list[int] = []
        rem: list[float] = []
        self._mfs: list[ActiveMF] = []          # ordinal -> record
        self._mf_of_job: dict[str, list[int]] = {}
        self._mf_ord: dict[tuple[str, str], int] = {}  # (job, name) -> ordinal
        # Flow->links incidence (CSR) + per-flow route id, resolved once
        # against the topology's deterministic routing.
        topo = self.fabric.topology
        lp: list[int] = [0]
        li: list[int] = []
        pathid: list[int] = []
        route_ids: dict[tuple[int, int], int] = {}
        for j in self.jobs:
            for p in j.ports_used():
                if not (0 <= p < self.fabric.n_ports):
                    raise ValueError(
                        f"job {j.name!r} uses port {p} outside fabric "
                        f"0..{self.fabric.n_ports - 1}")
            self._mf_of_job[j.name] = []
            for name, mf in j.metaflows.items():
                start = len(src)
                for f in mf.flows:
                    src.append(f.src)
                    dst.append(f.dst)
                    rem.append(f.remaining)
                    li.extend(topo.path(f.src, f.dst))
                    lp.append(len(li))
                    pathid.append(route_ids.setdefault((f.src, f.dst),
                                                       len(route_ids)))
                ix = np.arange(start, len(src), dtype=np.int64)
                rec = ActiveMF(job=j, mf=mf, name=name,
                               ordinal=len(self._mfs), flow_ix=ix,
                               bit=j.mf_bit(name), pair=(j.name, name))
                self._mfs.append(rec)
                self._mf_of_job[j.name].append(rec.ordinal)
                self._mf_ord[(j.name, name)] = rec.ordinal
        for r, o in enumerate(sorted(range(len(self._mfs)),
                                     key=lambda o: (self._mfs[o].job.name,
                                                    self._mfs[o].name))):
            self._mfs[o].rank = r
        self._src = np.asarray(src, dtype=np.int32)
        self._dst = np.asarray(dst, dtype=np.int32)
        self._rem = np.asarray(rem, dtype=np.float64)
        self._size = self._rem.copy()   # initial bytes (retransmit base)
        self._lp = np.asarray(lp, dtype=np.int64)
        self._li = np.asarray(li, dtype=np.int32)
        self._pathid = np.asarray(pathid, dtype=np.int64)
        # pathid -> (src, dst) pair, for fault-time rerouting; the
        # per-pathid flow index lists are built lazily on the first
        # reroute (zero cost on fault-free runs).
        self._route_pairs: list[tuple[int, int]] = [
            pr for pr, _ in sorted(route_ids.items(), key=lambda kv: kv[1])]
        self._reroute_state: tuple[list, list] | None = None
        # Degenerate all-paths-are-(up, down) layout (any big switch):
        # the hot paths then read link ids straight off src/dst.
        self._uniform2 = bool(np.all(np.diff(self._lp) == 2))
        self._flow_done = self._rem <= EPS
        # Per-metaflow outstanding-flow counters.
        self._mf_live = np.array([int((~self._flow_done[m.flow_ix]).sum())
                                  for m in self._mfs], dtype=np.int64)
        self._flow_mf = np.empty(len(src), dtype=np.int64)
        for m in self._mfs:
            self._flow_mf[m.flow_ix] = m.ordinal
        # Frozen remaining bytes per metaflow ordinal: exact while the
        # metaflow is inactive (flows only drain while active); 0.0 once
        # finished.  Same float arithmetic as a full-table slice sum.
        self._mf_frozen = np.array([self._rem[m.flow_ix].sum()
                                    for m in self._mfs], dtype=np.float64)
        self._dems_cache: dict[int, tuple] = {}

    def _inactive_dems(self, ordinal: int):
        """Dense per-link demand vector of an inactive, unfinished
        metaflow (None when fully drained) — computed once (the flows are
        untouched until activation, and the cache is never read after
        finish)."""
        hit = self._dems_cache.get(ordinal, _MISS)
        if hit is _MISS:
            ix = self._mfs[ordinal].flow_ix
            rem = self._rem[ix]
            live = rem > EPS
            if not live.any():
                hit = None
            else:
                ix = ix[live]
                rem = rem[live]
                if self._uniform2:
                    links = np.empty(2 * ix.size, dtype=np.int32)
                    links[0::2] = self._src[ix]
                    links[1::2] = self._dst[ix] + self.fabric.n_ports
                    w = np.repeat(rem, 2)
                else:
                    links, cnt = _csr_gather(self._lp, self._li, ix)
                    w = np.repeat(rem, cnt)
                hit = np.bincount(links, weights=w,
                                  minlength=self.fabric.n_links)
            self._dems_cache[ordinal] = hit
        return hit

    # ------------------------------------------------------------------ run
    def run(self) -> SimResult:
        t = 0.0
        jobs_by_arrival = self.jobs
        next_arrival = 0                       # admission cursor (sorted)
        all_faults = self.fault_events
        next_fault = 0                         # fault cursor (fault_key order)
        # Resilience accounting — all stay zero on fault-free runs.
        n_soft = 0                             # applied degrade/restore events
        n_hard = 0                             # applied fail/repair events
        retrans_total = 0.0
        stall_union = 0.0                      # seconds with >= 1 stalled flow
        flow_stall = 0.0                       # integral of stalled-flow count
        t_last_repair: float | None = None
        down_any = bool(self.fabric.down.any())
        down_ids: tuple[int, ...] = (
            tuple(sorted(self.fabric.down_links())) if down_any else ())
        timeline: list[tuple[float, str]] = []
        mf_finish: dict[tuple[str, str], float] = {}
        task_finish: dict[tuple[str, str], float] = {}
        last_flow: dict[str, float] = {}
        events = 0
        sched = self.scheduler
        tr = self.tracer
        if tr is not None:
            tr.run_begin(self.fabric)

        live_jobs: list[JobDAG] = []
        done_jobs: list[JobDAG] = []           # retire at end of the event
        running: list[tuple[JobDAG, ComputeTask]] = []
        active: dict[int, ActiveMF] = {}       # ordinal -> record
        # Incremental DAG frontier state, built per job at arrival.
        children: dict[str, dict[str, list[str]]] = {}
        pending_deps: dict[str, dict[str, int]] = {}
        unfinished_nodes: dict[str, int] = {}

        # Decision cache + incremental policy view.  The `active` dict is
        # the single source of truth for the active set; the compacted
        # arrays (and `view.active`) are re-derived from it only when it
        # changed — exactly the events that also dirty every decision
        # cache, so a cached Decision never outlives its compact layout.
        dirty = True
        dirty_why = "init"      # structural reason behind the next full schedule
        compact_stale = False
        compact_added: list[ActiveMF] = []  # activations since last rebuild
        compact_removed: list[tuple[int, int]] = []  # dropped (start, size)
        decision = None
        sched_full = 0
        sched_refresh = 0
        mf_rem_cache: dict[int, float] = {}
        bitrem_cache: dict[str, dict[int, float]] = {}
        attr_cache: dict[str, dict[int, float]] = {}
        job_scratch: dict[str, dict] = {}

        def invalidate_job(jname: str) -> None:
            bitrem_cache.pop(jname, None)
            attr_cache.pop(jname, None)
            job_scratch.pop(jname, None)

        def mark_dirty(why: str) -> None:
            """Invalidate the decision cache, remembering the *first*
            structural cause since the last full schedule (traced as the
            full-schedule reason)."""
            nonlocal dirty, dirty_why
            if not dirty:
                dirty_why = why
            dirty = True
        # Compacted active-flow state: one slot per flow of an active
        # metaflow, grouped contiguously per metaflow in activation order.
        c_src = np.empty(0, dtype=np.int32)
        c_dst = np.empty(0, dtype=np.int32)
        c_rem = np.empty(0, dtype=np.float64)
        c_mf = np.empty(0, dtype=np.int64)     # owning ordinal per slot
        c_glob = np.empty(0, dtype=np.int64)   # global flow index per slot
        c_done = np.empty(0, dtype=bool)
        c_starts = np.empty(0, dtype=np.int64)  # group starts (reduceat)
        view = SchedView(
            t=0.0, n_ports=self.fabric.n_ports,
            src=c_src, dst=c_dst, rem=c_rem,
            egress=np.asarray(self.fabric.egress, dtype=np.float64),
            ingress=np.asarray(self.fabric.ingress, dtype=np.float64),
            active=[], jobs=live_jobs, mf_records={},
            mf_rem_frozen=self._mf_frozen,
            inactive_dems=self._inactive_dems,
            mf_rem_cache=mf_rem_cache, bitrem_cache=bitrem_cache,
            attr_cache=attr_cache, job_scratch=job_scratch,
            link_cap=self.fabric.cap.copy(),
            n_links=self.fabric.n_links, n_hosts=self.fabric.n_ports,
            lp=np.zeros(1, dtype=np.int64), li=np.empty(0, dtype=np.int32),
            pathid=np.empty(0, dtype=np.int64), uniform2=self._uniform2,
            link_names=self.fabric.topology.link_names)

        def rebuild_links() -> None:
            """Re-derive the compacted flow->links CSR from ``c_glob`` —
            both rebuild paths leave it current, so one gather covers
            pure activations and compressions alike."""
            if self._uniform2:
                view.li = self._li.reshape(-1, 2)[c_glob].ravel()
                view.lp = np.arange(c_glob.size + 1, dtype=np.int64) * 2
            else:
                view.li, cnt = _csr_gather(self._lp, self._li, c_glob)
                lp_new = np.zeros(c_glob.size + 1, dtype=np.int64)
                np.cumsum(cnt, out=lp_new[1:])
                view.lp = lp_new
            view.pathid = self._pathid[c_glob]

        # ---- fault semantics (all zero-cost until a fault applies) -------
        def slots_crossing(links) -> np.ndarray:
            """Mask over compacted slots whose current route crosses any
            of ``links``."""
            if view.uniform2:
                hit = np.zeros(c_rem.size, dtype=bool)
                nh = view.n_hosts
                for link in links:
                    if link < nh:
                        hit |= c_src == link
                    elif link < 2 * nh:
                        hit |= c_dst == link - nh
                return hit
            member = np.isin(view.li,
                             np.asarray(list(links), dtype=view.li.dtype))
            if not member.any():
                return np.zeros(c_rem.size, dtype=bool)
            return np.add.reduceat(member, view.lp[:-1]) > 0

        def apply_retransmit(dead_links) -> None:
            """Re-add lost in-flight bytes of live flows crossing a link
            that just hard-failed, per the retransmission policy."""
            nonlocal retrans_total
            rp = self.retransmit
            if rp is None or rp.mode == "none" or c_rem.size == 0:
                return
            hit = slots_crossing(dead_links)
            hit &= c_rem > EPS
            if not hit.any():
                return
            delivered = self._size[c_glob[hit]] - c_rem[hit]
            np.clip(delivered, 0.0, None, out=delivered)
            lost = (delivered if rp.mode == "full"
                    else np.minimum(delivered, rp.window))
            total = float(lost.sum())
            if total <= 0.0:
                return
            c_rem[hit] += lost
            retrans_total += total
            for o in np.unique(c_mf[hit]).tolist():
                mf_rem_cache.pop(o, None)
                invalidate_job(self._mfs[o].job.name)
            if tr is not None:
                tr.retransmit(t, total, int(hit.sum()))

        def reroute() -> None:
            """Deterministically re-hash every (src, dst) pair's route
            around the current hard-down set; pairs with no surviving
            candidate keep the nominal (dead) route and stall until
            repair.  Rewrites the full-table CSR in place, re-derives
            the compacted incidence, and drops every route-dependent
            memo (inactive demand vectors, live-link bitmasks)."""
            topo = self.fabric.topology
            if not topo.has_alternate_paths:
                return
            if self._reroute_state is None:
                per_pid: list[list[int]] = [[] for _ in self._route_pairs]
                for i, pid in enumerate(self._pathid.tolist()):
                    per_pid[pid].append(i)
                self._reroute_state = (
                    [topo.path(*pr) for pr in self._route_pairs],
                    [np.asarray(v, dtype=np.int64) for v in per_pid])
            cur, flows_of = self._reroute_state
            down = self.fabric.down_links()
            changed: list[int] = []
            for pid, pr in enumerate(self._route_pairs):
                new = topo.route_avoiding(pr[0], pr[1], down)
                if new is None:
                    new = topo.path(*pr)
                if new != cur[pid]:
                    cur[pid] = new
                    changed.append(pid)
            if not changed:
                return
            li = self._li
            lp = self._lp
            for pid in changed:
                idx = flows_of[pid]
                if idx.size == 0:
                    continue
                new_row = np.asarray(cur[pid], dtype=li.dtype)
                if int(lp[idx[0] + 1] - lp[idx[0]]) != new_row.size:
                    raise RuntimeError(
                        f"route_candidates changed path length for pair "
                        f"{self._route_pairs[pid]}")
                pos = (lp[idx][:, None]
                       + np.arange(new_row.size, dtype=np.int64)).ravel()
                li[pos] = np.tile(new_row, idx.size)
            rebuild_links()
            self._dems_cache.clear()
            for rec in active.values():
                rec.pm = None
            if tr is not None:
                n_act = 0
                if c_glob.size:
                    n_act = int(np.isin(
                        self._pathid[c_glob],
                        np.asarray(changed, dtype=np.int64)).sum())
                tr.reroute(t, n_act)
        # First-service bookkeeping for SimResult.mf_service_order.
        unserved: set[int] = set()
        service_order: list[tuple[str, str]] = []

        def log(msg: str) -> None:
            if self.record_timeline:
                timeline.append((t, msg))

        def rebuild_compact() -> None:
            """Re-derive the compacted arrays from the active set — called
            only when it changed (activation / metaflow finish), which is
            O(active flows) amortized over structural events.  Surviving
            groups carry their drained values over (one boolean
            compression of the old arrays, in order — the active dict
            preserves layout order); the full table is re-synced at the
            same time so it stays canonical.  Pure activations take an
            append-only fast path: the previous layout is a prefix of the
            new one, so the new groups land in one concatenate."""
            nonlocal c_src, c_dst, c_rem, c_mf, c_glob, c_done, c_starts
            if not compact_removed and compact_added:
                offset = c_rem.size
                glob_new = [rec.flow_ix for rec in compact_added]
                starts_new = np.empty(len(compact_added), dtype=np.int64)
                for k, rec in enumerate(compact_added):
                    m = rec.flow_ix.size
                    starts_new[k] = offset
                    rec.view_ix = np.arange(offset, offset + m,
                                            dtype=np.int64)
                    offset += m
                glob_cat = np.concatenate(glob_new)
                c_rem = np.concatenate([c_rem, self._rem[glob_cat]])
                c_glob = np.concatenate([c_glob, glob_cat])
                c_mf = np.concatenate(
                    [c_mf, np.repeat([rec.ordinal for rec in compact_added],
                                     [g.size for g in glob_new])])
                c_src = np.concatenate([c_src, self._src[glob_cat]])
                c_dst = np.concatenate([c_dst, self._dst[glob_cat]])
                c_done = np.concatenate([c_done, self._flow_done[glob_cat]])
                c_starts = np.concatenate([c_starts, starts_new])
                view.src = c_src
                view.dst = c_dst
                view.rem = c_rem
                view.active = view.active + compact_added
                compact_added.clear()
                rebuild_links()
                return
            compact_added.clear()
            recs = list(active.values())
            n_surv = len(recs) - sum(1 for r in recs if r.view_ix is None)
            # Compress the survivors out of the old layout in one pass.
            if compact_removed:
                keep = np.ones(c_rem.size, dtype=bool)
                for s, m in compact_removed:
                    keep[s:s + m] = False
                compact_removed.clear()
                old_rem = c_rem[keep]
                old_glob = c_glob[keep]
                self._rem[old_glob] = old_rem      # re-sync full table
            else:
                old_rem = c_rem
                old_glob = c_glob
            if recs:
                sizes = np.fromiter((rec.flow_ix.size for rec in recs),
                                    dtype=np.int64, count=len(recs))
                c_starts = np.zeros(len(recs), dtype=np.int64)
                np.cumsum(sizes[:-1], out=c_starts[1:])
                if n_surv < len(recs):
                    glob_new = np.concatenate(
                        [rec.flow_ix for rec in recs[n_surv:]])
                    c_rem = np.concatenate([old_rem, self._rem[glob_new]])
                    c_glob = np.concatenate([old_glob, glob_new])
                else:
                    c_rem = old_rem
                    c_glob = old_glob
                c_mf = np.repeat(
                    np.fromiter((rec.ordinal for rec in recs),
                                dtype=np.int64, count=len(recs)), sizes)
                c_src = self._src[c_glob]
                c_dst = self._dst[c_glob]
                c_done = self._flow_done[c_glob].copy()
                master = np.arange(c_rem.size, dtype=np.int64)
                for k, rec in enumerate(recs):
                    s = c_starts[k]
                    rec.view_ix = master[s:s + sizes[k]]
            else:
                c_rem = np.empty(0, dtype=np.float64)
                c_glob = np.empty(0, dtype=np.int64)
                c_mf = np.empty(0, dtype=np.int64)
                c_src = np.empty(0, dtype=np.int32)
                c_dst = np.empty(0, dtype=np.int32)
                c_done = np.empty(0, dtype=bool)
                c_starts = np.empty(0, dtype=np.int64)
            view.src = c_src
            view.dst = c_dst
            view.rem = c_rem
            view.active = recs
            rebuild_links()

        def node_finished(job: JobDAG, name: str) -> None:
            """Cascade a node completion through the frontier."""
            job.mark_dirty()
            if sched.on_node_finish(job, name):
                mark_dirty("node_finish")
            unfinished_nodes[job.name] -= 1
            if unfinished_nodes[job.name] == 0:
                done_jobs.append(job)
            for child in children[job.name].get(name, ()):  # noqa: B023
                pending_deps[job.name][child] -= 1
                if pending_deps[job.name][child] == 0:
                    activate(job, child)

        def activate(job: JobDAG, name: str) -> None:
            nonlocal compact_stale
            node = job.node(name)
            if isinstance(node, ComputeTask):
                node.start_time = t
                running.append((job, node))
                if tr is not None:
                    tr.compute_start(t, job.name, name)
                log(f"start {job.name}/{name}")
            else:
                rec = self._mfs[self._mf_ord[(job.name, name)]]
                if self._mf_live[rec.ordinal] == 0:   # empty/zero metaflow
                    finish_metaflow(rec)
                else:
                    active[rec.ordinal] = rec
                    unserved.add(rec.ordinal)
                    compact_added.append(rec)
                    invalidate_job(job.name)
                    mark_dirty("activation")
                    compact_stale = True
                    if tr is not None:
                        tr.mf_activate(t, job.name, name)
                    log(f"activate {job.name}/{name}")

        def finish_metaflow(rec: ActiveMF) -> None:
            nonlocal compact_stale
            rec.mf.finish_time = t
            for f in rec.mf.flows:
                f.remaining = 0.0
            # Zero the table slice too: flows finish with sub-EPS residues
            # which would otherwise pollute later mf_remaining /
            # job_bit_remaining attribute sums (the frozen value guards the
            # compacted view; the table write keeps the two consistent).
            self._rem[rec.flow_ix] = 0.0
            self._mf_frozen[rec.ordinal] = 0.0
            mf_rem_cache.pop(rec.ordinal, None)
            invalidate_job(rec.job.name)
            mf_finish[(rec.job.name, rec.name)] = t
            last_flow[rec.job.name] = t
            if active.pop(rec.ordinal, None) is not None:
                compact_stale = True
                if rec.view_ix is not None:
                    compact_removed.append((int(rec.view_ix[0]),
                                            rec.view_ix.size))
                else:               # activated and finished between rebuilds
                    compact_added.remove(rec)
            rec.view_ix = None
            unserved.discard(rec.ordinal)
            mark_dirty("mf_finish")
            if tr is not None:
                tr.mf_finish(t, rec.job.name, rec.name)
            log(f"finish {rec.job.name}/{rec.name}")
            node_finished(rec.job, rec.name)

        def record_service(decision, rates) -> None:
            """First time a metaflow transfers, append it to the service
            order — priority-ordered within a single decision."""
            served = np.unique(c_mf[rates > 0.0])
            newly = [o for o in served.tolist()
                     if o in unserved
                     and float(rates[self._mfs[o].view_ix].sum()) > EPS]
            if not newly:
                return
            pos = {key: i for i, key in enumerate(decision.order)}
            n = len(pos)
            newly.sort(key=lambda o: (pos.get((self._mfs[o].job.name,
                                               self._mfs[o].name), n), o))
            for o in newly:
                unserved.discard(o)
                service_order.append((self._mfs[o].job.name,
                                      self._mfs[o].name))

        def admit(job: JobDAG) -> None:
            live_jobs.append(job)
            view.mf_records[job.name] = [self._mfs[o]
                                         for o in self._mf_of_job[job.name]]
            if tr is not None:
                tr.job_arrive(t, job.name)
            if sched.on_job_arrival(job):
                mark_dirty("arrival")
            ch: dict[str, list[str]] = {}
            pend: dict[str, int] = {}
            n_nodes = 0
            for name in list(job.tasks) + list(job.metaflows):
                node = job.node(name)
                pend[name] = len(node.deps)
                for d in node.deps:
                    ch.setdefault(d, []).append(name)
                n_nodes += 1
            children[job.name] = ch
            pending_deps[job.name] = pend
            unfinished_nodes[job.name] = n_nodes
            if n_nodes == 0:          # degenerate empty job: retire this event
                done_jobs.append(job)
            log(f"arrive {job.name}")
            # Snapshot the dep-free roots before activating: activating a
            # zero-size metaflow cascades node_finished into this same
            # `pend` dict, and re-reading live counts would double-activate
            # (and double-finish) nodes the cascade already handled.
            for name in [n for n, k in pend.items() if k == 0]:
                activate(job, name)

        while next_arrival < len(jobs_by_arrival) or live_jobs:
            events += 1
            if events > self.max_events:
                raise RuntimeError("simulator exceeded max_events — livelock?")

            while (next_arrival < len(jobs_by_arrival)
                   and jobs_by_arrival[next_arrival].arrival <= t + EPS):
                admit(jobs_by_arrival[next_arrival])
                next_arrival += 1

            # ---- rates from the policy under test
            view.t = t
            if compact_stale:
                rebuild_compact()
                compact_stale = False
            if view.active:
                view.want_order = bool(unserved)
                if dirty or decision is None or not self.cache_decisions:
                    if tr is None:
                        decision = sched.schedule(view)
                    else:
                        why = dirty_why if dirty else "uncached"
                        w0 = perf_counter()
                        decision = sched.schedule(view)
                        tr.sched(t, "full", perf_counter() - w0, why,
                                 len(view.active))
                    sched_full += 1
                    dirty = False
                else:
                    if tr is None:
                        decision = sched.refresh(view, decision)
                    else:
                        w0 = perf_counter()
                        decision = sched.refresh(view, decision)
                        tr.sched(t, "refresh", perf_counter() - w0, "",
                                 len(view.active))
                    sched_refresh += 1
                rates = decision.rates
                if self.debug_checks:
                    findings = self._audit_decision(view, decision)
                    if tr is not None:
                        tr.audit(t, len(findings))
                if unserved:
                    record_service(decision, rates)
            else:
                rates = np.empty(0, dtype=np.float64)

            # ---- next event horizon, per metaflow group (batched: under
            # MADD every flow of a group finishes at the group's horizon,
            # so the whole group retires in the same event)
            dt = float("inf")
            flowing = (rates > EPS) & (c_rem > EPS)
            any_flowing = bool(flowing.any())
            if any_flowing:
                ttf = np.full(c_rem.size, np.inf)
                ttf[flowing] = c_rem[flowing] / rates[flowing]
                group_horizon = np.minimum.reduceat(ttf, c_starts)
                dt = float(group_horizon.min())
            for _, task in running:
                dt = min(dt, task.remaining / self.machine_speed)
            if next_arrival < len(jobs_by_arrival):
                dt = min(dt, jobs_by_arrival[next_arrival].arrival - t)
            if next_fault < len(all_faults):
                dt = min(dt, all_faults[next_fault].time - t)

            if dt == float("inf"):
                blocked = [j.name for j in live_jobs]
                msg = f"deadlock at t={t}: no progress possible for {blocked}"
                if down_any:
                    msg += (f" (hard-down links {sorted(down_ids)} with no "
                            f"pending repair — fault streams must schedule "
                            f"repairs)")
                raise RuntimeError(msg)
            dt = max(dt, 0.0)

            # ---- stall accounting: live flows whose route crosses a
            # hard-down link receive zero rate for this whole segment.
            if down_any and dt > 0.0 and c_rem.size:
                stalled = slots_crossing(down_ids)
                stalled &= c_rem > EPS
                ns = int(stalled.sum())
                if ns:
                    stall_union += dt
                    flow_stall += ns * dt

            # ---- telemetry: one piecewise-constant rate segment per
            # event-loop advance; together they tile [0, makespan], so
            # integrals over them (busy seconds, bytes) are exact.
            if tr is not None and dt > 0.0:
                if rates.size:
                    w = (np.repeat(rates, 2) if view.uniform2
                         else np.repeat(rates, np.diff(view.lp)))
                    seg_load = np.bincount(view.li, weights=w,
                                           minlength=self.fabric.n_links)
                    seg_pairs = tuple(rec.pair for rec in view.active)
                    seg_mf_rates = np.add.reduceat(rates, c_starts)
                else:
                    seg_load = np.zeros(self.fabric.n_links)
                    seg_pairs = ()
                    seg_mf_rates = np.empty(0, dtype=np.float64)
                tr.segment(t, t + dt, seg_load, seg_pairs, seg_mf_rates)

            # ---- advance the fluid state
            t += dt
            if any_flowing:
                c_rem[flowing] -= rates[flowing] * dt
                np.clip(c_rem, 0.0, None, out=c_rem)
                # Drained metaflows: drop their memoized remaining sums
                # (everything blocked keeps its cache across the event).
                for o in np.unique(c_mf[flowing]).tolist():
                    mf_rem_cache.pop(o, None)
                    invalidate_job(self._mfs[o].job.name)
            if running:
                for job, task in running:
                    task.remaining = max(0.0, task.remaining
                                         - self.machine_speed * dt)
                    # Compute-dependent scratch (cpath keys) went stale.
                    job_scratch.pop(job.name, None)

            while (next_fault < len(all_faults)
                   and all_faults[next_fault].time <= t + EPS):
                ev = all_faults[next_fault]
                next_fault += 1
                kind = ev.kind
                hard = False
                if kind == "degrade_port":
                    self.fabric.degrade(ev.target, ev.factor)
                    log(f"degrade port {ev.target} x{ev.factor}")
                elif kind == "restore_port":
                    self.fabric.restore(ev.target)
                    log(f"restore port {ev.target}")
                elif kind == "degrade_link":
                    self.fabric.degrade_link(ev.target, ev.factor)
                    log(f"degrade link {ev.target} x{ev.factor}")
                elif kind == "restore_link":
                    self.fabric.restore_link(ev.target)
                    log(f"restore link {ev.target}")
                elif kind == "fail_link":
                    self.fabric.fail_link(ev.target)
                    apply_retransmit((ev.target,))
                    hard = True
                elif kind == "fail_host":
                    host = self.fabric.topology.host_links(ev.target)
                    self.fabric.fail_host(ev.target)
                    apply_retransmit(host)
                    hard = True
                elif kind == "repair_link":
                    self.fabric.repair_link(ev.target)
                    t_last_repair = t
                    hard = True
                else:                   # repair_host (ctor checked the kind)
                    self.fabric.repair_host(ev.target)
                    t_last_repair = t
                    hard = True
                if hard:
                    n_hard += 1
                    log(f"{kind} {ev.target}")
                    # The down set changed: re-hash routes around it and
                    # drop every route-dependent memo.
                    reroute()
                    down_any = bool(self.fabric.down.any())
                    down_ids = (tuple(sorted(self.fabric.down_links()))
                                if down_any else ())
                else:
                    n_soft += 1
                view.egress = np.asarray(self.fabric.egress, dtype=np.float64)
                view.ingress = np.asarray(self.fabric.ingress, dtype=np.float64)
                view.link_cap = self.fabric.cap.copy()
                job_scratch.clear()     # capacity-dependent keys everywhere
                sched.on_perturbation(ev)
                mark_dirty("fault" if hard else "perturbation")
                if tr is not None:
                    if kind in ("degrade_port", "restore_port"):
                        tr.perturbation(t, ev.target, ev.factor)
                    else:
                        tr.fault(t, kind, ev.target)

            # ---- commit flow / metaflow completions (per-group batches)
            if c_rem.size:
                newly = np.nonzero((c_rem <= EPS) & ~c_done)[0]
                if newly.size:
                    c_done[newly] = True
                    self._flow_done[c_glob[newly]] = True
                    for ordinal, cnt in zip(*np.unique(c_mf[newly],
                                                       return_counts=True)):
                        self._mf_live[ordinal] -= cnt
                        rec = self._mfs[ordinal]
                        rec.pm = None   # live-link set shrank
                        last_flow[rec.job.name] = t
                        if tr is not None:
                            tr.flow_finish(t, rec.job.name, rec.name,
                                           int(cnt))
                        if self._mf_live[ordinal] == 0 and ordinal in active:
                            finish_metaflow(rec)
                        elif sched.on_flow_finish(rec.job, rec.name):
                            mark_dirty("flow_finish")

            # ---- commit compute completions
            if running:
                still: list[tuple[JobDAG, ComputeTask]] = []
                for job, task in running:
                    if task.remaining <= EPS:
                        task.finish_time = t
                        task_finish[(job.name, task.name)] = t
                        if tr is not None:
                            tr.compute_finish(t, job.name, task.name)
                        log(f"finish {job.name}/{task.name}")
                        node_finished(job, task.name)
                    else:
                        still.append((job, task))
                running[:] = still

            # ---- retire finished jobs (collected by node_finished)
            if done_jobs:
                for j in done_jobs:
                    j.finish_time = t
                    for k, x in enumerate(live_jobs):
                        if x is j:
                            del live_jobs[k]
                            break
                    del view.mf_records[j.name]
                    invalidate_job(j.name)
                    if tr is not None:
                        tr.job_done(t, j.name)
                    log(f"done {j.name}")
                done_jobs.clear()

        if tr is not None:
            tr.run_end(t)
        jct = {j.name: (j.finish_time or 0.0) - j.arrival for j in self.jobs}
        cct = {j.name: last_flow.get(j.name, j.arrival) - j.arrival
               for j in self.jobs}
        recovery = 0.0 if t_last_repair is None else max(0.0, t - t_last_repair)
        return SimResult(jct=jct, cct=cct, mf_finish=mf_finish,
                         task_finish=task_finish, makespan=t, events=events,
                         timeline=timeline, sched_full=sched_full,
                         sched_refresh=sched_refresh,
                         mf_service_order=service_order,
                         n_perturbations=n_soft,
                         n_faults=n_hard,
                         retransmitted_bytes=retrans_total,
                         stall_s=stall_union,
                         flow_stall_s=flow_stall,
                         recovery_lag_s=recovery)

def simulate(jobs: list[JobDAG], scheduler, n_ports: int | None = None,
             fabric: Fabric | None = None, topology: Topology | None = None,
             **kw) -> SimResult:
    """Convenience wrapper: fresh fabric, run to completion.

    ``topology`` builds the fabric over any :class:`Topology`; passing
    it together with ``fabric`` raises (silently preferring one would
    quietly measure the wrong network).

    Note: mutates the given job objects (remaining sizes, finish times);
    build fresh jobs per run when comparing schedulers.
    """
    if fabric is not None and topology is not None:
        raise ValueError("pass either fabric or topology, not both")
    if fabric is None:
        if topology is not None:
            fabric = Fabric(topology=topology)
        else:
            if n_ports is None:
                n_ports = max(max(j.ports_used(), default=0)
                              for j in jobs) + 1
            fabric = Fabric(n_ports=n_ports)
    return Simulator(fabric, jobs, scheduler, **kw).run()
