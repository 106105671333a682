"""MSA — the Metaflow Scheduling Algorithm (paper Algorithm 1).

The port's copy of ``repro.core.sched.msa``.

On every scheduling event (metaflow arrival or finish — and, in our
simulator, compute finishes, since those can activate metaflows):

  1. *Gain estimation* per active metaflow:
       direct   — the metaflow alone unlocks computation:
                    gain = unlocked_compute_load / remaining_size
       indirect — the metaflow must wait for other unfinished metaflows:
                    attribute = sum of remaining sizes of every metaflow the
                    consumer transitively requires (smaller = closer to
                    unlocking compute).
  2. *Sort*: direct metaflows first (gain descending), then indirect
     (attribute ascending).
  3. *Bandwidth assignment*: walk the sorted list, MADD each metaflow on the
     residual port capacity, then backfill leftovers (work conservation).

Decision-caching split (see sched/base.py): the *classification* —
direct/indirect, gain numerators, consumer requirement masks — only
changes when a DAG node finishes or a job arrives, so it is cached per
record behind a per-job version counter (a node finishing in one job
cannot reclassify another job's metaflows) and ``schedule()`` ==
``refresh()`` by construction.  Keys (gains, attributes) are
remaining-bytes-dependent and recomputed per decision, but memoize
against the view's cross-event caches: a record's sort key is reused
verbatim while the object identities of its memoized remaining-sum and
attribute map hold, which the simulator guarantees implies the inputs
are unchanged — so cached runs are bit-exact against full
recomputation (pinned in tests/test_sched_api.py, and old-vs-new in
tests/test_sim_core_equiv.py).

Gain-numerator ambiguity (documented in DESIGN.md §8): the paper's Figure-2
prose sums ``load_c2 + load_c4`` for MF2 although c4 also consumes MF4.  We
implement both readings:

  * ``gain_mode='unlockable'`` (default, self-consistent): sum loads of all
    unfinished tasks whose *entire* unfinished-metaflow requirement is {m} —
    exactly the compute that m alone unlocks, transitively.
  * ``gain_mode='descendants'`` (literal Fig-2 arithmetic): sum loads of the
    direct consumers plus all their unfinished compute descendants,
    regardless of those descendants' other metaflow dependencies.

Both reproduce the paper's quantitative Figure-1 result (avg JCT 7 vs
Varys' 8); tests cover both.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.metaflow import EPS, JobDAG, Metaflow
from repro_torch.core.sched.base import Decision, Scheduler
from repro_torch.core.sched.registry import register


@dataclass(frozen=True)
class MetaflowPriority:
    """Sortable MSA priority record for one active metaflow."""

    job: str
    name: str
    direct: bool
    gain: float        # meaningful when direct
    attribute: float   # meaningful when indirect

    @property
    def sort_key(self) -> tuple:
        # Direct group strictly above indirect; within: gain desc / attr asc.
        if self.direct:
            return (0, -self.gain, self.job, self.name)
        return (1, self.attribute, self.job, self.name)


def _descendant_closure(job: JobDAG, roots: list[str]) -> set[str]:
    """All unfinished compute tasks reachable (via dep edges) from roots."""
    out: dict[str, list[str]] = {}
    for t in job.tasks.values():
        for d in t.deps:
            out.setdefault(d, []).append(t.name)
    seen: set[str] = set()
    stack = list(roots)
    while stack:
        n = stack.pop()
        for child in out.get(n, ()):
            if child not in seen and not job.tasks[child].done:
                seen.add(child)
                stack.append(child)
    return seen


def metaflow_priorities(jobs: list[JobDAG], active: list[tuple[JobDAG, Metaflow]],
                        gain_mode: str = "unlockable") -> list[MetaflowPriority]:
    """Step 1+2 of MSA: gains for every active metaflow, sorted.

    Pure frozenset reference implementation — the bitmask fast path inside
    :class:`MSAScheduler` is cross-checked against this by a hypothesis
    property test."""
    prios: list[MetaflowPriority] = []
    req_by_job = {j.name: j.unfinished_mf_requirements() for j in jobs}

    for job, mf in active:
        req = req_by_job[job.name]
        consumers = job.consumers_of(mf.name)
        # Direct iff some consumer's whole unfinished-metaflow need is {mf}.
        direct_consumers = [c for c in consumers
                            if not c.done and req[c.name] == frozenset({mf.name})]
        if direct_consumers:
            if gain_mode == "unlockable":
                unlocked = [t for t in job.tasks.values()
                            if not t.done and req[t.name] == frozenset({mf.name})]
                load = sum(t.load for t in unlocked)
            elif gain_mode == "descendants":
                names = {c.name for c in direct_consumers}
                names |= _descendant_closure(job, [c.name for c in direct_consumers])
                load = sum(job.tasks[n].load for n in names)
            else:
                raise ValueError(f"unknown gain_mode {gain_mode!r}")
            rem = max(mf.remaining, EPS)
            prios.append(MetaflowPriority(job.name, mf.name, True, load / rem, 0.0))
        else:
            # Indirect: nearest consumer's total outstanding metaflow bytes.
            attrs = []
            for c in consumers:
                if c.done:
                    continue
                need = req[c.name]
                attrs.append(sum(job.metaflows[m].remaining for m in need))
            attribute = min(attrs) if attrs else mf.remaining
            prios.append(MetaflowPriority(job.name, mf.name, False, 0.0, attribute))

    prios.sort(key=lambda p: p.sort_key)
    return prios


@register("msa")
class MSAScheduler(Scheduler):
    """Paper Algorithm 1 + backfill on the simulator's vectorized view.

    The priority logic is the bitmask fast path of
    :func:`metaflow_priorities`.  The cached structure maps each active
    metaflow ordinal to either ``("D", load)`` (direct, gain numerator) or
    ``("I", [mask, ...])`` (indirect, per-consumer requirement bitmasks),
    held *per job* behind a version counter bumped by the lifecycle hooks:
    a node finishing in one job cannot change another job's
    classification, so a structural event only rebuilds the entries of
    the jobs it touched.  Keys (gains, attributes) are recomputed from
    live remaining bytes on every decision, full or refresh — the key
    arithmetic is expression-for-expression the same on both paths, so
    cached runs stay bit-exact against full recomputation (asserted by
    tests/test_sched_api.py)."""

    def __init__(self, gain_mode: str = "unlockable") -> None:
        if gain_mode not in ("unlockable", "descendants"):
            raise ValueError(f"unknown gain_mode {gain_mode!r}")
        self.gain_mode = gain_mode
        self._job_ver: dict[str, int] = {}
        self._last_order: list = []

    # ------------------------------------------------------------ lifecycle
    def attach(self, fabric, jobs) -> None:
        self._job_ver = {}
        self._last_order = []

    def _bump(self, job) -> bool:
        self._job_ver[job.name] = self._job_ver.get(job.name, 0) + 1
        return True

    def on_job_arrival(self, job) -> bool:
        return self._bump(job)

    def on_node_finish(self, job, name: str) -> bool:
        return self._bump(job)

    # ----------------------------------------------------------- structure
    def _ent(self, rec) -> tuple:
        """Versioned classification entry for one active record, cached on
        the record itself against its job's version counter plus the
        scheduler identity (two MSA instances — e.g. different gain
        modes — must not reuse each other's entries)."""
        job = rec.job
        ver = self._job_ver.get(job.name, 0)
        cached = rec.msa_ent
        if cached is not None and cached[0] is self and cached[1] == ver:
            return cached[2]
        masks, mask_load = job.mf_masks()
        bit = 1 << job.mf_bit(rec.name)
        consumers = [c for c in job.consumers(rec.name)
                     if not job.tasks[c].done]
        if any(masks[c] == bit for c in consumers):
            if self.gain_mode == "unlockable":
                load = mask_load.get(bit, 0.0)
            else:  # 'descendants' — literal Fig-2 arithmetic (reference)
                roots = [c for c in consumers if masks[c] == bit]
                names = set(roots) | _descendant_closure(job, roots)
                load = sum(job.tasks[n].load for n in names)
            ent = ("D", load)
        else:
            ent = ("I", [masks[c] for c in consumers])
        rec.msa_ent = (self, ver, ent)
        return ent

    # ---------------------------------------------------------------- keys
    def _priorities(self, view) -> list[tuple[tuple, object]]:
        """Keyed priority list for the active set (cross-checked against
        the frozenset reference by the property test).  The rank element
        realizes the (job.name, metaflow name) tiebreak without string
        compares (hand-built views without ranks fall back to the name
        pair).  Indirect attributes memoize per (job, mask) in the view's
        cross-event cache — a job's attributes only move when its bytes
        do, and the simulator invalidates exactly then.

        Two O(changed)-per-decision devices (results provably unchanged):
        a record's key is reused verbatim while its job version and the
        *object identities* of its memoized remaining-float and attr map
        hold (those objects are replaced exactly when the underlying
        bytes move, so identity implies the recomputed key would be
        bit-equal); and records are visited in the previous decision's
        sorted order (stale dropped, activations appended), which makes
        the final Timsort near-linear — sorted output is independent of
        visit order since keys are unique."""
        job_ver = self._job_ver
        rem_cache = view.mf_rem_cache
        rem_of = view.mf_remaining
        attr_root = view.attr_cache if view.attr_cache is not None else {}
        bit_rems: dict[str, dict[int, float]] = {}
        active = view.active
        ranked = bool(active) and active[0].rank >= 0
        # Visit order: last sorted order, minus finished, plus activations.
        prev = self._last_order
        if prev:
            order = [rec for rec in prev if rec.view_ix is not None]
            order += [rec for rec in active if rec.msa_key is None]
            if len(order) != len(active):     # drifted (hand-built view)
                order = active
        else:
            order = active
        keyed = []
        for rec in order:
            job = rec.job
            ver = job_ver.get(job.name, 0)
            rem_obj = rem_cache.get(rec.ordinal) if rem_cache is not None \
                else None
            ck = rec.msa_key
            if (ck is not None and ck[0] is self and ck[1] == ver
                    and rem_obj is not None and ck[2] is rem_obj
                    and (ck[3] is None
                         or ck[3] is attr_root.get(job.name))):
                keyed.append((ck[4], rec))
                continue
            cached = rec.msa_ent
            if cached is not None and cached[0] is self and cached[1] == ver:
                ent = cached[2]
            else:
                ent = self._ent(rec)
            rem = rem_of(rec) if rem_obj is None else rem_obj
            if rem < EPS:
                rem = EPS
            amap = None
            if ent[0] == "D":
                val = -ent[1] / rem
                cls = 0
            else:
                jname = job.name
                amap = attr_root.get(jname)
                if amap is None:
                    amap = attr_root[jname] = {}
                attr = float("inf")
                for mask in ent[1]:
                    a = amap.get(mask)
                    if a is None:
                        bit_rem = bit_rems.get(jname)
                        if bit_rem is None:
                            bit_rem = bit_rems[jname] = \
                                view.job_bit_remaining(job)
                        total, mm, b = 0.0, mask, 0
                        while mm:
                            if mm & 1:
                                total += bit_rem[b]
                            mm >>= 1
                            b += 1
                        amap[mask] = a = total
                    if a < attr:
                        attr = a
                val = rem if attr == float("inf") else attr
                cls = 1
            if ranked:
                key = (cls, val, rec.rank)
            else:
                key = (cls, val, job.name, rec.name)
            if rem_cache is not None and rem_obj is None:
                rem_obj = rem_cache.get(rec.ordinal)   # seeded by rem_of
            rec.msa_key = (self, ver, rem_obj, amap, key)
            keyed.append((key, rec))
        keyed.sort()
        self._last_order = [rec for _, rec in keyed]
        return keyed

    # ------------------------------------------------------------- decide
    def _decide(self, view, keyed) -> Decision:
        groups = [rec.view_ix for _, rec in keyed]
        owners = [rec for _, rec in keyed]
        rates = self.ordered_rates(view, groups, owners)
        order = tuple(rec.pair or (rec.job.name, rec.name)
                      for _, rec in keyed) if view.want_order else ()
        return Decision(rates=rates, order=order)

    def schedule(self, view) -> Decision:
        return self._decide(view, self._priorities(view))

    def refresh(self, view, prev: Decision) -> Decision:
        # Same computation: keys are live on both paths and the structure
        # cache is already event-versioned, so refresh == schedule by
        # construction (the contract's bit-exactness, trivially).
        return self._decide(view, self._priorities(view))
