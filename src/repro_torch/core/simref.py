"""Frozen pre-compaction simulator core — the equivalence baseline.

The port's copy of ``repro.core.simref``: only the imports, this
paragraph and the consumers below differ.  It runs on the port's
``ActiveMF``, ``Perturbation``, ``SchedView`` and ``SimResult``
(``repro_torch.core.simulator``), and ``tests/test_torch_simref.py``
holds it equal to the reference's copy and to the port's live core.

This is the ``Simulator.run`` event loop exactly as it stood before the
compacted-core rebuild (DESIGN.md §10): every event pays O(total flows)
— full-table rate masking, capacity bincounts, horizon scan and remaining
update — the admission queue is popped O(n²), and ``finish_metaflow``
leaves sub-EPS residues in the flow table (the residual-bytes leak the
compacted core fixes).  Do not "improve" it: its value is that it stays
byte-for-byte the old semantics.

Two consumers in the port:

* tests/test_torch_simref.py runs it against the live core on a
  randomized 50-job workload and asserts identical JCT / CCT /
  mf_service_order for every registered policy;
* ``chip_smoke.py`` holds the live core to it for all five policies, and
  the lockstep fifo engine on the card (``repro_torch.core.simtorch``)
  to it on the paper's Figure 3b jobs.

Policies are shared with the live core: records here carry
``view_ix = flow_ix`` so every ``SchedView`` primitive resolves against
the full flow table, which is exactly the old behaviour.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.fabric import Fabric
from repro_torch.core.metaflow import EPS, ComputeTask, JobDAG
from repro_torch.core.simulator import (ActiveMF, Perturbation, SchedView,
                                        SimResult)


class UnsupportedTopologyError(ValueError):
    """An engine was handed a fabric topology it cannot simulate.

    A typed refusal: callers degrading to another engine (or asserting
    the refusal in tests) catch this specific type instead of pattern-
    matching a bare ``ValueError`` message — the two engines must never
    disagree *silently*."""


class ReferenceSimulator:
    """The pre-compaction core.  Same constructor contract as
    ``Simulator`` minus the post-freeze additions — ``debug_checks``
    (this core's capacity check always runs, as it used to), ``faults``,
    ``retransmit`` and ``tracer`` (hard failures, rerouting,
    retransmission accounting and structured tracing exist only in the
    live core; ``tests/test_docs.py`` pins the reference's docstring, and
    ``tests/test_torch_simref.py`` this one, against the two
    signatures)."""

    def __init__(self, fabric: Fabric, jobs: list[JobDAG], scheduler,
                 machine_speed: float = 1.0,
                 perturbations: list[Perturbation] | None = None,
                 record_timeline: bool = False,
                 max_events: int = 5_000_000,
                 cache_decisions: bool = True) -> None:
        if fabric.topology.kind != "big_switch":
            raise UnsupportedTopologyError(
                "ReferenceSimulator predates the topology abstraction and "
                "only supports the big-switch fabric; run routed topologies "
                "on repro_torch.core.Simulator")
        for j in jobs:
            j.validate()
        names = [j.name for j in jobs]
        if len(set(names)) != len(names):
            raise ValueError("job names must be unique")
        self.fabric = fabric
        self.jobs = sorted(jobs, key=lambda j: (j.arrival, j.name))
        self.scheduler = scheduler
        self.machine_speed = machine_speed
        # Same tie-break as the compacted simulator's fault_key:
        # same-timestamp restores apply before degrades, then by port.
        self.perturbations = sorted(
            perturbations or [],
            key=lambda p: (p.time, p.factor is not None, p.port))
        self.record_timeline = record_timeline
        self.max_events = max_events
        self.cache_decisions = cache_decisions
        self._build_tables()
        scheduler.attach(fabric, self.jobs)

    # ------------------------------------------------------------- tables
    def _build_tables(self) -> None:
        src: list[int] = []
        dst: list[int] = []
        rem: list[float] = []
        self._mfs: list[ActiveMF] = []          # ordinal -> record
        self._mf_of_job: dict[str, list[int]] = {}
        self._mf_ord: dict[tuple[str, str], int] = {}  # (job, name) -> ordinal
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
                ix = np.arange(start, len(src), dtype=np.int64)
                # view_ix = flow_ix: the old core's policies indexed the
                # full flow table directly.
                rec = ActiveMF(job=j, mf=mf, name=name,
                               ordinal=len(self._mfs), flow_ix=ix,
                               bit=j.mf_bit(name), pair=(j.name, name),
                               view_ix=ix)
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
        self._flow_done = self._rem <= EPS
        self._mf_live = np.array([int((~self._flow_done[m.flow_ix]).sum())
                                  for m in self._mfs], dtype=np.int64)
        self._flow_mf = np.empty(len(src), dtype=np.int64)
        for m in self._mfs:
            self._flow_mf[m.flow_ix] = m.ordinal

    # ------------------------------------------------------------------ run
    def run(self) -> SimResult:
        t = 0.0
        pending = list(self.jobs)
        perts = list(self.perturbations)
        timeline: list[tuple[float, str]] = []
        mf_finish: dict[tuple[str, str], float] = {}
        task_finish: dict[tuple[str, str], float] = {}
        last_flow: dict[str, float] = {}
        events = 0
        sched = self.scheduler

        live_jobs: list[JobDAG] = []
        running: list[tuple[JobDAG, ComputeTask]] = []
        active: dict[int, ActiveMF] = {}       # ordinal -> record
        children: dict[str, dict[str, list[str]]] = {}
        pending_deps: dict[str, dict[str, int]] = {}
        unfinished_nodes: dict[str, int] = {}

        dirty = True
        active_changed = False
        decision = None
        sched_full = 0
        sched_refresh = 0
        allowed = np.zeros(len(self._rem), dtype=bool)
        view = SchedView(
            t=0.0, n_ports=self.fabric.n_ports,
            src=self._src, dst=self._dst, rem=self._rem,
            egress=np.asarray(self.fabric.egress, dtype=np.float64),
            ingress=np.asarray(self.fabric.ingress, dtype=np.float64),
            active=[], jobs=live_jobs, mf_records={},
            legacy_walk=True)
        unserved: set[int] = set()
        service_order: list[tuple[str, str]] = []

        def log(msg: str) -> None:
            if self.record_timeline:
                timeline.append((t, msg))

        def node_finished(job: JobDAG, name: str) -> None:
            nonlocal dirty
            job.mark_dirty()
            if sched.on_node_finish(job, name):
                dirty = True
            unfinished_nodes[job.name] -= 1
            for child in children[job.name].get(name, ()):  # noqa: B023
                pending_deps[job.name][child] -= 1
                if pending_deps[job.name][child] == 0:
                    activate(job, child)

        def activate(job: JobDAG, name: str) -> None:
            nonlocal dirty, active_changed
            node = job.node(name)
            if isinstance(node, ComputeTask):
                node.start_time = t
                running.append((job, node))
                log(f"start {job.name}/{name}")
            else:
                rec = self._mfs[self._mf_ord[(job.name, name)]]
                if self._mf_live[rec.ordinal] == 0:   # empty/zero metaflow
                    finish_metaflow(rec)
                else:
                    active[rec.ordinal] = rec
                    allowed[rec.flow_ix] = True
                    unserved.add(rec.ordinal)
                    dirty = True
                    active_changed = True
                    log(f"activate {job.name}/{name}")

        def finish_metaflow(rec: ActiveMF) -> None:
            nonlocal dirty, active_changed
            rec.mf.finish_time = t
            for f in rec.mf.flows:
                f.remaining = 0.0
            # NOTE: self._rem[rec.flow_ix] deliberately NOT zeroed — the
            # old core's residual-bytes leak, preserved for faithfulness.
            mf_finish[(rec.job.name, rec.name)] = t
            last_flow[rec.job.name] = t
            if active.pop(rec.ordinal, None) is not None:
                allowed[rec.flow_ix] = False
                active_changed = True
            unserved.discard(rec.ordinal)
            dirty = True
            log(f"finish {rec.job.name}/{rec.name}")
            node_finished(rec.job, rec.name)

        def record_service(decision, rates) -> None:
            newly = [o for o in unserved
                     if float(rates[self._mfs[o].flow_ix].sum()) > EPS]
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
            nonlocal dirty
            live_jobs.append(job)
            view.mf_records[job.name] = [self._mfs[o]
                                         for o in self._mf_of_job[job.name]]
            if sched.on_job_arrival(job):
                dirty = True
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
            log(f"arrive {job.name}")
            for name in [n for n, k in pend.items() if k == 0]:
                activate(job, name)

        while pending or live_jobs:
            events += 1
            if events > self.max_events:
                raise RuntimeError("simulator exceeded max_events — livelock?")

            while pending and pending[0].arrival <= t + EPS:
                admit(pending.pop(0))

            # ---- rates from the policy under test
            view.t = t
            if active_changed:
                view.active = list(active.values())
                active_changed = False
            if view.active:
                if dirty or decision is None or not self.cache_decisions:
                    decision = sched.schedule(view)
                    sched_full += 1
                    dirty = False
                else:
                    decision = sched.refresh(view, decision)
                    sched_refresh += 1
                # Only active metaflows may transfer, whatever the policy says.
                rates = np.where(allowed, decision.rates, 0.0)
                self._check_capacity(rates, view)
                if unserved:
                    record_service(decision, rates)
            else:
                rates = np.zeros_like(self._rem)

            # ---- next event horizon
            dt = float("inf")
            flowing = (rates > EPS) & (self._rem > EPS)
            if flowing.any():
                dt = float((self._rem[flowing] / rates[flowing]).min())
            for _, task in running:
                dt = min(dt, task.remaining / self.machine_speed)
            if pending:
                dt = min(dt, pending[0].arrival - t)
            if perts:
                dt = min(dt, perts[0].time - t)

            if dt == float("inf"):
                blocked = [j.name for j in live_jobs]
                raise RuntimeError(
                    f"deadlock at t={t}: no progress possible for {blocked}")
            dt = max(dt, 0.0)

            # ---- advance the fluid state
            t += dt
            if flowing.any():
                self._rem[flowing] -= rates[flowing] * dt
                np.clip(self._rem, 0.0, None, out=self._rem)
            if running:
                for _, task in running:
                    task.remaining = max(0.0, task.remaining
                                         - self.machine_speed * dt)

            while perts and perts[0].time <= t + EPS:
                p = perts.pop(0)
                if p.factor is None:
                    self.fabric.restore(p.port)
                else:
                    self.fabric.degrade(p.port, p.factor)
                view.egress = np.asarray(self.fabric.egress, dtype=np.float64)
                view.ingress = np.asarray(self.fabric.ingress, dtype=np.float64)
                # Policy-shared bookkeeping (not frozen semantics): the
                # link-formulated primitives read capacities through the
                # derived big-switch link vector.
                view.link_cap = np.concatenate([view.egress, view.ingress])
                sched.on_perturbation(p)
                dirty = True
                log(f"degrade port {p.port} x{p.factor}" if p.factor
                    is not None else f"restore port {p.port}")

            # ---- commit flow / metaflow completions
            newly = np.nonzero((self._rem <= EPS) & ~self._flow_done)[0]
            if newly.size:
                self._flow_done[newly] = True
                for ordinal, cnt in zip(*np.unique(self._flow_mf[newly],
                                                   return_counts=True)):
                    self._mf_live[ordinal] -= cnt
                    rec = self._mfs[ordinal]
                    # Policy-shared bookkeeping (not part of the frozen
                    # semantics): the walk's link-mask cache must see the
                    # shrunken live set here too.
                    rec.pm = None
                    last_flow[rec.job.name] = t
                    if self._mf_live[ordinal] == 0 and ordinal in active:
                        finish_metaflow(rec)
                    elif sched.on_flow_finish(rec.job, rec.name):
                        dirty = True

            # ---- commit compute completions
            if running:
                still: list[tuple[JobDAG, ComputeTask]] = []
                for job, task in running:
                    if task.remaining <= EPS:
                        task.finish_time = t
                        task_finish[(job.name, task.name)] = t
                        log(f"finish {job.name}/{task.name}")
                        node_finished(job, task.name)
                    else:
                        still.append((job, task))
                running[:] = still

            # ---- retire finished jobs
            if any(unfinished_nodes[j.name] == 0 for j in live_jobs):
                for j in [j for j in live_jobs if unfinished_nodes[j.name] == 0]:
                    j.finish_time = t
                    live_jobs.remove(j)
                    del view.mf_records[j.name]
                    log(f"done {j.name}")

        jct = {j.name: (j.finish_time or 0.0) - j.arrival for j in self.jobs}
        cct = {j.name: last_flow.get(j.name, j.arrival) - j.arrival
               for j in self.jobs}
        return SimResult(jct=jct, cct=cct, mf_finish=mf_finish,
                         task_finish=task_finish, makespan=t, events=events,
                         timeline=timeline, sched_full=sched_full,
                         sched_refresh=sched_refresh,
                         mf_service_order=service_order)

    def _check_capacity(self, rates: np.ndarray, view: SchedView) -> None:
        """Invariant: the policy never oversubscribes a port."""
        out = np.bincount(self._src, weights=rates, minlength=view.n_ports)
        inn = np.bincount(self._dst, weights=rates, minlength=view.n_ports)
        if (out > view.egress + 1e-6).any() or (inn > view.ingress + 1e-6).any():
            bad = np.nonzero((out > view.egress + 1e-6)
                             | (inn > view.ingress + 1e-6))[0]
            raise AssertionError(f"port(s) {bad.tolist()} oversubscribed")


def simulate_reference(jobs: list[JobDAG], scheduler,
                       n_ports: int | None = None,
                       fabric: Fabric | None = None, **kw) -> SimResult:
    """``simulate`` twin running the frozen pre-compaction core."""
    if fabric is None:
        if n_ports is None:
            n_ports = max(max(j.ports_used(), default=0) for j in jobs) + 1
        fabric = Fabric(n_ports=n_ports)
    return ReferenceSimulator(fabric, jobs, scheduler, **kw).run()
