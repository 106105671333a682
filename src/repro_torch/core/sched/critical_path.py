"""Critical-path-first metaflow scheduling (Sincronia-style ordered policy).

The port's copy of ``repro.core.sched.critical_path``.

Orders active metaflows by the *remaining critical path* gated behind
them: the metaflow's own effective bottleneck time (Varys' SEBF key) plus
the longest chain of unfinished downstream work — compute remaining plus
downstream metaflow bottlenecks — it transitively unlocks.  Longest path
first: draining the metaflow that gates the deepest remaining work
minimizes the tail the DAG can still serialize on, which is exactly the
regime (deep ``total_order`` chains, skewed fan-out) where MSA's
greedy-gain rule can be myopic.

This is the first policy written *against* the ``repro.core.sched`` API
rather than ported to it, and it leans on every part of the contract:

* structure — per-job reverse adjacency and a topological order, both
  static for a DAG, built once per job on first sight and kept across
  every event (``on_node_finish`` returns False: finished nodes drop out
  of the backward pass by their zero remaining cost, not by a rebuild);
* keys — one backward pass per event over the cached topological order,
  O(nodes + edges), using live remaining bytes / remaining compute;
* rates — the shared MADD + backfill helper, like every ordered policy.

Compute remaining is measured in load units (unit machine speed, the
paper's convention).
"""

from __future__ import annotations

from repro_torch.core.metaflow import Metaflow
from repro_torch.core.sched.base import Decision, Scheduler
from repro_torch.core.sched.registry import register


@register("cpath")
class CriticalPathScheduler(Scheduler):
    """Longest-remaining-critical-path-first over active metaflows."""

    def __init__(self) -> None:
        self._structure: dict[str, tuple[dict, list]] | None = None

    def attach(self, fabric, jobs) -> None:
        self._structure = {}

    def on_node_finish(self, job, name: str) -> bool:
        return False      # adjacency is static; costs are read live

    def _job_structure(self, job) -> tuple[dict, list]:
        """(children adjacency, reverse topological order) — static."""
        if self._structure is None:
            self._structure = {}
        cached = self._structure.get(job.name)
        if cached is not None:
            return cached
        names = list(job.tasks) + list(job.metaflows)
        children: dict[str, list[str]] = {n: [] for n in names}
        indeg = {n: 0 for n in names}
        for n in names:
            for d in job.node(n).deps:
                children[d].append(n)
                indeg[n] += 1
        # Kahn topological order, then reversed for the backward pass.
        frontier = [n for n in names if indeg[n] == 0]
        topo: list[str] = []
        while frontier:
            n = frontier.pop()
            topo.append(n)
            for c in children[n]:
                indeg[c] -= 1
                if indeg[c] == 0:
                    frontier.append(c)
        topo.reverse()
        self._structure[job.name] = (children, topo)
        return self._structure[job.name]

    def _critical_paths(self, view) -> dict[str, dict[str, float]]:
        """Per job: remaining critical path *through* every node.

        Memoized in the view's per-job scratch: a job's paths only move
        when its bytes drain, its compute advances, or capacities change
        — the simulator invalidates the scratch on exactly those events,
        so hits return the identical floats."""
        scratch = view.job_scratch
        out: dict[str, dict[str, float]] = {}
        jobs_seen = {rec.job.name: rec.job for rec in view.active}
        for jname, job in jobs_seen.items():
            if scratch is not None:
                d = scratch.get(jname)
                if d is None:
                    d = scratch[jname] = {}
                cp = d.get("cpath")
                if cp is not None:
                    out[jname] = cp
                    continue
            children, topo = self._job_structure(job)
            by_name = {r.name: r for r in view.mf_records[jname]}
            cp = {}
            for n in topo:          # reverse topological: children first
                node = job.node(n)
                if isinstance(node, Metaflow):
                    cost = view.bottleneck_of(by_name[n])
                else:
                    cost = max(node.remaining, 0.0) if not node.done else 0.0
                down = 0.0
                for c in children[n]:
                    if cp[c] > down:
                        down = cp[c]
                cp[n] = cost + down
            if scratch is not None:
                d["cpath"] = cp
            out[jname] = cp
        return out

    def _decide(self, view) -> Decision:
        cp = self._critical_paths(view)
        keyed = sorted(view.active,
                       key=lambda rec: (-cp[rec.job.name][rec.name],
                                        rec.job.name, rec.name))
        rates = self.ordered_rates(view, [rec.view_ix for rec in keyed],
                                   keyed)
        order = tuple(rec.pair or (rec.job.name, rec.name)
                      for rec in keyed) if view.want_order else ()
        return Decision(rates=rates, order=order)

    def schedule(self, view) -> Decision:
        return self._decide(view)

    def refresh(self, view, prev: Decision) -> Decision:
        return self._decide(view)
