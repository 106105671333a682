"""Static DAG/scenario linter: named checks -> structured ``Finding``s.

The simulator validates lazily and fatally: a bad port index surfaces as
a ``ValueError`` deep in ``_build_tables``, a cycle as a ``validate()``
raise at admission, a byte-accounting bug in a lowered collective not at
all (the totals are simply wrong).  The ROADMAP's ingestion frontends
(real-workflow traces, open-system arrivals) will feed *user* DAGs into
that pipeline, so this module is the fail-fast analyzer in front of it:
a registry of named checks over ``JobDAG`` lists and compiled scenarios,
each returning structured :class:`Finding`\\ s (severity, job, node,
message) instead of raising, with :func:`strict` as the fail-fast
wrapper ``build_scenario`` runs on every compile.

Checks (registry order; ``available_checks()``):

* ``duplicate_names`` — duplicate job names across the batch, and node
  names living in both ``tasks`` and ``metaflows`` of one job (possible
  only by bypassing the ``add_*`` builders, which is exactly what an
  external ingester might do).
* ``dag_structure`` — unknown dependencies, and Kahn-unreachable nodes
  (anything on or downstream of a dependency cycle).
* ``flow_endpoints`` — self-flows (src == dst: the fabric has no
  loopback; collective lowerings must never emit one), negative or
  non-finite sizes (error), zero-byte flows (warning: legal but
  degenerate — they complete at activation).
* ``port_range`` — flow endpoints and compute-task machines outside the
  target :class:`~repro_torch.core.fabric.Topology`'s ``[0, n_ports)`` (the
  eager twin of the simulator's ``_build_tables`` raise, and of
  ``Fabric.degrade``'s index validation).
* ``arrivals`` — negative / non-finite arrival times (error), batch not
  sorted by arrival (warning: every shipped mixer emits sorted arrivals,
  and the simulator re-sorts, so disorder usually means a buggy
  generator upstream).
* ``offered_load`` — per-link offered load over the batch's arrival
  span, routed via ``Topology.path``: bytes crossing each link divided
  by ``cap * span``.  A sustained rho > 1 means the arrival process
  outruns the fabric (warning — closed batches often front-load on
  purpose, but an open-system scenario saturating a link will never
  reach steady state).

Fault/perturbation streams get their own front end, :func:`lint_faults`
(the ``FaultSpec.compile`` strict gate and the CLI's ``--fault-intensity``
mode): per-event kind/time/factor/target-range checks plus a per-link
state machine over the canonical ``fault_key`` order — fail of an
already-down link, repair of an up link, soft degrades targeting a
hard-down link, and failure windows never repaired before the stream
ends are all errors (zero-duration windows land here too: the tie-break
orders repair before fail at one instant, so ``[t, t)`` reads as a
repair-when-up).

Collective byte conservation cannot be re-derived from a compiled
``JobDAG`` (the logical kind/group/size is gone after lowering), so
:func:`lint_lowered` audits a ``LoweredCollective`` directly, against
totals derived here *independently* of ``repro_torch.appdag.lowering``'s round
builders: ring/HD/direct all-reduce must put ``2 * size * (P-1)`` on the
wire, reduce-scatter / all-gather / all-to-all ``size * (P-1)``, p2p
``size``.

``python -m repro_torch.analysis.lint`` lints registered scenarios (the CI
``analyze`` job runs every one at the quick profile and fails on any
error-severity finding).
"""

from __future__ import annotations

import math
from collections.abc import Callable, Iterable, Iterator
from dataclasses import dataclass

from repro_torch.core.fabric import Topology
from repro_torch.core.metaflow import JobDAG
from repro_torch.core.simulator import FAULT_KINDS, fault_key

SEVERITIES = ("error", "warning")

#: Relative slack for byte-conservation comparisons (pure-float sums).
REL_TOL = 1e-9


@dataclass(frozen=True)
class Finding:
    """One lint result: structured, never raised."""

    check: str
    severity: str          # "error" | "warning"
    message: str
    job: str | None = None
    node: str | None = None

    def __str__(self) -> str:
        where = self.job if self.job is not None else "<batch>"
        if self.node is not None:
            where = f"{where}/{self.node}"
        return f"[{self.severity}] {self.check} @ {where}: {self.message}"


class LintError(ValueError):
    """Raised by :func:`strict` when any error-severity finding exists."""

    def __init__(self, findings: list[Finding]):
        self.findings = findings
        errors = [f for f in findings if f.severity == "error"]
        head = "; ".join(str(f) for f in errors[:3])
        more = f" (+{len(errors) - 3} more)" if len(errors) > 3 else ""
        super().__init__(f"{len(errors)} lint error(s): {head}{more}")


CheckFn = Callable[[list[JobDAG], Topology | None], Iterator[Finding]]
_CHECKS: dict[str, CheckFn] = {}


def check(name: str) -> Callable[[CheckFn], CheckFn]:
    """Register a named lint check (registration order is run order)."""
    def deco(fn: CheckFn) -> CheckFn:
        if name in _CHECKS:
            raise ValueError(f"duplicate lint check {name!r}")
        _CHECKS[name] = fn
        return fn
    return deco


def available_checks() -> tuple[str, ...]:
    return tuple(_CHECKS)


# ------------------------------------------------------------------ checks
@check("duplicate_names")
def _duplicate_names(jobs: list[JobDAG], topology: Topology | None
                     ) -> Iterator[Finding]:
    seen: set[str] = set()
    for j in jobs:
        if j.name in seen:
            yield Finding("duplicate_names", "error",
                          "duplicate job name in batch", job=j.name)
        seen.add(j.name)
        for n in set(j.tasks) & set(j.metaflows):
            yield Finding("duplicate_names", "error",
                          "name is both a task and a metaflow",
                          job=j.name, node=n)


@check("dag_structure")
def _dag_structure(jobs: list[JobDAG], topology: Topology | None
                   ) -> Iterator[Finding]:
    for j in jobs:
        names = set(j.tasks) | set(j.metaflows)
        for n in sorted(names):
            for d in j.node(n).deps:
                if d not in names:
                    yield Finding("dag_structure", "error",
                                  f"depends on unknown node {d!r}",
                                  job=j.name, node=n)
        # Kahn over the known-dep subgraph; whatever never gets in-degree
        # zero sits on (or strictly downstream of) a dependency cycle.
        indeg = {n: sum(d in names for d in j.node(n).deps) for n in names}
        out: dict[str, list[str]] = {n: [] for n in names}
        for n in names:
            for d in j.node(n).deps:
                if d in names:
                    out[d].append(n)
        frontier = [n for n, k in indeg.items() if k == 0]
        reached = set(frontier)
        while frontier:
            n = frontier.pop()
            for m in out[n]:
                indeg[m] -= 1
                if indeg[m] == 0:
                    frontier.append(m)
                    reached.add(m)
        for n in sorted(names - reached):
            yield Finding("dag_structure", "error",
                          "unreachable: on or behind a dependency cycle",
                          job=j.name, node=n)


@check("flow_endpoints")
def _flow_endpoints(jobs: list[JobDAG], topology: Topology | None
                    ) -> Iterator[Finding]:
    for j in jobs:
        for name, mf in j.metaflows.items():
            for f in mf.flows:
                if f.src == f.dst:
                    yield Finding("flow_endpoints", "error",
                                  f"self-flow on port {f.src}",
                                  job=j.name, node=name)
                if not math.isfinite(f.size) or f.size < 0:
                    yield Finding("flow_endpoints", "error",
                                  f"flow size {f.size!r} is not a "
                                  "finite non-negative byte count",
                                  job=j.name, node=name)
                elif f.size == 0:
                    yield Finding("flow_endpoints", "warning",
                                  f"zero-byte flow {f.src}->{f.dst} "
                                  "(completes at activation)",
                                  job=j.name, node=name)


@check("port_range")
def _port_range(jobs: list[JobDAG], topology: Topology | None
                ) -> Iterator[Finding]:
    n_ports = topology.n_ports if topology is not None else None
    for j in jobs:
        for name, mf in j.metaflows.items():
            bad = sorted({p for f in mf.flows for p in (f.src, f.dst)
                          if p < 0 or (n_ports is not None
                                       and p >= n_ports)})
            if bad:
                rng = (f"0..{n_ports - 1}" if n_ports is not None
                       else ">= 0")
                yield Finding("port_range", "error",
                              f"flow port(s) {bad} outside fabric {rng}",
                              job=j.name, node=name)
        if n_ports is not None:
            for name, t in j.tasks.items():
                if t.machine >= n_ports:   # -1 = "nowhere" is legal
                    yield Finding("port_range", "error",
                                  f"machine {t.machine} outside fabric "
                                  f"0..{n_ports - 1}",
                                  job=j.name, node=name)


@check("arrivals")
def _arrivals(jobs: list[JobDAG], topology: Topology | None
              ) -> Iterator[Finding]:
    for j in jobs:
        if not math.isfinite(j.arrival) or j.arrival < 0:
            yield Finding("arrivals", "error",
                          f"arrival time {j.arrival!r} is not a finite "
                          "non-negative instant", job=j.name)
    arr = [j.arrival for j in jobs if math.isfinite(j.arrival)]
    if any(b < a for a, b in zip(arr, arr[1:])):
        yield Finding("arrivals", "warning",
                      "batch is not sorted by arrival time (the "
                      "simulator re-sorts; a generator emitting "
                      "disorder is usually buggy)")


@check("offered_load")
def _offered_load(jobs: list[JobDAG], topology: Topology | None
                  ) -> Iterator[Finding]:
    if topology is None or len(jobs) < 2:
        return
    arr = [j.arrival for j in jobs if math.isfinite(j.arrival)]
    span = max(arr, default=0.0) - min(arr, default=0.0)
    if span <= 0:          # closed batch: no arrival process to outrun
        return
    link_bytes = [0.0] * topology.n_links
    for j in jobs:
        for mf in j.metaflows.values():
            for f in mf.flows:
                if not (0 <= f.src < topology.n_ports
                        and 0 <= f.dst < topology.n_ports
                        and f.src != f.dst and f.size > 0):
                    continue             # port_range / flow_endpoints' beat
                for link in topology.path(f.src, f.dst):
                    link_bytes[link] += f.size
    for link, b in enumerate(link_bytes):
        cap = float(topology.cap[link])
        rho = b / (cap * span) if cap > 0 else math.inf
        if rho > 1.0 + 1e-6:
            name = topology.link_names[link] if topology.link_names \
                else str(link)
            yield Finding("offered_load", "warning",
                          f"link {name}: offered load {rho:.2f}x capacity "
                          f"over the {span:.3g}-unit arrival span")


# ------------------------------------------------- collective conservation
def expected_wire_bytes(kind: str, n_ranks: int, size: float) -> float:
    """Total wire bytes a bandwidth-optimal lowering of ``kind`` over
    ``n_ranks`` participants must move — derived from the collective
    semantics alone, independent of ``repro_torch.appdag.lowering``'s round
    builders (that independence is the point: the two must agree)."""
    p = n_ranks
    if kind == "p2p":
        return size
    if p <= 1:
        return 0.0
    if kind == "all_reduce":
        return 2.0 * size * (p - 1)          # reduce-scatter + all-gather
    if kind in ("reduce_scatter", "all_gather", "all_to_all"):
        return size * (p - 1)
    raise ValueError(f"unknown collective kind {kind!r}")


def lint_lowered(lowered) -> list[Finding]:
    """Byte-conservation + structural audit of one
    :class:`repro_torch.appdag.lowering.LoweredCollective`."""
    out: list[Finding] = []
    node = f"{lowered.kind}/{lowered.algorithm}"
    ranks = set(lowered.ranks)
    expected = expected_wire_bytes(lowered.kind, len(lowered.ranks),
                                   lowered.size)
    total = 0.0
    for t, rnd in enumerate(lowered.rounds):
        for (s, d, z) in rnd:
            total += z
            if s == d:
                out.append(Finding("collective_bytes", "error",
                                   f"self-flow on port {s} in round {t}",
                                   node=node))
            if s not in ranks or d not in ranks:
                out.append(Finding("collective_bytes", "error",
                                   f"round-{t} flow {s}->{d} uses a port "
                                   "outside the collective's rank group",
                                   node=node))
            if not math.isfinite(z) or z < 0:
                out.append(Finding("collective_bytes", "error",
                                   f"round-{t} flow {s}->{d} has size {z!r}",
                                   node=node))
    tol = REL_TOL * max(expected, total, 1.0)
    if abs(total - expected) > tol:
        out.append(Finding("collective_bytes", "error",
                           f"moves {total:.17g} wire bytes, semantics "
                           f"require {expected:.17g} (P={len(lowered.ranks)},"
                           f" size={lowered.size:.17g})", node=node))
    return out


# ----------------------------------------------------- fault-stream linting
def lint_faults(events, topology: Topology | None = None) -> list[Finding]:
    """Audit a fault/perturbation event stream (see module docstring).

    ``events`` is any iterable of :class:`repro_torch.core.simulator.FaultEvent`
    (order need not be canonical — disorder is only a warning, since the
    simulator re-sorts).  Pass the target topology so target-range and
    host-expansion checks see the real link/port counts.
    """
    out: list[Finding] = []
    n_links = topology.n_links if topology is not None else None
    n_ports = topology.n_ports if topology is not None else None
    valid = []
    for i, ev in enumerate(events):
        kind = getattr(ev, "kind", None)
        if kind not in FAULT_KINDS:
            out.append(Finding("fault_stream", "error",
                               f"event {i}: unknown fault kind {kind!r}"))
            continue
        ok = True
        if not math.isfinite(ev.time) or ev.time < 0:
            out.append(Finding("fault_stream", "error",
                               f"event {i} ({kind}): time {ev.time!r} is "
                               "not a finite non-negative instant"))
            ok = False
        if kind.startswith("degrade"):
            if (ev.factor is None or not math.isfinite(ev.factor)
                    or ev.factor <= 0):
                out.append(Finding("fault_stream", "error",
                                   f"event {i} ({kind}): degrade factor "
                                   f"{ev.factor!r} must be finite and > 0"))
                ok = False
            elif ev.factor >= 1.0:
                out.append(Finding("fault_stream", "warning",
                                   f"event {i} ({kind}): factor "
                                   f"{ev.factor:g} >= 1 is not a "
                                   "degradation"))
        elif ev.factor is not None:
            out.append(Finding("fault_stream", "error",
                               f"event {i} ({kind}): carries a factor "
                               f"({ev.factor!r}) but the kind takes none"))
            ok = False
        bound = n_links if kind.endswith("_link") else n_ports
        what = "link" if kind.endswith("_link") else "port"
        if ev.target < 0 or (bound is not None and ev.target >= bound):
            rng = f"0..{bound - 1}" if bound is not None else ">= 0"
            out.append(Finding("fault_stream", "error",
                               f"event {i} ({kind}): {what} {ev.target} "
                               f"outside fabric {rng}"))
            ok = False
        if ok:
            valid.append(ev)
    keys = [fault_key(ev) for ev in valid]
    if any(b < a for a, b in zip(keys, keys[1:])):
        out.append(Finding("fault_stream", "warning",
                           "stream is not in canonical fault_key order "
                           "(the simulator re-sorts; a generator emitting "
                           "disorder is usually buggy)"))

    # Per-link hard-down state machine over the canonical order.  Host
    # kinds expand to the port's two host links when the topology is
    # known; without it they still pair up in a host namespace.
    link_down_by: dict[int, str] = {}     # link -> "fail_link" | "fail_host"
    down_hosts: set[int] = set()

    def host_links(port: int) -> tuple[int, ...]:
        return (port, n_ports + port) if n_ports is not None else ()

    for ev in sorted(valid, key=fault_key):
        k, tgt = ev.kind, ev.target
        at = f"t={ev.time:g}"
        if k == "fail_link":
            if tgt in link_down_by:
                out.append(Finding("fault_stream", "error",
                                   f"{at}: fail_link {tgt} but the link is "
                                   f"already down (via "
                                   f"{link_down_by[tgt]}) — windows on one "
                                   "target must not overlap"))
            else:
                link_down_by[tgt] = "fail_link"
        elif k == "repair_link":
            if link_down_by.get(tgt) == "fail_link":
                del link_down_by[tgt]
            elif link_down_by.get(tgt) == "fail_host":
                out.append(Finding("fault_stream", "error",
                                   f"{at}: repair_link {tgt} targets a link "
                                   "downed by fail_host (repair_host must "
                                   "undo it)"))
            else:
                out.append(Finding("fault_stream", "error",
                                   f"{at}: repair_link {tgt} but the link "
                                   "is not down (repair must follow its "
                                   "failure, strictly later)"))
        elif k == "fail_host":
            clash = [li for li in host_links(tgt) if li in link_down_by]
            if tgt in down_hosts or clash:
                out.append(Finding("fault_stream", "error",
                                   f"{at}: fail_host {tgt} but the host or "
                                   "one of its links is already down"))
            else:
                down_hosts.add(tgt)
                for li in host_links(tgt):
                    link_down_by[li] = "fail_host"
        elif k == "repair_host":
            if tgt in down_hosts:
                down_hosts.discard(tgt)
                for li in host_links(tgt):
                    link_down_by.pop(li, None)
            else:
                out.append(Finding("fault_stream", "error",
                                   f"{at}: repair_host {tgt} but the host "
                                   "is not down (repair must follow its "
                                   "failure, strictly later)"))
        elif k in ("degrade_link", "restore_link"):
            if tgt in link_down_by:
                out.append(Finding("fault_stream", "error",
                                   f"{at}: {k} {tgt} targets a hard-down "
                                   "link (soft events must not land inside "
                                   "a failure window)"))
        elif k in ("degrade_port", "restore_port"):
            hit = [li for li in host_links(tgt) if li in link_down_by]
            if tgt in down_hosts or hit:
                out.append(Finding("fault_stream", "error",
                                   f"{at}: {k} {tgt} targets a hard-down "
                                   "host (soft events must not land inside "
                                   "a failure window)"))
    for tgt in sorted(down_hosts):
        out.append(Finding("fault_stream", "error",
                           f"host {tgt} fails but is never repaired "
                           "before the stream ends"))
    for tgt, via in sorted(link_down_by.items()):
        if via == "fail_link":
            out.append(Finding("fault_stream", "error",
                               f"link {tgt} fails but is never repaired "
                               "before the stream ends"))
    return out


# -------------------------------------------------------------- front ends
def lint_jobs(jobs: list[JobDAG], topology: Topology | None = None,
              checks: Iterable[str] | None = None) -> list[Finding]:
    """Run the named checks (default: all registered) over a job batch."""
    names = list(checks) if checks is not None else list(_CHECKS)
    out: list[Finding] = []
    for name in names:
        if name not in _CHECKS:
            raise KeyError(f"unknown lint check {name!r}; known: "
                           f"{available_checks()}")
        out.extend(_CHECKS[name](jobs, topology))
    return out


def strict(findings: list[Finding]) -> list[Finding]:
    """Fail-fast wrapper: raise :class:`LintError` on any error-severity
    finding, pass warnings through."""
    if any(f.severity == "error" for f in findings):
        raise LintError(findings)
    return findings


def lint_scenario(name: str, seed: int = 0, quick: bool = False,
                  topology: str | None = None) -> list[Finding]:
    """Compile one registered scenario and lint it against its fabric."""
    # Local import: mixer wires strict linting into build_scenario, so a
    # module-level import here would be circular.
    from repro_torch.appdag.mixer import build_scenario
    fabric, jobs = build_scenario(name, seed=seed, quick=quick,
                                  topology=topology, lint=False)
    return lint_jobs(jobs, fabric.topology)


def main(argv: list[str] | None = None) -> int:
    """Back-compat shim: the CLI moved to :mod:`repro_torch.analysis.cli`
    (which adds ``--structure`` / ``--json``); same flags, same exit
    semantics (1 iff any error-severity finding)."""
    from repro_torch.analysis.cli import main as cli_main
    return cli_main(argv)


if __name__ == "__main__":
    raise SystemExit(main())
