"""Metaflow abstraction: flows, metaflows, compute tasks, and job DAGs.

The port's copy of ``repro.core.metaflow``, whole: the scenario
builder, ``simtorch.pack_instance`` and the port's copy of the numpy
simulator (``repro_torch.core.simulator``) use it.  Only the imports
differ; ``tests/test_torch_comm_schedule.py`` holds the copy's
simulations equal to the reference's.

A *metaflow* (the paper's contribution) is the collection of network flows
consumed by the same computation task in a job's DAG — the smallest unit of
communication that advances computation.  It sits between per-flow scheduling
(no application semantics) and coflows (too coarse: hides intra-job DAG
structure).

The DAG model here is a superset of the paper's:

  * ``ComputeTask`` nodes carry a load (time units at unit machine speed) and
    depend on any mix of compute tasks and metaflows.
  * ``Metaflow`` nodes carry flows (src port -> dst port, size) and may depend
    on *producer* compute tasks (e.g. a shuffle that only starts once the map
    stage finished, or a gradient reduce-scatter that only starts once the
    layer's backward ran).  The paper's single-stage examples have no
    producers; the training-step DAGs built by ``comm_schedule`` do.

All sizes/loads/capacities are in abstract units (the paper's convention);
the JAX bridge uses bytes and FLOP-seconds.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field

EPS = 1e-9

_flow_ids = itertools.count()


@dataclass
class Flow:
    """One point-to-point transfer inside a metaflow."""

    src: int
    dst: int
    size: float
    id: int = field(default_factory=lambda: next(_flow_ids))
    remaining: float = field(default=-1.0)

    def __post_init__(self) -> None:
        if self.size < 0:
            raise ValueError(f"flow size must be >= 0, got {self.size}")
        if self.remaining < 0:
            self.remaining = float(self.size)

    @property
    def done(self) -> bool:
        return self.remaining <= EPS


@dataclass
class Metaflow:
    """A named set of flows consumed by the same downstream computation."""

    name: str
    flows: list[Flow]
    deps: list[str] = field(default_factory=list)  # producer node names
    finish_time: float | None = None

    @property
    def size(self) -> float:
        return sum(f.size for f in self.flows)

    @property
    def remaining(self) -> float:
        return sum(f.remaining for f in self.flows)

    @property
    def done(self) -> bool:
        return all(f.done for f in self.flows)


@dataclass
class ComputeTask:
    """A computation in the job DAG.  Runs at unit speed once runnable."""

    name: str
    load: float
    machine: int = -1  # informational; compute is not a contended resource
    deps: list[str] = field(default_factory=list)
    remaining: float = field(default=-1.0)
    start_time: float | None = None
    finish_time: float | None = None

    def __post_init__(self) -> None:
        if self.load < 0:
            raise ValueError(f"compute load must be >= 0, got {self.load}")
        if self.remaining < 0:
            self.remaining = float(self.load)

    @property
    def done(self) -> bool:
        return self.finish_time is not None


@dataclass
class JobDAG:
    """A distributed job: a DAG over compute tasks and metaflows."""

    name: str
    tasks: dict[str, ComputeTask] = field(default_factory=dict)
    metaflows: dict[str, Metaflow] = field(default_factory=dict)
    arrival: float = 0.0
    finish_time: float | None = None

    # ------------------------------------------------------------- builders
    def add_task(self, name: str, load: float, machine: int = -1,
                 deps: list[str] | None = None) -> ComputeTask:
        if name in self.tasks or name in self.metaflows:
            raise ValueError(f"duplicate node name {name!r} in job {self.name!r}")
        t = ComputeTask(name=name, load=load, machine=machine,
                        deps=list(deps or []))
        self.tasks[name] = t
        return t

    def add_metaflow(self, name: str, flows: list[tuple[int, int, float]],
                     deps: list[str] | None = None) -> Metaflow:
        if name in self.tasks or name in self.metaflows:
            raise ValueError(f"duplicate node name {name!r} in job {self.name!r}")
        m = Metaflow(name=name, flows=[Flow(src=s, dst=d, size=z)
                                       for (s, d, z) in flows],
                     deps=list(deps or []))
        self.metaflows[name] = m
        return m

    # ------------------------------------------------------------- queries
    def node(self, name: str) -> ComputeTask | Metaflow:
        if name in self.tasks:
            return self.tasks[name]
        if name in self.metaflows:
            return self.metaflows[name]
        raise KeyError(f"no node {name!r} in job {self.name!r}")

    def node_done(self, name: str) -> bool:
        return self.node(name).done

    def validate(self) -> None:
        """Check the DAG is well-formed: known deps, acyclic."""
        names = set(self.tasks) | set(self.metaflows)
        for n in names:
            for d in self.node(n).deps:
                if d not in names:
                    raise ValueError(
                        f"job {self.name!r}: node {n!r} depends on unknown {d!r}")
        # Kahn's algorithm for cycle detection.
        indeg = {n: len(self.node(n).deps) for n in names}
        out: dict[str, list[str]] = {n: [] for n in names}
        for n in names:
            for d in self.node(n).deps:
                out[d].append(n)
        frontier = [n for n, k in indeg.items() if k == 0]
        seen = 0
        while frontier:
            n = frontier.pop()
            seen += 1
            for m in out[n]:
                indeg[m] -= 1
                if indeg[m] == 0:
                    frontier.append(m)
        if seen != len(names):
            raise ValueError(f"job {self.name!r}: dependency cycle detected")

    @property
    def done(self) -> bool:
        return (all(t.done for t in self.tasks.values())
                and all(m.done for m in self.metaflows.values()))

    def consumers_of(self, mf_name: str) -> list[ComputeTask]:
        """Compute tasks that directly depend on metaflow ``mf_name``."""
        return [t for t in self.tasks.values() if mf_name in t.deps]

    def unfinished_mf_requirements(self) -> dict[str, frozenset[str]]:
        """For every node, the set of *unfinished* metaflows transitively
        required before it can start (a metaflow requires itself).

        This is the primitive behind both MSA gain classes:
          * direct:   req(consumer) == {m}
          * indirect: attribute = sum(remaining(m') for m' in req(consumer))
        """
        memo: dict[str, frozenset[str]] = {}

        def req(name: str) -> frozenset[str]:
            if name in memo:
                return memo[name]
            memo[name] = frozenset()  # cycle guard; DAG validated elsewhere
            node = self.node(name)
            if node.done:
                memo[name] = frozenset()
                return memo[name]
            acc: set[str] = set()
            if isinstance(node, Metaflow):
                acc.add(name)
            for d in node.deps:
                acc |= req(d)
            memo[name] = frozenset(acc)
            return memo[name]

        for n in list(self.tasks) + list(self.metaflows):
            req(n)
        return memo

    # ---------------------------------------------------- fast-path caches
    # Bitmask representation of unfinished_mf_requirements for the
    # simulator's hot loop: one bit per metaflow, masks recomputed only when
    # a node finishes (mark_dirty).  Kept consistent with the frozenset
    # reference above; tests/test_property.py cross-checks the two.

    def _ensure_static_caches(self) -> None:
        if getattr(self, "_mf_bit", None) is None:
            self._mf_bit: dict[str, int] = {n: i for i, n
                                            in enumerate(self.metaflows)}
            self._bit_name: list[str] = list(self.metaflows)
            cons: dict[str, list[str]] = {n: [] for n in self.metaflows}
            for t in self.tasks.values():
                for d in t.deps:
                    if d in cons:
                        cons[d].append(t.name)
            self._consumers: dict[str, list[str]] = cons

    def mark_dirty(self) -> None:
        self._masks = None

    def mf_bit(self, name: str) -> int:
        self._ensure_static_caches()
        return self._mf_bit[name]

    def consumers(self, name: str) -> list[str]:
        self._ensure_static_caches()
        return self._consumers[name]

    def mf_masks(self) -> tuple[dict[str, int], dict[int, float]]:
        """(masks, mask_load): per-node unfinished-metaflow bitmask, and the
        total load of unfinished tasks grouped by their exact mask (the
        'unlockable by exactly this set' aggregate used for direct gains)."""
        self._ensure_static_caches()
        if getattr(self, "_masks", None) is not None:
            return self._masks, self._mask_load
        masks: dict[str, int] = {}
        # Iterative post-order (job DAGs from comm_schedule can be deep).
        for start in list(self.tasks) + list(self.metaflows):
            if start in masks:
                continue
            stack: list[tuple[str, bool]] = [(start, False)]
            while stack:
                name, expanded = stack.pop()
                if name in masks and not expanded:
                    continue
                node = self.node(name)
                if node.done:
                    masks[name] = 0
                    continue
                if not expanded:
                    stack.append((name, True))
                    for d in node.deps:
                        if d not in masks:
                            stack.append((d, False))
                else:
                    m = 0
                    if isinstance(node, Metaflow):
                        m |= 1 << self._mf_bit[name]
                    for d in node.deps:
                        m |= masks[d]
                    masks[name] = m
        mask_load: dict[int, float] = {}
        for t in self.tasks.values():
            if not t.done and masks[t.name]:
                mask_load[masks[t.name]] = (mask_load.get(masks[t.name], 0.0)
                                            + t.load)
        self._masks = masks
        self._mask_load = mask_load
        return masks, mask_load

    # ------------------------------------------------------ template helpers
    def instantiate(self, name: str | None = None,
                    arrival: float | None = None,
                    port_offset: int = 0,
                    port_map: dict[int, int] | None = None,
                    comm_scale: float = 1.0,
                    compute_scale: float = 1.0,
                    n_ports: int | None = None) -> JobDAG:
        """Fresh runnable copy of this DAG treated as a template.

        Simulation mutates jobs (remaining sizes, finish times), so
        workload mixers build one template DAG and stamp out instances:
        new flow ids, full remaining sizes, no progress.  ``port_map``
        (exact) or ``port_offset`` (shift) relocates the job on the
        fabric; ``comm_scale``/``compute_scale`` rescale flow sizes and
        compute loads (matching workload regimes across job families).

        Relocation is validated eagerly: a mapped endpoint below 0 —
        or at/above ``n_ports`` when the target fabric's size is given —
        raises here, at the placement site, instead of surfacing deep in
        the simulator's table build (consistent with ``Fabric.degrade``'s
        index validation).
        """
        if comm_scale < 0 or compute_scale < 0:
            raise ValueError("scale factors must be >= 0")

        def port(p: int) -> int:
            q = port_map[p] if port_map is not None else p + port_offset
            if q < 0 or (n_ports is not None and q >= n_ports):
                top = f"0..{n_ports - 1}" if n_ports is not None else ">= 0"
                raise ValueError(
                    f"job {self.name!r}: port {p} relocates to {q}, "
                    f"outside the fabric ({top}); "
                    f"port_offset={port_offset}, port_map="
                    f"{'set' if port_map is not None else 'None'}")
            return q

        out = JobDAG(name=name if name is not None else self.name,
                     arrival=self.arrival if arrival is None else arrival)
        for t in self.tasks.values():
            out.add_task(t.name, load=t.load * compute_scale,
                         machine=port(t.machine) if t.machine >= 0 else -1,
                         deps=list(t.deps))
        for m in self.metaflows.values():
            out.add_metaflow(m.name,
                             flows=[(port(f.src), port(f.dst),
                                     f.size * comm_scale) for f in m.flows],
                             deps=list(m.deps))
        return out

    def total_size(self) -> float:
        return sum(m.size for m in self.metaflows.values())

    def total_load(self) -> float:
        return sum(t.load for t in self.tasks.values())

    def ports_used(self) -> set[int]:
        ports: set[int] = set()
        for m in self.metaflows.values():
            for f in m.flows:
                ports.add(f.src)
                ports.add(f.dst)
        return ports


def figure1_jobs() -> list[JobDAG]:
    """The paper's Figure-1 motivating example, reconstructed exactly.

    3x3 fabric (ports 0,1,2 = machines 1,2,3), unit capacity.
      J1: MF_A = {m2->m1, 3 units} -> compute c_a (load 3, on m1)
      J2: MF_B = {m2->m3, 1 unit}  -> compute c_b (load 3, on m3)
          MF_C = {m1->m3, 3 units};  compute c_c (load 3) deps {c_b, MF_C}

    Ground truth (paper arithmetic):
      Varys / CCT-optimal: CCTs (3, 4) avg 3.5; JCTs (6, 10) avg 8.
      MSA:                 CCTs (4, 4) avg 4.0; JCTs (7, 7)  avg 7.
    """
    j1 = JobDAG(name="J1")
    j1.add_metaflow("MF_A", flows=[(1, 0, 3.0)])
    j1.add_task("c_a", load=3.0, machine=0, deps=["MF_A"])

    j2 = JobDAG(name="J2")
    j2.add_metaflow("MF_B", flows=[(1, 2, 1.0)])
    j2.add_metaflow("MF_C", flows=[(0, 2, 3.0)])
    j2.add_task("c_b", load=3.0, machine=2, deps=["MF_B"])
    j2.add_task("c_c", load=3.0, machine=2, deps=["c_b", "MF_C"])

    for j in (j1, j2):
        j.validate()
    return [j1, j2]


def figure2_job() -> JobDAG:
    """The paper's Figure-2 example job: 4 senders, 2 receivers, 4 metaflows.

    DAG (reconstructed from the attribute arithmetic in Section 2):
      MF1 -> c1;  MF2 -> c2;  c3 deps {c1, MF3};  c4 deps {c2, c3, MF4}
    which yields the paper's indirect attributes exactly:
      attr(MF3) = reSize(MF1) + reSize(MF3)
      attr(MF4) = reSize(MF1) + reSize(MF2) + reSize(MF3) + reSize(MF4)
    """
    j = JobDAG(name="fig2")
    # 4 senders (ports 0..3), 2 receivers (ports 4, 5).
    j.add_metaflow("MF1", flows=[(0, 4, 2.0), (1, 4, 2.0)])
    j.add_metaflow("MF2", flows=[(2, 4, 1.0), (3, 4, 1.0)])
    j.add_metaflow("MF3", flows=[(0, 5, 2.0), (1, 5, 2.0)])
    j.add_metaflow("MF4", flows=[(2, 5, 1.0), (3, 5, 1.0)])
    j.add_task("c1", load=4.0, machine=4, deps=["MF1"])
    j.add_task("c2", load=2.0, machine=4, deps=["MF2"])
    j.add_task("c3", load=4.0, machine=5, deps=["c1", "MF3"])
    j.add_task("c4", load=2.0, machine=5, deps=["c2", "c3", "MF4"])
    j.validate()
    return j
