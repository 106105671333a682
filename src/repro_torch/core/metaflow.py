"""Metaflow abstraction: flows, metaflows, compute tasks, and job DAGs.

The port's copy of ``repro.core.metaflow``, cut to what a scenario's
description needs: the DAG's nodes, their loads, flows and dependencies.
The reference's run-state fields (``remaining``, ``finish_time``) and its
scheduler caches are left out, because the lockstep engine
(``repro_torch.core.simtorch``) keeps the run state in its own tensors and
never mutates a job.

A *metaflow* (the paper's contribution) is the collection of network flows
consumed by the same computation task in a job's DAG, the smallest unit of
communication that advances computation.

  * ``ComputeTask`` nodes carry a load (time units at unit machine speed)
    and depend on any mix of compute tasks and metaflows.
  * ``Metaflow`` nodes carry flows (src port -> dst port, size) and may
    depend on producer compute tasks.

All sizes, loads and capacities are in abstract units.
"""

from __future__ import annotations

from dataclasses import dataclass, field

EPS = 1e-9


@dataclass
class Flow:
    """One point-to-point transfer inside a metaflow."""

    src: int
    dst: int
    size: float

    def __post_init__(self) -> None:
        if self.size < 0:
            raise ValueError(f"flow size must be >= 0, got {self.size}")


@dataclass
class Metaflow:
    """A named set of flows consumed by the same downstream computation."""

    name: str
    flows: list[Flow]
    deps: list[str] = field(default_factory=list)  # producer node names

    @property
    def size(self) -> float:
        return sum(f.size for f in self.flows)


@dataclass
class ComputeTask:
    """A computation in the job DAG.  Runs at unit speed once runnable."""

    name: str
    load: float
    machine: int = -1  # informational; compute is not a contended resource
    deps: list[str] = field(default_factory=list)

    def __post_init__(self) -> None:
        if self.load < 0:
            raise ValueError(f"compute load must be >= 0, got {self.load}")


@dataclass
class JobDAG:
    """A distributed job: a DAG over compute tasks and metaflows."""

    name: str
    tasks: dict[str, ComputeTask] = field(default_factory=dict)
    metaflows: dict[str, Metaflow] = field(default_factory=dict)
    arrival: float = 0.0

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

    # ------------------------------------------------------ template helpers
    def instantiate(self, name: str | None = None,
                    arrival: float | None = None,
                    port_offset: int = 0,
                    port_map: dict[int, int] | None = None,
                    comm_scale: float = 1.0,
                    compute_scale: float = 1.0,
                    n_ports: int | None = None) -> JobDAG:
        """Fresh copy of this DAG treated as a template.

        ``port_map`` (exact) or ``port_offset`` (shift) relocates the job
        on the fabric; ``comm_scale``/``compute_scale`` rescale flow sizes
        and compute loads.  A mapped endpoint below 0, or at/above
        ``n_ports`` when the target fabric's size is given, raises here.
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
