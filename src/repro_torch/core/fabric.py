"""Topology-general fabric: capacitated links + deterministic routing.

The port's copy of ``repro.core.fabric``, whole: the topologies with
their routes and fault rerouting, ``Fabric`` with its mutable
capacities, degrades, failures and repairs, ``Residual`` and
``backfill``.  Only the imports differ.

The paper evaluates over an N x N datacenter fabric abstracted as one
non-blocking switch where only the N ingress and N egress ports are
contended (the standard coflow-literature model, cf. Varys).  The DAG
abstraction itself is topology-agnostic, so the fabric layer is built
around a general :class:`Topology`: a set of capacitated **link**
resources plus a deterministic ``path(src, dst) -> link ids`` routing
map.  The big switch is the degenerate 2-link case (``egress[src]``,
``ingress[dst]``); :func:`leaf_spine` and :func:`fat_tree` model
oversubscribed clusters with deterministic ECMP-style hashing, so the
same scheduling policies can be asked how their ordering gains survive
core-link contention.

Link-id convention shared by every topology (relied on by the
simulator's backfill short-circuit and by ``Fabric.degrade``):

  * links ``[0, P)``   — host *up* (egress) links, one per port;
  * links ``[P, 2P)``  — host *down* (ingress) links, one per port;
  * links ``[2P, L)``  — internal fabric links (leaf uplinks, core).

``path(src, dst)`` always starts with ``up(src)`` and ends with
``down(dst)`` and is pure: the same pair maps to the same link tuple
for the lifetime of the topology (ECMP hashing is a deterministic mix
of the pair, never load- or time-dependent), so a flow's route can be
resolved once at table-build time.

Capacities are mutable through :class:`Fabric` so tests and the
fault-tolerance benchmarks can degrade a port (or a single link)
mid-run (straggling NIC / failing node / flaky uplink).
"""

from __future__ import annotations

import math
import re

import numpy as np

from repro_torch.core.metaflow import EPS, Flow


def _ecmp(src: int, dst: int, nway: int, salt: int = 0) -> int:
    """Deterministic ECMP hash: stable across processes and runs (unlike
    ``hash``), uniform enough to spread port pairs over ``nway`` paths."""
    x = (src * 0x9E3779B1 ^ dst * 0x85EBCA77 ^ salt * 0xC2B2AE3D) & 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x045D9F3B) & 0xFFFFFFFF
    x ^= x >> 16
    return x % nway


class Topology:
    """A set of capacitated link resources plus deterministic routing.

    Subclasses fill ``cap`` / ``link_names`` and implement ``_route``;
    ``path`` memoizes routes per (src, dst) pair (routing is pure).
    Fault rerouting (DESIGN.md §15) rides on the same surface:
    ``route_candidates`` enumerates the ordered equal-length alternates
    (ECMP choice first), ``route_avoiding`` picks the first one clear of
    a hard-down link set, and ``has_alternate_paths`` advertises whether
    the subclass has any alternates at all — when ``False`` a flow on a
    dead link stalls until repair instead of rerouting."""

    kind: str = "?"

    def __init__(self, n_ports: int, cap: np.ndarray,
                 link_names: list[str]) -> None:
        if n_ports <= 0:
            raise ValueError(f"n_ports must be positive, got {n_ports}")
        self.n_ports = n_ports
        self.cap = np.asarray(cap, dtype=np.float64)
        self.n_links = int(self.cap.size)
        self.link_names = link_names
        if len(link_names) != self.n_links:
            raise ValueError("link_names must match cap length")
        self._paths: dict[tuple[int, int], tuple[int, ...]] = {}

    # --------------------------------------------------------------- routing
    def path(self, src: int, dst: int) -> tuple[int, ...]:
        """Deterministic link route of a (src, dst) flow; first link is
        always ``up(src)`` (< n_ports), last always ``down(dst)``."""
        key = (src, dst)
        hit = self._paths.get(key)
        if hit is None:
            for p in key:
                if not (0 <= p < self.n_ports):
                    raise ValueError(
                        f"port {p} outside 0..{self.n_ports - 1}")
            hit = self._paths[key] = self._route(src, dst)
        return hit

    def _route(self, src: int, dst: int) -> tuple[int, ...]:
        raise NotImplementedError

    # ---------------------------------------------------- fault rerouting
    #: Whether any (src, dst) pair has more than one candidate route.
    #: Topologies that leave this False never reroute: a flow on a
    #: hard-down link simply stalls until the link is repaired.
    has_alternate_paths: bool = False

    def route_candidates(self, src: int, dst: int) -> tuple[tuple[int, ...], ...]:
        """Deterministic, ordered candidate routes for a (src, dst) pair.

        The first candidate is always ``path(src, dst)`` (the nominal
        ECMP choice), and every candidate has the same link count — the
        simulator's CSR incidence relies on route length being a pure
        function of the pair.  The base topology has a single route."""
        return (self.path(src, dst),)

    def route_avoiding(self, src: int, dst: int,
                       down: frozenset[int] | set[int]) -> tuple[int, ...] | None:
        """First candidate route avoiding every link in ``down``, or
        ``None`` when no candidate survives (the flow must stall)."""
        for cand in self.route_candidates(src, dst):
            if not any(link in down for link in cand):
                return cand
        return None

    # ------------------------------------------------------------- structure
    def host_links(self, port: int) -> tuple[int, ...]:
        """Links attached to one host endpoint (its NIC up/down pair) —
        the resources ``Fabric.degrade`` scales for a straggler."""
        return (port, self.n_ports + port)

    def describe(self) -> str:
        return f"{self.kind}({self.n_ports} ports, {self.n_links} links)"


class BigSwitch(Topology):
    """The paper's non-blocking fabric: every flow crosses exactly its
    source egress link and destination ingress link."""

    kind = "big_switch"

    def __init__(self, n_ports: int, egress: list[float] | None = None,
                 ingress: list[float] | None = None) -> None:
        egress = [1.0] * n_ports if not egress else list(egress)
        ingress = [1.0] * n_ports if not ingress else list(ingress)
        if len(egress) != n_ports or len(ingress) != n_ports:
            raise ValueError("capacity vectors must have n_ports entries")
        names = [f"up[{p}]" for p in range(n_ports)] + \
                [f"down[{p}]" for p in range(n_ports)]
        super().__init__(n_ports, np.asarray(egress + ingress), names)

    def _route(self, src: int, dst: int) -> tuple[int, int]:
        return (src, self.n_ports + dst)


class LeafSpine(Topology):
    """Two-tier leaf-spine with an oversubscribed core.

    ``n_leaves * hosts_per_leaf`` hosts; each leaf has one up and one
    down link per spine, sized so the leaf's total uplink capacity is
    ``hosts_per_leaf * host_cap / oversubscription`` (a 3:1 fabric can
    drain a third of its hosts' aggregate demand into the core).
    Intra-leaf flows use only their host links (leaf switching is
    non-blocking); cross-leaf flows add the ECMP-hashed spine's leaf-up
    and leaf-down links."""

    kind = "leaf_spine"

    def __init__(self, n_leaves: int, hosts_per_leaf: int,
                 oversubscription: float = 1.0, n_spines: int = 2,
                 host_cap: float = 1.0) -> None:
        if n_leaves < 1 or hosts_per_leaf < 1 or n_spines < 1:
            raise ValueError("n_leaves, hosts_per_leaf, n_spines must be >= 1")
        if oversubscription <= 0:
            raise ValueError(
                f"oversubscription must be > 0, got {oversubscription}")
        self.n_leaves = n_leaves
        self.hosts_per_leaf = hosts_per_leaf
        self.n_spines = n_spines
        self.oversubscription = oversubscription
        n_ports = n_leaves * hosts_per_leaf
        spine_cap = hosts_per_leaf * host_cap / (oversubscription * n_spines)
        cap = [host_cap] * (2 * n_ports)
        names = [f"up[{p}]" for p in range(n_ports)] + \
                [f"down[{p}]" for p in range(n_ports)]
        self._leaf_up = 2 * n_ports
        for leaf in range(n_leaves):
            for s in range(n_spines):
                cap.append(spine_cap)
                names.append(f"leaf{leaf}-up-spine{s}")
        self._leaf_down = self._leaf_up + n_leaves * n_spines
        for leaf in range(n_leaves):
            for s in range(n_spines):
                cap.append(spine_cap)
                names.append(f"leaf{leaf}-down-spine{s}")
        super().__init__(n_ports, np.asarray(cap), names)

    def leaf_of(self, port: int) -> int:
        return port // self.hosts_per_leaf

    def _route(self, src: int, dst: int) -> tuple[int, ...]:
        up, down = src, self.n_ports + dst
        ls, ld = self.leaf_of(src), self.leaf_of(dst)
        if ls == ld:
            return (up, down)
        s = _ecmp(src, dst, self.n_spines)
        return (up,
                self._leaf_up + ls * self.n_spines + s,
                self._leaf_down + ld * self.n_spines + s,
                down)

    @property
    def has_alternate_paths(self) -> bool:  # type: ignore[override]
        return self.n_spines > 1

    def route_candidates(self, src: int, dst: int) -> tuple[tuple[int, ...], ...]:
        """Cross-leaf pairs can re-hash over every spine; the nominal
        ECMP spine comes first, the rest in deterministic rotation."""
        ls, ld = self.leaf_of(src), self.leaf_of(dst)
        if ls == ld:
            return (self.path(src, dst),)
        up, down = src, self.n_ports + dst
        s0 = _ecmp(src, dst, self.n_spines)
        out = []
        for k in range(self.n_spines):
            s = (s0 + k) % self.n_spines
            out.append((up,
                        self._leaf_up + ls * self.n_spines + s,
                        self._leaf_down + ld * self.n_spines + s,
                        down))
        return tuple(out)

    def describe(self) -> str:
        return (f"leaf_spine({self.n_leaves}x{self.hosts_per_leaf} hosts, "
                f"{self.n_spines} spines, "
                f"{self.oversubscription:g}:1 oversubscribed)")


class FatTree(Topology):
    """Classic 3-tier k-ary fat-tree (k even): k pods of k/2 edge and
    k/2 aggregation switches, (k/2)^2 cores, k^3/4 hosts.  Every
    switch-to-switch cable is one capacitated link per direction; ECMP
    hashes pick the aggregation switch and (for cross-pod flows) the
    core within its group — core group j attaches to aggregation switch
    j of every pod, which pins the down path."""

    kind = "fat_tree"

    def __init__(self, k: int, host_cap: float = 1.0) -> None:
        if k < 2 or k % 2:
            raise ValueError(f"fat-tree k must be even and >= 2, got {k}")
        self.k = k
        half = k // 2
        n_ports = k * half * half          # k pods * k/2 edges * k/2 hosts
        n_edge = k * half                  # global edge-switch count
        n_agg = k * half
        cap = [host_cap] * (2 * n_ports)
        names = [f"up[{p}]" for p in range(n_ports)] + \
                [f"down[{p}]" for p in range(n_ports)]
        # (edge e, agg j-within-pod) both directions, then (agg a, core
        # m-within-group) both directions.
        self._eu = len(cap)
        cap += [host_cap] * (n_edge * half)
        names += [f"edge{e}-up-agg{j}" for e in range(n_edge)
                  for j in range(half)]
        self._ad = len(cap)
        cap += [host_cap] * (n_edge * half)
        names += [f"agg{j}-down-edge{e}" for e in range(n_edge)
                  for j in range(half)]
        self._au = len(cap)
        cap += [host_cap] * (n_agg * half)
        names += [f"agg{a}-up-core{m}" for a in range(n_agg)
                  for m in range(half)]
        self._cd = len(cap)
        cap += [host_cap] * (n_agg * half)
        names += [f"core{m}-down-agg{a}" for a in range(n_agg)
                  for m in range(half)]
        super().__init__(n_ports, np.asarray(cap), names)

    def _locate(self, port: int) -> tuple[int, int]:
        """(pod, global edge-switch index) of a host port."""
        half = self.k // 2
        pod = port // (half * half)
        edge = pod * half + (port % (half * half)) // half
        return pod, edge

    def _route(self, src: int, dst: int) -> tuple[int, ...]:
        up, down = src, self.n_ports + dst
        ps, es = self._locate(src)
        pd, ed = self._locate(dst)
        if es == ed:
            return (up, down)
        half = self.k // 2
        j = _ecmp(src, dst, half)          # aggregation switch within pod
        if ps == pd:
            return (up, self._eu + es * half + j,
                    self._ad + ed * half + j, down)
        m = _ecmp(src, dst, half, salt=1)  # core within agg group j
        a_s = ps * half + j
        a_d = pd * half + j
        return (up,
                self._eu + es * half + j,
                self._au + a_s * half + m,
                self._cd + a_d * half + m,
                self._ad + ed * half + j,
                down)

    @property
    def has_alternate_paths(self) -> bool:  # type: ignore[override]
        return self.k >= 4

    def route_candidates(self, src: int, dst: int) -> tuple[tuple[int, ...], ...]:
        """Re-hash over every aggregation switch (and, cross-pod, every
        core within its group), nominal ECMP choice first, the rest in
        deterministic rotation — all candidates have the nominal route's
        link count."""
        ps, es = self._locate(src)
        pd, ed = self._locate(dst)
        if es == ed:
            return (self.path(src, dst),)
        up, down = src, self.n_ports + dst
        half = self.k // 2
        j0 = _ecmp(src, dst, half)
        out = []
        if ps == pd:
            for a in range(half):
                j = (j0 + a) % half
                out.append((up, self._eu + es * half + j,
                            self._ad + ed * half + j, down))
            return tuple(out)
        m0 = _ecmp(src, dst, half, salt=1)
        for a in range(half):
            j = (j0 + a) % half
            a_s = ps * half + j
            a_d = pd * half + j
            for b in range(half):
                m = (m0 + b) % half
                out.append((up,
                            self._eu + es * half + j,
                            self._au + a_s * half + m,
                            self._cd + a_d * half + m,
                            self._ad + ed * half + j,
                            down))
        return tuple(out)

    def describe(self) -> str:
        return f"fat_tree(k={self.k}, {self.n_ports} hosts)"


# ------------------------------------------------------------ CLI builders
def big_switch(n_ports: int, egress: list[float] | None = None,
               ingress: list[float] | None = None) -> BigSwitch:
    return BigSwitch(n_ports, egress, ingress)


def leaf_spine(n_leaves: int, hosts_per_leaf: int,
               oversubscription: float = 1.0, n_spines: int = 2,
               host_cap: float = 1.0) -> LeafSpine:
    return LeafSpine(n_leaves, hosts_per_leaf, oversubscription,
                     n_spines, host_cap)


def fat_tree(k: int, host_cap: float = 1.0) -> FatTree:
    return FatTree(k, host_cap)


def make_topology(spec: str, n_ports: int) -> Topology:
    """Resolve a CLI topology spec against a required host count.

    Specs: ``big_switch``; ``leaf_spine_<R>to1`` (e.g. ``leaf_spine_3to1``,
    8 hosts per leaf, enough leaves to cover ``n_ports``); ``fat_tree``
    (smallest even k with k^3/4 >= n_ports).  The built topology may have
    spare hosts — jobs address ports ``[0, n_ports)`` as usual."""
    if spec == "big_switch":
        return BigSwitch(n_ports)
    m = re.fullmatch(r"leaf_spine_(\d+(?:\.\d+)?)to1", spec)
    if m:
        # ~8 hosts per leaf, but never so many that the *used* port range
        # [0, n_ports) fits on one leaf — that would silently degenerate
        # to a non-blocking fabric with no cross-leaf traffic at all.
        hpl = min(8, max(1, math.ceil(n_ports / 2)))
        n_leaves = max(2, math.ceil(n_ports / hpl))
        return LeafSpine(n_leaves, hpl, oversubscription=float(m.group(1)))
    if spec == "fat_tree":
        k = 2
        while k * k * k // 4 < n_ports:
            k += 2
        return FatTree(k)
    raise ValueError(
        f"unknown topology spec {spec!r}; expected big_switch, "
        f"leaf_spine_<R>to1, or fat_tree")


class Fabric:
    """A topology with mutable *current* link capacities.

    ``Fabric(n_ports=N)`` keeps the historical big-switch constructor
    (optionally with explicit ``egress``/``ingress`` port capacities);
    ``Fabric(topology=...)`` binds any :class:`Topology`.  ``degrade``/
    ``restore`` model stragglers by scaling a *port's* host links on any
    topology; ``degrade_link``/``restore_link`` target single links
    (e.g. one flaky leaf uplink).  Hard failures are a separate axis
    (DESIGN.md §15): ``fail_link``/``repair_link`` (and the host-level
    ``fail_host``/``repair_host``) force capacity to zero and mark the
    link in the ``down`` mask the simulator reroutes around — soft
    degrades never touch ``down``, and a repair comes back at *nominal*
    capacity (replaced hardware forgets pre-failure degradation)."""

    def __init__(self, n_ports: int | None = None,
                 egress: list[float] | None = None,
                 ingress: list[float] | None = None,
                 topology: Topology | None = None) -> None:
        if topology is None:
            if n_ports is None:
                raise ValueError("Fabric needs n_ports or a topology")
            topology = BigSwitch(n_ports, egress, ingress)
        else:
            if egress is not None or ingress is not None:
                raise ValueError(
                    "pass port capacities through the topology, not Fabric")
            if n_ports is not None and n_ports != topology.n_ports:
                raise ValueError(
                    f"n_ports={n_ports} != topology.n_ports="
                    f"{topology.n_ports}")
        self.topology = topology
        self.n_ports = topology.n_ports
        self.n_links = topology.n_links
        # Current link capacities; nominal kept for ``restore()``.
        self.cap = topology.cap.copy()
        self._base_cap = topology.cap.copy()
        # Hard-down links (capacity forced to 0, excluded from rerouted
        # paths).  Only ``fail_link``/``fail_host`` set it; only
        # ``repair_link``/``repair_host`` clear it.
        self.down = np.zeros(self.n_links, dtype=bool)

    # ------------------------------------------------- big-switch port views
    @property
    def egress(self) -> list[float]:
        """Per-port host up-link capacities (the big-switch egress
        vector; host up-links on any topology).

        A read-only *snapshot*: writing into the returned list does not
        touch the fabric (capacities mutate only through ``degrade`` /
        ``degrade_link`` / ``restore``, or the ``cap`` link vector)."""
        return self.cap[:self.n_ports].tolist()

    @property
    def ingress(self) -> list[float]:
        return self.cap[self.n_ports:2 * self.n_ports].tolist()

    # ------------------------------------------------------------ mutation
    def _check_port(self, port: int) -> None:
        if not isinstance(port, (int, np.integer)) \
                or not (0 <= port < self.n_ports):
            raise ValueError(
                f"port {port!r} outside fabric 0..{self.n_ports - 1}")

    def _check_link(self, link: int) -> None:
        if not isinstance(link, (int, np.integer)) \
                or not (0 <= link < self.n_links):
            raise ValueError(
                f"link {link!r} outside fabric 0..{self.n_links - 1}")

    def degrade(self, port: int, factor: float) -> None:
        """Scale a port's host-link capacities (straggler / partial NIC
        failure).

        ``factor`` must be positive: a zero or negative capacity would
        deadlock the fluid simulator (flows on the port can never finish)
        rather than model a failure — hard failures go through
        ``fail_link``/``fail_host``, whose events carry a scheduled
        repair.  Out-of-range ports raise ``ValueError`` — a typo'd
        perturbation must not silently bend a different port (or grow a
        list) instead.  Degrading an already-degraded port compounds
        multiplicatively (two 0.5x storms leave 0.25x); a single
        ``restore`` resets to nominal.  Degrading a port whose host link
        is hard-down raises: soft and hard fault windows on one target
        must not overlap (the stream lint enforces this)."""
        if not factor > 0:
            raise ValueError(f"degrade factor must be > 0, got {factor}")
        self._check_port(port)
        for link in self.topology.host_links(port):
            if self.down[link]:
                raise ValueError(
                    f"cannot degrade port {port}: link {link} is hard-down")
        for link in self.topology.host_links(port):
            self.cap[link] *= factor

    def restore(self, port: int | None = None) -> None:
        """Inverse of ``degrade``: reset a port's host links (or, with
        ``None``, every non-failed link) to nominal capacity — the
        straggler recovered.  Perturbation benchmarks pair a ``degrade``
        with a later ``restore`` to model transient slowdowns.
        Restoring a never-degraded port is a documented no-op (resets to
        nominal, which it already holds).  Restoring a port with a
        hard-down host link raises — repair goes through
        ``repair_link``/``repair_host``, never ``restore``."""
        if port is None:
            keep = self.down
            self.cap[~keep] = self._base_cap[~keep]
            return
        self._check_port(port)
        for link in self.topology.host_links(port):
            if self.down[link]:
                raise ValueError(
                    f"cannot restore port {port}: link {link} is hard-down "
                    f"(use repair_link/repair_host)")
        for link in self.topology.host_links(port):
            self.cap[link] = self._base_cap[link]

    def degrade_link(self, link: int, factor: float) -> None:
        """Scale one link (e.g. a single flaky leaf uplink).

        Double-degrade compounds multiplicatively; degrading a hard-down
        link raises (its capacity is pinned at 0 until repair)."""
        if not factor > 0:
            raise ValueError(f"degrade factor must be > 0, got {factor}")
        self._check_link(link)
        if self.down[link]:
            raise ValueError(f"cannot degrade link {link}: it is hard-down")
        self.cap[link] *= factor

    def restore_link(self, link: int) -> None:
        """Reset one link to nominal capacity.  Restoring a
        never-degraded link is a documented no-op; restoring a hard-down
        link raises (use ``repair_link``)."""
        self._check_link(link)
        if self.down[link]:
            raise ValueError(
                f"cannot restore link {link}: it is hard-down "
                f"(use repair_link)")
        self.cap[link] = self._base_cap[link]

    # --------------------------------------------------- hard failures
    def fail_link(self, link: int) -> None:
        """Hard-fail one link: capacity 0 and marked down until
        ``repair_link``.  Failing an already-down link raises — the
        fault-stream lint rejects overlapping failure windows, and a
        silent double-fail would make the later repair ambiguous."""
        self._check_link(link)
        if self.down[link]:
            raise ValueError(f"link {link} is already down")
        self.down[link] = True
        self.cap[link] = 0.0

    def repair_link(self, link: int) -> None:
        """Bring a failed link back at *nominal* capacity (a repair
        replaces the hardware, discarding any pre-failure degradation).
        Repairing a link that is not down raises."""
        self._check_link(link)
        if not self.down[link]:
            raise ValueError(f"link {link} is not down")
        self.down[link] = False
        self.cap[link] = self._base_cap[link]

    def fail_host(self, port: int) -> None:
        """Hard-fail both host links of a port (NIC/node failure)."""
        self._check_port(port)
        links = self.topology.host_links(port)
        for link in links:
            if self.down[link]:
                raise ValueError(
                    f"cannot fail host {port}: link {link} is already down")
        for link in links:
            self.down[link] = True
            self.cap[link] = 0.0

    def repair_host(self, port: int) -> None:
        """Inverse of ``fail_host``; raises unless every host link of
        the port is down (host repair must pair with host failure, not
        absorb an unrelated single-link failure)."""
        self._check_port(port)
        links = self.topology.host_links(port)
        for link in links:
            if not self.down[link]:
                raise ValueError(
                    f"cannot repair host {port}: link {link} is not down")
        for link in links:
            self.down[link] = False
            self.cap[link] = self._base_cap[link]

    def down_links(self) -> frozenset[int]:
        """The current hard-down link set (for ``route_avoiding``)."""
        return frozenset(int(i) for i in np.nonzero(self.down)[0])

    def residual(self) -> Residual:
        return Residual(cap=self.cap.tolist(), route=self.topology.path)


class Residual:
    """Mutable leftover link capacity during one rate-assignment round.

    ``Residual(cap=..., route=...)`` is the general form (``route`` maps
    a flow's (src, dst) to its link ids); ``Residual(eg=..., ing=...)``
    keeps the historical big-switch form — two port vectors, routed as
    the degenerate 2-link path."""

    def __init__(self, cap: list[float] | None = None, route=None, *,
                 eg: list[float] | None = None,
                 ing: list[float] | None = None) -> None:
        if eg is not None or ing is not None:
            if cap is not None or route is not None:
                raise ValueError("pass either cap/route or eg/ing, not both")
            if eg is None or ing is None or len(eg) != len(ing):
                raise ValueError("eg and ing must both be given, same length")
            n = len(eg)
            self.cap = list(eg) + list(ing)

            def route2(s: int, d: int) -> tuple[int, int]:
                return (s, n + d)

            self._route = route2
        else:
            if cap is None or route is None:
                raise ValueError("general Residual needs cap and route")
            self.cap = list(cap)
            self._route = route

    def links(self, flow: Flow) -> tuple[int, ...]:
        return self._route(flow.src, flow.dst)

    def headroom(self, flow: Flow) -> float:
        return max(0.0, min(self.cap[link] for link in self.links(flow)))

    def take(self, flow: Flow, rate: float) -> None:
        for link in self.links(flow):
            v = self.cap[link] - rate
            # numeric hygiene: clamp tiny negatives
            if -1e-6 < v < 0:
                v = 0.0
            if v < 0:
                raise AssertionError("over-allocated link capacity")
            self.cap[link] = v


def backfill(flows: list[Flow], rates: dict[int, float],
             residual: Residual) -> None:
    """Work-conserving backfill: hand leftover link bandwidth to flows in
    priority order.  Both Varys and MSA are work-conserving; reproducing
    the paper's Figure-1 arithmetic requires it (see DESIGN.md §8.4).

    Flows whose headroom is already below ``EPS`` are skipped *before*
    ``take`` — granting sub-EPS slivers would repeatedly shave the
    residual by amounts the clamp then rounds, accumulating drift over
    long runs without ever advancing a flow."""
    for f in flows:
        if f.done:
            continue
        extra = residual.headroom(f)
        if extra > EPS:
            residual.take(f, extra)
            rates[f.id] = rates.get(f.id, 0.0) + extra
