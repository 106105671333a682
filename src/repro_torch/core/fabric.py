"""Topology-general fabric: capacitated links + deterministic routing.

The port's copy of ``repro.core.fabric``, cut to what a scenario and
``simtorch.pack_instance`` need: the topologies with their routes, the
spec resolver ``make_topology``, and ``Fabric`` as a topology with its link
capacities.  The reference's mutable-capacity machinery (degrade, restore,
hard failures, ``Residual``) and its fault rerouting are left out: the
fifo engine runs fault-free on nominal capacities.

Link-id convention shared by every topology:

  * links ``[0, P)``   -- host *up* (egress) links, one per port;
  * links ``[P, 2P)``  -- host *down* (ingress) links, one per port;
  * links ``[2P, L)``  -- internal fabric links (leaf uplinks, core).

``path(src, dst)`` always starts with ``up(src)`` and ends with
``down(dst)`` and is pure: ECMP hashing is a deterministic mix of the
pair, so a flow's route is resolved once, when the lane is packed.
"""

from __future__ import annotations

import math
import re

import numpy as np


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
    ``path`` memoizes routes per (src, dst) pair (routing is pure)."""

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


class BigSwitch(Topology):
    """The paper's non-blocking fabric: every flow crosses exactly its
    source egress link and destination ingress link."""

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
    ``hosts_per_leaf * host_cap / oversubscription``.  Intra-leaf flows
    use only their host links; cross-leaf flows add the ECMP-hashed
    spine's leaf-up and leaf-down links."""

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


class FatTree(Topology):
    """Classic 3-tier k-ary fat-tree (k even): k pods of k/2 edge and
    k/2 aggregation switches, (k/2)^2 cores, k^3/4 hosts.  Every
    switch-to-switch cable is one capacitated link per direction; ECMP
    hashes pick the aggregation switch and (for cross-pod flows) the
    core within its group -- core group j attaches to aggregation switch
    j of every pod, which pins the down path."""

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


def make_topology(spec: str, n_ports: int) -> Topology:
    """Resolve a topology spec against a required host count.

    Specs: ``big_switch``; ``leaf_spine_<R>to1`` (e.g. ``leaf_spine_3to1``,
    8 hosts per leaf, enough leaves to cover ``n_ports``); ``fat_tree``
    (smallest even k with k^3/4 >= n_ports).  The built topology may have
    spare hosts -- jobs address ports ``[0, n_ports)`` as usual."""
    if spec == "big_switch":
        return BigSwitch(n_ports)
    m = re.fullmatch(r"leaf_spine_(\d+(?:\.\d+)?)to1", spec)
    if m:
        # ~8 hosts per leaf, but never so many that the *used* port range
        # [0, n_ports) fits on one leaf -- that would silently degenerate
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
    """A topology with its link capacities.

    ``Fabric(n_ports=N)`` builds the big switch (optionally with explicit
    ``egress``/``ingress`` port capacities); ``Fabric(topology=...)`` binds
    any :class:`Topology`."""

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
        self.n_links = topology.n_links
        self.cap = topology.cap.copy()
