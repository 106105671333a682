"""``repro_torch.core.simtorch`` -- the batched lockstep fifo engine in torch.

The port of ``repro.core.simjax`` (the fifo MADD + backfill engine; DESIGN.md
§17 states its contract).  B scenario instances ("lanes") advance in
lockstep as stacked tensors: one step serves lane 0's event 312 and lane
19's event 87 at once.  Lanes are padded to the batch maxima (jobs, DAG
nodes, flows, path length, links, routes) and finished lanes are masked
no-ops, so a batch needs ``max(per-lane events)`` steps.

The reference's structure is kept, name for name: every segment reduction
(flow->metaflow, flow->job, edge->node, (job, link) demand) is a
static-permutation prefix sum (``_seg_sum``: cumsum + two gathers, no
scatter); the MADD walk is a loop over the job slots whose body is
elementwise on ``[B, links]``; the backfill runs in priority *waves* (a
flow executes once no pending higher-priority flow shares one of its
links, which applies the per-link subtractions in the sequential sweep's
order).  The reference's ``lax.while_loop``s (the activation cascade, the
backfill waves) are Python loops here: each test of their condition is a
host read of one flag, and ``sync_count()`` counts them, with the
done/deadlock read once per ``steps_per_sync`` steps and the final read of
the results.

Everything is float64 with int64 indices, on the device the caller names:
``run_fifo_batch`` runs on the card unless it is given ``device="cpu"``,
and raises when asked for a card that is not there.  The numpy simulator
of the JAX package stays the oracle: per-lane JCT/CCT agree with it within
float tolerance, not bit for bit (``tests/test_torch_simtorch.py``).
Scope: fifo policy, fault-free, uniform ``machine_speed``.

Worked example -- two seeds of a one-job scenario as one batch::

    >>> from repro_torch.core import Fabric, JobDAG
    >>> def lane(size):
    ...     job = JobDAG("j0")
    ...     job.add_metaflow("m0", [(0, 1, size)])
    ...     return pack_instance(Fabric(n_ports=2), [job])
    >>> res = run_fifo_batch([lane(10.0), lane(30.0)], device="cpu")
    >>> [r.jct["j0"] for r in res]      # unit caps: size / 1.0 seconds
    [10.0, 30.0]
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F_

from repro_torch.core.metaflow import EPS

__all__ = [
    "LaneResult",
    "PackedInstance",
    "pack_instance",
    "run_fifo_batch",
    "sync_count",
]

#: Priority-key sentinel larger than any real backfill key.
_BIG = 2 ** 62


# --------------------------------------------------------------------- pack
@dataclass(frozen=True)
class PackedInstance:
    """One scenario instance flattened to arrays (lane-local sizes).

    Node space: per job (sorted by ``(arrival, name)``, the simulator's
    admission and fifo priority order), compute tasks then metaflows in
    DAG insertion order.  Flows are packed metaflow-contiguously, so
    ``flow_node`` and the derived ``flow_job`` are sorted -- the invariant
    behind the prefix-sum reductions.  The arrays, their dtypes and their
    order are the reference's, field for field.
    """

    job_names: tuple[str, ...]          # sorted by (arrival, name)
    arrival: np.ndarray                 # [J] f8
    node_job: np.ndarray                # [N] i4  owning job index
    node_is_mf: np.ndarray              # [N] bool
    node_load: np.ndarray               # [N] f8  compute load (0 for mfs)
    node_pend: np.ndarray               # [N] i4  unmet dependency count
    edge_parent: np.ndarray             # [E] i4
    edge_child: np.ndarray              # [E] i4 (sorted)
    flow_node: np.ndarray               # [F] i4  owning metaflow node
    flow_size: np.ndarray               # [F] f8
    flow_links: np.ndarray              # [F, L] i4, short paths padded
    flow_pathid: np.ndarray             # [F] i4  equal iff same (src, dst)
    link_cap: np.ndarray                # [n_links] f8
    n_links: int
    n_routes: int
    machine_speed: float


def pack_instance(fabric, jobs: Sequence, machine_speed: float = 1.0
                  ) -> PackedInstance:
    """Flatten ``(fabric, jobs)`` into the array form the engine consumes.

    ``fabric`` needs ``topology.path``, ``n_links`` and ``cap``; each job
    needs ``name``, ``arrival``, ``tasks``, ``metaflows``, ``node`` and
    ``validate``.  So the port's scenario objects and the JAX package's
    both pack.  A node is a metaflow iff its name is in ``job.metaflows``.
    Job order, node order, flow order, routes and the per-``(src, dst)``
    ``pathid`` keys all match the numpy core."""
    for j in jobs:
        j.validate()
    names = [j.name for j in jobs]
    if len(set(names)) != len(names):
        raise ValueError("job names must be unique")
    jobs = sorted(jobs, key=lambda j: (j.arrival, j.name))
    topo = fabric.topology

    node_id: dict[tuple[int, str], int] = {}
    node_job: list[int] = []
    node_is_mf: list[bool] = []
    node_load: list[float] = []
    node_pend: list[int] = []
    edge_parent: list[int] = []
    edge_child: list[int] = []
    flow_node: list[int] = []
    flow_size: list[float] = []
    flow_paths: list[tuple[int, ...]] = []
    flow_pathid: list[int] = []
    route_ids: dict[tuple[int, int], int] = {}

    for ji, job in enumerate(jobs):
        for name in list(job.tasks) + list(job.metaflows):
            node_id[(ji, name)] = len(node_job)
            node = job.node(name)
            node_job.append(ji)
            is_mf = name in job.metaflows
            node_is_mf.append(is_mf)
            node_load.append(0.0 if is_mf else float(node.load))
            node_pend.append(len(node.deps))
        for name in list(job.tasks) + list(job.metaflows):
            nid = node_id[(ji, name)]
            for dep in job.node(name).deps:
                edge_parent.append(node_id[(ji, dep)])
                edge_child.append(nid)
        for mf in job.metaflows.values():
            nid = node_id[(ji, mf.name)]
            for f in mf.flows:
                flow_node.append(nid)
                flow_size.append(float(f.size))
                flow_paths.append(tuple(topo.path(f.src, f.dst)))
                flow_pathid.append(
                    route_ids.setdefault((f.src, f.dst), len(route_ids)))

    n_links = fabric.n_links
    max_len = max((len(p) for p in flow_paths), default=1)
    links = np.full((len(flow_paths), max_len), n_links, dtype=np.int32)
    for i, p in enumerate(flow_paths):
        links[i, :len(p)] = p

    return PackedInstance(
        job_names=tuple(j.name for j in jobs),
        arrival=np.array([j.arrival for j in jobs], dtype=np.float64),
        node_job=np.asarray(node_job, dtype=np.int32),
        node_is_mf=np.asarray(node_is_mf, dtype=bool),
        node_load=np.asarray(node_load, dtype=np.float64),
        node_pend=np.asarray(node_pend, dtype=np.int32),
        edge_parent=np.asarray(edge_parent, dtype=np.int32),
        edge_child=np.asarray(edge_child, dtype=np.int32),
        flow_node=np.asarray(flow_node, dtype=np.int32),
        flow_size=np.asarray(flow_size, dtype=np.float64),
        flow_links=links,
        flow_pathid=np.asarray(flow_pathid, dtype=np.int32),
        link_cap=np.asarray(fabric.cap, dtype=np.float64).copy(),
        n_links=n_links,
        n_routes=len(route_ids),
        machine_speed=float(machine_speed),
    )


class _Batch(NamedTuple):
    """Stacked lanes, padded to batch maxima, plus the static index
    machinery for scatter-free reductions.  Dummy slots: job ``J``
    (arrival=inf, invalid), node ``N`` (pend huge, never activates),
    link ``K`` (cap=inf, absorbs padded path positions), flat position
    ``F*L`` (gather target resolving to neutral elements).  Index
    tensors are int64, values float64."""

    arrival: torch.Tensor       # [B, J+1] f8 (pad inf)
    job_valid: torch.Tensor     # [B, J+1] bool
    node_job: torch.Tensor      # [B, N+1] (pad J)
    node_is_mf: torch.Tensor    # [B, N+1] bool
    node_load: torch.Tensor     # [B, N+1] f8
    node_pend0: torch.Tensor    # [B, N+1]
    node_valid: torch.Tensor    # [B, N+1] bool
    edge_parent: torch.Tensor   # [B, E] (pad N)
    flow_node: torch.Tensor     # [B, F] (pad N, sorted)
    flow_job: torch.Tensor      # [B, F] (pad J, sorted)
    flow_size: torch.Tensor     # [B, F] f8 (pad 0)
    flow_links: torch.Tensor    # [B, F, L] (pad K)
    flow_pos: torch.Tensor      # [B, F] position within its metaflow
    link_cap: torch.Tensor      # [B, K+1] f8 (pad/dummy inf)
    speed: torch.Tensor         # [B] f8
    # prefix-sum segment bounds (each [B, D+1] for D segments)
    nf_bounds: torch.Tensor     # flow_node   -> nodes   [B, N+2]
    ne_bounds: torch.Tensor     # edge_child  -> nodes   [B, N+2]
    jn_bounds: torch.Tensor     # node_job    -> jobs    [B, J+2]
    jf_bounds: torch.Tensor     # flow_job    -> jobs    [B, J+2]
    # (job, link) demand segments over the flat (flow, leg) space
    jl_perm: torch.Tensor       # [B, F*L]  sort by job*(K+1)+link
    jl_bounds: torch.Tensor     # [B, (J+1)*(K+1)+1]
    # per-link flat (flow, leg) positions (pad F*L), real links only,
    # flattened from [B, K+1, ML]
    pairs_flat: torch.Tensor    # [B, (K+1)*ML]
    dummy_link: torch.Tensor    # [K+1] bool, true at link K only


class _State(NamedTuple):
    t: torch.Tensor             # [B] f8
    admitted: torch.Tensor      # [B, J+1] bool
    node_state: torch.Tensor    # [B, N+1]  0 idle / 1 active / 2 done
    pend: torch.Tensor          # [B, N+1]
    task_rem: torch.Tensor      # [B, N+1] f8
    act_seq: torch.Tensor       # [B, N+1]  per-lane activation sequence
    act_ctr: torch.Tensor       # [B]
    flow_rem: torch.Tensor      # [B, F] f8
    flow_done: torch.Tensor     # [B, F] bool
    job_done: torch.Tensor      # [B, J+1] bool
    job_finish: torch.Tensor    # [B, J+1] f8
    last_flow: torch.Tensor     # [B, J+1] f8
    done: torch.Tensor          # [B] bool
    deadlock: torch.Tensor      # [B] bool
    events: torch.Tensor        # [B]


def _bounds(ids: np.ndarray, n_segs: int) -> np.ndarray:
    """Segment bounds of a *sorted* id array: segment ``d`` occupies
    ``[out[d], out[d+1])``."""
    return np.searchsorted(ids, np.arange(n_segs + 1)).astype(np.int32)


def _pad_lists(lists: list[list[int]], width: int, fill: int) -> np.ndarray:
    out = np.full((len(lists), width), fill, dtype=np.int32)
    for i, row in enumerate(lists):
        out[i, :len(row)] = row
    return out


def _seg_sum(vals: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    """Sum ``vals`` ([B, M]; a bool mask sums as int64) over the static
    segments described by ``bounds`` ([B, D+1]) -- cumsum + two gathers,
    no scatter."""
    cs = F_.pad(torch.cumsum(vals, dim=1), (1, 0))
    return cs.gather(1, bounds[:, 1:]) - cs.gather(1, bounds[:, :-1])


def _pack_batch(lanes: Sequence[PackedInstance], device: torch.device
                ) -> _Batch:
    """Pad and stack the lanes on the host (numpy), then move every array
    to ``device`` in one go."""
    B = len(lanes)
    J = max(p.arrival.size for p in lanes)
    N = max(p.node_job.size for p in lanes)
    E = max(p.edge_parent.size for p in lanes)
    F = max(p.flow_node.size for p in lanes)
    L = max(p.flow_links.shape[1] for p in lanes)
    K = max(p.n_links for p in lanes)

    arrival = np.full((B, J + 1), np.inf)
    job_valid = np.zeros((B, J + 1), dtype=bool)
    node_job = np.full((B, N + 1), J, dtype=np.int64)
    node_is_mf = np.zeros((B, N + 1), dtype=bool)
    node_load = np.zeros((B, N + 1))
    node_pend0 = np.full((B, N + 1), 2 ** 30, dtype=np.int64)
    node_valid = np.zeros((B, N + 1), dtype=bool)
    edge_parent = np.full((B, E), N, dtype=np.int64)
    edge_child = np.full((B, E), N, dtype=np.int64)
    flow_node = np.full((B, F), N, dtype=np.int64)
    flow_job = np.full((B, F), J, dtype=np.int64)
    flow_size = np.zeros((B, F))
    flow_links = np.full((B, F, L), K, dtype=np.int64)
    flow_pos = np.zeros((B, F), dtype=np.int64)
    link_cap = np.full((B, K + 1), np.inf)
    speed = np.empty(B)

    for b, p in enumerate(lanes):
        j, n, e, f = (p.arrival.size, p.node_job.size, p.edge_parent.size,
                      p.flow_node.size)
        arrival[b, :j] = p.arrival
        job_valid[b, :j] = True
        node_job[b, :n] = p.node_job
        node_is_mf[b, :n] = p.node_is_mf
        node_load[b, :n] = p.node_load
        node_pend0[b, :n] = p.node_pend
        node_valid[b, :n] = True
        edge_parent[b, :e] = p.edge_parent
        edge_child[b, :e] = p.edge_child
        flow_node[b, :f] = p.flow_node
        flow_job[b, :f] = p.node_job[p.flow_node]
        flow_size[b, :f] = p.flow_size
        flow_links[b, :f, :p.flow_links.shape[1]] = np.where(
            p.flow_links == p.n_links, K, p.flow_links)
        # Position within the owning metaflow: flows are packed
        # metaflow-contiguously, so each group is a run of equal
        # flow_node values.
        if f:
            starts = np.flatnonzero(np.diff(p.flow_node, prepend=-1) != 0)
            pos = np.arange(f, dtype=np.int64)
            flow_pos[b, :f] = pos - np.repeat(
                pos[starts], np.diff(np.append(starts, f)))
        link_cap[b, :p.n_links] = p.link_cap
        speed[b] = p.machine_speed
    # The reference's batch also carries flow_pathid, which its fifo step
    # never reads; the port's leaves it out.

    # --- static reduction machinery (all id arrays above are sorted)
    K1 = K + 1
    nf_bounds = np.stack([_bounds(flow_node[b], N + 1) for b in range(B)])
    ne_bounds = np.stack([_bounds(edge_child[b], N + 1) for b in range(B)])
    jn_bounds = np.stack([_bounds(node_job[b], J + 1) for b in range(B)])
    jf_bounds = np.stack([_bounds(flow_job[b], J + 1) for b in range(B)])

    links_flat = flow_links.reshape(B, F * L)
    jl_key = np.repeat(flow_job, L, axis=1) * K1 + links_flat
    jl_perm = np.argsort(jl_key, axis=1, kind="stable")
    jl_bounds = np.stack([
        _bounds(np.take_along_axis(jl_key, jl_perm, axis=1)[b],
                (J + 1) * K1)
        for b in range(B)])

    link_lists: list[list[int]] = []
    for b, p in enumerate(lanes):
        per_link: list[list[int]] = [[] for _ in range(K1)]
        flat = links_flat[b]
        for pos_i in range(p.flow_node.size * L):
            lk = int(flat[pos_i])
            if lk < K:                       # real links only
                per_link[lk].append(pos_i)
        link_lists.extend(per_link)
    ml = max((len(x) for x in link_lists), default=0) or 1
    pairs_flat = _pad_lists(link_lists, ml, F * L).reshape(B, K1 * ml)
    dummy_link = np.arange(K1) == K1 - 1

    def dev(a: np.ndarray) -> torch.Tensor:
        if a.dtype.kind in "iu":
            a = a.astype(np.int64)
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return _Batch(*map(dev, (
        arrival, job_valid, node_job, node_is_mf, node_load, node_pend0,
        node_valid, edge_parent, flow_node, flow_job, flow_size,
        flow_links, flow_pos, link_cap, speed,
        nf_bounds, ne_bounds, jn_bounds, jf_bounds,
        jl_perm, jl_bounds, pairs_flat, dummy_link)))


def _init_state(pk: _Batch) -> _State:
    B, J1 = pk.arrival.shape
    N1 = pk.node_job.shape[1]
    dev = pk.arrival.device
    f8 = dict(dtype=torch.float64, device=dev)
    i8 = dict(dtype=torch.int64, device=dev)
    b1 = dict(dtype=torch.bool, device=dev)
    return _State(
        t=torch.zeros(B, **f8),
        admitted=torch.zeros((B, J1), **b1),
        node_state=torch.zeros((B, N1), **i8),
        pend=pk.node_pend0,
        task_rem=pk.node_load,
        act_seq=torch.full((B, N1), _BIG, **i8),
        act_ctr=torch.zeros(B, **i8),
        flow_rem=pk.flow_size,
        # Zero-size flows are born finished (the numpy core presets them
        # done), so they never stamp last_flow.
        flow_done=pk.flow_size <= EPS,
        job_done=torch.zeros((B, J1), **b1),
        job_finish=torch.zeros((B, J1), **f8),
        last_flow=torch.where(torch.isfinite(pk.arrival), pk.arrival, 0.0),
        done=torch.zeros(B, **b1),
        deadlock=torch.zeros(B, **b1),
        events=torch.zeros(B, **i8),
    )


# ---------------------------------------------------------------- host reads
_HOST_READS = 0


def _read(flag: torch.Tensor) -> bool:
    """The one way a loop condition leaves the device: a counted host read
    of a one-element flag (a synchronisation on the card)."""
    return bool(_fetch(flag)[0])


def _fetch(*tensors: torch.Tensor) -> list[np.ndarray]:
    """Copy ``tensors`` to the host as one counted read."""
    global _HOST_READS
    _HOST_READS += 1
    return [x.cpu().numpy() for x in tensors]


def sync_count() -> int:
    """Host reads made by ``run_fifo_batch`` in this process so far: one
    per activation-cascade iteration and per backfill-wave test, one per
    ``steps_per_sync`` window, and one for the results.  A run's count is
    the difference across it."""
    return _HOST_READS


# ------------------------------------------------------------------- settle
def _settle(pk: _Batch, s: _State) -> _State:
    """Commit everything instantaneous at the current lane times:
    admissions, flow/metaflow/task completions, the DAG activation
    cascade (breadth-first waves to a fixpoint), job retirement, and
    lane-done flags.  Idempotent -- running it twice changes nothing."""
    admitted = s.admitted | (pk.job_valid & (pk.arrival <= s.t[:, None] + EPS))

    # Newly drained flows stamp the owning job's last-flow time (the
    # numpy core does this in its completion commit).
    new_fd = ~s.flow_done & (s.flow_rem <= EPS)
    flow_done = s.flow_done | new_fd
    hit = _seg_sum(new_fd, pk.jf_bounds) > 0
    last_flow = torch.where(hit, s.t[:, None], s.last_flow)
    # Live-flow counts per metaflow are fixed for the whole cascade
    # (flow_rem only changes in _kick), and so is what finishes a node.
    flows_left = _seg_sum(~flow_done, pk.nf_bounds)
    finishes = torch.where(pk.node_is_mf, flows_left == 0, s.task_rem <= EPS)
    adm_node = admitted.gather(1, pk.node_job)

    node_state, pend, act_seq, act_ctr = (s.node_state, s.pend, s.act_seq,
                                          s.act_ctr)
    while True:
        new_done = (node_state == 1) & finishes
        node_state = torch.where(new_done, 2, node_state)
        # finish_metaflow stamps last_flow even for zero-flow metaflows.
        mf_hit = _seg_sum(new_done & pk.node_is_mf, pk.jn_bounds) > 0
        last_flow = torch.where(mf_hit, s.t[:, None], last_flow)
        pend = pend - _seg_sum(new_done.gather(1, pk.edge_parent),
                               pk.ne_bounds)
        act = (node_state == 0) & (pend <= 0) & pk.node_valid & adm_node
        node_state = torch.where(act, 1, node_state)
        rank = torch.cumsum(act, dim=1)
        act_seq = torch.where(act, act_ctr[:, None] + rank - 1, act_seq)
        act_ctr = act_ctr + rank[:, -1]
        if not _read((new_done | act).any()):
            break

    unfin = _seg_sum((node_state != 2) & pk.node_valid, pk.jn_bounds)
    new_jd = admitted & (unfin == 0) & ~s.job_done
    job_done = s.job_done | new_jd
    job_finish = torch.where(new_jd, s.t[:, None], s.job_finish)
    done = (job_done | ~pk.job_valid).all(dim=1)

    return s._replace(admitted=admitted, node_state=node_state, pend=pend,
                      act_seq=act_seq, act_ctr=act_ctr, flow_done=flow_done,
                      job_done=job_done, job_finish=job_finish,
                      last_flow=last_flow, done=done)


# --------------------------------------------------------------------- kick
def _kick(pk: _Batch, s: _State) -> _State:
    """One fifo decision + fluid advance per lane: MADD each job's
    coflow (all its active metaflows) in job-priority order on the
    residual link capacities, work-conserving backfill over the live
    flows in priority waves, then advance every lane to its own next
    event time.  Done lanes get dt=0 and stay bit-frozen; lanes with no
    possible progress raise the deadlock flag (checked on the host)."""
    B, F = s.flow_rem.shape
    J1 = pk.arrival.shape[1]
    N1 = pk.node_job.shape[1]
    K1 = pk.link_cap.shape[1]
    L = pk.flow_links.shape[2]
    links_flat = pk.flow_links.reshape(B, F * L)

    live = (s.node_state.gather(1, pk.flow_node) == 1) & (s.flow_rem > EPS)

    # --- MADD walk: all (job, link) demands in one prefix pass, then a
    # loop over the job slots whose body is elementwise on [B, links].
    w = torch.where(live, s.flow_rem, 0.0)
    w_fl = w.repeat_interleave(L, dim=1).gather(1, pk.jl_perm)
    # A cumsum may reassociate (XLA's does, and so does torch's on the
    # card), so an *empty* segment's prefix difference can leave
    # +-ulp-of-prefix residue instead of an exact 0.0 -- and a phantom
    # "used" link on an exhausted residual would wrongly refuse the whole
    # MADD.  An integer count of live contributors is exact; it gates
    # which segments carry demand.
    cnt = _seg_sum(w_fl > 0.0, pk.jl_bounds)
    dem_all = torch.where(cnt > 0, _seg_sum(w_fl, pk.jl_bounds),
                          0.0).reshape(B, J1, K1)

    res = pk.link_cap
    oks, gammas = [], []
    for j in range(J1 - 1):
        dem = dem_all[:, j]
        used = dem > 0.0
        blocked = (used & (res <= EPS)).any(dim=1)
        gamma = torch.where(used & (res > EPS), dem / res, 0.0).amax(dim=1)
        ok = ~blocked & (gamma > EPS)
        safe = torch.where(ok, gamma, 1.0)
        res = torch.where(ok[:, None],
                          (res - dem / safe[:, None]).clamp_min(0.0), res)
        oks.append(ok)
        gammas.append(safe)
    ok_j = torch.stack(oks + [torch.zeros_like(s.done)], dim=1)
    gamma_j = torch.stack(gammas + [torch.ones_like(s.t)], dim=1)
    rates = torch.where(live & ok_j.gather(1, pk.flow_job),
                        s.flow_rem / gamma_j.gather(1, pk.flow_job), 0.0)

    # --- backfill: priority key = (job, metaflow activation order, flow
    # position) -- the numpy walk's concatenation order.  Flows execute
    # in priority *waves*: a flow runs once no pending higher-priority
    # flow shares any of its links, which applies the per-link
    # subtractions in exactly the sequential sweep's order.  A grant
    # zeroes the path's smallest residual, so same-route followers are
    # retired by the capacity filter below, exactly.
    seq = s.act_seq.gather(1, pk.flow_node).clamp_max(N1 + 1)
    key = (pk.flow_job * (N1 + 2) + seq) * (F + 1) + pk.flow_pos
    keyed = torch.where(live, key, _BIG)
    big_col = torch.full((B, 1), _BIG, dtype=torch.int64, device=key.device)
    zero_col = torch.zeros((B, 1), dtype=torch.float64, device=key.device)

    pending = live
    while _read(pending.any()):
        # Residuals only shrink during the sweep, so a flow whose path
        # minimum is already <= EPS can never receive a grant at its
        # turn -- retiring it now is exact and collapses the priority
        # chains to the few flows with actual capacity.
        h_row = res.gather(1, links_flat).reshape(B, F, L).amin(dim=2)
        pending = pending & (h_row > EPS)
        key_p = torch.where(pending, keyed, _BIG)
        key_fl = torch.cat([key_p.repeat_interleave(L, dim=1), big_col], 1)
        best = key_fl.gather(1, pk.pairs_flat).reshape(B, K1, -1).amin(dim=2)
        # A flow is at its turn iff it is the best (minimum-key) pending
        # flow on EVERY link it crosses.  best <= key on each of its real
        # links (its own key participates in those minima), so the test
        # is min-over-links == key; the dummy link is pinned to the
        # sentinel so padded path positions cannot veto a turn.
        best = torch.where(pk.dummy_link, _BIG, best)
        at_turn = pending & (best.gather(1, links_flat).reshape(B, F, L)
                             .amin(dim=2) == keyed)
        h = torch.where(at_turn, h_row, 0.0)
        rates = rates + h
        h_fl = torch.cat([h.repeat_interleave(L, dim=1), zero_col], 1)
        sub = h_fl.gather(1, pk.pairs_flat).reshape(B, K1, -1).sum(dim=2)
        res = res - torch.where(pk.dummy_link, 0.0, sub)
        pending = pending & ~at_turn

    # --- event horizon
    inf = torch.inf
    flowing = (rates > EPS) & (s.flow_rem > EPS)
    dt = torch.where(flowing, s.flow_rem / torch.where(flowing, rates, 1.0),
                     inf).amin(dim=1)
    task_running = (s.node_state == 1) & ~pk.node_is_mf & pk.node_valid
    dt = torch.minimum(dt, torch.where(task_running, s.task_rem, inf)
                       .amin(dim=1) / pk.speed)
    waiting = pk.job_valid & ~s.admitted
    dt = torch.minimum(dt, torch.where(waiting, pk.arrival, inf)
                       .amin(dim=1) - s.t)
    dead = ~s.done & torch.isinf(dt)
    dt = torch.where(s.done | dead, 0.0, dt.clamp_min(0.0))

    # --- fluid advance
    flow_rem = torch.where(
        flowing, (s.flow_rem - rates * dt[:, None]).clamp_min(0.0),
        s.flow_rem)
    task_rem = torch.where(
        task_running,
        (s.task_rem - pk.speed[:, None] * dt[:, None]).clamp_min(0.0),
        s.task_rem)
    return s._replace(t=s.t + dt, flow_rem=flow_rem, task_rem=task_rem,
                      deadlock=s.deadlock | dead,
                      events=s.events + (~s.done).long())


def _step(pk: _Batch, s: _State) -> _State:
    """One lockstep event for every unfinished lane: advance each lane
    to its own next event time, then settle the consequences."""
    return _settle(pk, _kick(pk, s))


def _multi_step(pk: _Batch, s: _State, n: int) -> _State:
    """``n`` lockstep events between two reads of the done/deadlock
    flags."""
    for _ in range(n):
        s = _step(pk, s)
    return s


# ---------------------------------------------------------------------- run
@dataclass(frozen=True)
class LaneResult:
    """Per-lane outcome, keyed like ``SimResult``: per-job JCT/CCT by
    job name, plus the lane makespan and lockstep event count."""

    jct: dict[str, float]
    cct: dict[str, float]
    makespan: float
    events: int


def run_fifo_batch(lanes: Sequence[PackedInstance], *,
                   steps_per_sync: int = 16,
                   max_events: int = 5_000_000,
                   device: str | torch.device = "cuda") -> list[LaneResult]:
    """Advance every lane to completion under the fifo policy on
    ``device``; returns per-lane results in input order.
    ``steps_per_sync`` bounds how many lockstep events run between two
    reads of the done/deadlock flags -- finished lanes are masked no-ops,
    so overshooting a fast lane's final event is harmless.  Raises on
    deadlock (mirroring the numpy core), on ``max_events`` (livelock
    guard), and when ``device`` is a card this machine does not have."""
    if not lanes:
        return []
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "run_fifo_batch: no CUDA device here; pass device='cpu' to run "
            "the engine on the CPU")
    pk = _pack_batch(lanes, device)
    s = _settle(pk, _init_state(pk))
    steps = 0
    while not _read((s.done | s.deadlock).all()):
        if steps > max_events:
            raise RuntimeError(
                "batched simulator exceeded max_events — livelock?")
        s = _multi_step(pk, s, steps_per_sync)
        steps += steps_per_sync

    t, jf, lf, ev, dead = _fetch(s.t, s.job_finish, s.last_flow, s.events,
                                 s.deadlock)
    if dead.any():
        bad = [i for i, d in enumerate(dead.tolist()) if d]
        raise RuntimeError(f"deadlock: no progress possible in lanes {bad}")
    return [
        LaneResult(
            jct={n: float(jf[b, i] - p.arrival[i])
                 for i, n in enumerate(p.job_names)},
            cct={n: float(lf[b, i] - p.arrival[i])
                 for i, n in enumerate(p.job_names)},
            makespan=float(t[b]),
            events=int(ev[b]),
        )
        for b, p in enumerate(lanes)
    ]
