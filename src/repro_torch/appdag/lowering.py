"""Collective lowering: logical collectives -> per-port flow rounds.

The port's copy of ``repro.appdag.lowering`` (plain Python, no JAX).

A parallelism plan speaks in *logical* collectives (all-reduce this
gradient bucket over the DP group, all-to-all these expert tokens over the
EP group); the fabric simulator speaks in point-to-point ``Flow``s.  This
module is the bridge: it lowers one logical collective into a
dependency-ordered sequence of *rounds*, where every round is a set of
``(src_port, dst_port, size)`` flows that may run concurrently and round
``t+1`` may only start once round ``t`` delivered (the algorithm's data
dependence).  Each round becomes one ``Metaflow`` in the job DAG — the
flows of a round are consumed together by the next communication step (or
by the downstream compute, for the last round).

Byte accounting is exact and algorithm-independent for the bandwidth-
optimal algorithms:

  reduce_scatter / all_gather of a ``size`` buffer over P ranks moves
      ``size * (P-1)`` wire bytes total (``size * (P-1)/P`` per rank),
  all_reduce = reduce_scatter + all_gather = ``2 * size * (P-1)``,
  all_to_all of ``size`` per-rank payload moves ``size * (P-1)``,
  p2p moves ``size``,

whether lowered as ``ring`` (P-1 rounds of P flows each), as
``halving_doubling`` (log2 P recursive-distance exchanges; P must be a
power of two), or ``direct`` (one round of P*(P-1) chunk flows).  No
algorithm ever emits a self-flow (src == dst).

Sizes are unit-agnostic: pass bytes and divide by link bandwidth at the
call site (``plans.py`` passes seconds-at-unit-capacity).
"""

from __future__ import annotations

from dataclasses import dataclass

COLLECTIVES = ("all_reduce", "reduce_scatter", "all_gather", "all_to_all",
               "p2p")
ALGORITHMS = ("ring", "halving_doubling", "direct")

# One flow: (src_port, dst_port, size).  One round: flows that may run
# concurrently.  Rounds are dependency-ordered.
FlowSpec = tuple[int, int, float]
Round = tuple[FlowSpec, ...]


@dataclass(frozen=True)
class LoweredCollective:
    """A logical collective lowered onto fabric ports."""

    kind: str
    algorithm: str
    ranks: tuple[int, ...]          # fabric port of each participant
    size: float                     # logical buffer size (per participant)
    rounds: tuple[Round, ...]


def _check(kind: str, ranks: tuple[int, ...], size: float,
           algorithm: str) -> None:
    if kind not in COLLECTIVES:
        raise ValueError(f"unknown collective {kind!r}; known: {COLLECTIVES}")
    if algorithm not in ALGORITHMS:
        raise ValueError(f"unknown algorithm {algorithm!r}; "
                         f"known: {ALGORITHMS}")
    if len(set(ranks)) != len(ranks):
        raise ValueError(f"duplicate ranks in collective group: {ranks}")
    if size < 0:
        raise ValueError(f"collective size must be >= 0, got {size}")
    if (algorithm == "halving_doubling"
            and kind in ("all_reduce", "reduce_scatter", "all_gather")):
        # Only the kinds actually lowered through _hd_rounds need the
        # power-of-two restriction (all_to_all/p2p lower direct).
        p = len(ranks)
        if p > 1 and (p & (p - 1)):
            raise ValueError(
                f"halving_doubling needs a power-of-two group, got {p}")


def _ring_rs_rounds(ranks: tuple[int, ...], size: float) -> list[Round]:
    """Ring reduce-scatter: P-1 rounds, each rank passes one chunk of
    ``size/P`` to its ring successor."""
    p = len(ranks)
    chunk = size / p
    return [tuple((ranks[i], ranks[(i + 1) % p], chunk) for i in range(p))
            for _ in range(p - 1)]


def _hd_rounds(ranks: tuple[int, ...], size: float,
               halving: bool) -> list[Round]:
    """Recursive halving (reduce-scatter) / doubling (all-gather): log2 P
    rounds of pairwise exchanges at shrinking/growing distance.  Halving
    sends size/2, size/4, ..., size/P; doubling the reverse."""
    p = len(ranks)
    steps = p.bit_length() - 1                      # log2(p); p power of two
    fracs = [size / (1 << (k + 1)) for k in range(steps)]
    if not halving:
        fracs = fracs[::-1]
    rounds: list[Round] = []
    for k, frac in enumerate(fracs):
        dist = (p >> (k + 1)) if halving else (1 << k)
        rounds.append(tuple((ranks[i], ranks[i ^ dist], frac)
                            for i in range(p)))
    return rounds


def _direct_scatter_rounds(ranks: tuple[int, ...], size: float) -> list[Round]:
    """Direct chunk exchange: one round, rank i sends chunk j (size/P)
    straight to rank j.  Lowers reduce-scatter, all-gather (mirror), and
    all-to-all alike — the flow sets coincide; only the payload meaning
    differs."""
    p = len(ranks)
    chunk = size / p
    return [tuple((ranks[i], ranks[j], chunk)
                  for i in range(p) for j in range(p) if i != j)]


def lower_collective(kind: str, ranks: tuple[int, ...] | list[int],
                     size: float, algorithm: str = "ring"
                     ) -> LoweredCollective:
    """Lower one logical collective over ``ranks`` into flow rounds.

    ``size`` is the full logical buffer per participant: the gradient
    bucket for (all_)reduce(_scatter), the gathered result for all_gather,
    the per-rank token payload for all_to_all, the message for p2p (which
    takes exactly two ranks: (src, dst)).
    """
    ranks = tuple(int(r) for r in ranks)
    _check(kind, ranks, size, algorithm)
    p = len(ranks)

    if kind == "p2p":
        if p != 2:
            raise ValueError(f"p2p takes exactly (src, dst), got {ranks}")
        rounds = [((ranks[0], ranks[1], size),)] if size > 0 else []
        return LoweredCollective(kind, algorithm, ranks, size, tuple(rounds))

    if p <= 1 or size == 0:                   # degenerate: nothing on the wire
        return LoweredCollective(kind, algorithm, ranks, size, ())

    if kind == "all_to_all":
        # Personalized exchange is direct under every algorithm name (ring
        # staging moves the same bytes through more hops; we model the
        # bandwidth-optimal direct exchange).
        rounds = _direct_scatter_rounds(ranks, size)
    elif algorithm == "ring":
        if kind == "reduce_scatter":
            rounds = _ring_rs_rounds(ranks, size)
        elif kind == "all_gather":
            rounds = _ring_rs_rounds(ranks, size)   # same flow pattern
        else:                                       # all_reduce = RS + AG
            rounds = _ring_rs_rounds(ranks, size) + _ring_rs_rounds(ranks, size)
    elif algorithm == "halving_doubling":
        if kind == "reduce_scatter":
            rounds = _hd_rounds(ranks, size, halving=True)
        elif kind == "all_gather":
            rounds = _hd_rounds(ranks, size, halving=False)
        else:
            rounds = (_hd_rounds(ranks, size, halving=True)
                      + _hd_rounds(ranks, size, halving=False))
    else:                                           # direct
        if kind in ("reduce_scatter", "all_gather"):
            rounds = _direct_scatter_rounds(ranks, size)
        else:
            rounds = (_direct_scatter_rounds(ranks, size)
                      + _direct_scatter_rounds(ranks, size))

    for r in rounds:
        for (s, d, _) in r:
            if s == d:
                raise AssertionError(
                    f"lowering emitted a self-flow on port {s} "
                    f"({kind}/{algorithm}, P={p})")
    return LoweredCollective(kind, algorithm, ranks, size, tuple(rounds))


def lower_grouped(kind: str, groups: list[tuple[int, ...]], size: float,
                  algorithm: str = "ring") -> LoweredCollective:
    """Lower the same collective over several disjoint groups (all the DP
    groups of one gradient bucket, say) and merge round-for-round: the
    groups run in lockstep because one SPMD computation consumes them all,
    so round t of every group lands in one combined round.

    Groups may differ in size (ragged merges pad with empty tails).
    """
    lows = [lower_collective(kind, g, size, algorithm) for g in groups]
    all_ports: list[int] = [p for g in groups for p in g]
    if len(set(all_ports)) != len(all_ports):
        raise ValueError("grouped collective groups must be disjoint")
    n_rounds = max((len(lc.rounds) for lc in lows), default=0)
    merged: list[Round] = []
    for t in range(n_rounds):
        merged.append(tuple(f for lc in lows if t < len(lc.rounds)
                            for f in lc.rounds[t]))
    return LoweredCollective(kind, algorithm, tuple(all_ports), size,
                             tuple(merged))


def add_lowered(job, name: str, lowered: LoweredCollective,
                deps: list[str] | None = None) -> str | None:
    """Emit a lowered collective into ``job`` as chained metaflows.

    Round t becomes metaflow ``{name}/r{t}`` depending on round t-1 (and
    round 0 on ``deps``, the producer compute).  Returns the name of the
    *last* round — what downstream compute should depend on — or ``None``
    for degenerate collectives with nothing on the wire (callers then
    depend directly on ``deps``).
    """
    prev: str | None = None
    for t, round_flows in enumerate(lowered.rounds):
        mf_name = f"{name}/r{t}"
        mf_deps = [prev] if prev else list(deps or [])
        job.add_metaflow(mf_name, flows=[(s, d, z) for (s, d, z)
                                         in round_flows],
                         deps=mf_deps)
        prev = mf_name
    return prev
