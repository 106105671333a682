"""Launcher for the multi-tensor AdamW kernels (``csrc/adamw.cu``).

Replaces no TPU kernel: the JAX package's AdamW is plain ``jnp``, which XLA
fuses, and the port's plain version (``optim/adamw.py``'s per-leaf loop,
which ``AdamW.update`` keeps for CPU tensors) streams each leaf through
device memory some twenty times.  :func:`step` runs one AdamW step over
every leaf of a tree in three launches: the gradients' sum of squares, a
chunk at a time (``adamw_sumsq``); the global norm and the clip scale, on
the device (``adamw_finish``); the update of p, m and v in place
(``adamw_update``).  The memory rate bounds it: g read twice, p, m and v
read and written once, 24 bytes a bf16 parameter.

Each leaf is cut into chunks of ``CHUNK`` elements (:func:`chunk_table`), a
block a chunk.  The leaves' pointers, sizes, dtypes and decay flags form a
table on the device, cached while the parameters and moments stay where
they are (the key is their pointers); the gradients' pointers, new each
step, go to the device in one small copy from pinned memory a step (the
caching host allocator keeps the pinned block until that copy has run).

Parameters are float32 or bfloat16, each gradient of its parameter's
dtype and shape, the moments float32; p, m and v contiguous, a
strided gradient copied.  ``ValueError`` past those limits; nothing falls
back to the plain loop.  The library is built (``build.py``) at the first
launch, never when this module is imported.  ``P_STEPS``, :func:`steps_apart`
and :func:`p_gap` say how far the kernels' step may lie from the plain
loop's; the card tests and ``chip_smoke.py`` hold it to them.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
CHUNK = 65536      # elements a chunk (csrc/adamw.cu)
DECAY_BIT = 8      # the decay flag's bit in a leaf's meta word

#: Kernel launches in this process (three a step); ``ops.reset_launch_counts``
#: zeroes it.
launches = 0

_P, _I64, _F = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
# C entry point -> argument types (the stream last).
_ARGTYPES = {
    "adamw_sumsq": [_P, _I64, _P, _I64, _P, _P, _P],
    "adamw_finish": [_P, _I64, _F, _P, _P],
    "adamw_update": [_P, _I64, _P, _I64, _P, _P] + [_F] * 9 + [_P],
}
_fns: dict = {}
# (device, the leaves' pointer, size and meta rows) -> (chunk table, leaf
# table), both on the device; the newest MAX_TABLES kept.
_tables: dict = {}
MAX_TABLES = 8


def chunk_table(numels) -> list[int]:
    """The chunks of leaves of ``numels`` elements, in leaf order, each as
    ``leaf << 32 | index of the chunk in its leaf`` (its first element is
    index x ``CHUNK``, its length the rest of the leaf up to ``CHUNK``)."""
    out = []
    for leaf, n in enumerate(numels):
        if n >= CHUNK << 32:
            raise ValueError(f"adamw: leaf {leaf} of {n} elements is past "
                             f"{CHUNK} x 2**32")
        out.extend(leaf << 32 | i for i in range(-(-n // CHUNK)))
    return out


def chunk_span(entry: int, numels) -> tuple[int, int, int]:
    """(leaf, first element, length) of a :func:`chunk_table` entry, as the
    kernels read it."""
    leaf, start = entry >> 32, (entry & 0xFFFFFFFF) * CHUNK
    return leaf, start, min(CHUNK, numels[leaf] - start)


def _fn(name: str):
    """The C entry point ``name``, its library loaded (built) on first use."""
    if name not in _fns:
        fn = getattr(build.load("adamw"), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def _call(name: str, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        rc = _fn(name)(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def _check(params, grads, ms, vs) -> torch.device:
    if not params or not len(params) == len(grads) == len(ms) == len(vs):
        raise ValueError(f"adamw: {len(params)} parameters, {len(grads)} "
                         f"gradients, {len(ms)} and {len(vs)} moments")
    device = params[0].device
    for i, (p, g, m, v) in enumerate(zip(params, grads, ms, vs)):
        if p.dtype not in DTYPES:
            raise ValueError(f"adamw: leaf {i} is {p.dtype}, not float32 "
                             f"or bfloat16")
        if g.dtype != p.dtype or g.shape != p.shape:
            raise ValueError(f"adamw: leaf {i}'s gradient is {g.dtype} "
                             f"{tuple(g.shape)}, its parameter {p.dtype} "
                             f"{tuple(p.shape)}")
        if (m.dtype, v.dtype) != (torch.float32, torch.float32) or \
                m.numel() != p.numel() or v.numel() != p.numel():
            raise ValueError(f"adamw: leaf {i}'s moments must be float32 "
                             f"of {p.numel()} elements")
        if not (p.is_contiguous() and m.is_contiguous()
                and v.is_contiguous()):
            raise ValueError(f"adamw: leaf {i}'s parameter and moments must "
                             f"be contiguous (updated in place)")
        if any(t.device != device for t in (p, g, m, v)) or \
                device.type != "cuda":
            raise ValueError(f"adamw: leaf {i} is not on {device}, or that "
                             f"is not a CUDA device")
    return device


def _leaf_tables(device, params, ms, vs, decays):
    """The cached (chunk table, leaf table) of these leaves."""
    rows = (tuple(p.data_ptr() for p in params),
            tuple(m.data_ptr() for m in ms),
            tuple(v.data_ptr() for v in vs),
            tuple(p.numel() for p in params),
            tuple(DTYPES[p.dtype] | bool(d) << DECAY_BIT
                  for p, d in zip(params, decays)))
    key = (device, rows)
    if key not in _tables:
        chunks = chunk_table(rows[3])
        if not chunks:
            raise ValueError("adamw: every leaf is empty")
        if len(_tables) >= MAX_TABLES:
            del _tables[next(iter(_tables))]
        _tables[key] = (torch.tensor(chunks, dtype=torch.int64).to(device),
                        torch.tensor(rows, dtype=torch.int64).to(device))
    return _tables[key]


def step(params: list, grads: list, ms: list, vs: list, decays: list, *,
         b1: float, b2: float, eps: float, weight_decay: float,
         clip_norm: float, b1c: float, b2c: float, lr: float,
         sum_over=None) -> torch.Tensor:
    """One AdamW step over the leaves, in place; returns the gradients'
    global norm (a float32 scalar on the device; nothing waits for it).

    ``sum_over``: where a leaf is the local shard of a sharded tensor, per
    leaf the process groups over which its sum of squares is summed (empty
    for a whole leaf); the leaves of one set of groups are summed locally,
    all-reduced over each group of the set, and the totals then summed as
    the partials are.  ``None``: every leaf is whole here."""
    global launches
    device = _check(params, grads, ms, vs)
    grads = [g if g.is_contiguous() else g.contiguous() for g in grads]
    chunks, table = _leaf_tables(device, params, ms, vs, decays)
    n_chunks, n_leaves = chunks.numel(), len(params)
    gptrs = torch.tensor([g.data_ptr() for g in grads], dtype=torch.int64,
                         pin_memory=True).to(device, non_blocking=True)
    partials = torch.empty(n_chunks, dtype=torch.float64, device=device)
    _call("adamw_sumsq", device, chunks.data_ptr(), n_chunks,
          table.data_ptr(), n_leaves, gptrs.data_ptr(), partials.data_ptr())
    if sum_over is not None and any(sum_over):
        partials = _sum_by_groups(partials, params, sum_over)
    out = torch.empty(2, dtype=torch.float32, device=device)
    _call("adamw_finish", device, partials.data_ptr(), partials.numel(),
          clip_norm, out.data_ptr())
    _call("adamw_update", device, chunks.data_ptr(), n_chunks,
          table.data_ptr(), n_leaves, gptrs.data_ptr(), out[1:].data_ptr(),
          b1, 1 - b1, b2, 1 - b2, b1c, b2c, eps, -lr, weight_decay)
    launches += 3
    return out[0]


def _sum_by_groups(partials: torch.Tensor, params: list,
                   sum_over: list) -> torch.Tensor:
    """Per set of groups (in the order of its first leaf), the sum of its
    leaves' chunk partials, all-reduced over each group of the set."""
    import torch.distributed as dist

    rows: dict[tuple, list[int]] = {}
    first = 0
    for p, groups in zip(params, sum_over):
        n = -(-p.numel() // CHUNK)
        rows.setdefault(tuple(groups), []).extend(range(first, first + n))
        first += n
    sums = []
    for groups, idx in rows.items():
        s = partials[torch.tensor(idx, device=partials.device)].sum()
        for group in groups:
            dist.all_reduce(s, group=group)
        sums.append(s)
    return torch.stack(sums)


# How far the kernels' step lies from the plain loop's (``AdamW.plain_update``)
# from the same state: m and v are bit-equal with the clip off, and p within
# ``P_STEPS`` steps of its dtype (:func:`steps_apart`).  bf16 one, where both
# round the same update to p's dtype; float32 four, where the update is added
# unrounded and the plain loop's divisions of m and v by the bias corrections
# (products with a reciprocal on the card) move it by a few float32 steps.
P_STEPS = {torch.bfloat16: 1, torch.float32: 4}
_MANTISSA = {torch.bfloat16: (7, -126), torch.float32: (23, -126)}
_PIECE = 1 << 26


def steps_apart(a: torch.Tensor, b: torch.Tensor,
                before: torch.Tensor) -> torch.Tensor:
    """|a - b| in steps of their dtype at the largest magnitude of a, b,
    ``before`` (the parameter before the step) and the step a - before:
    where the update cancels the parameter, two roundings of the update
    differ at the update's size, not at the small sum's."""
    mant, emin = _MANTISSA[a.dtype]
    a, b, before = a.float(), b.float(), before.float()
    top = torch.maximum(torch.maximum(a.abs(), b.abs()),
                        torch.maximum(before.abs(), (a - before).abs()))
    exp = (torch.frexp(top).exponent - 1).clamp(min=emin)
    return (a - b).abs() / torch.exp2((exp - mant).float())


def p_gap(kernel: list, plain: list, before: list,
          atol: float = 0.0) -> tuple[int, int, dict]:
    """The kernels' parameters against the plain loop's, leaf by leaf:
    (elements that differ, elements, {dtype: (the widest
    :func:`steps_apart`, its leaf, its element)}), a difference within
    ``atol`` counted as none."""
    differ = total = 0
    worst: dict = {}
    for leaf, (a, b, b0) in enumerate(zip(kernel, plain, before)):
        a, b, b0 = a.flatten(), b.flatten(), b0.flatten()
        # A piece at a time: an expert leaf's fp32 temporaries would be
        # 3.2 GB each.
        for at in range(0, a.numel(), _PIECE):
            cut = slice(at, at + _PIECE)
            d = steps_apart(a[cut], b[cut], b0[cut])
            d[(a[cut].float() - b[cut].float()).abs() <= atol] = 0
            i = int(d.argmax())
            if float(d[i]) >= worst.get(a.dtype, (-1.0,))[0]:
                worst[a.dtype] = (float(d[i]), leaf, at + i)
            differ += int((d > 0).sum())
        total += a.numel()
    return differ, total, worst
