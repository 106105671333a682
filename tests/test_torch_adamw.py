"""The multi-tensor AdamW's host side on the CPU (``kernels/adamw.py``): the
chunk table the kernels walk, the sums of a sharded tree's leaves by their
groups, and the dispatch of ``AdamW.update``: CPU leaves run the plain loop
(``AdamW.plain_update``) and never reach the kernels or their counter.  The
kernels themselves run on the card (``tests/test_torch_cuda.py``, ``-k
adamw``)."""

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import adamw as tadamw
from repro_torch.kernels import ops
from repro_torch.launch import train
from repro_torch.optim.adamw import AdamW
from repro_torch.tree import leaves, unflatten

C = tadamw.CHUNK
LEAF_SETS = {
    "odd": [1, 7, 8191, C - 1, C, C + 1, 0, 3 * C + 5],
    "one": [1],
    "mixtral_expert": [8 * 6144 * 16384, 6144, 6144 * 8],
    "past_2_31": [5, 2**31 + 3, 2**33 + C // 2],
}


def _spans(numels):
    return [tadamw.chunk_span(e, numels) for e in tadamw.chunk_table(numels)]


@pytest.mark.parametrize("name", list(LEAF_SETS))
def test_chunks_cover_every_element_of_every_leaf_once(name):
    numels = LEAF_SETS[name]
    spans = _spans(numels)
    # In leaf order, each chunk starting where the one before it ended, and
    # each leaf's chunks ending at its last element.
    ends = {}
    for leaf, start, length in spans:
        assert 0 < length <= C
        assert start == ends.get(leaf, 0)
        assert start + length <= numels[leaf]     # inside one leaf
        ends[leaf] = start + length
    assert [leaf for leaf, *_ in spans] == sorted(leaf for leaf, *_ in spans)
    assert ends == {i: n for i, n in enumerate(numels) if n}
    assert len(spans) == sum(-(-n // C) for n in numels)


def test_offsets_past_2_31_survive():
    numels = LEAF_SETS["past_2_31"]
    table = tadamw.chunk_table(numels)
    assert all(0 <= e < 2**63 for e in table)      # int64 on the device
    leaf, start, length = tadamw.chunk_span(table[-1], numels)
    assert (leaf, start + length) == (2, 2**33 + C // 2)
    assert start * 4 > 2**34                        # fp32 moment bytes
    big = [s for s in _spans(numels) if s[0] == 1]
    assert big[-1] == (1, 2**31, 3)                 # the ragged last chunk
    # The table as the kernels receive it: an int64 tensor, entries intact.
    assert torch.tensor(table, dtype=torch.int64).tolist() == table


def test_the_table_refuses_a_leaf_past_its_index():
    with pytest.raises(ValueError):
        tadamw.chunk_table([C << 32])


def test_the_kernels_refuse_cpu_tensors_without_building():
    p = torch.zeros(3)
    with pytest.raises(ValueError):
        tadamw.step([p], [p], [p], [p], [True], b1=0.9, b2=0.95, eps=1e-8,
                    weight_decay=0.1, clip_norm=1.0, b1c=0.1, b2c=0.05,
                    lr=1e-3)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_the_kernels_refuse_other_dtypes_without_building(dtype):
    """Parameters are float32 or bfloat16; any other dtype is refused by
    name before the library is built or a device looked at."""
    p, m = torch.zeros(3, dtype=dtype), torch.zeros(3)
    with pytest.raises(ValueError, match=str(dtype)):
        tadamw.step([p], [p], [m], [m], [True], b1=0.9, b2=0.95, eps=1e-8,
                    weight_decay=0.1, clip_norm=1.0, b1c=0.1, b2c=0.05,
                    lr=1e-3)
    assert tadamw.DTYPES == {torch.float32: 0, torch.bfloat16: 1}


def test_p_gap_counts_steps_of_each_dtype_a_piece_at_a_time(monkeypatch):
    """The kernels' agreement measure: a difference in steps of the leaf's
    dtype at the largest magnitude, located across pieces, and none within
    ``atol``."""
    monkeypatch.setattr(tadamw, "_PIECE", 5)
    before = [torch.ones(12, dtype=torch.bfloat16), torch.ones(3)]
    kernel = [b.clone() for b in before]
    plain = [b.clone() for b in before]
    kernel[0][7] = 1 + 2**-7                        # one bf16 step
    kernel[1][2] = 1 + 2**-22                       # two float32 steps
    differ, total, worst = tadamw.p_gap(kernel, plain, before)
    assert (differ, total) == (2, 15)
    assert worst == {torch.bfloat16: (1.0, 0, 7), torch.float32: (2.0, 1, 2)}
    differ, _, worst = tadamw.p_gap(kernel, plain, before, atol=1e-5)
    assert differ == 1 and worst[torch.float32][0] == 0.0
    assert all(w <= tadamw.P_STEPS[dt] for dt, (w, *_) in
               tadamw.p_gap(kernel, plain, before)[2].items())


def test_sharded_leaves_sum_by_their_groups(monkeypatch):
    """Each set of groups sums its leaves' chunk partials, all-reduced over
    each of its groups in order; sets in the order of their first leaf."""
    import torch.distributed as dist

    calls = []

    def all_reduce(t, group=None):
        calls.append(group)
        t.mul_(2)                          # a second rank with equal sums

    monkeypatch.setattr(dist, "all_reduce", all_reduce)
    params = [torch.zeros(n) for n in (C + 1, 3, 2 * C, 5)]
    over = [("data",), (), ("data",), ("data", "model")]
    partials = torch.arange(1.0, 7.0, dtype=torch.float64)  # 2, 1, 2, 1
    got = tadamw._sum_by_groups(partials, params, over)
    assert got.tolist() == [2 * (1 + 2 + 4 + 5), 3, 4 * 6]
    assert calls == ["data", "data", "model"]


@pytest.mark.parametrize("arch", ["mixtral-8x22b-smoke", "mamba2-370m-smoke"])
def test_cpu_leaves_run_the_plain_loop_and_never_the_kernels(arch):
    cfg = get_config(arch)
    t = train.setup(cfg, steps=4, batch=2, seq=16, seed=5, device="cpu")
    a, b = t.init(), t.init()
    grads = [torch.randn(p.shape, generator=torch.Generator().manual_seed(i))
             .to(p.dtype) for i, p in enumerate(leaves(a.params))]
    g = unflatten(a.params, grads)
    ops.reset_launch_counts()
    pa, sa, ma = t.optimizer.update(g, a.opt, a.params, t.model.decays)
    pb, sb, mb = t.optimizer.plain_update(g, b.opt, b.params, t.model.decays)
    assert ops.launch_counts()["adamw"] == 0
    assert not tadamw._tables
    assert torch.equal(ma["grad_norm"], mb["grad_norm"])
    assert ma["lr"] == mb["lr"] and sa.step == sb.step == 1
    for x, y in zip(leaves((pa, sa.m, sa.v)), leaves((pb, sb.m, sb.v))):
        assert torch.equal(x, y)


def test_update_dispatches_on_the_device_of_the_leaves(monkeypatch):
    """A CUDA leaf goes to the kernels and never to the plain loop; a CPU
    leaf the other way (the device read from the first leaf, faked here)."""
    opt = AdamW()
    seen = []
    monkeypatch.setattr(AdamW, "plain_update",
                        lambda self, *a, **k: seen.append("plain"))
    monkeypatch.setattr(AdamW, "_kernel_update",
                        lambda self, *a, **k: seen.append("kernels") or 0.0)

    class OnCard(torch.Tensor):
        @property
        def device(self):
            return torch.device("cuda")

    p = torch.zeros(2)
    state = opt.init({"w": p})
    opt.update({"w": p}, state, {"w": p})
    opt.update({"w": p}, state, {"w": p.as_subclass(OnCard)})
    assert seen == ["plain", "kernels"]


# ------------------------------------------------------ sharded (DTensor)

SHARD_WORLD, SHARD_MESH = 4, (2, 2)
SHARD_ARCH = "mixtral-8x22b-smoke"
SHARD_TIMEOUT_S = 240


def _plain_kernels(params, grads, ms, vs, decays, *, b1, b2, eps,
                   weight_decay, clip_norm, b1c, b2c, lr, sum_over=None):
    """``kernels.adamw.step``'s arithmetic in plain torch, for the CPU: the
    chunks' float64 partials (summed by ``_sum_by_groups`` where the
    leaves are shards), the norm and scale, then the plain loop's update
    of each element."""
    numels = [p.numel() for p in params]
    partials = torch.tensor(
        [float(grads[leaf].reshape(-1)[start:start + n].double().square()
               .sum()) for leaf, start, n in
         (tadamw.chunk_span(e, numels) for e in tadamw.chunk_table(numels))],
        dtype=torch.float64)
    if sum_over is not None and any(sum_over):
        partials = tadamw._sum_by_groups(partials, params, sum_over)
    gnorm = partials.sum().sqrt().float()
    scale = torch.clamp(clip_norm / (gnorm + 1e-9), max=1.0)
    for p, g, mu, nu, d in zip(params, grads, ms, vs, decays):
        g32 = g.float() * scale
        mu.mul_(b1).add_((1 - b1) * g32)
        nu.mul_(b2).add_((1 - b2) * g32 * g32)
        upd = (mu / b1c).div_((nu / b2c).sqrt_().add_(eps))
        if d:
            upd.add_(p.float(), alpha=weight_decay)
        p.add_(upd.mul_(-lr).to(p.dtype))
    return gnorm


def _seeded_grads(params, device) -> list:
    return [(1e-2 * torch.randn(p.shape, generator=torch.Generator()
                                .manual_seed(i))).to(p.dtype).to(device)
            for i, p in enumerate(leaves(params))]


def sharded_adamw_rank(rank: int, tmp: str, device_type: str) -> None:
    """One rank of a (2, 2) mesh: the state of ``SHARD_ARCH`` as DTensors,
    seeded gradients in the parameters' placements, one step of
    ``AdamW``'s kernel path with the clip off (on the CPU through
    ``_plain_kernels``); rank 0 saves the global norm, each leaf's sharded
    mesh dimensions and the gathered parameters and moments."""
    import dataclasses

    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.tree import leaves_with_path

    cuda = device_type == "cuda"
    if cuda:
        torch.cuda.set_device(rank)
    else:
        torch.set_num_threads(1)
        tadamw.step = _plain_kernels
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"file://{tmp}/rendezvous",
                            world_size=SHARD_WORLD, rank=rank)
    try:
        mesh = make_test_mesh(*SHARD_MESH, device_type=device_type)
        device = f"cuda:{rank}" if cuda else "cpu"
        t = train.setup(get_config(SHARD_ARCH), steps=4, batch=2, seq=16,
                        seed=0, device=device, mesh=mesh)
        state = t.init()
        pairs = leaves_with_path(state.params)
        grads = [distribute_tensor(g, mesh, p.placements) for g, (_, p) in
                 zip(_seeded_grads(state.params, device), pairs)]
        opt = dataclasses.replace(t.optimizer, clip_norm=1e30)
        gnorm = opt._kernel_update(pairs, grads, leaves(state.opt.m),
                                   leaves(state.opt.v), t.model.decays,
                                   *opt._bias_and_lr(1))
        full = [x.full_tensor().cpu() for x in
                leaves((state.params, state.opt.m, state.opt.v))]
        if rank == 0:
            torch.save({"gnorm": float(gnorm), "full": full,
                        "dims": [tuple(i for i, pl in enumerate(p.placements)
                                       if pl.is_shard()) for _, p in pairs]},
                       f"{tmp}/got.pt")
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_sharded_adamw(tmp: str, device_type: str) -> dict:
    import time

    import torch.multiprocessing as mp

    ctx = mp.start_processes(sharded_adamw_rank, args=(tmp, device_type),
                             nprocs=SHARD_WORLD, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + SHARD_TIMEOUT_S
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"ranks still running after {SHARD_TIMEOUT_S} s")
    return torch.load(f"{tmp}/got.pt")


def test_sharded_leaves_sum_over_their_mesh_dims_on_four_ranks(tmp_path):
    """Four gloo ranks run ``AdamW``'s kernel path on DTensor leaves (the
    kernels' arithmetic in plain torch, ``_plain_kernels``): each leaf's
    sum of squares all-reduced over the mesh dimensions where it is
    sharded gives the one-process norm within 1e-6, and the update of the
    local shards in place gives the one-process plain loop's parameters
    and moments bit for bit (the clip off)."""
    import dataclasses

    got = run_sharded_adamw(str(tmp_path), "cpu")
    # Replicated leaves, leaves sharded over one mesh dimension and over two.
    assert {(), (0,), (0, 1)} <= set(got["dims"])
    t = train.setup(get_config(SHARD_ARCH), steps=4, batch=2, seq=16,
                    seed=0, device="cpu")
    state = t.init()
    grads = unflatten(state.params, _seeded_grads(state.params, "cpu"))
    opt = dataclasses.replace(t.optimizer, clip_norm=1e30)
    params, st, m = opt.plain_update(grads, state.opt, state.params,
                                     t.model.decays)
    want = float(torch.stack([g.double().square().sum()
                              for g in leaves(grads)]).sum().sqrt())
    assert abs(got["gnorm"] - want) <= 1e-6 * want
    assert abs(float(m["grad_norm"]) - want) <= 1e-6 * want
    for a, b in zip(got["full"], leaves((params, st.m, st.v))):
        assert torch.equal(a, b)
