"""The port's scheduled ring exchange (sparkucx_tpu_torch/ops/ici_exchange.py,
ops/ring_kernels.py) against the JAX package's (sparkucx_tpu/ops/ici_exchange.py
on the virtual CPU mesh of tests/conftest.py, its Pallas ring kernels under
``lowering='interpret'`` and the scheduled permutes under ``'xla'``; the port
has one route, the kernels, which run their plain versions on the CPU).

The schedule model is pure Python and must equal the JAX package's item for
item.  Exchanges compare whole receive buffers (zero tails included) and
receive-size matrices: tolerance 0.  The fused-combine exchange folds int32
rows, where every order gives the same bits: tolerance 0."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from sparkucx_tpu.ops import combine as jax_combine
from sparkucx_tpu.ops import exchange as jax_exchange
from sparkucx_tpu.ops import ici_exchange as jax_ici
from sparkucx_tpu_torch.config import TpuShuffleConf
from sparkucx_tpu_torch.core.block import MemoryBlock, ShuffleBlockId
from sparkucx_tpu_torch.ops import combine as torch_combine
from sparkucx_tpu_torch.ops import exchange as torch_exchange
from sparkucx_tpu_torch.ops import ici_exchange as torch_ici
from sparkucx_tpu_torch.ops import ring_kernels
from sparkucx_tpu_torch.transport.tpu import TpuShuffleCluster

LANE = 32


# -- schedule model ----------------------------------------------------------


@pytest.mark.parametrize("dim", [2, 3, 4, 5, 8])
@pytest.mark.parametrize("chunks", [1, 2, 4])
def test_schedule_equals_jax_and_delivers_exactly_once(dim, chunks):
    sched = torch_ici.ring_schedule(dim, chunks)
    assert sched.raw_steps() == jax_ici.ring_schedule(dim, chunks).raw_steps()
    deliveries, link_load = torch_ici.simulate_ring(sched)
    for src in range(dim):
        for dst in range(dim):
            for c in range(chunks):
                assert deliveries.get((src, dst, c), 0) == (0 if src == dst else 1)
    assert all(v <= 1 for v in link_load.values())
    assert torch_ici.step_occupancy(sched) == jax_ici.step_occupancy(jax_ici.ring_schedule(dim, chunks))


@pytest.mark.parametrize("dim", [3, 4, 8])
def test_chunk_major_interleaving_and_antipodes(dim):
    sched = torch_ici.ring_schedule(dim, 4)
    for direction in (1, -1):
        seq = [it.chunk for it in sched.items() if it.direction == direction]
        assert seq == sorted(seq)
    for it in sched.items():
        if 2 * it.offset == dim:
            assert it.direction == (1 if it.chunk % 2 == 0 else -1)


def test_schedule_chunks_and_bad_dims():
    for group, req in [(16, 3), (16, 64), (12, 8), (8, 1), (7, 4), (1500304, 2), (14996513, 2)]:
        assert torch_ici.schedule_chunks(group, req) == jax_ici.schedule_chunks(group, req)
    with pytest.raises(ValueError, match="group_rows"):
        torch_ici.schedule_chunks(0, 2)
    with pytest.raises(ValueError, match="dim"):
        torch_ici.ring_schedule(1)
    with pytest.raises(ValueError, match="chunks_per_dest"):
        torch_ici.ring_schedule(4, 0)


def test_resolvers():
    for impl in ("stock", "pallas", "auto"):
        for platform, n in (("tpu", 8), ("tpu", 1), ("cpu", 8), ("cuda", 4)):
            assert torch_ici.resolve_exchange_impl(impl, platform, n) == jax_ici.resolve_exchange_impl(
                impl, platform, n
            )
    with pytest.raises(ValueError, match="exchange impl"):
        torch_ici.resolve_exchange_impl("bogus", "cpu", 8)
    # one route: every name is the kernels' on the CPU; the card refuses the
    # JAX-only names
    for low in ("auto", "dma", "xla", "interpret"):
        assert torch_ici.resolve_ici_lowering(low, "cpu") == "dma"
    for low in ("auto", "dma"):
        assert torch_ici.resolve_ici_lowering(low, "cuda") == "dma"
    for low in ("xla", "interpret"):
        with pytest.raises(ValueError, match="kernels"):
            torch_ici.resolve_ici_lowering(low, "cuda")
    with pytest.raises(ValueError, match="lowering"):
        torch_ici.resolve_ici_lowering("bogus", "cpu")
    for low in ("dma", "xla", "interpret"):
        for kind in ("ici", "dcn"):
            assert torch_ici.resolve_schedule_lowering(low, kind) == jax_ici.resolve_schedule_lowering(low, kind)


# -- K3 and the flat builder ---------------------------------------------------


def _case(rng, n, slot):
    sizes = rng.integers(0, slot + 1, size=(n, n)).astype(np.int32)
    data = rng.integers(-100, 100, size=(n * n * slot, LANE), dtype=np.int32)
    return data, sizes


def _jax_run(fn, n, data, sizes):
    mesh = jax_exchange.make_mesh(n)
    sh = NamedSharding(mesh, P("ex", None))
    recv, rs = fn(jax.device_put(data, sh), jax.device_put(sizes, sh))
    return np.asarray(recv), np.asarray(rs)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("chunks", [1, 2])
@pytest.mark.parametrize("jax_lowering", ["xla", "interpret"])
def test_build_ici_exchange_matches_jax_and_stock(n, chunks, jax_lowering):
    """The port's one route against each of the JAX package's lowerings."""
    rng = np.random.default_rng(n * 10 + chunks)
    slot = 8
    data, sizes = _case(rng, n, slot)
    jspec = jax_exchange.ExchangeSpec(num_executors=n, send_rows=n * slot, recv_rows=n * slot, lane=LANE)
    jfn = jax_ici.build_ici_exchange(jax_exchange.make_mesh(n), jspec, chunks_per_dest=chunks, lowering=jax_lowering)
    jrecv, jrs = _jax_run(jfn, n, data, sizes)
    tspec = torch_exchange.ExchangeSpec(n, n * slot, n * slot, LANE)
    tfn = torch_ici.build_ici_exchange(["cpu"] * n, tspec, chunks_per_dest=chunks)
    assert tfn.lowering == "dma" and tfn.schedule.chunks == chunks
    before = ring_kernels.ring_exchange_grid.launches
    trecv, trs = tfn(torch.from_numpy(data), sizes)
    assert ring_kernels.ring_exchange_grid.launches == before  # CPU: the plain version
    assert np.array_equal(trs.numpy(), jrs.reshape(n, n))
    assert trecv.numpy().tobytes() == jrecv.tobytes()
    srecv, srs = torch_exchange.build_exchange(["cpu"] * n, tspec)(torch.from_numpy(data), sizes)
    for j in range(n):
        rows = int(sizes[:, j].sum())
        assert torch.equal(trecv[j * n * slot : j * n * slot + rows], srecv[j * n * slot : j * n * slot + rows])
    assert torch.equal(srs, trs)


def test_asymmetric_recv_rows_match_jax():
    n, slot = 4, 8
    rng = np.random.default_rng(3)
    data, sizes = _case(rng, n, slot)
    jspec = jax_exchange.ExchangeSpec(num_executors=n, send_rows=n * slot, recv_rows=2 * n * slot, lane=LANE)
    jrecv, _ = _jax_run(jax_ici.build_ici_exchange(jax_exchange.make_mesh(n), jspec, chunks_per_dest=2), n, data, sizes)
    tspec = torch_exchange.ExchangeSpec(n, n * slot, 2 * n * slot, LANE)
    trecv, _ = torch_ici.build_ici_exchange(["cpu"] * n, tspec, chunks_per_dest=2)(torch.from_numpy(data), sizes)
    assert trecv.numpy().tobytes() == jrecv.tobytes()


@pytest.mark.parametrize("n,chunks", [(2, 1), (3, 2), (4, 4), (8, 2)])
def test_ring_grid_is_the_sender_major_transpose(n, chunks):
    slot = 8
    rng = np.random.default_rng(n + chunks)
    data = torch.from_numpy(rng.integers(-(2**31), 2**31 - 1, size=(n * n * slot, 5), dtype=np.int64).astype(np.int32))
    steps = torch_ici.ring_schedule(n, chunks).raw_steps()
    grid = ring_kernels.ring_exchange_grid(n, slot, slot // chunks, steps, data)
    want = data.view(n, n, slot, 5).transpose(0, 1).reshape(-1, 5)
    assert torch.equal(grid, want)
    assert torch.equal(ring_kernels.ring_exchange_grid_ref(n, slot, slot // chunks, steps, data), want)
    table = ring_kernels.ring_windows(n, slot, slot // chunks, steps)
    assert table.shape == (n * (1 + (n - 1) * chunks), 5)
    assert (table[:, 4].reshape(n, -1)[:, 0] == slot).all()  # own slot first


@pytest.mark.parametrize("recv_rows", [16, 32, 40])
def test_compact_plan_is_the_compaction(recv_rows):
    """K1's per-receiver plan, run by the plain gather, rebuilds
    compact_slots' output, cut at recv_rows and zero after it."""
    from sparkucx_tpu_torch.ops.block_kernels import block_gather_ref, plan_tensors

    n, slot = 4, 8
    rng = np.random.default_rng(recv_rows)
    grid = torch.from_numpy(rng.integers(-100, 100, size=(n * n * slot, 3), dtype=np.int32))
    sizes = rng.integers(0, slot + 1, size=(n, n)).astype(np.int32)
    recv = torch_ici.compact_slots(grid, sizes, slot, recv_rows)
    for j in range(n):
        starts, counts, outs, filled = torch_ici.compact_plan(sizes, j, slot, recv_rows)
        assert filled == min(int(sizes[:, j].sum()), recv_rows)
        got = block_gather_ref(*plan_tensors(starts, counts, outs, "cpu"), grid, recv_rows)
        shard = recv[j * recv_rows : (j + 1) * recv_rows]
        assert torch.equal(shard[:filled], got[:filled]) and not shard[filled:].any()


def test_n1_delegates_and_builder_validation():
    spec = torch_exchange.ExchangeSpec(1, 8, 8, LANE)
    assert not hasattr(torch_ici.build_ici_exchange(["cpu"], spec), "schedule")
    spec = torch_exchange.ExchangeSpec(4, 32, 32, LANE)
    with pytest.raises(ValueError, match="num_executors"):
        torch_ici.build_ici_exchange(["cpu"] * 2, spec)
    with pytest.raises(ValueError, match="schedule dim"):
        torch_ici.build_ici_exchange(["cpu"] * 4, spec, schedule=torch_ici.ring_schedule(8, 1))
    with pytest.raises(ValueError, match="divide"):
        torch_ici.build_ici_exchange(["cpu"] * 4, spec, schedule=torch_ici.ring_schedule(4, 3))
    with pytest.raises(ValueError, match="RingSchedule"):
        torch_ici.build_ici_exchange(["cpu"] * 4, spec, schedule=object())
    with pytest.raises(NotImplementedError, match="NCCL"):
        torch_ici.build_ici_exchange(["cpu", "cpu", "cpu", "meta"], spec)
    with pytest.raises(NotImplementedError, match="'dcn' ring"):
        torch_ici.build_ici_exchange(["cpu"] * 4, spec, schedule=torch_ici.ring_schedule(4, 1, kind="dcn"))
    with pytest.raises(ValueError, match="schedule item"):
        ring_kernels.ring_exchange_grid(2, 4, 4, (((1, 1, 1),),), torch.zeros((16, 2), dtype=torch.int32))


# -- K4 and the fused-combine builder -------------------------------------------


def _grid_case(rng, n, slot, cspec):
    lane = cspec.row_width
    data = np.zeros((n, n * slot, lane), np.int32)
    sizes = np.zeros((n, n), np.int32)
    for s in range(n):
        for d in range(n):
            rows = int(rng.integers(0, slot + 1))
            sizes[s, d] = rows
            keys = rng.integers(0, cspec.num_groups + 1, size=rows).astype(np.uint32)  # some out of range
            vals = rng.integers(-50, 50, size=(rows, cspec.width)).astype(np.int32)
            counts = rng.integers(1, 5, size=rows).astype(np.int32)
            data[s, d * slot : d * slot + rows] = np.concatenate(
                [keys.view(np.int32)[:, None], vals, counts[:, None]], axis=1
            )
    return data.reshape(n * n * slot, lane), sizes


def _jax_combine(n, slot, kw, data, sizes, lowering, chunks):
    cspec = jax_combine.CombineSpec(**kw)
    mesh = jax_exchange.make_mesh(n)
    spec = jax_exchange.ExchangeSpec(
        num_executors=n, send_rows=n * slot, recv_rows=n * slot, lane=cspec.row_width, impl="dense"
    )
    fn = jax_ici.build_combine_exchange(mesh, spec, cspec, chunks_per_dest=chunks, lowering=lowering)
    av, ac = jax_combine.acc_init(cspec)
    sh = NamedSharding(mesh, P("ex", None))
    out = fn(
        jax.device_put(data, sh), jax.device_put(sizes, sh),
        jax.device_put(np.tile(np.asarray(av), (n, 1)), sh), jax.device_put(np.tile(np.asarray(ac), (n, 1)), sh),
    )
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize("n,chunks", [(2, 1), (4, 2)])
@pytest.mark.parametrize("jax_lowering", ["xla", "interpret"])
def test_build_combine_exchange_matches_jax(n, chunks, jax_lowering):
    slot, kw = 8, dict(num_groups=16, aggs=("sum", "min", "max"), dtype=np.int32)
    rng = np.random.default_rng(n * 3 + chunks)
    tspec_c = torch_combine.CombineSpec(**kw)
    data, sizes = _grid_case(rng, n, slot, tspec_c)
    jv, jc, jr = _jax_combine(n, slot, kw, data, sizes, jax_lowering, chunks)
    spec = torch_exchange.ExchangeSpec(n, n * slot, n * slot, tspec_c.row_width)
    fn = torch_ici.build_combine_exchange(["cpu"] * n, spec, tspec_c, chunks_per_dest=chunks)
    av, ac = torch_combine.acc_init(tspec_c)
    tv, tc, tr = fn(torch.from_numpy(data), sizes, av.repeat(n, 1), ac.repeat(n, 1))
    assert np.array_equal(tv.numpy(), jv) and np.array_equal(tc.numpy(), jc)
    assert np.array_equal(tr.numpy(), jr.reshape(n, n))


def test_ring_combine_grid_plain_equals_jax_kernel_body():
    """K4's wrapper on CPU tensors (its plain version) against the JAX Pallas
    kernel run by the interpreter: the accumulators, and the grid against
    K3's."""
    n, slot, chunks = 4, 8, 2
    kw = dict(num_groups=8, aggs=("sum", "max", "min"), dtype=np.int32)
    cspec = torch_combine.CombineSpec(**kw)
    data, sizes = _grid_case(np.random.default_rng(11), n, slot, cspec)
    jv, jc, _ = _jax_combine(n, slot, kw, data, sizes, "interpret", chunks)
    steps = torch_ici.ring_schedule(n, chunks).raw_steps()
    before = ring_kernels.ring_combine_grid.launches
    grid, tv, tc = ring_kernels.ring_combine_grid(n, slot, slot // chunks, steps, cspec, torch.from_numpy(data))
    assert ring_kernels.ring_combine_grid.launches == before
    assert np.array_equal(tv.numpy(), jv) and np.array_equal(tc.numpy(), jc)
    assert torch.equal(grid, ring_kernels.ring_exchange_grid(n, slot, slot // chunks, steps, torch.from_numpy(data)))
    assert ring_kernels.ring_combine_tier(cspec) == "shared"
    assert ring_kernels.ring_combine_tier(torch_combine.CombineSpec(1 << 20, ("sum",))) == "global"


def test_build_combine_exchange_validation():
    cspec = torch_combine.CombineSpec(num_groups=8, aggs=("sum",))
    with pytest.raises(ValueError, match="row width"):
        torch_ici.build_combine_exchange(["cpu"] * 2, torch_exchange.ExchangeSpec(2, 8, 8, 5), cspec)
    with pytest.raises(ValueError, match="num_executors > 1"):
        torch_ici.build_combine_exchange(["cpu"], torch_exchange.ExchangeSpec(1, 8, 8, 3), cspec)
    with pytest.raises(ValueError, match="lanes"):
        ring_kernels.ring_combine_grid(2, 4, 4, (), cspec, torch.zeros((16, 4), dtype=torch.int32))


def test_span_rows_cover_and_respect_the_budget():
    assert ring_kernels.span_rows_for(10) == ring_kernels.MIN_SPAN_ROWS
    assert ring_kernels.span_rows_for(1 << 40) == ring_kernels.MAX_SPAN_ROWS
    total, part = 60_000_000, 64 * 1024
    rows = ring_kernels.span_rows_for(total, part)
    assert -(-total // rows) * part <= ring_kernels.PARTIALS_BUDGET_BYTES + part


# -- the transport under exchange.impl=pallas --------------------------------------

N_EXEC = 4


def _exchange(impl, mode="array"):
    conf = TpuShuffleConf(
        staging_capacity_per_executor=N_EXEC * 4096, block_alignment=128, num_executors=N_EXEC,
        host_recv_mode=mode, exchange_impl=impl, keep_device_recv=(mode == "device"),
    )
    cluster = TpuShuffleCluster(conf, devices=["cpu"] * N_EXEC)
    M, R = 3 * N_EXEC, 8
    meta = cluster.create_shuffle(0, M, R)
    rng = np.random.default_rng(77)
    oracle = {}
    for m in range(M):
        t = cluster.transport(meta.map_owner[m])
        w = t.store.map_writer(0, m)
        for r in range(R):
            size = int(rng.integers(2000, 3000)) if r == 0 else int(rng.integers(1, 300))
            oracle[(m, r)] = rng.integers(0, 256, size=size, dtype=np.uint8).tobytes()
            w.write_partition(r, oracle[(m, r)])
        t.commit_block(w.commit().pack())
    cluster.run_exchange(0)
    for r in range(R):
        consumer = meta.owner_of_reduce(r)
        bufs = [MemoryBlock(np.zeros(8192, np.uint8), size=8192) for _ in range(M)]
        reqs = cluster.transport(consumer).fetch_blocks_by_block_ids(
            consumer, [ShuffleBlockId(0, m, r) for m in range(M)], bufs, [None] * M
        )
        for m in range(M):
            assert reqs[m].wait(5).error is None
            assert bufs[m].host_view()[: bufs[m].size].tobytes() == oracle[(m, r)]
    return meta


@pytest.mark.parametrize("mode", ["array", "device"])
def test_cluster_pallas_matches_stock(mode):
    base = _exchange("stock", mode)
    meta = _exchange("pallas", mode)
    assert len(base.recv_sizes) > 1, "should spill multiple rounds"
    for rnd in range(len(base.recv_sizes)):
        assert np.array_equal(meta.recv_sizes[rnd], base.recv_sizes[rnd])
        for j in range(N_EXEC):
            rows = int(base.recv_sizes[rnd][j].sum())
            if mode == "array":
                used = rows * 128
                assert bytes(meta.recv_shards[rnd][j][:used]) == bytes(base.recv_shards[rnd][j][:used])
            else:
                assert torch.equal(meta.recv_device[rnd][j][:rows], base.recv_device[rnd][j][:rows])


def test_cluster_auto_is_stock_off_tpu(monkeypatch):
    calls = []
    real = torch_ici.build_ici_exchange
    monkeypatch.setattr("sparkucx_tpu_torch.transport.executor.build_ici_exchange", lambda *a, **k: calls.append(1) or real(*a, **k))
    _exchange("auto")
    assert not calls
    _exchange("pallas")
    assert calls
