"""Kernel-against-plain checks for the card: the Hopper block gather and block
scatter (sparkucx_tpu_torch/csrc/block_copy.cu) and the radix pass
(csrc/radix_sort.cu) against their plain PyTorch versions on CUDA tensors,
bit-exact.  Marked ``cuda``; each test skips unless
a CUDA device is present (``python -m pytest tests/test_torch_cuda.py`` on the
machine with the card).  No JAX here."""

from dataclasses import replace

import numpy as np
import pytest
import torch

from sparkucx_tpu_torch.ops.block_kernels import (
    block_gather,
    block_gather_ref,
    block_scatter,
    block_scatter_ref,
    plan_tensors,
)
from sparkucx_tpu_torch.ops.radix import TILE_ROWS, radix_pass, radix_pass_ref, radix_sort_rows
from sparkucx_tpu_torch.ops.sort import SortSpec, build_distributed_sort

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _plan(seed, num_blocks, src_rows, max_rows):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, max_rows, size=num_blocks).astype(np.int32)
    counts[rng.random(num_blocks) < 0.2] = 0
    starts = np.array([rng.integers(0, src_rows - c + 1) for c in counts], dtype=np.int32)
    return starts, counts, (np.cumsum(counts) - counts).astype(np.int32)


@pytest.mark.parametrize("lane", [128, 33])
@pytest.mark.parametrize("seed", [0, 1])
def test_gather_matches_plain(cuda, lane, seed):
    src = torch.randint(0, 1 << 30, (4096, lane), dtype=torch.int32, device=cuda)
    starts, counts, outs = _plan(seed, 300, 4096, 40)
    total = int(counts.sum())
    # count=0 pads pointing at the packed end are no-ops
    starts, counts, outs = (np.concatenate([a, [0, 0]]).astype(np.int32) for a in (starts, counts, outs))
    outs[-2:] = total
    s, c, o = plan_tensors(starts, counts, outs, cuda)
    before = block_gather.launches
    got = block_gather(s, c, o, src, total)
    torch.cuda.synchronize()
    assert block_gather.launches == before + 1
    assert torch.equal(got[:total], block_gather_ref(s, c, o, src, total)[:total])


@pytest.mark.parametrize("lane", [128, 33])
def test_scatter_matches_plain(cuda, lane):
    dst = torch.randint(0, 1 << 30, (4096, lane), dtype=torch.int32, device=cuda)
    counts = np.full(200, 7, dtype=np.int32)
    counts[::5] = 0
    starts = (np.arange(200) * 20).astype(np.int32)
    outs = (np.cumsum(counts) - counts).astype(np.int32)
    src = torch.randint(0, 1 << 30, (int(counts.sum()), lane), dtype=torch.int32, device=cuda)
    s, c, o = plan_tensors(starts, counts, outs, cuda)
    expected = block_scatter_ref(s, c, o, src, dst.clone())
    before = block_scatter.launches
    got = block_scatter(s, c, o, src, dst)
    torch.cuda.synchronize()
    assert got.data_ptr() == dst.data_ptr()
    assert block_scatter.launches == before + 1
    assert torch.equal(got, expected)


def test_rows_outside_the_source_are_not_copied(cuda):
    """The kernel's memory guard: a block running past the source's end copies
    its in-range rows and touches nothing outside the buffers."""
    src = torch.randint(0, 1 << 30, (100, 128), dtype=torch.int32, device=cuda)
    s, c, o = plan_tensors([90], [20], [0], cuda)
    got = block_gather(s, c, o, src, 20)
    torch.cuda.synchronize()
    assert torch.equal(got[:10], src[90:])


def _radix_rows(device, n, width, seed, sign_bit=True):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    rows = torch.randint(-(2**31), 2**31 - 1, (n, width), dtype=torch.int32, generator=gen, device=device)
    if sign_bit and n:
        rows[::3, 0] = -1  # key 0xFFFFFFFF
        rows[1::5, 0] |= -(2**31)  # keys >= 2**31
    return rows


# N = 1 and 2; one whole tile; one row past it; a partial last tile that also
# ends inside a 256-row chunk; many tiles
@pytest.mark.parametrize("n,width", [(1, 1), (2, 2), (TILE_ROWS, 3), (TILE_ROWS + 1, 25),
                                     (3 * TILE_ROWS + 1001, 25), (100_003, 25)])
@pytest.mark.parametrize("shift", [0, 8, 24])
def test_radix_pass_matches_plain(cuda, n, width, shift):
    rows = _radix_rows(cuda, n, width, seed=n + shift)
    before = radix_pass.launches
    got = radix_pass(rows, shift)
    torch.cuda.synchronize()
    assert radix_pass.launches == before + 1
    assert torch.equal(got, radix_pass_ref(rows, shift))


def test_radix_sort_matches_library_sort(cuda):
    """Sign-bit keys and a partial last tile, float32 rows through their bits."""
    rows = _radix_rows(cuda, 300_001, 25, seed=7).view(torch.float32)
    got = radix_sort_rows(rows)
    keys = rows[:, 0].view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    want = rows.index_select(0, torch.sort(keys, stable=True).indices)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_radix_distributed_sort_on_the_card(cuda):
    n = 50_000
    gen = torch.Generator(device=cuda)
    gen.manual_seed(3)
    keys = torch.randint(0, 2**32, (n,), dtype=torch.int64, generator=gen, device=cuda)
    keys[::4] = 2**32 - 1
    payload = torch.randint(-(2**31), 2**31 - 1, (n, 24), dtype=torch.int32, generator=gen, device=cuda)
    fn = build_distributed_sort(["cuda"], SortSpec(1, n, n, impl="radix"))
    ko, po, counts = fn(keys, payload, [n - 7])
    masked = keys.clone()
    masked[n - 7 :] = 2**32 - 1
    want_k, order = torch.sort(masked, stable=True)
    want_p = payload.index_select(0, order)
    want_p[n - 7 :] = 0
    torch.cuda.synchronize()
    assert counts.tolist() == [n - 7]
    assert torch.equal(ko, want_k) and torch.equal(po, want_p)


# -- K3 and K4: the scheduled ring exchange and its combine (csrc/ring_exchange.cu)


def _ring_data(device, n, slot, lane, seed, dtype=torch.int32):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    data = torch.randint(-(2**31), 2**31 - 1, (n * n * slot, lane), dtype=torch.int32, generator=gen, device=device)
    return data.view(dtype)


@pytest.mark.parametrize("n,chunks", [(2, 1), (3, 2), (4, 2), (8, 4)])
@pytest.mark.parametrize("lane", [32, 9])
def test_ring_exchange_grid_matches_plain(cuda, n, chunks, lane):
    from sparkucx_tpu_torch.ops.ici_exchange import ring_schedule
    from sparkucx_tpu_torch.ops.ring_kernels import ring_exchange_grid, ring_exchange_grid_ref

    slot = 1000 * chunks
    data = _ring_data(cuda, n, slot, lane, seed=n * 10 + lane)
    steps = ring_schedule(n, chunks).raw_steps()
    before = ring_exchange_grid.launches
    got = ring_exchange_grid(n, slot, slot // chunks, steps, data)
    torch.cuda.synchronize()
    assert ring_exchange_grid.launches == before + 1
    assert torch.equal(got, ring_exchange_grid_ref(n, slot, slot // chunks, steps, data))
    assert torch.equal(got, data.view(n, n, slot, lane).transpose(0, 1).reshape(-1, lane))


def _combine_data(device, n, slot, cspec, seed, distinct):
    """Slot staging of [key | payload | count] rows: a valid prefix per region,
    keys below G (distinct inside a region when asked), some >= 2**31."""
    from sparkucx_tpu_torch.ops.compress import quantize_rows

    rng = np.random.default_rng(seed)
    g = cspec.num_groups
    rows = np.zeros((n * n * slot, cspec.row_width), np.int32)
    for region in range(n * n):
        k = int(rng.integers(0, min(slot, g) + 1))
        keys = rng.permutation(g)[:k] if distinct else rng.integers(0, g, size=k)
        keys = keys.astype(np.int64)
        keys[rng.random(k) < 0.05] = 2**31 + 5  # outside the domain: no group
        base = region * slot
        rows[base : base + k, 0] = keys.astype(np.uint32).view(np.int32)
        rows[base : base + k, -1] = rng.integers(1, 5, size=k)
        if cspec.dtype == np.int32:
            rows[base : base + k, 1:-1] = rng.integers(-1000, 1000, size=(k, cspec.width))
        else:
            vals = rng.normal(size=(k, cspec.width)).astype(np.float32) * 100
            payload = vals if cspec.qspec is None else quantize_rows(cspec.qspec, torch.from_numpy(vals)).numpy()
            rows[base : base + k, 1:-1] = payload.view(np.int32)
    return torch.from_numpy(rows).to(device).view(cspec.torch_dtype)


_K4_CASES = [
    # groups, aggs, dtype, quantize, distinct keys in a window
    (1, ("sum", "min", "max"), np.int32, "off", False),
    (8, ("sum", "min", "max", "avg"), np.int32, "off", False),
    (1024, ("sum", "max"), np.int32, "off", False),
    (8, ("sum", "min", "max"), np.float32, "off", True),
    (64, ("sum", "avg"), np.float32, "int8", True),
    (64, ("sum", "max"), np.float32, "blockfloat", True),
    (1 << 20, ("sum", "min", "max"), np.int32, "off", False),
    (1 << 20, ("sum", "max"), np.float32, "off", True),
]


@pytest.mark.parametrize("groups,aggs,dtype,qmode,distinct", _K4_CASES)
@pytest.mark.parametrize("n,chunks", [(2, 1), (4, 2)])
def test_ring_combine_grid_matches_plain(cuda, groups, aggs, dtype, qmode, distinct, n, chunks):
    from sparkucx_tpu_torch.ops.combine import CombineSpec
    from sparkucx_tpu_torch.ops.ici_exchange import ring_schedule
    from sparkucx_tpu_torch.ops.ring_kernels import ring_combine_grid, ring_combine_grid_ref

    cspec = CombineSpec(groups, aggs, dtype, quantize_mode=qmode, quantize_block=8)
    slot = 512 * chunks
    data = _combine_data(cuda, n, slot, cspec, seed=groups + n, distinct=distinct)
    steps = ring_schedule(n, chunks).raw_steps()
    before = ring_combine_grid.launches
    grid, av, ac = ring_combine_grid(n, slot, slot // chunks, steps, cspec, data)
    again = ring_combine_grid(n, slot, slot // chunks, steps, cspec, data)
    torch.cuda.synchronize()
    assert ring_combine_grid.launches == before + 2
    pg, pv, pc = ring_combine_grid_ref(n, slot, slot // chunks, steps, cspec, data)
    assert torch.equal(grid.view(torch.int32), pg.view(torch.int32))
    assert torch.equal(ac, pc)
    assert torch.equal(av.view(torch.int32), pv.view(torch.int32))
    for a, b in zip((grid, av, ac), again):  # deterministic
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("groups", [8, 1 << 20])
def test_ring_combine_float_duplicates_are_deterministic(cuda, groups):
    from sparkucx_tpu_torch.ops.combine import CombineSpec
    from sparkucx_tpu_torch.ops.ici_exchange import ring_schedule
    from sparkucx_tpu_torch.ops.ring_kernels import ring_combine_grid, ring_combine_grid_ref

    cspec = CombineSpec(groups, ("sum", "min"), np.float32)
    n, slot = 4, 1024
    data = _combine_data(cuda, n, slot, cspec, seed=99, distinct=False)
    steps = ring_schedule(n, 2).raw_steps()
    _, av, ac = ring_combine_grid(n, slot, slot // 2, steps, cspec, data)
    _, bv, bc = ring_combine_grid(n, slot, slot // 2, steps, cspec, data)
    _, pv, pc = ring_combine_grid_ref(n, slot, slot // 2, steps, cspec, data.cpu())
    torch.cuda.synchronize()
    assert torch.equal(av.view(torch.int32), bv.view(torch.int32)) and torch.equal(ac, bc)
    assert torch.equal(ac.cpu(), pc)
    torch.testing.assert_close(av.cpu(), pv, rtol=1e-5, atol=1e-3)


def test_fused_group_by_on_the_card_goes_through_k4(cuda):
    from sparkucx_tpu_torch.ops.relational import AggregateSpec, oracle_aggregate, run_grouped_aggregate
    from sparkucx_tpu_torch.ops.ring_kernels import ring_combine_grid

    rng = np.random.default_rng(4)
    keys = rng.integers(0, 60, size=5000).astype(np.uint32)
    vals = rng.integers(-100, 100, size=(5000, 3)).astype(np.int32)
    spec = AggregateSpec(4, 1300, 256, ("sum", "min", "max"), partial=True, combine="auto")
    before = ring_combine_grid.launches
    got = run_grouped_aggregate(["cuda"] * 4, spec, keys, vals)
    assert ring_combine_grid.launches > before
    ref = run_grouped_aggregate(["cuda"] * 4, replace(spec, combine="off"), keys, vals)
    for a, b, c in zip(got, ref, oracle_aggregate(keys, vals, spec.aggs)):
        assert np.array_equal(a, b) and np.array_equal(a, c)


def test_pallas_superstep_on_the_card_goes_through_k3(cuda):
    from sparkucx_tpu_torch.ops.exchange import ExchangeSpec, build_exchange
    from sparkucx_tpu_torch.ops.ici_exchange import build_ici_exchange
    from sparkucx_tpu_torch.ops.ring_kernels import ring_exchange_grid

    n, slot, lane = 4, 256, 128
    rng = np.random.default_rng(8)
    sizes = rng.integers(0, slot + 1, size=(n, n)).astype(np.int32)
    data = _ring_data(cuda, n, slot, lane, seed=8)
    spec = ExchangeSpec(n, n * slot, n * slot, lane)
    before = ring_exchange_grid.launches
    recv, rs = build_ici_exchange(["cuda"] * n, spec, chunks_per_dest=2)(data, sizes)
    assert ring_exchange_grid.launches == before + 1
    want, ws = build_exchange(["cuda"] * n, spec)(data, sizes)
    torch.cuda.synchronize()
    assert torch.equal(rs, ws)
    for j in range(n):
        rows = int(sizes[:, j].sum())
        assert torch.equal(recv[j * n * slot : j * n * slot + rows], want[j * n * slot : j * n * slot + rows])


# -- K5: the fused send side (csrc/ring_exchange.cu fused_scatter_launch)


def _fused_case(device, n, slot, lane, seed, per_dest=3):
    """Ragged blocks (some empty) back to back in each destination slot, count-0
    pads at the packed end, and a stale staging whose uncovered rows carry."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, slot // per_dest + 1, size=(n, n, per_dest))
    lens[rng.random(lens.shape) < 0.2] = 0
    nb = n * per_dest + 2
    p_rows = max(1, int(lens.sum(axis=(1, 2)).max()))
    starts, counts, outs = (np.zeros((n, nb), np.int32) for _ in range(3))
    for i in range(n):
        off, b = 0, 0
        for j in range(n):
            at = j * slot
            for k in range(per_dest):
                c = int(lens[i, j, k])
                starts[i, b], counts[i, b], outs[i, b] = at, c, off
                at, off, b = at + c, off + c, b + 1
        outs[i, b:] = off
    plan = [torch.from_numpy(a).to(device) for a in (starts, counts, outs)]
    packed = _ring_data(device, 1, p_rows * n, lane, seed=seed + 1)[: n * p_rows].contiguous()
    staging = _ring_data(device, n, slot, lane, seed=seed + 2)
    return plan, packed, staging


@pytest.mark.parametrize("n,chunks", [(2, 1), (3, 2), (4, 2), (8, 4)])
@pytest.mark.parametrize("lane", [128, 9])
def test_fused_scatter_ring_grid_matches_plain(cuda, n, chunks, lane):
    from sparkucx_tpu_torch.ops.block_kernels import block_scatter
    from sparkucx_tpu_torch.ops.ici_exchange import ring_schedule
    from sparkucx_tpu_torch.ops.ring_kernels import (
        fused_scatter_ring_grid, fused_scatter_ring_grid_ref, ring_exchange_grid,
    )

    slot = 300 * chunks
    plan, packed, staging = _fused_case(cuda, n, slot, lane, seed=n * 7 + lane)
    steps = ring_schedule(n, chunks).raw_steps()
    ref_staging = staging.clone()
    counts = [k.launches for k in (fused_scatter_ring_grid, block_scatter, ring_exchange_grid)]
    got = fused_scatter_ring_grid(n, slot, slot // chunks, steps, *plan, packed, staging)
    torch.cuda.synchronize()
    assert [k.launches for k in (fused_scatter_ring_grid, block_scatter, ring_exchange_grid)] == [
        counts[0] + 1, counts[1], counts[2]]
    want = fused_scatter_ring_grid_ref(n, slot, slot // chunks, steps, *plan, packed, ref_staging)
    assert torch.equal(staging, ref_staging), "the staging is scattered in place"
    assert torch.equal(got, want)
    again = fused_scatter_ring_grid(n, slot, slot // chunks, steps, *plan, packed, staging.clone())
    torch.cuda.synchronize()
    assert torch.equal(again, got)


def test_fused_scatter_cooperative_grid_is_resident(cuda):
    from sparkucx_tpu_torch.ops.ring_kernels import fused_scatter_grid_ctas

    props = torch.cuda.get_device_properties(cuda)
    assert torch.cuda.get_device_capability(cuda) >= (9, 0)
    for wide in (True, False):
        ctas = fused_scatter_grid_ctas(wide)
        # every CTA resident at once: a whole number of CTAs per SM, at most
        # the SM's 2048 threads / 256
        assert ctas % props.multi_processor_count == 0
        assert 1 <= ctas // props.multi_processor_count <= 8


@pytest.mark.parametrize("impl", ["stock", "pallas"])
@pytest.mark.parametrize("mode", ["array", "device"])
def test_chunked_run_exchange_on_the_card(cuda, impl, mode):
    from sparkucx_tpu_torch.config import TpuShuffleConf
    from sparkucx_tpu_torch.core.block import ShuffleBlockId
    from sparkucx_tpu_torch.transport.tpu import TpuShuffleCluster

    n, m_count, r_count = 4, 12, 8
    conf = TpuShuffleConf(staging_capacity_per_executor=n * 8192, block_alignment=128, host_recv_mode=mode,
                          keep_device_recv=True, slot_quota_rows=8, pipeline_depth=2, exchange_impl=impl,
                          device_staging=True)
    cluster = TpuShuffleCluster(conf, devices=["cuda"] * n)
    meta = cluster.create_shuffle(0, m_count, r_count)
    rng = np.random.default_rng(12)
    written = {}
    for m in range(m_count):
        t = cluster.transport(meta.map_owner[m])
        w = t.store.map_writer(0, m)
        for r in range(r_count):
            rows = int(rng.integers(10, 20)) if r == 0 else int(rng.integers(0, 3))  # reducer 0 is hot
            block = torch.from_numpy(rng.integers(-9, 9, size=(rows, 32), dtype=np.int32)).to(cuda)
            written[(m, r)] = block
            w.write_partition_device(r, block, length=rows * 128)
        t.commit_block(w.commit().pack())
    cluster.run_exchange(0)
    assert cluster.stats.summary("exchange.pipeline.drain").ops > 1  # chunked: several sub-rounds
    for r in range(r_count):
        j = meta.owner_of_reduce(r)
        packed, entries = cluster.transport(j).fetch_blocks_device([ShuffleBlockId(0, m, r) for m in range(m_count)])
        assert torch.equal(packed, torch.cat([written[(m, r)] for m in range(m_count)]))


def _behind_a_busy_stream(device):
    """Queue half a second of device work on the current stream; returns an
    event behind it, not yet reached."""
    torch.cuda.synchronize(device)
    torch.cuda._sleep(int(1e9))
    busy = torch.cuda.Event()
    busy.record(torch.cuda.current_stream(device))
    return busy


def test_upload_does_not_wait_for_the_stream(cuda):
    from sparkucx_tpu_torch.utils.devices import upload

    a = np.arange(1 << 16, dtype=np.int64)
    upload(a, cuda)  # warm the page-locked cache: its first allocation may synchronize
    busy = _behind_a_busy_stream(cuda)
    t = upload(a, cuda)
    assert not busy.query(), "upload waited for the work queued before it"
    a[:] = 0  # the page-locked staging copy was taken at the call
    torch.cuda.synchronize(cuda)
    assert np.array_equal(t.cpu().numpy(), np.arange(1 << 16))


def test_kernel_tables_upload_without_waiting(cuda):
    """K1's plan and K3's window tables go up behind queued work without the
    host waiting for it, and the kernels still read them right."""
    from sparkucx_tpu_torch.ops.ici_exchange import ring_schedule
    from sparkucx_tpu_torch.ops.ring_kernels import ring_exchange_grid, ring_exchange_grid_ref

    n, slot, lane = 4, 64, 32
    data = _ring_data(cuda, n, slot, lane, seed=3)
    steps = ring_schedule(n, 2).raw_steps()
    starts, counts, outs = _plan(4, 16, data.shape[0], 40)

    def launch():
        grid = ring_exchange_grid(n, slot, slot // 2, steps, data)
        p = plan_tensors(starts, counts, outs, cuda)
        return grid, p, block_gather(*p, data, int(counts.sum()))

    launch()  # build the kernels and warm the page-locked cache first
    busy = _behind_a_busy_stream(cuda)
    grid, p, got = launch()
    assert not busy.query(), "a table upload waited for the work queued before it"
    torch.cuda.synchronize(cuda)
    assert torch.equal(grid, ring_exchange_grid_ref(n, slot, slot // 2, steps, data))
    assert torch.equal(got, block_gather_ref(*p, data, int(counts.sum())))
