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
