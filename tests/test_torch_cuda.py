"""Kernel-against-plain checks for the card: the Hopper block gather and block
scatter (sparkucx_tpu_torch/csrc/block_copy.cu), the radix sort and its pass
(csrc/radix_sort.cu) and the ring kernels (csrc/ring_exchange.cu) against
their plain PyTorch versions on CUDA tensors,
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
from sparkucx_tpu_torch.ops.radix import (
    TILE_ROWS,
    radix_pass,
    radix_pass_ref,
    radix_sort_rows,
    radix_sort_rows_ref,
)
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


#: K1's row widths on the paths: 4 B, 12 B (Q18), 36 B (Q1), 100 B (TeraSort), 512 B
_K1_LANES = [1, 3, 9, 25, 128]


@pytest.mark.parametrize("lane", _K1_LANES)
@pytest.mark.parametrize("offset", [0, 1, 3])
def test_gather_byte_spans_at_every_row_width(cuda, lane, offset):
    """Ragged blocks, empty blocks and count-0 pads, into ``out`` a row slice
    ``offset`` rows into a larger buffer (off 16 bytes for most widths):
    every byte of the buffer equal to the plain version's, rows past the
    packed total and outside the slice left as they were."""
    src = torch.randint(-(2**31), 2**31 - 1, (5000, lane), dtype=torch.int32, device=cuda)
    starts, counts, outs = _plan(lane + offset, 400, 5000, 60)
    total = int(counts.sum())
    starts, counts, outs = (np.concatenate([a, [0, 0, 0]]).astype(np.int32) for a in (starts, counts, outs))
    outs[-3:] = total
    s, c, o = plan_tensors(starts, counts, outs, cuda)
    out_rows = total + 7
    buf = torch.randint(-(2**31), 2**31 - 1, (out_rows + offset + 5, lane), dtype=torch.int32, device=cuda)
    want = buf.clone()
    block_gather_ref(s, c, o, src, out_rows, out=want[offset : offset + out_rows])
    got = block_gather(s, c, o, src, out_rows, out=buf[offset : offset + out_rows])
    torch.cuda.synchronize()
    assert got.data_ptr() == buf[offset:].data_ptr()
    assert torch.equal(buf, want)


def test_gather_forty_thousand_one_row_blocks(cuda):
    for lane in (3, 128):
        src = torch.randint(-(2**31), 2**31 - 1, (50_000, lane), dtype=torch.int32, device=cuda)
        starts = np.random.default_rng(lane).permutation(50_000)[:40_000].astype(np.int32)
        counts = np.ones(40_000, np.int32)
        p = plan_tensors(starts, counts, np.arange(40_000, dtype=np.int32), cuda)
        got = block_gather(*p, src, 40_000)
        torch.cuda.synchronize()
        assert torch.equal(got, src[torch.from_numpy(starts).to(cuda).long()])


def test_gather_zero_count_plans_are_no_ops(cuda):
    src = torch.randint(0, 1 << 30, (64, 9), dtype=torch.int32, device=cuda)
    out = torch.full((16, 9), 7, dtype=torch.int32, device=cuda)
    before = block_gather.launches
    for plan in (([], [], []), ([3, 5], [0, 0], [0, 0])):
        block_gather(*plan_tensors(*plan, cuda), src, 16, out=out)
        torch.cuda.synchronize()
        assert torch.equal(out, torch.full_like(out, 7))
    assert block_gather.launches == before + 1  # B = 0 launches nothing; the pads launch and copy nothing


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


def _radix_case(device, name):
    """The rows of one named K6 case (sizes in rows of 100 B unless named)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(sum(name.encode()))

    def rand(n, width=25):
        return torch.randint(-(2**31), 2**31 - 1, (n, width), dtype=torch.int32, generator=gen, device=device)

    if name.startswith("N="):
        return rand(int(name[2:]))
    if name == "one whole tile":
        return rand(TILE_ROWS)
    if name == "one row past a tile":
        return rand(TILE_ROWS + 1)
    if name in ("all keys 7", "all keys 0xFFFFFFFF"):
        rows = rand(50_000)
        rows[:, 0] = 7 if name == "all keys 7" else -1
        return rows
    if name == "keys >= 2**31":
        rows = rand(200_000)
        rows[:, 0] |= -(2**31)
        rows[::2, 0] &= 2**31 - 1
        return rows
    if name == "three keys, payload = row id":
        n = 1_000_000
        keys = torch.randint(0, 3, (n,), dtype=torch.int32, generator=gen, device=device)
        return torch.stack([keys, torch.arange(n, dtype=torch.int32, device=device)], dim=1)
    if name.startswith("width "):
        return rand(70_001, int(name[6:]))
    if name == "float32 rows":
        return rand(100_000).view(torch.float32)
    if name == "past 2**31 bytes":
        return rand(22_000_000)
    raise ValueError(name)


_RADIX_CASES = ["N=0", "N=1", "N=2", "one whole tile", "one row past a tile", "all keys 7", "all keys 0xFFFFFFFF",
                "keys >= 2**31", "three keys, payload = row id", "width 1", "width 2", "width 25", "float32 rows",
                "past 2**31 bytes"]


@pytest.mark.parametrize("name", _RADIX_CASES)
def test_radix_sort_rows_matches_plain(cuda, name):
    rows = _radix_case(cuda, name)
    keep = rows.clone()
    before = radix_sort_rows.launches
    got = radix_sort_rows(rows)
    torch.cuda.synchronize()
    assert radix_sort_rows.launches == before + (1 if rows.shape[0] else 0)
    assert torch.equal(rows.view(torch.int32), keep.view(torch.int32)), "the input was written"
    want = radix_sort_rows_ref(rows)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    if name == "three keys, payload = row id":  # stable: equal keys keep their row order
        keys = got[:, 0].to(torch.int64)
        ids = got[:, 1].to(torch.int64)
        same = keys[1:] == keys[:-1]
        assert bool((ids[1:][same] > ids[:-1][same]).all())


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


def test_ring_exchange_grid_off_the_16_byte_alignment(cuda):
    """A staging view that starts 4 bytes past a 16-byte boundary: every
    piece takes the 4-byte word path."""
    from sparkucx_tpu_torch.ops.ici_exchange import ring_schedule
    from sparkucx_tpu_torch.ops.ring_kernels import ring_exchange_grid, ring_exchange_grid_ref

    n, slot, lane, chunks = 4, 4096, 32, 2
    flat = _ring_data(cuda, 1, n * n * slot * lane + 1, 1, seed=5).view(-1)
    data = flat[1 : 1 + n * n * slot * lane].view(n * n * slot, lane)
    assert data.data_ptr() % 16 == 4 and data.is_contiguous()
    steps = ring_schedule(n, chunks).raw_steps()
    got = ring_exchange_grid(n, slot, slot // chunks, steps, data)
    torch.cuda.synchronize()
    assert torch.equal(got, ring_exchange_grid_ref(n, slot, slot // chunks, steps, data))


@pytest.mark.parametrize("n", [64, 65, 130])
@pytest.mark.parametrize("lane", [32, 9])
def test_ring_exchange_grid_past_one_receiver_group(cuda, n, lane):
    """One launch a group of MAX_EXECUTORS receivers, bit-equal at 64 (one
    group), 65 and 130 executors."""
    from sparkucx_tpu_torch.ops.ici_exchange import ring_schedule
    from sparkucx_tpu_torch.ops.ring_kernels import ring_exchange_grid, ring_exchange_grid_ref

    slot = 4
    data = _ring_data(cuda, n, slot, lane, seed=n + lane)
    steps = ring_schedule(n, 2).raw_steps()
    got = ring_exchange_grid(n, slot, slot // 2, steps, data)
    torch.cuda.synchronize()
    assert torch.equal(got, ring_exchange_grid_ref(n, slot, slot // 2, steps, data))
    assert torch.equal(got, data.view(n, n, slot, lane).transpose(0, 1).reshape(-1, lane))


def test_ring_exchange_grid_two_calls_on_one_cached_schedule(cuda):
    """Two stagings through one cached window table land in two grids, each
    its own staging's transpose; the second call adds no table."""
    from sparkucx_tpu_torch.ops import ring_kernels
    from sparkucx_tpu_torch.ops.ici_exchange import ring_schedule

    n, slot, lane = 8, 2048, 128
    steps = ring_schedule(n, 4).raw_steps()
    a = _ring_data(cuda, n, slot, lane, seed=21)
    b = _ring_data(cuda, n, slot, lane, seed=22)
    ga = ring_kernels.ring_exchange_grid(n, slot, slot // 4, steps, a)
    tables = len(ring_kernels._window_tables)
    table = ring_kernels.window_table(n, slot, slot // 4, steps, a.device)
    gb = ring_kernels.ring_exchange_grid(n, slot, slot // 4, steps, b)
    torch.cuda.synchronize()
    assert len(ring_kernels._window_tables) == tables
    assert ring_kernels.window_table(n, slot, slot // 4, steps, b.device) is table
    assert ga.data_ptr() != gb.data_ptr()
    assert torch.equal(ga, a.view(n, n, slot, lane).transpose(0, 1).reshape(-1, lane))
    assert torch.equal(gb, b.view(n, n, slot, lane).transpose(0, 1).reshape(-1, lane))


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


@pytest.mark.parametrize("width", [2, 3])
def test_ring_combine_global_tier_copies_through_k3(cuda, width):
    """The global tier lands its grid with K3's launch (16-byte rows at
    width 2, 4-byte words at 3) on a schedule already in K3's cache, then
    folds in rounds."""
    from sparkucx_tpu_torch.ops import ring_kernels
    from sparkucx_tpu_torch.ops.combine import CombineSpec
    from sparkucx_tpu_torch.ops.ici_exchange import ring_schedule

    cspec = CombineSpec(1 << 20, ("sum", "max", "min")[:width], np.int32)
    assert ring_kernels.ring_combine_tier(cspec) == "global"
    n, slot = 4, 2048
    data = _combine_data(cuda, n, slot, cspec, seed=70 + width, distinct=False)
    steps = ring_schedule(n, 2).raw_steps()
    k3 = ring_kernels.ring_exchange_grid(n, slot, slot // 2, steps, data)
    before = ring_kernels.ring_combine_grid.launches
    grid, av, ac = ring_kernels.ring_combine_grid(n, slot, slot // 2, steps, cspec, data)
    torch.cuda.synchronize()
    assert ring_kernels.ring_combine_grid.launches == before + 1
    pg, pv, pc = ring_kernels.ring_combine_grid_ref(n, slot, slot // 2, steps, cspec, data)
    assert torch.equal(grid, k3) and torch.equal(grid, pg)
    assert torch.equal(ac, pc) and torch.equal(av, pv)


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


#: NaNs of three bit patterns: np.nan, another positive one, a negative one
#: (x86's 0/0); min and max pass on the bits of the NaN they pick
_NANS = np.array([0x7FC00000, 0x7FC00001, 0xFFC00000], np.uint32).view(np.float32)


def _signed_staging(device, n, slot, cspec, seed, distinct):
    """``_combine_data`` with the float payload drawn from {-0.0, +0.0, -1.5,
    2.5} and the NaNs ``_NANS``: every group sees both zeros, in both orders,
    and some a NaN."""
    data = _combine_data(device, n, slot, cspec, seed, distinct).view(torch.int32)
    rng = np.random.default_rng(seed + 1)
    pool = np.concatenate([np.array([-0.0, 0.0, -1.5, 2.5], np.float32).view(np.int32), _NANS.view(np.int32)])
    pick = rng.integers(0, pool.size, size=(data.shape[0], cspec.width))
    zeros = rng.random(pick.shape) < 0.8  # mostly a zero of either sign
    pick[zeros] = rng.integers(0, 2, size=int(zeros.sum()))
    valid = data[:, -1] > 0
    payload = torch.from_numpy(pool[pick]).to(device)
    data[:, 1:-1] = torch.where(valid[:, None], payload, data[:, 1:-1])
    return data.view(torch.float32)


_SIGNED_K4 = [
    # groups, aggs, distinct keys in a window; 8 groups: shared tier, 2**20: global
    (8, ("min", "max", "sum"), True),
    (8, ("max", "min"), False),
    (1 << 20, ("min", "max"), False),  # no float sum: the one-pass atomic fold
    (1 << 20, ("sum", "min", "max"), True),  # a float sum: the ordered cooperative fold
]


@pytest.mark.parametrize("groups,aggs,distinct", _SIGNED_K4)
def test_ring_combine_signed_zeros_and_nan_bit_equal(cuda, groups, aggs, distinct):
    """Min and max on the JAX package's order (-0.0 below +0.0, a NaN's own
    bits passed on) on both tiers, bit-equal to ``ring_combine_grid_ref`` and
    across two calls."""
    from sparkucx_tpu_torch.ops.combine import CombineSpec
    from sparkucx_tpu_torch.ops.ici_exchange import ring_schedule
    from sparkucx_tpu_torch.ops.ring_kernels import ring_combine_grid, ring_combine_grid_ref

    cspec = CombineSpec(groups, aggs, np.float32)
    n, slot = 4, 1024
    data = _signed_staging(cuda, n, slot, cspec, seed=groups + len(aggs), distinct=distinct)
    steps = ring_schedule(n, 2).raw_steps()
    first = ring_combine_grid(n, slot, slot // 2, steps, cspec, data)
    again = ring_combine_grid(n, slot, slot // 2, steps, cspec, data)
    want = ring_combine_grid_ref(n, slot, slot // 2, steps, cspec, data)
    torch.cuda.synchronize()
    for a, b, c in zip(first, again, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        assert torch.equal(a.view(torch.int32), c.view(torch.int32))
    bits = first[1].view(torch.int32)
    other_nans = torch.from_numpy(_NANS[1:].view(np.int32).copy()).to(cuda)
    assert bool(torch.isin(bits, other_nans).any()) and bool((bits == -(2**31)).any())  # such a NaN and -0.0


@pytest.mark.parametrize("cspec_args", [((1 << 14, ("sum",), np.int32), False),
                                        ((1 << 14, ("sum", "max"), np.float32), True)])
def test_ring_combine_global_tier_past_one_receiver_group(cuda, cspec_args):
    """K4's global tier at n = 65 executors with tiny slots: two receiver
    groups, bit-equal to the plain version (and K3's grid)."""
    from sparkucx_tpu_torch.ops.combine import CombineSpec
    from sparkucx_tpu_torch.ops.ici_exchange import ring_schedule
    from sparkucx_tpu_torch.ops.ring_kernels import ring_combine_grid, ring_combine_grid_ref, ring_combine_tier

    (groups, aggs, dtype), distinct = cspec_args
    cspec = CombineSpec(groups, aggs, dtype)
    assert ring_combine_tier(cspec) == "global"
    n, slot = 65, 4
    data = _combine_data(cuda, n, slot, cspec, seed=65, distinct=distinct)
    steps = ring_schedule(n, 2).raw_steps()
    got = ring_combine_grid(n, slot, slot // 2, steps, cspec, data)
    want = ring_combine_grid_ref(n, slot, slot // 2, steps, cspec, data)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("dtype,aggs", [(np.int32, ("sum",)), (np.float32, ("sum", "min"))])
def test_ring_combine_global_tier_never_waits_for_the_device(cuda, dtype, aggs):
    """The global tier's call issues its launches and returns: under
    ``torch.cuda.set_sync_debug_mode("error")`` a host sync inside it
    raises.  A first call outside builds the library; the checked call
    takes a schedule not yet in the table cache (its upload included)."""
    from sparkucx_tpu_torch.ops.combine import CombineSpec
    from sparkucx_tpu_torch.ops.ici_exchange import ring_schedule
    from sparkucx_tpu_torch.ops.ring_kernels import ring_combine_grid, ring_combine_grid_ref, ring_combine_tier

    cspec = CombineSpec(1 << 20, aggs, dtype)
    assert ring_combine_tier(cspec) == "global"
    n, slot = 4, 1536
    data = _combine_data(cuda, n, slot, cspec, seed=7, distinct=True)
    ring_combine_grid(n, slot, slot // 2, ring_schedule(n, 2).raw_steps(), cspec, data)
    steps = ring_schedule(n, 3).raw_steps()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = ring_combine_grid(n, slot, slot // 3, steps, cspec, data)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = ring_combine_grid_ref(n, slot, slot // 3, steps, cspec, data)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


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


@pytest.mark.parametrize("combine", ["off", "dense"])
def test_group_by_float_min_max_on_the_card_matches_the_cpu(cuda, combine):
    """The unfused GROUP BY's segment reduce and the fused route's K4 on
    CUDA tensors give the CPU route's bits (the JAX package's, as
    tests/test_torch_relational.py holds them) over both signed zeros and
    NaN."""
    from sparkucx_tpu_torch.ops.relational import AggregateSpec, run_grouped_aggregate

    rng = np.random.default_rng(11)
    keys = rng.integers(0, 40, size=4000).astype(np.uint32)
    vals = np.where(rng.random((4000, 2)) < 0.5, np.float32(-0.0), np.float32(0.0))  # zeros of both signs
    draw = rng.random(vals.shape)
    vals[draw < 0.005] = _NANS[rng.integers(0, _NANS.size, size=int((draw < 0.005).sum()))]  # some groups meet none
    vals[(draw >= 0.005) & (draw < 0.01)] = np.float32(1.0)
    spec = AggregateSpec(4, 1000, 256, ("min", "max"), dtype=np.dtype(np.float32), partial=True, combine=combine,
                         combine_groups=64 if combine == "dense" else 0)
    got = run_grouped_aggregate(["cuda"] * 4, spec, keys, vals)
    want = run_grouped_aggregate(["cpu"] * 4, spec, keys, vals)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a.view(np.uint8), b.view(np.uint8))


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


@pytest.mark.parametrize("join_type", ["inner", "left_outer", "left_semi", "left_anti", "right_outer", "full_outer"])
def test_hash_join_on_the_card_matches_the_cpu(cuda, join_type):
    """``build_hash_join`` on CUDA executors: every output buffer bit-equal to
    the CPU route's (the JAX package's, as tests/test_torch_join.py holds
    it), K1 launched once a receiver and side."""
    from sparkucx_tpu_torch.ops.relational import JoinSpec, build_hash_join

    n, cap = 4, 300
    rng = np.random.default_rng(21)
    bk = rng.integers(0, 200, size=n * cap).astype(np.int64)
    pk = rng.integers(100, 300, size=n * cap).astype(np.int64)
    bk[:3] = 0xFFFFFFFF
    pk[5:7] = 0xFFFFFFFF
    bv = rng.integers(-99, 99, size=(n * cap, 2)).astype(np.int32)
    pv = rng.integers(-99, 99, size=(n * cap, 3)).astype(np.int32)
    bn, pn = np.array([cap, 0, 17, cap - 1]), np.array([cap, cap, 1, 250])
    spec = JoinSpec(n, cap, n * cap, 2, cap, n * cap, 3, 4 * n * cap, join_type=join_type)
    outs = {}
    for dev in ("cpu", cuda):
        t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        before = block_gather.launches
        outs[str(dev)] = build_hash_join([dev] * n, spec)(t(bk), t(bv), bn, t(pk), t(pv), pn)
        if dev is cuda:
            torch.cuda.synchronize()
            assert block_gather.launches - before == 2 * n
    cpu, card = outs["cpu"], outs[str(cuda)]
    assert int(card[3].sum()) > 0
    for a, b in zip(cpu, card):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b.cpu())
        else:
            assert np.array_equal(a, b)


def test_transitive_closure_on_the_card_matches_the_cpu(cuda):
    from sparkucx_tpu_torch.ops.tc import TcSpec, oracle_tc, run_transitive_closure

    rng = np.random.default_rng(3)
    edges = rng.integers(0, 60, size=(120, 2)).astype(np.uint32)
    edges[:10] += np.uint32(2**31)  # vertex ids past 2**31
    spec = TcSpec(4, 64, 2048, 4096)
    before = block_gather.launches
    got, rounds = run_transitive_closure(["cuda"] * 4, spec, edges)
    assert block_gather.launches - before == 4 * (1 + 2 * rounds)
    want, want_rounds = run_transitive_closure(["cpu"] * 4, spec, edges)
    assert rounds == want_rounds and np.array_equal(got, want)
    assert np.array_equal(got, oracle_tc(edges))


def test_plan_driven_aggregate_on_the_card_goes_through_k4(cuda):
    from sparkucx_tpu_torch.ops.relational import AggregateSpec, run_grouped_aggregate, run_plan_grouped_aggregate
    from sparkucx_tpu_torch.ops.ring_kernels import ring_combine_grid
    from sparkucx_tpu_torch.ops.skew import ExchangePlan

    rng = np.random.default_rng(6)
    keys = rng.integers(0, 60, size=3000).astype(np.uint32)
    vals = rng.integers(-100, 100, size=(3000, 3)).astype(np.int32)
    spec = AggregateSpec(4, 800, 256, ("sum", "min", "max"), partial=True, combine="dense", combine_groups=64)
    plan = ExchangePlan(slot_rows=256, chunks_per_round=(4,), combine="dense")
    before = ring_combine_grid.launches
    got = run_plan_grouped_aggregate(["cuda"] * 4, spec, plan, keys, vals)
    assert ring_combine_grid.launches - before == 4
    want = run_grouped_aggregate(["cpu"] * 4, replace(spec, combine="off"), keys, vals)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32, torch.int64])
def test_take_rows_of_16_bytes_moves_bits(cuda, dtype):
    """ops/columnar.take_rows gathers 16-byte rows as complex128 elements:
    every bit moved as ``index_select`` moves it, NaN payloads included."""
    from sparkucx_tpu_torch.ops.columnar import take_rows

    lanes = 16 // torch.empty(0, dtype=dtype).element_size()
    bits = torch.randint(-(2**31), 2**31 - 1, (5000, 16 // 4), dtype=torch.int32, device=cuda)
    bits[:4, 0] = torch.tensor([0x7FC00001, 0x7F800001, -4194303, -1], dtype=torch.int32, device=cuda)
    rows = bits.view(dtype).view(-1, lanes)
    idx = torch.randperm(5000, device=cuda)
    got = take_rows(rows, idx)
    assert got.dtype == dtype and got.shape == (5000, lanes)
    assert torch.equal(got.view(torch.int32), rows.index_select(0, idx).view(torch.int32))


# -- the benchmark CLI's modes (perf/benchmark.py), with phase 20's counts ------------


def _chip_smoke():
    """chip_smoke.py at the root of the repository: the launch counts of
    phase 20 (``mode_launches``) stand there alone."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("argv", [
    "superstep -s 8k -i 1 -o 2 --executors 4",
    "gather -n 4 -s 4k -i 2 -o 3",
    "write -n 4 -s 4k -i 2 --impl host,device",
    "pipeline --executors 4 -n 3 -s 64k --depths 1,2 -i 1",
    "skew --executors 4 -s 150k -i 2",
    "adaptive --executors 4 -s 256k -i 1",
    "sort -n 3000 -i 1 -o 2 --sort-impl radix",
    "sort -n 3000 -i 1 -o 2 --executors 4",
    "sort -n 3000 -i 1 --executors 2 --batches 3",
    "columnar -n 3000 -s 100 -i 1 -o 2 --executors 4",
    "groupby -n 3000 -i 1 -o 2 --executors 4 --keys 50",
    "groupby -n 3000 -i 1 -o 2 --executors 4 --keys 50 --partial",
    "join -n 3000 -i 1 -o 2 --executors 4",
    "join -n 3000 -i 1 -o 2 --executors 4 --join-type full_outer",
    "combine --executors 4 -s 8k --keys 8 -i 1",
    "combine --executors 4 -s 8k --keys 40000 -i 1",
])
def test_benchmark_mode_launch_counts(cuda, capsys, argv):
    """Each mode at a tiny size on the card, its kernels launched as often as
    phase 20 of chip_smoke.py requires (``mode_launches``)."""
    from sparkucx_tpu_torch.ops.ring_kernels import ring_combine_grid, ring_exchange_grid
    from sparkucx_tpu_torch.perf import benchmark

    counters = {"K1": block_gather, "K2": block_scatter, "K3": ring_exchange_grid, "K4": ring_combine_grid,
                "K6": radix_sort_rows}
    before = {k: c.launches for k, c in counters.items()}
    assert benchmark.main(argv.split()) == 0
    got = {k: c.launches - before[k] for k, c in counters.items()}
    lines = capsys.readouterr().out.splitlines()
    want = _chip_smoke().mode_launches(benchmark._parse_args(argv.split()), lines)
    assert want
    for k, count in want.items():
        if isinstance(count, tuple):
            assert got[k] >= count[0], k
        else:
            assert got[k] == count, k
    assert any("GB/s" in ln or "rows/s" in ln for ln in lines)


def test_benchmark_cpu_lowerings_refused_on_the_card(cuda):
    from sparkucx_tpu_torch.perf import benchmark

    with pytest.raises(ValueError, match="on the card"):
        benchmark.measure_gather(2, 4096, 1, 1, impl="xla")


@pytest.mark.parametrize("n,chunks", [(2, 1), (4, 2), (8, 4)])
def test_ring_exchange_grid_at_132_byte_rows(cuda, n, chunks):
    """The quantized grid's rows: quantized_width(128) = 33 int32 lanes, 132
    bytes, off the 16-byte path (K3's 4-byte words)."""
    from sparkucx_tpu_torch.ops.ici_exchange import ring_schedule
    from sparkucx_tpu_torch.ops.ring_kernels import ring_exchange_grid, ring_exchange_grid_ref

    slot, lane = 1024 * chunks, 33
    data = _ring_data(cuda, n, slot, lane, seed=n + 132)
    steps = ring_schedule(n, chunks).raw_steps()
    got = ring_exchange_grid(n, slot, slot // chunks, steps, data)
    torch.cuda.synchronize()
    assert torch.equal(got, ring_exchange_grid_ref(n, slot, slot // chunks, steps, data))


def _quantized_counters():
    from sparkucx_tpu_torch.ops.ring_kernels import fused_scatter_ring_grid, ring_exchange_grid

    return {"K1": block_gather, "K2": block_scatter, "K3": ring_exchange_grid, "K5": fused_scatter_ring_grid}


@pytest.mark.parametrize("mode", ["int8", "blockfloat"])
def test_quantized_exchange_on_the_card_goes_through_k3_and_k1(cuda, mode):
    """``build_quantized_exchange`` and its fused twin on the card: K3 once
    and K1 once a receiver (K2 once an executor on the fused route, K5
    never), each route bit-equal to the same builder on the CPU."""
    from sparkucx_tpu_torch.ops.compress import QuantizeSpec
    from sparkucx_tpu_torch.ops.exchange import ExchangeSpec
    from sparkucx_tpu_torch.ops.ici_exchange import build_quantized_exchange, build_quantized_fused_exchange

    n, slot, lane = 4, 512, 128
    spec = ExchangeSpec(n, n * slot, n * slot, lane)
    q = QuantizeSpec(mode=mode, block_size=128)
    rng = np.random.default_rng(21)
    data = rng.standard_normal((n * n * slot, lane), dtype=np.float32)
    sizes = rng.integers(1, slot + 1, size=(n, n)).astype(np.int32)
    counters = _quantized_counters()
    before = {k: c.launches for k, c in counters.items()}
    got, rs = build_quantized_exchange([cuda] * n, spec, q)(torch.from_numpy(data).to(cuda), sizes)
    torch.cuda.synchronize()
    assert {k: c.launches - before[k] for k, c in counters.items()} == {"K1": n, "K2": 0, "K3": 1, "K5": 0}
    want, wrs = build_quantized_exchange(["cpu"] * n, spec, q)(torch.from_numpy(data), sizes)
    assert torch.equal(rs, wrs)
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))

    # the fused route: one block per (executor, destination), packed back to back
    starts = np.tile(np.arange(n, dtype=np.int32) * slot, (n, 1))
    counts = sizes.copy()
    outs = (np.cumsum(counts, axis=1) - counts).astype(np.int32)
    packed = rng.standard_normal((n * n * slot, lane), dtype=np.float32)
    put = lambda a: torch.from_numpy(a).to(cuda)
    fused = build_quantized_fused_exchange([cuda] * n, spec, q, n)
    before = {k: c.launches for k, c in counters.items()}
    got_f, _ = fused(put(starts), put(counts), put(outs), put(packed), torch.zeros_like(put(data)), sizes)
    torch.cuda.synchronize()
    assert {k: c.launches - before[k] for k, c in counters.items()} == {"K1": n, "K2": n, "K3": 1, "K5": 0}
    cpu = build_quantized_fused_exchange(["cpu"] * n, spec, q, n)
    want_f, _ = cpu(*(torch.from_numpy(a) for a in (starts, counts, outs, packed)), torch.zeros(data.shape), sizes)
    assert torch.equal(got_f.cpu().view(torch.int32), want_f.view(torch.int32))


@pytest.mark.parametrize("streams", [1, 4])
def test_block_server_over_a_device_staged_store(cuda, streams):
    """A BlockServer over a store staged on the card through
    ``write_partition_device`` and sealed by K2: a port PeerTransport fetches
    every block over loopback TCP, bytes equal to the written ones, with one
    K1 launch a fetch batch (the sealed round's blocks packed on the card and
    copied to the host once), and nothing on the host per block."""
    import time

    from sparkucx_tpu_torch.config import TpuShuffleConf
    from sparkucx_tpu_torch.core.block import MemoryBlock, ShuffleBlockId
    from sparkucx_tpu_torch.transport.peer import PeerTransport

    conf = TpuShuffleConf(staging_capacity_per_executor=8 << 20, block_alignment=512, device_staging=True,
                          wire_streams=streams, wire_chunk_bytes=64 << 10, max_blocks_per_request=16)
    rng = np.random.default_rng(30 + streams)
    server, client = PeerTransport(conf, executor_id=0, device=cuda), PeerTransport(conf, executor_id=1, device=cuda)
    try:
        client.add_executor(0, server.init())
        server.store.create_shuffle(0, 4, 8)
        payloads = {}
        for m in range(4):
            w = server.store.map_writer(0, m)
            for r in range(8):
                n = int(rng.integers(1, 20_000))
                raw = rng.integers(0, 256, size=-(-n // 512) * 512, dtype=np.uint8)
                payloads[(m, r)] = raw[:n].tobytes()
                w.write_partition_device(r, torch.from_numpy(raw.view(np.int32).reshape(-1, 128)).to(cuda), n)
            w.commit()
        scatter_before = block_scatter.launches
        server.store.seal(0)
        assert block_scatter.launches - scatter_before == 1
        keys = sorted(payloads)
        bufs = [MemoryBlock(np.zeros(len(payloads[k]), np.uint8), size=len(payloads[k])) for k in keys]
        before = block_gather.launches
        reqs = client.fetch_blocks_by_block_ids(0, [ShuffleBlockId(0, m, r) for m, r in keys], bufs, [None] * 32)
        deadline = time.monotonic() + 30
        while not all(r.completed() for r in reqs) and time.monotonic() < deadline:
            client.progress()
            client.wait_for_activity(0.002)
        for k, req, buf in zip(keys, reqs, bufs):
            assert req.wait(1).status.name == "SUCCESS"
            assert buf.host_view()[: buf.size].tobytes() == payloads[k]
        assert block_gather.launches - before == 2  # 32 blocks in batches of 16
    finally:
        client.close()
        server.close()
