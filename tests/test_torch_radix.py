"""The port's LSD radix sort (sparkucx_tpu_torch/ops/radix.py) against the JAX
package's Pallas radix sort (sparkucx_tpu/ops/radix.py, interpret mode on the
CPU, as tests/test_radix.py runs it) on the same seeded rows.

On CPU tensors the port runs ``radix_pass_ref``, the plain version the Hopper
kernel is held against on the card.  Tolerance 0: sorted rows must be bit-equal
(float32 rows are compared through their int32 view).  Sizes stay as small as
tests/test_radix.py keeps them: each JAX case runs eight interpreted passes."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkucx_tpu.ops import radix as jax_radix
from sparkucx_tpu_torch.ops import radix as torch_radix


def _rows(keys, width=1, rng=None):
    keys = np.asarray(keys, np.uint32)
    if rng is None:
        pay = np.arange(len(keys), dtype=np.int32)[:, None] * np.ones(width, np.int32)
    else:
        pay = rng.integers(-1000, 1000, size=(len(keys), width)).astype(np.int32)
    return np.concatenate([keys.view(np.int32)[:, None], pay], axis=1)


def _both(rows, tile_rows):
    """(JAX interpret-mode result, port result) for the same rows and tile."""
    theirs = np.asarray(jax_radix.radix_sort_rows(jnp.asarray(rows), tile_rows=tile_rows, interpret=True))
    src = torch.from_numpy(rows.copy())
    ours = torch_radix.radix_sort_rows(src, tile_rows=tile_rows).numpy()
    assert np.array_equal(src.numpy().view(np.int32), rows.view(np.int32)), "input was overwritten"
    return theirs, ours


def _check(keys, tile_rows, width=1, rng=None):
    rows = _rows(keys, width, rng)
    theirs, ours = _both(rows, tile_rows)
    want = rows[np.argsort(np.asarray(keys, np.uint32), kind="stable")]
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(ours, want)


def _uniform(rng, n, hi=2**32):
    return rng.integers(0, hi, size=n, dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("tile,hi", [(64, 4), (128, 2**16), (256, 2**32)])
def test_differential_fuzz_matches_jax(tile, hi):
    rng = np.random.default_rng(tile)
    n = int(rng.integers(10, 2000))
    _check(_uniform(rng, n, hi), tile, width=int(rng.integers(1, 6)), rng=rng)


def test_stability_heavy_duplicates_matches_jax():
    _check(np.random.default_rng(3).integers(0, 3, size=777), 128)


@pytest.mark.parametrize("value", [7, 0xFFFFFFFF, 0])
def test_all_equal_keys_match_jax(value):
    _check(np.full(300, value, np.uint32), 64)


def test_sign_bit_keys_unsigned_order_match_jax():
    _check(np.array([0, 2**31, 2**31 - 1, 0xFFFFFFFF, 5], np.uint32), 64)


def test_non_tile_multiple_matches_jax():
    _check(_uniform(np.random.default_rng(5), 1000), 96)


@pytest.mark.parametrize("keys", [[42], [3, 1]])
def test_single_row_and_tiny_match_jax(keys):
    _check(np.array(keys, np.uint32), 64)


def test_tile_clamp_matches_jax():
    for tile, n in ((2048, 1001), (64, 3), (8, 9), (8192, 1)):
        assert torch_radix.clamped_tile_rows(tile, n) == jax_radix.clamped_tile_rows(tile, n)
    _check(_uniform(np.random.default_rng(6), 1001), torch_radix.clamped_tile_rows(2048, 1001))


def test_float32_rows_match_jax_bitwise():
    """Float rows whose key words are NaN or negative floats: the key is the
    bitcast word, never a value cast."""
    rng = np.random.default_rng(7)
    keys = np.array(
        [0xD0327A78, 0xE9AA5979, 0xF0000000, 0xBF800001, 0xFFFFFFFF, 1, 2, 3, 4, 5, 6, 7], np.uint32
    )
    rows = np.concatenate([keys.view(np.float32)[:, None], rng.normal(size=(12, 2)).astype(np.float32)], axis=1)
    theirs, ours = _both(rows, 8)
    want = rows[np.argsort(keys, kind="stable")]
    np.testing.assert_array_equal(ours.view(np.int32), theirs.view(np.int32))
    np.testing.assert_array_equal(ours.view(np.int32), want.view(np.int32))


def test_terasort_width_matches_jax():
    """100-byte rows (1 key + 24 payload words) at a small N."""
    rng = np.random.default_rng(8)
    _check(_uniform(rng, 700), 128, width=24, rng=rng)


def test_empty_rows():
    rows = torch.zeros((0, 25), dtype=torch.int32)
    assert torch_radix.radix_sort_rows(rows).shape == (0, 25)
    assert torch_radix.radix_pass(rows, 0).shape == (0, 25)


@pytest.mark.parametrize("shift", [0, 4, 8, 16, 24, 28, 31])
@pytest.mark.parametrize("n", [1, 64, 2 * torch_radix.TILE_ROWS + 1])
def test_pass_is_a_stable_sort_by_its_digit(shift, n):
    rng = np.random.default_rng(shift)
    keys = _uniform(rng, n)
    keys[::7] = 0xFFFFFFFF
    rows = _rows(keys, width=3)
    got = torch_radix.radix_pass(torch.from_numpy(rows), shift).numpy()
    digit = (keys.astype(np.int64) >> shift) & (torch_radix.NUM_BUCKETS - 1)
    np.testing.assert_array_equal(got, rows[np.argsort(digit, kind="stable")])


def _onesweep_model(keys, vals, shift, counts, tile, rng):
    """One pass of the card's pair sort in numpy (csrc/radix_sort.cu
    ``radix_onesweep_kernel``): the pass's global digit starts from the
    counts; per tile the warps' stable ranks, the tile's count of each digit,
    and its exclusive prefix from a look-back over earlier tiles that have
    published either their count only or their inclusive prefix (chosen at
    random, as the tiles' CTAs race); the tile in digit order, each digit's
    run written from its look-back prefix."""
    n, warps = len(keys), 8
    warp_rows = -(-tile // warps)
    digit = ((keys.astype(np.int64) >> shift) & (torch_radix.NUM_BUCKETS - 1)).astype(np.int64)
    start = np.cumsum(counts) - counts
    tiles = -(-n // tile)
    count = np.zeros((tiles, torch_radix.NUM_BUCKETS), np.int64)
    inclusive = np.zeros_like(count)
    published = rng.random(tiles) < 0.5  # which tiles have published their inclusive prefix
    out_k, out_v = np.empty_like(keys), np.empty_like(vals)
    for t in range(tiles):
        lo, hi = t * tile, min(n, (t + 1) * tile)
        d = digit[lo:hi]
        # ranks: the digit's count in earlier warps plus earlier rows of this warp
        warp_count = np.zeros((warps, torch_radix.NUM_BUCKETS), np.int64)
        rank = np.empty(hi - lo, np.int64)
        for i, dg in enumerate(d):
            w = i // warp_rows
            rank[i] = warp_count[w, dg]
            warp_count[w, dg] += 1
        warp_offset = np.cumsum(warp_count, axis=0) - warp_count
        rank += warp_offset[np.arange(hi - lo) // warp_rows, d]
        count[t] = warp_count.sum(axis=0)
        if t == 0:
            excl = start.copy()
        else:
            excl = np.zeros(torch_radix.NUM_BUCKETS, np.int64)
            for u in range(t - 1, -1, -1):
                if u == 0 or published[u]:
                    excl += inclusive[u]
                    break
                excl += count[u]
        inclusive[t] = excl + count[t]
        local = np.cumsum(count[t]) - count[t]
        pos = local[d] + rank  # the row's place in the tile's digit order
        assert np.array_equal(np.sort(pos), np.arange(hi - lo))
        dest = excl[d] - local[d] + pos
        out_k[dest], out_v[dest] = keys[lo:hi], vals[lo:hi]
    return out_k, out_v


def _pair_sort_model(rows, tile, rng):
    """The card's whole sort in numpy: every pass's digit counts from one read
    of the keys, the passes over (key, row number) pairs, then one row
    permutation."""
    keys = rows[:, 0].view(np.uint32)
    counts = [np.bincount((keys.astype(np.int64) >> (p * torch_radix.BITS)) & (torch_radix.NUM_BUCKETS - 1),
                          minlength=torch_radix.NUM_BUCKETS) for p in range(torch_radix.NUM_PASSES)]
    k, v = keys.copy(), np.arange(len(keys), dtype=np.uint32)
    for p in range(torch_radix.NUM_PASSES):
        k, v = _onesweep_model(k, v, p * torch_radix.BITS, counts[p], tile, rng)
    return rows[v]


@pytest.mark.parametrize("tile", [64, 1000])
def test_onesweep_model_reproduces_the_plain_pass(tile):
    """All-digit counts plus per-tile look-back prefixes: the permutation one
    pass over (key, row number) pairs yields moves the rows exactly as the
    plain pass does, on every pass's digit."""
    rng = np.random.default_rng(tile)
    keys = _uniform(rng, 5003)
    keys[::3] = 0xFFFFFFFF
    keys[1::7] = 5
    rows = _rows(keys, width=2)
    for p in range(torch_radix.NUM_PASSES):
        shift = p * torch_radix.BITS
        counts = np.bincount((keys.astype(np.int64) >> shift) & 255, minlength=torch_radix.NUM_BUCKETS)
        k, perm = _onesweep_model(keys, np.arange(len(keys), dtype=np.uint32), shift, counts, tile, rng)
        want = torch_radix.radix_pass_ref(torch.from_numpy(rows), shift).numpy()
        np.testing.assert_array_equal(rows[perm], want)
        np.testing.assert_array_equal(k, want[:, 0].view(np.uint32))


@pytest.mark.parametrize("width,tile", [(1, 64), (25, 1000)])
def test_pairs_then_permutation_reproduce_the_sort(width, tile):
    rng = np.random.default_rng(width)
    keys = _uniform(rng, 4099)
    keys[::5] = 2**31 + 3
    rows = _rows(keys, width=width - 1, rng=rng) if width > 1 else keys.view(np.int32)[:, None].copy()
    got = torch_radix.radix_sort_rows(torch.from_numpy(rows)).numpy()
    np.testing.assert_array_equal(_pair_sort_model(rows, tile, rng), got)
    np.testing.assert_array_equal(got, rows[np.argsort(keys, kind="stable")])


def test_row_numbers_are_uint32():
    rows = torch.empty((2**32, 1), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="uint32"):
        torch_radix.radix_sort_rows(rows)
    with pytest.raises(ValueError, match="uint32"):
        torch_radix.radix_pass(rows, 0)
    assert torch_radix.MAX_ROWS == 2**32 - 1


def test_sort_in_place_and_pure():
    """The sort returns new rows and leaves its input as it was (the JAX
    function is pure); the builder checks its shape."""
    rng = np.random.default_rng(10)
    rows = _rows(_uniform(rng, 333), width=2, rng=rng)
    want = rows[np.argsort(rows[:, 0].view(np.uint32), kind="stable")]
    src = torch.from_numpy(rows.copy())
    got = torch_radix.radix_sort_rows(src)
    assert got.data_ptr() != src.data_ptr()
    np.testing.assert_array_equal(src.numpy(), rows)
    np.testing.assert_array_equal(got.numpy(), want)
    fn = torch_radix.build_radix_sort(333, 3)
    assert fn.impl == "radix"
    np.testing.assert_array_equal(fn(torch.from_numpy(rows)).numpy(), want)
    with pytest.raises(ValueError, match="shape"):
        fn(torch.from_numpy(rows[:10]))


def test_cpu_tensors_run_the_plain_version():
    before = torch_radix.radix_pass.launches, torch_radix.radix_sort_rows.launches
    rows = torch.from_numpy(_rows(np.arange(100, dtype=np.uint32)))
    torch_radix.radix_sort_rows(rows)
    torch_radix.radix_pass(rows, 8)
    assert (torch_radix.radix_pass.launches, torch_radix.radix_sort_rows.launches) == before


def test_pass_rejects_bad_arguments():
    rows = torch.zeros((16, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="32-bit"):
        torch_radix.radix_pass(torch.zeros((16, 3), dtype=torch.int64), 0)
    with pytest.raises(ValueError, match="contiguous"):
        torch_radix.radix_pass(torch.zeros((3, 16), dtype=torch.int32).t(), 0)
    with pytest.raises(ValueError, match="shift"):
        torch_radix.radix_pass(rows, 32)
    with pytest.raises(ValueError, match="not be the rows"):
        torch_radix.radix_pass(rows, 0, out=rows)
    with pytest.raises(ValueError, match="cuda or cpu"):
        torch_radix.radix_pass(rows.to("meta"), 0)


def test_digit_width_matches_the_kernel_source():
    src = (Path(torch_radix.__file__).parent.parent / "csrc" / "radix_sort.cu").read_text()
    assert int(re.search(r"constexpr int kBits = (\d+);", src).group(1)) == torch_radix.BITS
    assert int(re.search(r"constexpr long long kTileRows = (\d+);", src).group(1)) == torch_radix.TILE_ROWS
    threads = int(re.search(r"constexpr int kThreads = (\d+);", src).group(1))
    items = int(re.search(r"constexpr int kItems = (\d+);", src).group(1))
    assert threads * items == torch_radix.TILE_ROWS  # a tile is the CTA's threads x the keys each ranks
    assert threads == torch_radix.NUM_BUCKETS  # one thread per digit
    assert items * 32 < 2**16  # a warp's ranks fit the kernel's 16-bit halves
    assert torch_radix.BITS * torch_radix.NUM_PASSES == 32
