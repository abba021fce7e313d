"""The port's block gather / block scatter (sparkucx_tpu_torch/ops/block_kernels.py)
against the JAX package's ``build_block_gather`` / ``build_block_scatter``.

On CPU tensors the wrappers run their plain PyTorch versions; the JAX side runs
as its own tests run it on the CPU: the 'xla' lowering compiled and the 'tiled'
Pallas kernel in interpret mode.  Inputs come from numpy with fixed seeds, and
the tolerance is exact — the kernels only move 32-bit words, so the packed
prefix (gather) or the whole destination (scatter) must be bit-identical."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkucx_tpu.ops import pallas_kernels as jax_kernels
from sparkucx_tpu_torch.ops.block_kernels import (
    block_gather,
    block_gather_ref,
    block_scatter,
    pack_plan,
    plan_tensors,
)

ROW = 512
LANE = ROW // 4
SRC_ROWS = 512
OUT_ROWS = 256


def _src():
    rng = np.random.default_rng(7)
    return rng.integers(0, 1 << 30, size=(SRC_ROWS, LANE), dtype=np.int32)


def _random_gather_plan(seed, num_blocks):
    """Ragged (offset, length) pairs inside the source, with empties."""
    rng = np.random.default_rng(seed)
    plan = []
    for _ in range(num_blocks):
        start = int(rng.integers(0, SRC_ROWS - 40))
        length = int(rng.integers(0, 40 * ROW)) if rng.random() > 0.2 else 0
        plan.append((start * ROW, length))
    return plan


GATHER_PLANS = {
    # the byte-level plans of tests/test_pallas_kernels.py
    "ragged": [(0, ROW), (3 * ROW, 2 * ROW), (10 * ROW, 0), (40 * ROW, 7 * ROW + 17)],
    "sub_row_tails": [(100 * ROW, 30 * ROW), (5 * ROW, 100), (200 * ROW, ROW * 8)],
    "one_tiny": [(0, 13)],
    # every residue mod the TPU tile height, including counts below it
    "every_tail": [(i * 16 * ROW, (i + 1) * ROW) for i in range(12)],
    "whole_source": [(0, SRC_ROWS * ROW)],
    "random_a": _random_gather_plan(1, 9),
    "random_b": _random_gather_plan(2, 17),
}


def _with_pads(starts, counts, outs, total, pads):
    """Append ``pads`` count=0 entries landing at the packed end (outs=total),
    the batch padding of transport/tpu.py and hbm_store.py."""
    return (
        np.concatenate([starts, np.zeros(pads, np.int32)]),
        np.concatenate([counts, np.zeros(pads, np.int32)]),
        np.concatenate([outs, np.full(pads, total, np.int32)]),
    )


def _jax_gather(impl, starts, counts, outs, src, out_rows):
    interpret = impl == "tiled"
    fn = jax_kernels.build_block_gather(len(starts), out_rows, impl=impl, interpret=interpret)
    return np.asarray(fn(jnp.asarray(starts), jnp.asarray(counts), jnp.asarray(outs), jnp.asarray(src)))


def _torch_gather(starts, counts, outs, src, out_rows):
    s, c, o = plan_tensors(starts, counts, outs, "cpu")
    return block_gather(s, c, o, torch.from_numpy(src), out_rows).numpy()


@pytest.mark.parametrize("impl", ["xla", "tiled"])
@pytest.mark.parametrize("pads", [0, 3])
@pytest.mark.parametrize("name", sorted(GATHER_PLANS))
def test_gather_matches_jax(name, pads, impl):
    src = _src()
    starts, counts, outs, total = pack_plan(GATHER_PLANS[name], ROW)
    starts, counts, outs = _with_pads(starts, counts, outs, total, pads)
    out_rows = max(total, 1)
    expected = _jax_gather(impl, starts, counts, outs, src, out_rows)
    got = _torch_gather(starts, counts, outs, src, out_rows)
    assert got.shape == (out_rows, LANE)
    assert np.array_equal(got[:total], expected[:total])


def test_gather_empty_plan_is_a_noop():
    src = torch.from_numpy(_src())
    s, c, o = plan_tensors([], [], [], "cpu")
    assert block_gather(s, c, o, src, 0).shape == (0, LANE)


# (dst slot row, row count) pairs — non-overlapping dst windows, with empties
SCATTER_PLANS = {
    "ragged": [(3, 5), (40, 0), (64, 8), (200, 3)],
    "aligned": [(0, 8), (16, 16), (250, 1)],
    "one": [(95, 5)],
    "empty_block": [(0, 0)],
    "whole_dst": [(0, OUT_ROWS)],
    "ones": [(i * 7, 1) for i in range(30)],
}


def _random_scatter_plan(seed):
    """Disjoint dst windows: split the rows into runs, keep a random subset."""
    rng = np.random.default_rng(seed)
    cuts = np.sort(rng.choice(np.arange(1, OUT_ROWS), size=20, replace=False))
    bounds = [0, *cuts.tolist(), OUT_ROWS]
    plan = []
    for a, b in zip(bounds[:-1], bounds[1:]):
        if rng.random() < 0.6:
            plan.append((a, int(rng.integers(0, b - a + 1))))
    return plan


SCATTER_PLANS["random_a"] = _random_scatter_plan(3)
SCATTER_PLANS["random_b"] = _random_scatter_plan(4)


def _scatter_args(plan):
    starts = np.asarray([s for s, _ in plan], dtype=np.int32)
    counts = np.asarray([c for _, c in plan], dtype=np.int32)
    outs = (np.cumsum(counts) - counts).astype(np.int32)
    return starts, counts, outs, int(counts.sum())


def _dst():
    rng = np.random.default_rng(23)
    return rng.integers(0, 1 << 30, size=(OUT_ROWS, LANE), dtype=np.int32)


@pytest.mark.parametrize("impl", ["xla", "tiled"])
@pytest.mark.parametrize("name", sorted(SCATTER_PLANS))
def test_scatter_matches_jax(name, impl):
    """Placed blocks AND every uncovered destination row must match: the
    scatter writes in place, and a version that zeroed the staging would pass
    a blocks-only check while destroying earlier writes."""
    starts, counts, outs, total = _scatter_args(SCATTER_PLANS[name])
    src = _src()[: max(total, 1)]
    dst = _dst()
    fn = jax_kernels.build_block_scatter(
        len(starts), OUT_ROWS, impl=impl, interpret=impl == "tiled"
    )
    expected = np.asarray(
        fn(jnp.asarray(starts), jnp.asarray(counts), jnp.asarray(outs), jnp.asarray(src), jnp.asarray(dst))
    )
    dst_t = torch.from_numpy(dst.copy())
    s, c, o = plan_tensors(starts, counts, outs, "cpu")
    got = block_scatter(s, c, o, torch.from_numpy(src), dst_t)
    assert got.data_ptr() == dst_t.data_ptr()  # in place
    assert np.array_equal(got.numpy(), expected)


def test_scatter_is_gather_inverse():
    """gather(scatter(x)) over the same plan returns the packed input."""
    starts, counts, outs, total = _scatter_args(SCATTER_PLANS["random_a"])
    s, c, o = plan_tensors(starts, counts, outs, "cpu")
    packed = torch.from_numpy(_src()[:total].copy())
    staged = block_scatter(s, c, o, packed, torch.zeros((OUT_ROWS, LANE), dtype=torch.int32))
    assert torch.equal(block_gather(s, c, o, staged, total), packed)


@pytest.mark.parametrize("name", ["ragged", "sub_row_tails", "one_tiny", "every_tail"])
def test_pack_plan_matches_jax(name):
    ours = pack_plan(GATHER_PLANS[name], ROW)
    theirs = jax_kernels.pack_plan(GATHER_PLANS[name], ROW)
    for a, b in zip(ours[:3], theirs[:3]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert ours[3] == theirs[3]


def test_pack_plan_rejects_misaligned():
    with pytest.raises(ValueError, match="aligned"):
        pack_plan([(ROW + 1, ROW)], ROW)


@pytest.mark.parametrize(
    "starts,counts,outs",
    [
        ([0, 1], [2, -1], [0, 2]),  # negative count
        ([-3, 1], [2, 1], [0, 2]),  # negative start
        ([0, 5], [2, 3], [0, 1]),  # overlapping packed rows
        ([0, 0, 5], [2, 0, 3], [0, 0, 2]),  # a pad in the middle breaks the block search
    ],
)
def test_plan_tensors_rejects_unpacked_plans(starts, counts, outs):
    with pytest.raises(ValueError, match="non-negative|not packed"):
        plan_tensors(starts, counts, outs, "cpu")


@pytest.mark.parametrize("name", ["ragged", "whole_source"])
def test_gather_into_a_row_slice_matches_jax(name):
    """``out=``: the packed rows land in a row slice of a larger buffer (the
    columnar exchange's receive buffer); rows outside the slice are untouched."""
    src = _src()
    starts, counts, outs, total = pack_plan(GATHER_PLANS[name], ROW)
    expected = _jax_gather("xla", starts, counts, outs, src, total)
    buf = torch.full((total + 6, LANE), -5, dtype=torch.int32)
    s, c, o = plan_tensors(starts, counts, outs, "cpu")
    got = block_gather(s, c, o, torch.from_numpy(src), total, out=buf[3 : 3 + total])
    assert got.data_ptr() == buf[3].data_ptr()
    assert np.array_equal(buf[3 : 3 + total].numpy(), expected[:total])
    assert (buf[:3] == -5).all() and (buf[3 + total :] == -5).all()
    with pytest.raises(ValueError, match="must be"):
        block_gather(s, c, o, torch.from_numpy(src), total, out=buf[:total - 1])


def test_wrappers_validate_inputs():
    src = torch.from_numpy(_src())
    s, c, o = plan_tensors([0], [1], [0], "cpu")
    with pytest.raises(ValueError, match="int32"):
        block_gather(s.long(), c, o, src, 1)
    with pytest.raises(ValueError, match="32-bit"):
        block_gather(s, c, o, src.double(), 1)
    with pytest.raises(ValueError, match="lane width"):
        block_scatter(s, c, o, src, torch.zeros((4, LANE + 1), dtype=torch.int32))
    meta = torch.empty((4, LANE), dtype=torch.int32, device="meta")
    ms, mc, mo = (t.to("meta") for t in (s, c, o))
    with pytest.raises(ValueError, match="cuda or cpu"):
        block_gather(ms, mc, mo, meta, 1)


def test_cpu_calls_do_not_count_as_launches():
    before = (block_gather.launches, block_scatter.launches)
    src = torch.from_numpy(_src())
    s, c, o = plan_tensors([0], [2], [0], "cpu")
    out = block_gather(s, c, o, src, 2)
    block_scatter(s, c, o, out, src.clone())
    assert (block_gather.launches, block_scatter.launches) == before
    assert torch.equal(out, block_gather_ref(s, c, o, src, 2))
