"""The fused send side of the port (ops/ici_exchange.py
``build_fused_ici_exchange`` over ops/ring_kernels.py
``fused_scatter_ring_grid``, K5) against the JAX package's
``build_fused_ici_exchange`` on the 8-device CPU mesh, on the same seeded
numpy inputs, exact.

The JAX side runs at ``lowering="auto"`` (its portable tier on the CPU: the
window-scan scatter, then the scheduled permutes).  ``lowering="interpret"``
is no second oracle here: the JAX interpreter cannot run K5 on the CPU mesh
(its scatter phase copies ``counts[i]`` rows per block, a DMA of traced
length, which the interpreter's discharge refuses: "Shapes must be 1D
sequences of concrete values").  Also K5's plain version against
scatter-then-ring, in-place staging and the plan checks."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from sparkucx_tpu.ops.exchange import ExchangeSpec as JaxSpec
from sparkucx_tpu.ops.exchange import make_mesh
from sparkucx_tpu.ops.ici_exchange import build_fused_ici_exchange as jax_build_fused
from sparkucx_tpu_torch.ops.block_kernels import block_scatter_ref
from sparkucx_tpu_torch.ops.exchange import ExchangeSpec, build_exchange
from sparkucx_tpu_torch.ops.ici_exchange import build_fused_ici_exchange, ring_schedule
from sparkucx_tpu_torch.ops.ring_kernels import (
    fused_scatter_ring_grid,
    fused_scatter_ring_grid_ref,
    ring_exchange_grid_ref,
)

LANE = 8


def _one_block_per_destination(rng, n, slot):
    """The JAX test's case: one block per destination, packed back to back
    per sender, placed at the head of each destination slot."""
    send_rows = n * slot
    sizes = rng.integers(1, slot + 1, size=(n, n)).astype(np.int32)
    starts, counts, outs = (np.zeros((n, n), dtype=np.int32) for _ in range(3))
    packed = np.zeros((n * send_rows, LANE), dtype=np.int32)
    staged = np.zeros((n * send_rows, LANE), dtype=np.int32)
    for i in range(n):
        off = 0
        for j in range(n):
            c = int(sizes[i, j])
            rows = rng.integers(-100, 100, size=(c, LANE), dtype=np.int32)
            packed[i * send_rows + off : i * send_rows + off + c] = rows
            staged[i * send_rows + j * slot : i * send_rows + j * slot + c] = rows
            starts[i, j], counts[i, j], outs[i, j] = j * slot, c, off
            off += c
    return sizes, starts, counts, outs, packed, staged


def _ragged_blocks(rng, n, slot, per_dest=3, pads=2):
    """Several blocks per destination of ragged (some empty) lengths, placed
    back to back in each destination slot, plus count-0 pads at the packed
    end; packed buffers sized to the largest executor."""
    send_rows = n * slot
    lens = rng.integers(0, slot // per_dest + 1, size=(n, n, per_dest))
    lens[rng.random(lens.shape) < 0.2] = 0
    sizes = lens.sum(axis=2).astype(np.int32)
    num_blocks = n * per_dest + pads
    p_rows = int(sizes.sum(axis=1).max())
    starts, counts, outs = (np.zeros((n, num_blocks), dtype=np.int32) for _ in range(3))
    packed = rng.integers(-100, 100, size=(n * p_rows, LANE), dtype=np.int32)
    staged = np.zeros((n * send_rows, LANE), dtype=np.int32)
    for i in range(n):
        off, b = 0, 0
        for j in range(n):
            at = j * slot
            for k in range(per_dest):
                c = int(lens[i, j, k])
                staged[i * send_rows + at : i * send_rows + at + c] = packed[i * p_rows + off : i * p_rows + off + c]
                starts[i, b], counts[i, b], outs[i, b] = at, c, off
                at, off, b = at + c, off + c, b + 1
        outs[i, b:] = off  # count-0 pads at the packed end
    return sizes, starts, counts, outs, packed, staged, num_blocks


def _jax_fused(n, slot, num_blocks, lowering, chunks, sizes, starts, counts, outs, packed, send_rows):
    mesh = make_mesh(n)
    sharding = NamedSharding(mesh, P("ex", None))
    put = lambda a: jax.device_put(a, sharding)
    spec = JaxSpec(num_executors=n, send_rows=send_rows, recv_rows=send_rows, lane=LANE)
    fn = jax_build_fused(mesh, spec, num_blocks, chunks_per_dest=chunks, lowering=lowering, max_block_rows=slot)
    recv, rs = fn(put(starts), put(counts), put(outs), put(packed),
                  put(np.zeros((n * send_rows, LANE), dtype=np.int32)), put(sizes))
    return np.asarray(recv), np.asarray(rs)


def _ours(n, slot, num_blocks, chunks, sizes, starts, counts, outs, packed, send_rows):
    spec = ExchangeSpec(n, send_rows, send_rows, LANE)
    fn = build_fused_ici_exchange(["cpu"] * n, spec, num_blocks, chunks_per_dest=chunks, max_block_rows=slot)
    t = torch.from_numpy
    staging = torch.zeros((n * send_rows, LANE), dtype=torch.int32)
    recv, rs = fn(t(starts), t(counts), t(outs), t(packed), staging, sizes)
    return recv.numpy(), rs.numpy(), staging


@pytest.mark.parametrize("n,chunks", [(4, 2), (2, 1), (8, 2)])
def test_matches_jax_one_block_per_destination(n, chunks):
    rng = np.random.default_rng(n * 10 + chunks)
    slot = 16
    send_rows = n * slot
    sizes, starts, counts, outs, packed, _ = _one_block_per_destination(rng, n, slot)
    theirs, theirs_rs = _jax_fused(n, slot, n, "auto", chunks, sizes, starts, counts, outs, packed, send_rows)
    ours, ours_rs, _ = _ours(n, slot, n, chunks, sizes, starts, counts, outs, packed, send_rows)
    np.testing.assert_array_equal(ours_rs, theirs_rs.reshape(n, n))
    assert ours.tobytes() == theirs.tobytes()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_matches_jax_ragged_multi_block(seed):
    rng = np.random.default_rng(100 + seed)
    n, slot, chunks = 4, 24, 2
    send_rows = n * slot
    sizes, starts, counts, outs, packed, _, nb = _ragged_blocks(rng, n, slot)
    theirs, theirs_rs = _jax_fused(n, slot, nb, "auto", chunks, sizes, starts, counts, outs, packed, send_rows)
    ours, ours_rs, _ = _ours(n, slot, nb, chunks, sizes, starts, counts, outs, packed, send_rows)
    np.testing.assert_array_equal(ours_rs, theirs_rs.reshape(n, n))
    assert ours.tobytes() == theirs.tobytes()


def test_matches_scatter_then_exchange_and_stages_in_place(rng):
    n, slot = 4, 16
    send_rows = n * slot
    sizes, starts, counts, outs, packed, staged, nb = _ragged_blocks(rng, n, slot)
    recv, rs, staging = _ours(n, slot, nb, 2, sizes, starts, counts, outs, packed, send_rows)
    ref, ref_rs = build_exchange(["cpu"] * n, ExchangeSpec(n, send_rows, send_rows, LANE))(torch.from_numpy(staged), sizes)
    np.testing.assert_array_equal(rs, ref_rs.numpy())
    for j in range(n):
        used = int(sizes[:, j].sum())
        assert recv[j * send_rows : j * send_rows + used].tobytes() == ref[j * send_rows : j * send_rows + used].numpy().tobytes()
        assert not recv[j * send_rows + used : (j + 1) * send_rows].any()
    assert np.array_equal(staging.numpy(), staged), "the staging is updated in place"


@pytest.mark.parametrize("n,chunks", [(2, 1), (3, 2), (4, 4)])
def test_k5_plain_version_is_scatter_then_ring_and_keeps_stale_rows(n, chunks):
    """Staging rows no block covers (stale bytes) carry into the grid."""
    rng = np.random.default_rng(7 * n + chunks)
    slot = 8 * chunks
    sizes, starts, counts, outs, packed, _, nb = _ragged_blocks(rng, n, slot)
    stale = torch.from_numpy(rng.integers(-9, 9, size=(n * n * slot, LANE), dtype=np.int32))
    t = torch.from_numpy
    steps = ring_schedule(n, chunks).raw_steps()
    got = fused_scatter_ring_grid(n, slot, slot // chunks, steps, t(starts), t(counts), t(outs), t(packed), stale.clone())
    staging = stale.clone()
    p_rows = packed.shape[0] // n
    for i in range(n):
        block_scatter_ref(t(starts[i]), t(counts[i]), t(outs[i]), t(packed[i * p_rows : (i + 1) * p_rows]),
                          staging[i * n * slot : (i + 1) * n * slot])
    want = ring_exchange_grid_ref(n, slot, slot // chunks, steps, staging)
    assert torch.equal(got, want)
    again = fused_scatter_ring_grid_ref(n, slot, slot // chunks, steps, t(starts), t(counts), t(outs), t(packed), stale.clone())
    assert torch.equal(again, want)
    assert fused_scatter_ring_grid.launches == 0  # CPU tensors: the plain version


def test_operand_and_builder_checks(rng):
    n, slot = 2, 8
    sizes, starts, counts, outs, packed, _ = _one_block_per_destination(rng, n, slot)
    t = torch.from_numpy
    steps = ring_schedule(n, 1).raw_steps()
    staging = torch.zeros((n * n * slot, LANE), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        fused_scatter_ring_grid(n, slot, slot, steps, t(starts).long(), t(counts), t(outs), t(packed), staging)
    with pytest.raises(ValueError, match="like starts"):
        fused_scatter_ring_grid(n, slot, slot, steps, t(starts), t(counts[:, :1].copy()), t(outs), t(packed), staging)
    with pytest.raises(ValueError, match="multiple"):
        fused_scatter_ring_grid(n, slot, slot, steps, t(starts), t(counts), t(outs), t(packed[:-1].copy()), staging)
    with pytest.raises(ValueError, match="lane width"):
        fused_scatter_ring_grid(n, slot, slot, steps, t(starts), t(counts), t(outs), t(packed[:, :4].copy()), staging)
    spec = ExchangeSpec(n, n * slot, n * slot, LANE)
    with pytest.raises(ValueError, match="num_executors > 1"):
        build_fused_ici_exchange(["cpu"], ExchangeSpec(1, 8, 8, LANE), 1)
    fn = build_fused_ici_exchange(["cpu"] * n, spec, n, max_block_rows=1)
    with pytest.raises(ValueError, match="max_block_rows"):
        fn(t(starts), t(counts), t(outs), t(packed), staging, sizes)
    with pytest.raises(NotImplementedError):
        build_fused_ici_exchange(["cpu", "meta"], spec, n)
