"""The port's columnar shuffle (sparkucx_tpu_torch/ops/columnar.py) against the
JAX package's (sparkucx_tpu/ops/columnar.py, dense lowering on the virtual CPU
mesh of tests/conftest.py) on the same seeded rows and owners.

The port runs n executors on the CPU: each receiver's shard is one block
gather (K1's plain version here) over the destination-sorted rows.  Tolerance
0: the whole receive buffer (zero rows after each received total included)
and the receive-count matrix must be equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from sparkucx_tpu.ops import columnar as jax_columnar
from sparkucx_tpu.ops import exchange as jax_exchange
from sparkucx_tpu_torch.ops import columnar as torch_columnar
from sparkucx_tpu_torch.ops.block_kernels import block_gather

CAP = 64
W = 16


def _jax_shuffle(n, rows, owners, recv_capacity, width=W):
    mesh = jax_exchange.make_mesh(n)
    spec = jax_columnar.ColumnarSpec(n, CAP, recv_capacity, width, np.dtype(rows.dtype), impl="dense")
    fn = jax_columnar.build_columnar_shuffle(mesh, spec)
    recv, counts = fn(
        jax.device_put(rows, NamedSharding(mesh, P("ex", None))),
        jax.device_put(owners, NamedSharding(mesh, P("ex"))),
    )
    return np.asarray(recv), np.asarray(counts)


def _torch_shuffle(n, rows, owners, recv_capacity, width=W):
    spec = torch_columnar.ColumnarSpec(n, CAP, recv_capacity, width, np.dtype(rows.dtype))
    fn = torch_columnar.build_columnar_shuffle(["cpu"] * n, spec)
    assert fn.spec.impl == "shared"
    recv, counts = fn(torch.from_numpy(rows), torch.from_numpy(owners))
    return recv.numpy(), counts.numpy()


def _assert_same(n, rows, owners, recv_capacity):
    jrecv, jcounts = _jax_shuffle(n, rows, owners, recv_capacity)
    trecv, tcounts = _torch_shuffle(n, rows, owners, recv_capacity)
    assert np.array_equal(tcounts, jcounts)
    assert trecv.shape == jrecv.shape
    assert np.array_equal(trecv.view(np.int32), jrecv.view(np.int32))
    return trecv, tcounts


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_random_owners_match_jax(n):
    rng = np.random.default_rng(n)
    rows = rng.normal(size=(n * CAP, W)).astype(np.float32)
    owners = rng.integers(0, n + 1, size=n * CAP).astype(np.int32)  # some padding rows
    _assert_same(n, rows, owners, n * CAP)


@pytest.mark.parametrize("n", [2, 8])
def test_padding_rows_not_sent_match_jax(n):
    rng = np.random.default_rng(20 + n)
    rows = rng.normal(size=(n * CAP, W)).astype(np.float32)
    owners = np.full(n * CAP, n, dtype=np.int32)
    owners[5] = n - 1
    trecv, counts = _assert_same(n, rows, owners, CAP)
    assert counts.sum() == 1
    assert np.array_equal(trecv[(n - 1) * CAP], rows[5])


@pytest.mark.parametrize("n", [4, 8])
def test_skew_all_to_one_matches_jax(n):
    rng = np.random.default_rng(30 + n)
    rows = rng.normal(size=(n * CAP, W)).astype(np.float32)
    owners = np.zeros(n * CAP, dtype=np.int32)
    trecv, counts = _assert_same(n, rows, owners, n * CAP)
    assert counts[0].sum() == n * CAP
    assert np.array_equal(trecv[: n * CAP], rows)  # sender-major, input order


@pytest.mark.parametrize("n", [2, 4])
def test_overflow_truncates_like_jax(n):
    """A receiver offered more than recv_capacity rows keeps the first
    recv_capacity of the sender-major concatenation; the counts report the
    true totals (the caller's overflow signal)."""
    rng = np.random.default_rng(40 + n)
    rows = rng.integers(-(2**31), 2**31 - 1, size=(n * CAP, W), dtype=np.int64).astype(np.int32)
    owners = (rng.random(n * CAP) < 0.8).astype(np.int32)  # mostly to executor 1
    _, counts = _assert_same(n, rows, owners, CAP)
    assert counts[1].sum() > CAP


def test_int32_rows_and_width_one_match_jax():
    n = 4
    rng = np.random.default_rng(50)
    rows = rng.integers(-(2**31), 2**31 - 1, size=(n * CAP, 1), dtype=np.int64).astype(np.int32)
    owners = rng.integers(0, n, size=n * CAP).astype(np.int32)
    jrecv, jcounts = _jax_shuffle(n, rows, owners, 2 * CAP, width=1)
    trecv, tcounts = _torch_shuffle(n, rows, owners, 2 * CAP, width=1)
    assert np.array_equal(tcounts, jcounts) and np.array_equal(trecv, jrecv)


@pytest.mark.parametrize("balanced", [False, True])
def test_run_columnar_shuffle_matches_jax(balanced):
    n, cap = 4, 256 if not balanced else 64
    rng = np.random.default_rng(60 + balanced)
    rows = rng.normal(size=(n * cap, 4)).astype(np.float32)
    owners = (np.arange(n * cap) % n).astype(np.int32) if balanced else np.zeros(n * cap, np.int32)
    jspec = jax_columnar.ColumnarSpec(n, cap, cap if not balanced else 2 * cap, 4, impl="dense")
    jrecv, jcounts = jax_columnar.run_columnar_shuffle(jax_exchange.make_mesh(n), jspec, rows, owners)
    tspec = torch_columnar.ColumnarSpec(n, cap, jspec.recv_capacity, 4)
    trecv, tcounts = torch_columnar.run_columnar_shuffle(["cpu"] * n, tspec, rows, owners)
    assert np.array_equal(tcounts.numpy(), np.asarray(jcounts))
    assert np.array_equal(trecv.numpy(), np.asarray(jrecv))


def test_run_columnar_shuffle_gives_up_on_extreme_skew():
    n, cap = 4, 64
    rows = np.zeros((n * cap, 2), np.float32)
    spec = torch_columnar.ColumnarSpec(n, cap, 8, 2)
    with pytest.raises(RuntimeError, match="skew"):
        torch_columnar.run_columnar_shuffle(["cpu"] * n, spec, rows, np.zeros(n * cap, np.int32), max_attempts=2)


@pytest.mark.parametrize("n", [1, 3, 8])
def test_size_matrix_from_owners(n):
    rng = np.random.default_rng(70 + n)
    owners = rng.integers(0, n + 1, size=(n, CAP))
    sizes, send, recv, offsets = torch_columnar.size_matrix_from_owners(n, torch.from_numpy(owners))
    want = np.stack([np.bincount(owners[i], minlength=n + 1)[:n] for i in range(n)])
    assert np.array_equal(sizes, want)
    for me in range(n):
        theirs = jax_exchange.ragged_params(want, me, None, xp=np)
        assert np.array_equal(send[me], theirs[1])
        assert np.array_equal(offsets[me], theirs[2])
        assert np.array_equal(recv[me], theirs[3])


def test_receive_plan_is_one_packed_gather_per_receiver():
    n = 4
    rng = np.random.default_rng(80)
    rows = rng.normal(size=(n * CAP, W)).astype(np.float32)
    owners = rng.integers(0, n, size=n * CAP).astype(np.int32)
    fn = torch_columnar.build_columnar_shuffle(["cpu"] * n, torch_columnar.ColumnarSpec(n, CAP, n * CAP, W))
    before = block_gather.launches
    fn(torch.from_numpy(rows), torch.from_numpy(owners))
    assert block_gather.launches == before  # CPU tensors: the plain version, no launch
    sizes = rng.integers(0, 20, size=(n, n))
    for j in range(n):
        starts, counts, outs = torch_columnar.receive_plan(sizes, j, CAP, 25)
        assert np.array_equal(outs, np.minimum(np.cumsum(counts) - counts, 25))
        assert counts.sum() == min(sizes[:, j].sum(), 25)
        assert np.array_equal(starts, np.arange(n) * CAP + (np.cumsum(sizes, axis=1) - sizes)[:, j])


@pytest.mark.parametrize("num_partitions,n", [(10, 4), (6, 3), (7, 7), (3, 5)])
def test_owners_from_partitions_match_jax(num_partitions, n):
    pids = np.arange(-2, num_partitions + 3, dtype=np.int32)
    theirs = np.asarray(jax_columnar.owners_from_partitions(jnp.asarray(pids), num_partitions, n))
    ours = torch_columnar.owners_from_partitions(torch.from_numpy(pids), num_partitions, n)
    assert ours.dtype == torch.int32
    assert np.array_equal(ours.numpy(), theirs)


@pytest.mark.parametrize("total,n,cap", [(0, 2, 4), (7, 3, 3), (100, 4, 30), (5, 8, 1)])
def test_shard_rows_host_and_unpack_match_jax(total, n, cap):
    rng = np.random.default_rng(total)
    keys = rng.integers(0, 2**32, size=total, dtype=np.uint64).astype(np.uint32)
    vals = rng.integers(-9, 9, size=(total, 3)).astype(np.int32)
    ours = torch_columnar.shard_rows_host(keys, vals, n, cap, key_fill=0xFFFFFFFF)
    theirs = jax_columnar.shard_rows_host(keys, vals, n, cap, key_fill=0xFFFFFFFF)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    back = torch_columnar.unpack_shard_prefixes(ours[:2], ours[2], cap)
    for a, b in zip(back, jax_columnar.unpack_shard_prefixes(theirs[:2], theirs[2], cap)):
        assert np.array_equal(a, b)
    assert np.array_equal(back[0], keys)
    with pytest.raises(ValueError, match="capacity"):
        torch_columnar.shard_rows_host(keys, vals, 1, total - 1 if total else -1)


def test_spec_lowerings():
    spec = torch_columnar.ColumnarSpec(2, 8, 8, 1)
    assert spec.resolve_impl().impl == "shared"
    with pytest.raises(NotImplementedError, match="NCCL"):
        torch_columnar.build_columnar_shuffle(["cpu"] * 2, torch_columnar.ColumnarSpec(2, 8, 8, 1, impl="ragged"))
    with pytest.raises(ValueError, match="unknown impl"):
        torch_columnar.build_columnar_shuffle(["cpu"] * 2, torch_columnar.ColumnarSpec(2, 8, 8, 1, impl="dense"))
    with pytest.raises(NotImplementedError, match="NCCL"):
        torch_columnar.build_columnar_shuffle(["cpu", "meta"], spec)
    fn = torch_columnar.build_columnar_shuffle(["cpu"] * 2, spec)
    with pytest.raises(ValueError, match="owners must lie"):
        fn(torch.zeros((16, 1)), torch.full((16,), 3, dtype=torch.int32))
    with pytest.raises(ValueError, match="rows shape"):
        fn(torch.zeros((15, 1)), torch.zeros(16, dtype=torch.int32))
