"""The port's exchange (sparkucx_tpu_torch/ops/exchange.py) against the JAX
package's on the same ``pack_chunks_slots`` input.

The port runs n executors on one device (the CPU here): receiver j's buffer is
one block gather over the concatenated staging.  The JAX side runs its dense
lowering on the virtual CPU mesh of tests/conftest.py.  Exact comparison over
each receiver's sized prefix and of the received-size matrices."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from sparkucx_tpu.ops import exchange as jax_exchange
from sparkucx_tpu_torch.ops import exchange as torch_exchange

LANE = 32
ROW_BYTES = LANE * 4
SLOT_ROWS = 16


def _chunks(n, seed):
    """chunks[i][j]: bytes executor i sends executor j (empties and sub-row
    tails included), each fitting one slot."""
    rng = np.random.default_rng(seed)
    return [
        [
            rng.integers(0, 256, size=int(rng.integers(0, SLOT_ROWS * ROW_BYTES)), dtype=np.uint8).tobytes()
            if rng.random() > 0.15
            else b""
            for _ in range(n)
        ]
        for _ in range(n)
    ]


def _staging(chunks):
    n = len(chunks)
    bufs, sizes = zip(*[jax_exchange.pack_chunks_slots(chunks[i], SLOT_ROWS, ROW_BYTES) for i in range(n)])
    return np.concatenate(bufs, axis=0), np.stack(sizes).astype(np.int32)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_exchange_matches_jax_dense(n):
    chunks = _chunks(n, seed=100 + n)
    data, size_mat = _staging(chunks)
    send_rows = n * SLOT_ROWS

    mesh = jax_exchange.make_mesh(n)
    sharding = NamedSharding(mesh, P("ex", None))
    jfn = jax_exchange.build_exchange(
        mesh, jax_exchange.ExchangeSpec(n, send_rows, send_rows, lane=LANE, impl="dense")
    )
    jrecv, jsizes = jfn(jax.device_put(data, sharding), jax.device_put(size_mat, sharding))
    jrecv, jsizes = np.asarray(jrecv), np.asarray(jsizes)

    tfn = torch_exchange.build_exchange(
        ["cpu"] * n, torch_exchange.ExchangeSpec(n, send_rows, send_rows, lane=LANE)
    )
    trecv, tsizes = tfn(torch.from_numpy(data), size_mat)
    trecv, tsizes = trecv.numpy(), tsizes.numpy()

    assert trecv.shape == jrecv.shape
    assert np.array_equal(tsizes, jsizes)
    padded = [[c + b"\x00" * (-len(c) % ROW_BYTES) for c in row] for row in chunks]
    expected = jax_exchange.oracle_exchange(padded)
    for j in range(n):
        total = int(tsizes[j].sum())
        lo = j * send_rows
        assert np.array_equal(trecv[lo : lo + total], jrecv[lo : lo + total]), f"receiver {j}"
        assert trecv[lo : lo + total].tobytes() == expected[j]


def test_exchange_rejects_mismatched_shapes():
    spec = torch_exchange.ExchangeSpec(2, 2 * SLOT_ROWS, 2 * SLOT_ROWS, lane=LANE)
    fn = torch_exchange.build_exchange(["cpu", "cpu"], spec)
    with pytest.raises(ValueError, match="data shape"):
        fn(torch.zeros((SLOT_ROWS, LANE), dtype=torch.int32), np.zeros((2, 2), np.int32))
    with pytest.raises(ValueError, match="exceeds its slot"):
        fn(torch.zeros((4 * SLOT_ROWS, LANE), dtype=torch.int32), np.full((2, 2), SLOT_ROWS + 1, np.int32))
    with pytest.raises(ValueError, match="divisible"):
        torch_exchange.build_exchange(["cpu"] * 3, torch_exchange.ExchangeSpec(3, 10, 10))


def test_exchange_across_devices_is_not_ported():
    spec = torch_exchange.ExchangeSpec(2, 2 * SLOT_ROWS, 2 * SLOT_ROWS, lane=LANE)
    with pytest.raises(NotImplementedError, match="NCCL"):
        torch_exchange.build_exchange(["cpu", "meta"], spec)


@pytest.mark.parametrize("n", [1, 3, 8])
@pytest.mark.parametrize("slot_rows", [None, SLOT_ROWS])
def test_ragged_params_match_jax(n, slot_rows):
    rng = np.random.default_rng(n)
    sizes = rng.integers(0, SLOT_ROWS + 1, size=(n, n)).astype(np.int32)
    for me in range(n):
        ours = torch_exchange.ragged_params(sizes, me, slot_rows)
        theirs = jax_exchange.ragged_params(sizes, me, slot_rows, xp=np)
        for a, b in zip(ours, theirs):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("n", [1, 3, 4, 8])
def test_bucket_and_rebucket_match_jax(n):
    rng = np.random.default_rng(40 + n)
    for rows in (1, 5, 64, 100):
        assert torch_exchange.bucket_send_rows(rows, n) == jax_exchange.bucket_send_rows(rows, n)
    payload = rng.integers(0, 1 << 20, size=(n * 6, LANE), dtype=np.int32)
    bucketed = jax_exchange.bucket_send_rows(n * 6, n)
    expected = jax_exchange.rebucket_slots(payload, n, bucketed)
    assert np.array_equal(torch_exchange.rebucket_slots(payload, n, bucketed), expected)
    got = torch_exchange.rebucket_slots(torch.from_numpy(payload), n, bucketed)
    assert np.array_equal(got.numpy(), expected)


def test_pack_and_unpack_match_jax():
    chunks = _chunks(4, seed=9)[0]
    ours, our_sizes = torch_exchange.pack_chunks_slots(chunks, SLOT_ROWS, ROW_BYTES)
    theirs, their_sizes = jax_exchange.pack_chunks_slots(chunks, SLOT_ROWS, ROW_BYTES)
    assert np.array_equal(our_sizes, their_sizes)
    for j, c in enumerate(chunks):
        used = int(our_sizes[j])
        lo = j * SLOT_ROWS
        assert np.array_equal(ours[lo : lo + used], theirs[lo : lo + used])
    blob = b"".join(ours[j * SLOT_ROWS : j * SLOT_ROWS + our_sizes[j]].tobytes() for j in range(4))
    assert torch_exchange.unpack_received(blob, our_sizes, ROW_BYTES) == jax_exchange.unpack_received(
        blob, their_sizes, ROW_BYTES
    )
