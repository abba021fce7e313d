"""The port's loopback transport (sparkucx_tpu_torch/transport/loopback.py):
every case of ``tests/test_loopback.py`` (registry, deferred fetch, staged
store) on the port's classes, and one sequence of operations held against
the JAX package's transport, result for result (status, bytes, sizes).
Host code: no device, tolerance exact."""

import numpy as np
import pytest

from sparkucx_tpu_torch.core.block import BytesBlock, MemoryBlock, ShuffleBlockId
from sparkucx_tpu_torch.core.definitions import MapperInfo
from sparkucx_tpu_torch.core.operation import OperationStatus
from sparkucx_tpu_torch.core.transport import ShuffleTransport
from sparkucx_tpu_torch.transport.loopback import LoopbackFabric, LoopbackTransport


@pytest.fixture
def pair():
    fabric = LoopbackFabric()
    a = LoopbackTransport(executor_id=1, fabric=fabric)
    b = LoopbackTransport(executor_id=2, fabric=fabric)
    addr_a, addr_b = a.init(), b.init()
    a.add_executor(2, addr_b)
    b.add_executor(1, addr_a)
    yield a, b
    a.close()
    b.close()


def _buf(n):
    return MemoryBlock(np.zeros(n, dtype=np.uint8), size=n)


class TestRegistry:
    def test_register_fetch_roundtrip(self, pair):
        a, b = pair
        bid = ShuffleBlockId(0, 1, 2)
        b.register(bid, BytesBlock(b"payload-123"))
        out = _buf(64)
        results = []
        [req] = a.fetch_blocks_by_block_ids(2, [bid], [out], [results.append])
        # progress() contract: nothing completes until polled
        assert not req.completed() and not results
        while not req.completed():
            a.progress()
        res = req.wait(1)
        assert res.status == OperationStatus.SUCCESS
        assert out.host_view()[:11].tobytes() == b"payload-123"
        assert results and results[0].stats.recv_size == 11

    def test_fetch_missing_block_fails(self, pair):
        a, b = pair
        out = _buf(16)
        [req] = a.fetch_blocks_by_block_ids(2, [ShuffleBlockId(9, 9, 9)], [out], [None])
        while not req.completed():
            a.progress()
        assert req.wait(1).status == OperationStatus.FAILURE

    def test_fetch_unknown_executor_fails(self, pair):
        a, _ = pair
        [req] = a.fetch_blocks_by_block_ids(42, [ShuffleBlockId(0, 0, 0)], [_buf(4)], [None])
        while not req.completed():
            a.progress()
        assert req.wait(1).status == OperationStatus.FAILURE

    def test_oversized_block_fails_cleanly(self, pair):
        # A payload larger than the result buffer must complete as FAILURE,
        # not leave the request hanging.
        a, b = pair
        bid = ShuffleBlockId(0, 0, 0)
        b.register(bid, BytesBlock(b"x" * 100))
        [req] = a.fetch_blocks_by_block_ids(2, [bid], [_buf(16)], [None])
        while not req.completed():
            a.progress()
        res = req.wait(1)
        assert res.status == OperationStatus.FAILURE
        assert "exceeds result buffer" in str(res.error)

    def test_close_cancels_pending(self):
        fabric = LoopbackFabric()
        a = LoopbackTransport(executor_id=1, fabric=fabric)
        a.init()
        [req] = a.fetch_blocks_by_block_ids(1, [ShuffleBlockId(0, 0, 0)], [_buf(4)], [None])
        a.close()
        assert req.wait(1).status == OperationStatus.CANCELED

    def test_mutate_swaps_under_lock(self, pair):
        a, b = pair
        bid = ShuffleBlockId(0, 0, 0)
        b.register(bid, BytesBlock(b"old"))
        done = []
        b.mutate(bid, BytesBlock(b"new"), done.append)
        assert done[0].status == OperationStatus.SUCCESS
        out = _buf(8)
        [req] = a.fetch_blocks_by_block_ids(2, [bid], [out], [None])
        while not req.completed():
            a.progress()
        assert out.host_view()[:3].tobytes() == b"new"

    def test_unregister_shuffle_bulk(self, pair):
        _, b = pair
        for r in range(4):
            b.register(ShuffleBlockId(5, 0, r), BytesBlock(b"x"))
        b.register(ShuffleBlockId(6, 0, 0), BytesBlock(b"y"))
        b.unregister_shuffle(5)
        assert b.registered_block(ShuffleBlockId(5, 0, 1)) is None
        assert b.registered_block(ShuffleBlockId(6, 0, 0)) is not None

    def test_batch_fetch(self, pair):
        a, b = pair
        payloads = {r: bytes([r]) * (r + 1) for r in range(8)}
        for r, p in payloads.items():
            b.register(ShuffleBlockId(1, 0, r), BytesBlock(p))
        bids = [ShuffleBlockId(1, 0, r) for r in range(8)]
        bufs = [_buf(16) for _ in range(8)]
        reqs = a.fetch_blocks_by_block_ids(2, bids, bufs, [None] * 8)
        while not all(r.completed() for r in reqs):
            a.progress()
        for r in range(8):
            assert bufs[r].host_view()[: r + 1].tobytes() == payloads[r]


class TestStagedStore:
    def test_staged_fetch(self, pair):
        a, b = pair
        b.store_write(3, 1, 0, b"staged-bytes")
        out = _buf(64)
        req = a.fetch_block(2, 3, 1, 0, out)
        while not req.completed():
            a.progress()
        res = req.wait(1)
        assert res.status == OperationStatus.SUCCESS
        assert out.size == 12
        assert out.host_view()[:12].tobytes() == b"staged-bytes"

    def test_commit_block_validates(self, pair):
        a, _ = pair
        done = []
        blob = MapperInfo(1, 0, ((0, 10), (16, 6))).pack()
        a.commit_block(blob, done.append)
        assert done[0].status == OperationStatus.SUCCESS

    def test_unregister_shuffle_clears_store(self, pair):
        a, b = pair
        b.store_write(7, 0, 0, b"z")
        b.unregister_shuffle(7)
        req = a.fetch_block(2, 7, 0, 0, _buf(8))
        while not req.completed():
            a.progress()
        assert req.wait(1).status == OperationStatus.FAILURE


def test_is_transport_subclass():
    assert issubclass(LoopbackTransport, ShuffleTransport)


def _drive(mod_loopback, mod_block, mod_defs):
    """One sequence of every operation; returns what each observably did."""
    fabric = mod_loopback.LoopbackFabric()
    a = mod_loopback.LoopbackTransport(executor_id=1, fabric=fabric)
    b = mod_loopback.LoopbackTransport(executor_id=2, fabric=fabric)
    a.add_executor(2, b.init())
    b.add_executor(1, a.init())
    seen = []

    def spin(reqs):
        while not all(r.completed() for r in reqs):
            a.progress()
        return [r.wait(1) for r in reqs]

    def buf(n):
        return mod_block.MemoryBlock(np.zeros(n, dtype=np.uint8), size=n)

    for r in range(6):
        b.register(mod_block.ShuffleBlockId(1, 0, r), mod_block.BytesBlock(bytes([r + 1]) * (7 * r + 1)))
    b.mutate(mod_block.ShuffleBlockId(1, 0, 2), mod_block.BytesBlock(b"swapped"), seen.append)
    b.unregister(mod_block.ShuffleBlockId(1, 0, 5))
    bids = [mod_block.ShuffleBlockId(1, 0, r) for r in range(6)] + [mod_block.ShuffleBlockId(9, 9, 9)]
    bufs = [buf(32) for _ in bids]
    for res, out in zip(spin(a.fetch_blocks_by_block_ids(2, bids, bufs, [None] * len(bids))), bufs):
        seen.append((res.status.name, res.stats.recv_size if res.status.name == "SUCCESS" else None,
                     out.host_view()[: out.size].tobytes()))
    b.store_write(3, 1, 0, b"staged-bytes")
    for sid in (3, 4):
        out = buf(64)
        [res] = spin([a.fetch_block(2, sid, 1, 0, out)])
        seen.append((res.status.name, out.size))
    a.commit_block(mod_defs.MapperInfo(1, 0, ((0, 10), (16, 6))).pack(), seen.append)
    b.unregister_shuffle(1)
    seen.append(b.registered_block(mod_block.ShuffleBlockId(1, 0, 0)))
    a.close()
    b.close()
    return [(x.status.name if hasattr(x, "status") else x) for x in seen]


def test_one_sequence_equals_the_jax_transport():
    from sparkucx_tpu.core import block as jax_block
    from sparkucx_tpu.core import definitions as jax_defs
    from sparkucx_tpu.transport import loopback as jax_loopback
    from sparkucx_tpu_torch.core import block as torch_block
    from sparkucx_tpu_torch.core import definitions as torch_defs
    from sparkucx_tpu_torch.transport import loopback as torch_loopback

    got = _drive(torch_loopback, torch_block, torch_defs)
    assert got == _drive(jax_loopback, jax_block, jax_defs)
    assert got[1] == ("SUCCESS", 1, b"\x01")
    assert got[3] == ("SUCCESS", 7, b"swapped") and got[6][0] == got[7][0] == "FAILURE"
