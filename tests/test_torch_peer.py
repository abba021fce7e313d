"""Port twins of ``tests/test_peer.py``: the block server, batched fetch,
handshake, mapper-info broadcast and a two-process executor pair over
``sparkucx_tpu_torch/transport/peer.py``, stores on the CPU.  Then the
cross-package wire: a JAX ``PeerTransport`` fetches from a port server and a
port ``PeerTransport`` from a JAX server, at ``wire.streams`` 1 and 4, with
checksums and compressed pages, byte for byte; and a device-staged store
(``write_partition_device``, sealed by the scatter's plain version on CPU
tensors) served a batch at a time through one block gather per round.
"""

import signal

import numpy as np
import pytest

from sparkucx_tpu_torch.config import TpuShuffleConf
from sparkucx_tpu_torch.core.block import BytesBlock, MemoryBlock, ShuffleBlockId
from sparkucx_tpu_torch.core.operation import OperationStatus
from sparkucx_tpu_torch.transport.peer import pack_batch_fetch_req, unpack_batch_fetch_req
from sparkucx_tpu_torch.transport import peer as _peer_mod

#: seconds a test of this file may run; past it the test fails instead of
#: hanging the run (a socket wait that never returns)
TEST_TIMEOUT_S = 60


@pytest.fixture(autouse=True)
def _deadline():
    """Interrupt this test with a TimeoutError once it has run for
    ``TEST_TIMEOUT_S`` (SIGALRM; pytest runs tests on the main thread)."""

    def expire(signum, frame):
        raise TimeoutError(f"test ran past its {TEST_TIMEOUT_S} s limit")

    previous = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, TEST_TIMEOUT_S)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)



class PeerTransport(_peer_mod.PeerTransport):
    """The port's PeerTransport with its store on the CPU (its default is the card)."""

    def __init__(self, conf=None, executor_id=0, store=None, device="cpu"):
        super().__init__(conf, executor_id, store, device=device)


def _buf(n):
    return MemoryBlock(np.zeros(n, dtype=np.uint8), size=n)


@pytest.fixture
def pair():
    conf = TpuShuffleConf(staging_capacity_per_executor=1 << 20, max_blocks_per_request=4)
    a = PeerTransport(conf, executor_id=1)
    b = PeerTransport(conf, executor_id=2)
    addr_a, addr_b = a.init(), b.init()
    a.add_executor(2, addr_b)
    b.add_executor(1, addr_a)
    yield a, b
    a.close()
    b.close()


def _drive(t, reqs, timeout=5.0):
    import time

    deadline = time.monotonic() + timeout
    while not all(r.completed() for r in reqs):
        t.progress()
        if time.monotonic() > deadline:
            raise TimeoutError("requests did not complete")
        time.sleep(0.001)


class TestWire:
    def test_batch_header_roundtrip(self):
        bids = [ShuffleBlockId(1, 2, 3), ShuffleBlockId(4, 5, 6)]
        tag, got = unpack_batch_fetch_req(pack_batch_fetch_req(77, bids))
        assert tag == 77 and got == bids


class TestPeerFetch:
    def test_registered_block_fetch(self, pair):
        a, b = pair
        bid = ShuffleBlockId(0, 0, 0)
        b.register(bid, BytesBlock(b"over-the-wire"))
        out = _buf(64)
        [req] = a.fetch_blocks_by_block_ids(2, [bid], [out], [None])
        assert not req.completed()  # explicit-poll contract
        _drive(a, [req])
        assert req.wait(1).status == OperationStatus.SUCCESS
        assert out.host_view()[: out.size].tobytes() == b"over-the-wire"

    def test_batched_fetch_with_windowing(self, pair):
        a, b = pair
        payloads = {r: bytes([r + 1]) * (100 * (r + 1)) for r in range(10)}
        for r, p in payloads.items():
            b.register(ShuffleBlockId(1, 0, r), BytesBlock(p))
        bids = [ShuffleBlockId(1, 0, r) for r in range(10)]
        bufs = [_buf(2048) for _ in range(10)]
        reqs = a.fetch_blocks_by_block_ids(2, bids, bufs, [None] * 10)  # 3 windows of 4
        _drive(a, reqs)
        for r in range(10):
            assert reqs[r].wait(1).status == OperationStatus.SUCCESS
            assert bufs[r].host_view()[: bufs[r].size].tobytes() == payloads[r]

    def test_partial_batch_failure(self, pair):
        a, b = pair
        b.register(ShuffleBlockId(2, 0, 0), BytesBlock(b"found"))
        bids = [ShuffleBlockId(2, 0, 0), ShuffleBlockId(2, 0, 99)]
        bufs = [_buf(64), _buf(64)]
        reqs = a.fetch_blocks_by_block_ids(2, bids, bufs, [None, None])
        _drive(a, reqs)
        assert reqs[0].wait(1).status == OperationStatus.SUCCESS
        res1 = reqs[1].wait(1)
        assert res1.status == OperationStatus.FAILURE
        assert "not found" in str(res1.error)

    def test_staged_store_fetch(self, pair):
        a, b = pair
        b.store.create_shuffle(3, 1, 2)
        w = b.store.map_writer(3, 0)
        w.write_partition(0, b"staged-over-wire")
        w.commit()
        out = _buf(64)
        req = a.fetch_block(2, 3, 0, 0, out)
        _drive(a, [req])
        assert req.wait(1).status == OperationStatus.SUCCESS
        assert out.host_view()[: out.size].tobytes() == b"staged-over-wire"

    def test_unknown_executor(self, pair):
        a, _ = pair
        [req] = a.fetch_blocks_by_block_ids(42, [ShuffleBlockId(0, 0, 0)], [_buf(8)], [None])
        assert req.wait(1).status == OperationStatus.FAILURE

    def test_callbacks_fire_under_progress(self, pair):
        a, b = pair
        b.register(ShuffleBlockId(4, 0, 0), BytesBlock(b"cb"))
        got = []
        [req] = a.fetch_blocks_by_block_ids(2, [ShuffleBlockId(4, 0, 0)], [_buf(8)], [got.append])
        _drive(a, [req])
        assert got and got[0].status == OperationStatus.SUCCESS


class TestThreadSlots:
    def test_threads_use_distinct_connections(self):
        # threadId % numClientWorkers routing (UcxShuffleTransport.scala:277-279)
        import threading

        conf = TpuShuffleConf(staging_capacity_per_executor=1 << 18, num_client_workers=4)
        a = PeerTransport(conf, executor_id=1)
        b = PeerTransport(conf, executor_id=2)
        a.init()
        a.add_executor(2, b.init())
        b.register(ShuffleBlockId(0, 0, 0), BytesBlock(b"slot"))
        done = []

        def worker():
            [req] = a.fetch_blocks_by_block_ids(2, [ShuffleBlockId(0, 0, 0)], [_buf(16)], [None])
            _drive(a, [req])
            done.append(req.wait(1).status)

        threads = [threading.Thread(target=worker) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert all(s == OperationStatus.SUCCESS for s in done)
        # multiple slots were actually opened for the single peer
        assert len({k for k in a._conns if k[0] == 2}) >= 2
        a.close()
        b.close()


class TestControlMessages:
    def test_init_executor_handshake(self, pair):
        a, b = pair
        a.init_executor(4, 8)
        assert b.server.handshaken[1] == b"4x8"

    def test_commit_block_broadcast(self, pair):
        from sparkucx_tpu_torch.core.definitions import MapperInfo
        import time

        a, b = pair
        b.store.create_shuffle(5, 2, 2)
        blob = MapperInfo(5, 1, ((0, 64), (512, 32))).pack()
        a.commit_block(blob)
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            if b.store.block_length(5, 1, 0) == 64:
                break
            time.sleep(0.01)
        assert b.store.block_length(5, 1, 0) == 64
        assert b.store.block_length(5, 1, 1) == 32


class TestMultiProcess:
    def test_two_process_shuffle(self, tmp_path):
        """A real second process serves blocks over its BlockServer."""
        import subprocess
        import sys
        import textwrap

        script = textwrap.dedent(
            """
            import sys, numpy as np
            sys.path.insert(0, %r)
            from sparkucx_tpu_torch.config import TpuShuffleConf
            from sparkucx_tpu_torch.transport.peer import PeerTransport

            conf = TpuShuffleConf(staging_capacity_per_executor=1 << 20)
            t = PeerTransport(conf, executor_id=2, device="cpu")
            addr = t.init()
            t.store.create_shuffle(0, 1, 4)
            w = t.store.map_writer(0, 0)
            for r in range(4):
                w.write_partition(r, bytes([r]) * (100 + r))
            w.commit()
            print(addr.decode(), flush=True)
            sys.stdin.readline()  # hold until parent is done
            t.close()
            """
            % __import__("os").path.dirname(__import__("os").path.dirname(__import__("os").path.abspath(__file__)))
        )
        proc = subprocess.Popen(
            [sys.executable, "-c", script],
            stdout=subprocess.PIPE,
            stdin=subprocess.PIPE,
            text=True,
        )
        try:
            addr = proc.stdout.readline().strip().encode()
            assert addr, "child failed to start"
            conf = TpuShuffleConf(staging_capacity_per_executor=1 << 20)
            a = PeerTransport(conf, executor_id=1)
            a.init()
            a.add_executor(2, addr)
            bufs = [_buf(256) for _ in range(4)]
            reqs = a.fetch_blocks_by_block_ids(
                2, [ShuffleBlockId(0, 0, r) for r in range(4)], bufs, [None] * 4
            )
            _drive(a, reqs, timeout=10)
            for r in range(4):
                assert reqs[r].wait(1).status == OperationStatus.SUCCESS
                assert bufs[r].host_view()[: bufs[r].size].tobytes() == bytes([r]) * (100 + r)
            a.close()
        finally:
            try:
                proc.stdin.write("done\n")
                proc.stdin.flush()
            except OSError:
                pass
            proc.terminate()
            proc.wait(timeout=10)


class TestNativeReplyAssembly:
    """Reply construction from zero-copy views (block_staging_view +
    registry-materialized buffers): the vectored sendmsg parts (primary) and
    the contiguous assembly (no-sendmsg fallback) must produce
    identical bytes for mixed store/registry/empty/missing batches."""

    def test_mixed_sources_roundtrip(self):
        import numpy as np
        from sparkucx_tpu_torch.config import TpuShuffleConf
        from sparkucx_tpu_torch.core.block import BytesBlock, ShuffleBlockId
        from sparkucx_tpu_torch.store.hbm_store import HbmBlockStore
        from sparkucx_tpu_torch.transport.peer import BlockServer

        conf = TpuShuffleConf(staging_capacity_per_executor=1 << 20, block_alignment=128)
        store = HbmBlockStore(conf)
        store.create_shuffle(7, 1, 3)
        w = store.map_writer(7, 0)
        rng = np.random.default_rng(3)
        p0 = rng.integers(0, 256, size=999, dtype=np.uint8).tobytes()
        w.write_partition(0, p0)
        w.write_partition(1, b"")          # empty block
        w.write_partition(2, b"z" * 300)
        w.commit()

        reg_payload = b"registry-bytes" * 10
        registry = {ShuffleBlockId(9, 0, 0): BytesBlock(np.frombuffer(reg_payload, np.uint8))}

        srv = BlockServer(conf, store=store, registry_lookup=registry.get)
        try:
            bids = [
                ShuffleBlockId(7, 0, 0),   # store view
                ShuffleBlockId(9, 0, 0),   # registry bytes
                ShuffleBlockId(7, 0, 1),   # empty store block
                ShuffleBlockId(7, 0, 99),  # missing -> -1
                ShuffleBlockId(7, 0, 2),   # store view again (same staging)
            ]
            entries = [srv._resolve_one(b) for b in bids]
            sizes_blob, body = srv._assemble_reply(entries)
            import struct

            sizes = struct.unpack(f"<{len(bids)}q", sizes_blob)
            assert sizes == (999, len(reg_payload), 0, -1, 300)
            got = bytes(body)
            assert got == p0 + reg_payload + b"z" * 300
            # the vectored (sendmsg) form must be byte-identical to the
            # assembled fallback
            sizes_blob2, parts, total = srv._reply_parts(entries)
            assert sizes_blob2 == sizes_blob
            assert total == len(got)
            assert b"".join(bytes(p) for p in parts) == got
        finally:
            srv.close()

    def test_view_survives_seal(self):
        import numpy as np
        from sparkucx_tpu_torch.config import TpuShuffleConf
        from sparkucx_tpu_torch.store.hbm_store import HbmBlockStore

        conf = TpuShuffleConf(staging_capacity_per_executor=1 << 20, block_alignment=128)
        store = HbmBlockStore(conf)
        store.create_shuffle(1, 1, 1)
        w = store.map_writer(1, 0)
        w.write_partition(0, b"q" * 500)
        w.commit()
        store.seal(1)
        view = store.block_staging_view(1, 0, 0)
        assert view is not None
        staging, off, ln = view
        assert ln == 500
        assert staging[off : off + ln].tobytes() == b"q" * 500


class TestMalformedFrames:
    """A misbehaving client must cost only its own connection — the server
    keeps serving others (endpoint-eviction semantics,
    UcxWorkerWrapper.scala:248-253)."""

    def test_garbage_then_valid_client(self):
        import socket as socketlib
        import struct as structlib

        import numpy as np
        from sparkucx_tpu_torch.config import TpuShuffleConf
        from sparkucx_tpu_torch.core.block import BytesBlock, ShuffleBlockId
        from sparkucx_tpu_torch.transport.peer import BlockServer

        conf = TpuShuffleConf()
        payload = b"served" * 100
        registry = {ShuffleBlockId(0, 0, 0): BytesBlock(np.frombuffer(payload, np.uint8))}
        srv = BlockServer(conf, registry_lookup=registry.get)
        try:
            for garbage in (
                b"\x00" * 16,                                   # bogus frame header
                structlib.pack("<iqq", 3, 4, 10) + b"\xff" * 14,  # FETCH req, truncated header
                b"short",
            ):
                s = socketlib.create_connection(srv.address, timeout=5)
                s.sendall(garbage)
                s.close()

            # the server must still serve a well-formed client
            t = PeerTransport(conf, executor_id=5)
            t.add_executor(0, srv.address_bytes())
            from sparkucx_tpu_torch.core.block import MemoryBlock
            buf = MemoryBlock(np.zeros(1024, np.uint8), size=1024)
            [req] = t.fetch_blocks_by_block_ids(0, [ShuffleBlockId(0, 0, 0)], [buf], [None])
            while not req.completed():
                t.progress()
            res = req.wait(5)
            assert res.status.name == "SUCCESS", str(res.error)
            assert buf.host_view()[: buf.size].tobytes() == payload
            t.close()
        finally:
            srv.close()


class TestMalformedAck:
    """A fetch-ack whose size list disagrees with the frame body (skewed or
    buggy peer) must fail the whole batch with FAILURE results — not raise a
    slicing error out of progress() and leave the batch incomplete."""

    def _inject(self, a, header, body):
        from sparkucx_tpu_torch.core.definitions import AmId
        from sparkucx_tpu_torch.core.operation import OperationStats, Request

        reqs = [Request(OperationStats()) for _ in range(2)]
        bufs = [_buf(64), _buf(64)]
        a._inflight[7] = (reqs, bufs, [None, None], None)
        a._handle_frame((AmId.FETCH_BLOCK_REQ_ACK, header, body, False))
        return reqs

    def test_sizes_disagree_with_body(self):
        from sparkucx_tpu_torch.transport import peer as peer_mod

        conf = TpuShuffleConf(staging_capacity_per_executor=1 << 20)
        a = PeerTransport(conf, executor_id=1)
        try:
            # sizes claim 10+10 bytes but the body carries only 5
            header = (
                peer_mod._TAG.pack(7)
                + peer_mod._COUNT.pack(2)
                + peer_mod._SIZE.pack(10)
                + peer_mod._SIZE.pack(10)
            )
            reqs = self._inject(a, header, b"12345")
            for r in reqs:
                res = r.wait(1)
                assert res.status == OperationStatus.FAILURE
                assert "malformed" in str(res.error)
            assert 7 not in a._inflight  # batch retired, nothing leaks
        finally:
            a.close()

    def test_truncated_size_list(self):
        from sparkucx_tpu_torch.transport import peer as peer_mod

        conf = TpuShuffleConf(staging_capacity_per_executor=1 << 20)
        a = PeerTransport(conf, executor_id=1)
        try:
            # count says 2 but the header carries no size entries at all —
            # must fail the batch, not raise struct.error out of progress()
            header = peer_mod._TAG.pack(7) + peer_mod._COUNT.pack(2)
            reqs = self._inject(a, header, b"")
            for r in reqs:
                res = r.wait(1)
                assert res.status == OperationStatus.FAILURE
                assert "malformed" in str(res.error)
        finally:
            a.close()

    def test_count_disagrees_with_batch(self):
        from sparkucx_tpu_torch.transport import peer as peer_mod

        conf = TpuShuffleConf(staging_capacity_per_executor=1 << 20)
        a = PeerTransport(conf, executor_id=1)
        try:
            # one size entry for a two-request batch: zip would silently leave
            # the second request incomplete
            header = peer_mod._TAG.pack(7) + peer_mod._COUNT.pack(1) + peer_mod._SIZE.pack(3)
            reqs = self._inject(a, header, b"abc")
            for r in reqs:
                res = r.wait(1)
                assert res.status == OperationStatus.FAILURE
                assert "malformed" in str(res.error)
        finally:
            a.close()


class TestEvictedConnectionDrain:
    """An ack that parked before its connection was evicted must still
    complete under progress() (the zombie-drain path) — before, eviction
    removed the conn from the cache and its parked frames were lost."""

    def test_parked_ack_survives_eviction(self):
        import time as timelib

        import numpy as np
        from sparkucx_tpu_torch.config import TpuShuffleConf
        from sparkucx_tpu_torch.core.block import BytesBlock, MemoryBlock, ShuffleBlockId
        from sparkucx_tpu_torch.transport.peer import BlockServer

        conf = TpuShuffleConf()
        payload = b"evict-me" * 200
        registry = {ShuffleBlockId(0, 0, 0): BytesBlock(np.frombuffer(payload, np.uint8))}
        srv = BlockServer(conf, registry_lookup=registry.get)
        t = PeerTransport(conf, executor_id=3)
        try:
            t.add_executor(0, srv.address_bytes())
            buf = MemoryBlock(np.zeros(4096, np.uint8), size=4096)
            [req] = t.fetch_blocks_by_block_ids(0, [ShuffleBlockId(0, 0, 0)], [buf], [None])

            # wait for the ack to PARK (recv thread) without draining it
            deadline = timelib.monotonic() + 10
            conns = list(t._conns.values())
            assert conns
            while timelib.monotonic() < deadline and not any(c.inbox for c in conns):
                timelib.sleep(0.005)
            assert any(c.inbox for c in conns), "ack never parked"

            t._evict(0)  # connection gone from the cache, frame still parked

            deadline = timelib.monotonic() + 10
            while not req.completed() and timelib.monotonic() < deadline:
                t.progress()
            res = req.wait(1)
            assert res.status.name == "SUCCESS", str(res.error)
            assert buf.host_view()[: buf.size].tobytes() == payload
            # zombie retired once nothing references it
            for _ in range(10):
                t.progress()
            assert not t._zombies
        finally:
            t.close()
            srv.close()


# ---------------------------------------------------------------------------
# the cross-package wire, and device-staged serving
# ---------------------------------------------------------------------------

import torch  # noqa: E402

import sparkucx_tpu.config as jax_config  # noqa: E402
import sparkucx_tpu.core.block as jax_block  # noqa: E402
import sparkucx_tpu.transport.peer as jax_peer  # noqa: E402
import sparkucx_tpu_torch.store.hbm_store as port_store  # noqa: E402
from sparkucx_tpu_torch.store.hbm_store import HbmBlockStore  # noqa: E402
from sparkucx_tpu_torch.transport.peer import BlockServer  # noqa: E402


def _payloads(seed, num_mappers, num_reducers):
    """Seeded blocks, half of them word runs that the page codecs shrink,
    sizes off every alignment, one empty."""
    rng = np.random.default_rng(seed)
    out = {}
    for m in range(num_mappers):
        for r in range(num_reducers):
            n = int(rng.integers(1, 9000))
            if (m + r) % 2:
                words = np.repeat(rng.integers(0, 2**32, size=8, dtype=np.uint64).astype("<u4"), -(-n // 32))
                out[(m, r)] = words.tobytes()[:n]
            else:
                out[(m, r)] = rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()
    out[(0, 0)] = b""
    return out


def _stage_both(t, payloads, shuffle_id, num_mappers, num_reducers):
    t.store.create_shuffle(shuffle_id, num_mappers, num_reducers)
    for m in range(num_mappers):
        w = t.store.map_writer(shuffle_id, m)
        for r in range(num_reducers):
            w.write_partition(r, payloads[(m, r)])
        w.commit()


def _fetch_every(client, peer, mk_id, mk_buf, payloads, shuffle_id, timeout=20.0, missing=()):
    """Every block of ``payloads`` fetched in one call; the blocks of
    ``missing`` must fail (the server answered them as not found) and are
    left out of the result."""
    keys = sorted(payloads)
    bids = [mk_id(shuffle_id, m, r) for m, r in keys]
    bufs = [mk_buf(max(1, len(payloads[k]))) for k in keys]
    reqs = client.fetch_blocks_by_block_ids(peer, bids, bufs, [None] * len(bids))
    _drive(client, reqs, timeout=timeout)
    got = {}
    for k, req, buf in zip(keys, reqs, bufs):
        res = req.wait(1)
        if k in missing:
            assert res.status.name == "FAILURE", f"block {k} was served"
            continue
        assert res.status.name == "SUCCESS", str(res.error)
        got[k] = buf.host_view()[: buf.size].tobytes()
    return got


def _served(payloads, device_staged):
    """What a server answers for ``payloads``: a committed empty block of a
    device-staged round keeps no tensor and is answered as missing, by the
    JAX store and the port alike; every other block with its bytes."""
    if not device_staged:
        return payloads
    return {k: v for k, v in payloads.items() if v}


_WIRE = [(1, False, "off"), (4, False, "off"), (1, True, "off"), (4, True, "rle"), (1, False, "dict"), (4, True, "off")]


class TestCrossPackageWire:
    @pytest.mark.parametrize("streams,checksum,codec", _WIRE)
    def test_jax_client_fetches_from_port_server(self, streams, checksum, codec):
        kw = dict(staging_capacity_per_executor=1 << 20, wire_streams=streams, wire_chunk_bytes=4096,
                  wire_checksum=checksum, wire_compress_codec=codec, max_blocks_per_request=5)
        payloads = _payloads(1, 3, 4)
        server = PeerTransport(TpuShuffleConf(**kw), executor_id=2)
        client = jax_peer.PeerTransport(jax_config.TpuShuffleConf(**kw), executor_id=1)
        try:
            _stage_both(server, payloads, 0, 3, 4)
            client.add_executor(2, server.init())
            got = _fetch_every(client, 2, jax_block.ShuffleBlockId,
                               lambda n: jax_block.MemoryBlock(np.zeros(n, np.uint8), size=n), payloads, 0)
            assert got == payloads
        finally:
            client.close()
            server.close()

    @pytest.mark.parametrize("streams,checksum,codec", _WIRE)
    def test_port_client_fetches_from_jax_server(self, streams, checksum, codec):
        kw = dict(staging_capacity_per_executor=1 << 20, wire_streams=streams, wire_chunk_bytes=4096,
                  wire_checksum=checksum, wire_compress_codec=codec, max_blocks_per_request=5)
        payloads = _payloads(2, 3, 4)
        server = jax_peer.PeerTransport(jax_config.TpuShuffleConf(**kw), executor_id=2)
        client = PeerTransport(TpuShuffleConf(**kw), executor_id=1)
        try:
            _stage_both(server, payloads, 0, 3, 4)
            client.add_executor(2, server.init())
            got = _fetch_every(client, 2, ShuffleBlockId, _buf, payloads, 0)
            assert got == payloads
            if codec != "off" and streams > 1:
                assert server.compress_stats()["encoded_chunks"] > 0
        finally:
            client.close()
            server.close()

    def test_reply_frames_equal_jax_servers(self):
        """The same blocks staged in a port store and a JAX store give the
        same sizes blob and the same vectored reply bytes."""
        payloads = _payloads(3, 2, 3)
        kw = dict(staging_capacity_per_executor=1 << 20, block_alignment=128)
        port = HbmBlockStore(TpuShuffleConf(**kw))
        import sparkucx_tpu.store.hbm_store as jax_store

        ref = jax_store.HbmBlockStore(jax_config.TpuShuffleConf(**kw))
        for store in (port, ref):
            store.create_shuffle(4, 2, 3)
            for m in range(2):
                w = store.map_writer(4, m)
                for r in range(3):
                    w.write_partition(r, payloads[(m, r)])
                w.commit()
        p_srv = BlockServer(TpuShuffleConf(**kw), store=port)
        j_srv = jax_peer.BlockServer(jax_config.TpuShuffleConf(**kw), store=ref)
        try:
            keys = [(m, r) for m in range(2) for r in range(3)] + [(0, 99)]
            p_parts = p_srv._reply_parts(p_srv._resolve_batch([ShuffleBlockId(4, m, r) for m, r in keys]))
            j_parts = j_srv._reply_parts([j_srv._resolve_one(jax_block.ShuffleBlockId(4, m, r)) for m, r in keys])
            assert p_parts[0] == j_parts[0] and p_parts[2] == j_parts[2]
            assert b"".join(bytes(x) for x in p_parts[1]) == b"".join(bytes(x) for x in j_parts[1])
        finally:
            p_srv.close()
            j_srv.close()

    def test_store_defaults_to_the_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            _peer_mod.PeerTransport(TpuShuffleConf(), executor_id=0)


def _device_stage(t, payloads, shuffle_id, num_mappers, num_reducers):
    """Stage ``payloads`` through ``write_partition_device`` on CPU tensors."""
    t.store.create_shuffle(shuffle_id, num_mappers, num_reducers)
    align = t.store.conf.block_alignment
    lane = align // 4
    for m in range(num_mappers):
        w = t.store.map_writer(shuffle_id, m)
        for r in range(num_reducers):
            data = payloads[(m, r)]
            rows = -(-len(data) // align)
            buf = np.zeros(rows * align, np.uint8)
            buf[: len(data)] = np.frombuffer(data, np.uint8)
            w.write_partition_device(r, torch.from_numpy(buf.view(np.int32).reshape(rows, lane)), len(data))
        w.commit()


class TestDeviceStagedServing:
    """A device-staged round is served a batch at a time: one block gather per
    batch over the sealed round (the scatter kernel's output), one copy to
    the host, the reply's views into it."""

    @pytest.fixture
    def gathers(self, monkeypatch):
        calls = []
        real = port_store.block_gather

        def counting(*args, **kwargs):
            calls.append(int(args[0].shape[0]))
            return real(*args, **kwargs)

        monkeypatch.setattr(port_store, "block_gather", counting)
        return calls

    @pytest.mark.parametrize("streams,checksum", [(1, False), (4, False), (4, True)])
    def test_sealed_round_one_gather_a_batch(self, gathers, streams, checksum):
        kw = dict(staging_capacity_per_executor=1 << 21, wire_streams=streams, wire_chunk_bytes=4096,
                  wire_checksum=checksum, max_blocks_per_request=6, device_staging=True)
        payloads = _payloads(4, 4, 3)
        a, b = PeerTransport(TpuShuffleConf(**kw), executor_id=1), PeerTransport(TpuShuffleConf(**kw), executor_id=2)
        try:
            a.init()
            a.add_executor(2, b.init())
            _device_stage(b, payloads, 0, 4, 3)
            b.store.seal(0)
            got = _fetch_every(a, 2, ShuffleBlockId, _buf, payloads, 0, missing={(0, 0)})
            assert got == _served(payloads, True)
            # 12 blocks in windows of 6: one gather a window, of its non-empty blocks
            assert gathers == [5, 6]
        finally:
            a.close()
            b.close()

    def test_unsealed_round_lands_without_a_gather(self, gathers):
        kw = dict(staging_capacity_per_executor=1 << 21, max_blocks_per_request=50, device_staging=True)
        payloads = _payloads(5, 2, 3)
        a, b = PeerTransport(TpuShuffleConf(**kw), executor_id=1), PeerTransport(TpuShuffleConf(**kw), executor_id=2)
        try:
            a.init()
            a.add_executor(2, b.init())
            _device_stage(b, payloads, 0, 2, 3)
            got = _fetch_every(a, 2, ShuffleBlockId, _buf, payloads, 0, missing={(0, 0)})
            assert got == _served(payloads, True) and gathers == []
        finally:
            a.close()
            b.close()

    def test_jax_client_reads_device_staged_port_server(self, gathers):
        kw = dict(staging_capacity_per_executor=1 << 21, wire_streams=4, wire_chunk_bytes=4096,
                  max_blocks_per_request=12)
        payloads = _payloads(6, 4, 3)
        server = PeerTransport(TpuShuffleConf(device_staging=True, **kw), executor_id=2)
        client = jax_peer.PeerTransport(jax_config.TpuShuffleConf(**kw), executor_id=1)
        try:
            _device_stage(server, payloads, 0, 4, 3)
            server.store.seal(0)
            client.add_executor(2, server.init())
            got = _fetch_every(client, 2, jax_block.ShuffleBlockId,
                               lambda n: jax_block.MemoryBlock(np.zeros(n, np.uint8), size=n), payloads, 0,
                               missing={(0, 0)})
            assert got == _served(payloads, True) and gathers == [11]
        finally:
            client.close()
            server.close()

    @pytest.mark.parametrize("sealed", [False, True])
    def test_reply_frames_equal_jax_servers(self, sealed):
        """The same blocks staged through ``write_partition_device`` in a port
        store and a JAX store give the same sizes blob (a committed empty
        block and an unknown one both -1) and the same reply bytes, before
        and after the seal; ``block_staging_view`` hands out the same bytes."""
        import jax.numpy as jnp

        import sparkucx_tpu.store.hbm_store as jax_store

        payloads = _payloads(9, 2, 3)
        kw = dict(staging_capacity_per_executor=1 << 20, block_alignment=128, device_staging=True)
        port = HbmBlockStore(TpuShuffleConf(**kw))
        ref = jax_store.HbmBlockStore(jax_config.TpuShuffleConf(gather_impl="xla", **kw))
        for store, asarray in ((port, torch.from_numpy), (ref, jnp.asarray)):
            store.create_shuffle(4, 2, 3)
            for m in range(2):
                w = store.map_writer(4, m)
                for r in range(3):
                    data = payloads[(m, r)]
                    buf = np.zeros(-(-len(data) // 128) * 128, np.uint8)
                    buf[: len(data)] = np.frombuffer(data, np.uint8)
                    w.write_partition_device(r, asarray(buf.view(np.int32).reshape(-1, 32)), len(data))
                w.commit()
            if sealed:
                store.seal(4)
        p_srv = BlockServer(TpuShuffleConf(**kw), store=port)
        j_srv = jax_peer.BlockServer(jax_config.TpuShuffleConf(**kw), store=ref)
        try:
            keys = [(m, r) for m in range(2) for r in range(3)] + [(0, 99)]
            p_parts = p_srv._reply_parts(p_srv._resolve_batch([ShuffleBlockId(4, m, r) for m, r in keys]))
            j_parts = j_srv._reply_parts([j_srv._resolve_one(jax_block.ShuffleBlockId(4, m, r)) for m, r in keys])
            assert p_parts[0] == j_parts[0] and p_parts[2] == j_parts[2]
            assert np.frombuffer(p_parts[0], "<i8")[0] == -1  # the empty block (0, 0)
            assert b"".join(bytes(x) for x in p_parts[1]) == b"".join(bytes(x) for x in j_parts[1])
            for m, r in keys:
                p_view, j_view = port.block_staging_view(4, m, r), ref.block_staging_view(4, m, r)
                assert (p_view is None) == (j_view is None), (m, r)
                if p_view is not None:
                    assert p_view[0][p_view[1] : p_view[1] + p_view[2]].tobytes() == \
                        j_view[0][j_view[1] : j_view[1] + j_view[2]].tobytes()
        finally:
            p_srv.close()
            j_srv.close()

    def test_replica_source_lands_the_round_once(self, gathers):
        kw = dict(staging_capacity_per_executor=1 << 21, replication_factor=1, device_staging=True)
        payloads = _payloads(7, 3, 2)
        a, b = PeerTransport(TpuShuffleConf(**kw), executor_id=0), PeerTransport(TpuShuffleConf(**kw), executor_id=1)
        try:
            addrs = a.init(), b.init()
            a.add_executor(1, addrs[1])
            b.add_executor(0, addrs[0])
            _device_stage(a, payloads, 0, 3, 2)
            a.store.seal(0)
            assert a.replication_wait(0, timeout=10.0, strict=True)
            for (m, r), data in payloads.items():
                assert b.store.replica_block(0, 0, m, r) == data
            assert gathers == [5]
        finally:
            a.close()
            b.close()

    def test_hot_device_block_pins_in_serve_cache(self, gathers):
        kw = dict(staging_capacity_per_executor=1 << 21, device_staging=True,
                  serve_hot_threshold_fetches_per_sec=1.0, serve_cache_bytes=1 << 20)
        payloads = _payloads(8, 1, 2)
        a, b = PeerTransport(TpuShuffleConf(**kw), executor_id=1), PeerTransport(TpuShuffleConf(**kw), executor_id=2)
        try:
            a.init()
            a.add_executor(2, b.init())
            _device_stage(b, payloads, 0, 1, 2)
            b.store.seal(0)
            p = payloads[(0, 1)]
            for _ in range(8):
                buf = _buf(len(p))
                req = a.fetch_block(2, 0, 0, 1, buf)
                _drive(a, [req])
                assert req.wait(1).status.name == "SUCCESS" and buf.host_view()[: buf.size].tobytes() == p
            snap = b.store.serve_cache.snapshot()
            assert snap["cache_entries"] == 1 and snap["cache_hits"] >= 1 and snap["cache_used_bytes"] == len(p)
            # served from the device until the block was pinned, then from the cache
            assert 1 <= len(gathers) < 8
        finally:
            a.close()
            b.close()
