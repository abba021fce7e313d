"""Port twins of ``tests/test_wire.py``: the striped zero-copy wire of
``sparkucx_tpu_torch/transport/peer.py`` — zero-copy receive and vectored send
under short reads and partial sends, the chunk protocol, single-lane
bit-equality, the striped oracle, stripe reassembly under any interleaving,
wire timeouts, CRC32C, the checksum and compression knobs, and the bounded
replicator — each run on the port with its stores on the CPU.  The reader's
credit pipelining, hedges and failover, ``CreditGate``, the memory sanitizer
and the eviction tiers are not ported and have no twins here.  The last
section holds the frame helpers and CRC32C vectors byte-equal to the JAX
package's.
"""

import random
import signal
import socket
import struct
import threading
import time

import numpy as np
import pytest

from sparkucx_tpu_torch.config import TpuShuffleConf
from sparkucx_tpu_torch.core.block import BytesBlock, MemoryBlock, ShuffleBlockId
from sparkucx_tpu_torch.core.definitions import (
    FRAME_HEADER_SIZE,
    AmId,
    pack_chunk_hdr,
    pack_frame,
    pack_frame_prefix,
    pack_wire_hello,
    unpack_chunk_hdr,
    unpack_frame_header,
    unpack_wire_hello,
)
from sparkucx_tpu_torch.core.operation import OperationStats, OperationStatus, Request
from sparkucx_tpu_torch.transport.peer import (
    BlockServer,
    _StripeRx,
    pack_batch_fetch_req,
    recv_exact,
    recv_frame,
)
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


_TAG = struct.Struct("<Q")
_COUNT = struct.Struct("<I")
_SIZE = struct.Struct("<q")


class PeerTransport(_peer_mod.PeerTransport):
    """The port's PeerTransport with its store on the CPU (its default is the card)."""

    def __init__(self, conf=None, executor_id=0, store=None, device="cpu"):
        super().__init__(conf, executor_id, store, device=device)


def _buf(n):
    return MemoryBlock(np.zeros(n, dtype=np.uint8), size=n)


def _drive(t, reqs, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not all(r.completed() for r in reqs):
        t.progress()
        if time.monotonic() > deadline:
            raise TimeoutError("requests did not complete")
        time.sleep(0.001)


def _pair(streams=1, chunk_bytes=1 << 20, **kw):
    conf = TpuShuffleConf(wire_streams=streams, wire_chunk_bytes=chunk_bytes, **kw)
    a = PeerTransport(conf, executor_id=1)
    b = PeerTransport(conf, executor_id=2)
    a.init()
    a.add_executor(2, b.init())
    return a, b


class ShortReadSock:
    """recv_into hands out at most ``step`` bytes per call (short reads)."""

    def __init__(self, data: bytes, step: int = 3):
        self.data = memoryview(bytes(data))
        self.pos = 0
        self.step = step

    def recv_into(self, mv, n):
        n = min(n, self.step, len(self.data) - self.pos)
        if n <= 0:
            return 0  # EOF
        mv[:n] = self.data[self.pos : self.pos + n]
        self.pos += n
        return n


class PartialSendSock:
    """sendmsg/sendall accept at most ``step`` bytes per call, splitting
    mid-iovec; everything sent accumulates in ``out``."""

    def __init__(self, step: int = 5):
        self.out = bytearray()
        self.step = step

    def sendmsg(self, bufs):
        budget = self.step
        sent = 0
        for b in bufs:
            n = min(budget - sent, b.nbytes)
            self.out += bytes(b[:n])
            sent += n
            if sent >= budget:
                break
        return sent

    def sendall(self, data):
        self.out += bytes(data)


class TestRecvExact:
    def test_short_reads_reassemble(self):
        payload = bytes(range(256)) * 7
        got = recv_exact(ShortReadSock(payload, step=3), len(payload))
        assert got is not None and bytes(got) == payload

    def test_eof_mid_read_returns_none(self):
        assert recv_exact(ShortReadSock(b"abc", step=2), 10) is None

    def test_zero_length(self):
        got = recv_exact(ShortReadSock(b"", step=1), 0)
        assert got is not None and bytes(got) == b""

    def test_result_is_bytes_compatible(self):
        """bytearray results must work everywhere bytes did."""
        got = recv_exact(ShortReadSock(_TAG.pack(42) + b"xy", step=2), 10)
        assert _TAG.unpack_from(got)[0] == 42
        assert np.frombuffer(got, dtype=np.uint8).shape == (10,)
        assert (b"prefix" + got).endswith(b"xy")

    def test_recv_frame_over_short_reads(self):
        frame = pack_frame(AmId.MAPPER_INFO, b"hdr", b"body-bytes")
        am_id, header, body = recv_frame(ShortReadSock(frame, step=4))
        assert am_id == AmId.MAPPER_INFO
        assert bytes(header) == b"hdr" and bytes(body) == b"body-bytes"


class TestSendmsgAll:
    def test_partial_sends_preserve_stream(self):
        parts = [memoryview(bytes([i]) * (10 + i)) for i in range(7)]
        sock = PartialSendSock(step=5)
        BlockServer._sendmsg_all(sock, list(parts))
        assert bytes(sock.out) == b"".join(bytes(p) for p in parts)

    def test_iov_window_beyond_1024(self):
        parts = [b"a"] * 1500 + [b"bc"]
        sock = PartialSendSock(step=64)
        BlockServer._sendmsg_all(sock, parts)
        assert bytes(sock.out) == b"a" * 1500 + b"bc"


class TestChunkProtocol:
    def test_chunk_header_roundtrip(self):
        hdr = pack_chunk_hdr(2**40, 7, 123, 2**33 + 5)
        assert unpack_chunk_hdr(hdr) == (2**40, 7, 123, 2**33 + 5)

    def test_hello_roundtrip(self):
        hdr = pack_wire_hello(2**63 + 1, 3, 4, 1 << 20)
        assert unpack_wire_hello(hdr) == (2**63 + 1, 3, 4, 1 << 20)

    def test_am_ids_pinned(self):
        # wire constants: renumbering is a protocol break
        assert int(AmId.FETCH_BLOCK_CHUNK) == 5
        assert int(AmId.WIRE_HELLO) == 6
        assert int(AmId.REPLICA_PUT) == 7
        assert int(AmId.REPLICA_ACK) == 8
        assert int(AmId.MEMBER_SUSPECT) == 9
        assert int(AmId.MEMBER_REJOIN) == 10

    def test_member_event_roundtrip(self):
        from sparkucx_tpu_torch.core.definitions import (
            pack_member_event,
            unpack_member_event,
        )

        hdr = pack_member_event(2**40, 7, 3)
        assert unpack_member_event(hdr) == (2**40, 7, 3)


class TestSingleLaneBitEquality:
    def test_fetch_reply_bytes_pinned(self):
        """A streams=1 fetch reply must be EXACTLY the pre-striping frame:
        one FETCH_BLOCK_REQ_ACK, header=[tag, count, sizes], body=concat —
        no chunk frames, no manifest split."""
        payloads = [b"alpha-block", b"", b"g" * 4097]
        srv = BlockServer(TpuShuffleConf())
        lookup = {}
        for i, p in enumerate(payloads):
            lookup[ShuffleBlockId(9, i, 0)] = BytesBlock(p)
        srv.registry_lookup = lookup.get
        try:
            sock = socket.create_connection(srv.address, timeout=10)
            bids = list(lookup)
            req = pack_frame(AmId.FETCH_BLOCK_REQ, pack_batch_fetch_req(77, bids))
            sock.sendall(req)
            hdr = recv_exact(sock, FRAME_HEADER_SIZE)
            am_id, hlen, blen = unpack_frame_header(hdr)
            header = recv_exact(sock, hlen)
            body = recv_exact(sock, blen)
            # golden reply, constructed by hand from the documented layout
            golden_hdr = (
                _TAG.pack(77)
                + _COUNT.pack(3)
                + b"".join(_SIZE.pack(len(p)) for p in payloads)
            )
            assert am_id == AmId.FETCH_BLOCK_REQ_ACK
            assert bytes(header) == golden_hdr
            assert bytes(body) == b"".join(payloads)
            sock.close()
        finally:
            srv.close()

    def test_request_bytes_pinned(self):
        """The client request frame layout is pinned byte-for-byte."""
        bids = [ShuffleBlockId(1, 2, 3), ShuffleBlockId(4, 5, 6)]
        golden = (
            struct.pack("<IQQ", 3, 4 + 8 + 2 * 12, 0)
            + _TAG.pack(9)
            + _COUNT.pack(2)
            + struct.pack("<iii", 1, 2, 3)
            + struct.pack("<iii", 4, 5, 6)
        )
        assert pack_frame(AmId.FETCH_BLOCK_REQ, pack_batch_fetch_req(9, bids)) == golden

    def test_single_lane_emits_no_stripe_ams(self):
        """With wire.streams=1 the client opens a plain connection: no
        WIRE_HELLO handshake, so the server never forms a stripe group."""
        a, b = _pair(streams=1)
        try:
            bid = ShuffleBlockId(0, 0, 0)
            b.register(bid, BytesBlock(b"plain"))
            buf = _buf(16)
            reqs = a.fetch_blocks_by_block_ids(2, [bid], [buf], [None])
            _drive(a, reqs)
            assert reqs[0].wait(0).status == OperationStatus.SUCCESS
            assert b.server._groups == {}  # no hello ever arrived
        finally:
            a.close()
            b.close()


def _fetch_all(streams, payloads, chunk_bytes=64 << 10, missing=()):
    a, b = _pair(streams=streams, chunk_bytes=chunk_bytes)
    try:
        bids = []
        for i, p in enumerate(payloads):
            bid = ShuffleBlockId(0, i, 0)
            if i not in missing:
                b.register(bid, BytesBlock(p))
            bids.append(bid)
        bufs = [_buf(max(len(p), 1)) for p in payloads]
        reqs = a.fetch_blocks_by_block_ids(2, bids, bufs, [None] * len(bids))
        _drive(a, reqs)
        out = []
        for p, buf, r in zip(payloads, bufs, reqs):
            res = r.wait(0)
            if res.status == OperationStatus.SUCCESS:
                out.append(bytes(buf.host_view()[: res.stats.recv_size].tobytes()))
            else:
                out.append(None)
        return out
    finally:
        a.close()
        b.close()


class TestStripedOracle:
    PAYLOADS = [
        np.random.default_rng(3).integers(0, 256, size=n, dtype=np.uint8).tobytes()
        for n in (1 << 20, 3 * (1 << 18) + 17, 5, 1, 1 << 16)
    ]

    @pytest.mark.parametrize("streams", [2, 4])
    def test_striped_matches_single_frame(self, streams):
        oracle = _fetch_all(1, self.PAYLOADS)
        got = _fetch_all(streams, self.PAYLOADS)
        assert got == oracle

    def test_striped_with_missing_blocks(self):
        oracle = _fetch_all(1, self.PAYLOADS, missing={1, 3})
        got = _fetch_all(4, self.PAYLOADS, missing={1, 3})
        assert got == oracle
        assert got[1] is None and got[3] is None

    def test_chunk_smaller_than_block(self):
        # many chunks per block, odd remainder chunk
        p = [bytes(range(256)) * 600]  # 150 KiB
        assert _fetch_all(4, p, chunk_bytes=4096) == _fetch_all(1, p)

    def test_dead_server_fails_striped_batch(self):
        a, b = _pair(streams=4)
        try:
            bid = ShuffleBlockId(0, 0, 0)
            b.register(bid, BytesBlock(b"x" * 1024))
            buf = _buf(1024)
            reqs = a.fetch_blocks_by_block_ids(2, [bid], [buf], [None])
            _drive(a, reqs)  # establish group + one good fetch
            b.server.close()  # server gone: all lanes die
            buf2 = _buf(1024)
            reqs2 = a.fetch_blocks_by_block_ids(2, [bid], [buf2], [None])
            _drive(a, reqs2)
            assert reqs2[0].wait(0).status == OperationStatus.FAILURE
        finally:
            a.close()
            b.close()


class TestStripeReassembly:
    """Drive the transport's chunk/manifest callbacks directly — the exact
    code lane recv threads run — in adversarial orderings."""

    def _seed(self, a, tag, sizes):
        reqs = [Request(OperationStats()) for _ in sizes]
        bufs = [_buf(n) for n in sizes]
        with a._tag_lock:
            a._inflight[tag] = (reqs, bufs, [None] * len(sizes), None)
            a._stripe_rx[tag] = _StripeRx()
        return reqs, bufs

    def _manifest_hdr(self, tag, sizes):
        return (
            _TAG.pack(tag)
            + _COUNT.pack(len(sizes))
            + b"".join(_SIZE.pack(s) for s in sizes)
        )

    @pytest.mark.parametrize("seed", [0, 1, 2, 3])
    @pytest.mark.parametrize("manifest_at", ["first", "middle", "last"])
    def test_shuffled_interleavings_complete_once(self, seed, manifest_at):
        a = PeerTransport(TpuShuffleConf(), executor_id=1)
        try:
            rng = random.Random(seed)
            payloads = [bytes([i]) * n for i, n in enumerate((5000, 0, 1, 12345))]
            sizes = [len(p) for p in payloads]
            tag = 1000 + seed
            reqs, bufs = self._seed(a, tag, [max(n, 1) for n in sizes])
            chunk = 512
            events = []
            for blk, p in enumerate(payloads):
                for off in range(0, len(p), chunk):
                    events.append(("chunk", blk, off, p[off : off + chunk]))
            rng.shuffle(events)
            idx = {"first": 0, "middle": len(events) // 2, "last": len(events)}[manifest_at]
            events.insert(idx, ("manifest",))
            completions = []
            for ev in events:
                if ev[0] == "manifest":
                    done = a._on_manifest(self._manifest_hdr(tag, sizes))
                else:
                    _, blk, off, data = ev
                    mv = a._chunk_buffers(tag, blk, off, len(data))
                    assert mv is not None
                    mv[:] = data
                    done = a._chunk_done(tag, len(data), True)
                if done is not None:
                    completions.append(done)
            assert len(completions) == 1  # completes exactly once
            assert a._stripe_rx == {}  # accounting fully drained
            assert a._scattering == {}
            a._handle_frame((AmId.FETCH_BLOCK_REQ_ACK, completions[0], b"", True))
            for p, buf, req in zip(payloads, bufs, reqs):
                res = req.wait(0)
                assert res.status == OperationStatus.SUCCESS
                assert buf.host_view()[: len(p)].tobytes() == p
        finally:
            a.close()

    def test_unknown_tag_chunk_is_drained_not_scattered(self):
        a = PeerTransport(TpuShuffleConf(), executor_id=1)
        try:
            assert a._chunk_buffers(999, 0, 0, 64) is None
            assert a._chunk_done(999, 64, False) is None  # no rx state: ignored
        finally:
            a.close()

    def test_oversized_chunk_rejected(self):
        a = PeerTransport(TpuShuffleConf(), executor_id=1)
        try:
            tag = 5
            self._seed(a, tag, [16])
            # offset+len beyond the result buffer: no view, drained instead
            assert a._chunk_buffers(tag, 0, 8, 16) is None
            assert a._chunk_buffers(tag, 1, 0, 8) is None  # bad block index
            with a._tag_lock:
                assert tag not in a._scattering
        finally:
            a.close()

    def test_scattering_counter_survives_concurrent_lanes(self):
        """Two lanes scattering one tag: the mark must persist until BOTH
        finish (a set would drop the sibling's mark on first done)."""
        a = PeerTransport(TpuShuffleConf(), executor_id=1)
        try:
            tag = 6
            self._seed(a, tag, [4096])
            mv1 = a._chunk_buffers(tag, 0, 0, 1024)
            mv2 = a._chunk_buffers(tag, 0, 1024, 1024)
            assert mv1 is not None and mv2 is not None
            with a._tag_lock:
                assert a._scattering[tag] == 2
            a._chunk_done(tag, 1024, True)
            with a._tag_lock:
                assert a._scattering[tag] == 1  # sibling still writing
            a._chunk_done(tag, 1024, True)
            with a._tag_lock:
                assert tag not in a._scattering
        finally:
            a.close()


class TestWireTimeouts:
    def test_server_times_out_hung_midframe_client(self):
        """A client that stalls mid-frame-header is cut loose at the timeout
        (strict mid-frame read); an idle client that sent nothing is not."""
        srv = BlockServer(TpuShuffleConf(wire_timeout_ms=200))
        try:
            idle = socket.create_connection(srv.address, timeout=10)
            hung = socket.create_connection(srv.address, timeout=10)
            hung.sendall(b"\x01\x00\x00")  # 3 of 20 header bytes, then silence
            hung.settimeout(5)
            assert hung.recv(1) == b""  # server closed the hung conn
            hung.close()
            # the idle conn (zero bytes sent) must still be alive and serving
            time.sleep(0.3)  # well past wire_timeout_ms
            idle.sendall(
                pack_frame(AmId.FETCH_BLOCK_REQ, pack_batch_fetch_req(5, [ShuffleBlockId(0, 0, 0)]))
            )
            hdr = recv_exact(idle, FRAME_HEADER_SIZE)
            assert hdr is not None  # got a reply: conn survived idling
            idle.close()
        finally:
            srv.close()

    def test_client_times_out_midbody_with_addressed_error(self):
        """A server that stalls mid-ack-body fails the fetch at the client's
        timeout, and the error names the peer address and fetch tag."""
        lst = socket.socket()
        lst.bind(("127.0.0.1", 0))
        lst.listen(1)
        addr = lst.getsockname()

        def stalling_server():
            conn, _ = lst.accept()
            hdr = recv_exact(conn, FRAME_HEADER_SIZE)
            _, hlen, blen = unpack_frame_header(hdr)
            req_hdr = recv_exact(conn, hlen + blen)
            tag = _TAG.unpack_from(req_hdr)[0]
            # ack claims a 1000 B body but only 100 B ever arrive
            ack_hdr = _TAG.pack(tag) + _COUNT.pack(1) + _SIZE.pack(1000)
            conn.sendall(
                struct.pack("<IQQ", int(AmId.FETCH_BLOCK_REQ_ACK), len(ack_hdr), 1000)
                + ack_hdr
                + b"\x55" * 100
            )
            time.sleep(3)  # hold the socket open, never send the rest
            conn.close()

        t = threading.Thread(target=stalling_server, daemon=True)
        t.start()
        a = PeerTransport(TpuShuffleConf(wire_timeout_ms=200), executor_id=1)
        try:
            a.add_executor(9, f"{addr[0]}:{addr[1]}".encode())
            buf = _buf(1000)
            t0 = time.monotonic()
            [req] = a.fetch_blocks_by_block_ids(9, [ShuffleBlockId(0, 0, 0)], [buf], [None])
            _drive(a, [req], timeout=10)
            res = req.wait(1)
            assert res.status == OperationStatus.FAILURE
            assert "127.0.0.1" in str(res.error)  # peer named, not a bare reset
            assert time.monotonic() - t0 < 2.5  # timeout fired, no 3 s stall
        finally:
            a.close()
            lst.close()
            t.join(timeout=10)


class TestCrc32c:
    def test_known_vectors(self):
        """google/crc32c reference vectors: byte-compatibility with every
        hardware implementation is the whole point of picking Castagnoli."""
        from sparkucx_tpu_torch.utils.checksum import crc32c

        assert crc32c(b"") == 0x00000000
        assert crc32c(b"a") == 0xC1D04330
        assert crc32c(b"abc") == 0x364B3FB7
        assert crc32c(b"123456789") == 0xE3069283
        # the iSCSI 32x zero-byte vector (RFC 3720 B.4)
        assert crc32c(b"\x00" * 32) == 0x8A9136AA

    def test_incremental_matches_oneshot(self):
        from sparkucx_tpu_torch.utils.checksum import crc32c

        data = bytes(range(256)) * 5
        assert crc32c(data[128:], crc32c(data[:128])) == crc32c(data)

    def test_detects_single_bit_flip(self):
        from sparkucx_tpu_torch.utils.checksum import crc32c

        data = bytearray(b"x" * 100)
        want = crc32c(bytes(data))
        data[50] ^= 0x01
        assert crc32c(bytes(data)) != want


class TestWireChecksum:
    def test_checksum_off_frames_are_golden(self):
        """Knob off (the default): chunk headers carry NO crc trailer — the
        striped wire stays byte-identical to the pre-checksum protocol."""
        from sparkucx_tpu_torch.core.definitions import CHUNK_HEADER_SIZE

        a, b = _pair(streams=2, chunk_bytes=512)
        try:
            assert not a.conf.wire_checksum
            bid = ShuffleBlockId(0, 0, 0)
            b.register(bid, BytesBlock(b"p" * 2000))
            seen = []
            orig = a._chunk_done

            def spy(tag, nbytes, scattered):
                seen.append(nbytes)
                return orig(tag, nbytes, scattered)

            a._chunk_done = spy
            buf = _buf(2048)
            reqs = a.fetch_blocks_by_block_ids(2, [bid], [buf], [None])
            _drive(a, reqs)
            assert reqs[0].wait(0).status == OperationStatus.SUCCESS
            assert seen, "no chunks arrived"
            # header-length detection is the protocol: knob off means every
            # header is exactly CHUNK_HEADER_SIZE (spy proves chunks flowed)
            assert CHUNK_HEADER_SIZE == 24
        finally:
            a.close()
            b.close()

    @pytest.mark.parametrize("streams", [2, 4])
    def test_checksum_on_clean_fetch(self, streams):
        payload = bytes(np.random.default_rng(5).integers(0, 256, 6000, dtype=np.uint8))
        a, b = _pair(streams=streams, chunk_bytes=1024, wire_checksum=True)
        try:
            bid = ShuffleBlockId(3, 0, 0)
            b.register(bid, BytesBlock(payload))
            buf = _buf(8192)
            reqs = a.fetch_blocks_by_block_ids(2, [bid], [buf], [None])
            _drive(a, reqs)
            res = reqs[0].wait(0)
            assert res.status == OperationStatus.SUCCESS, str(res.error)
            assert bytes(res.data.host_view()[: res.data.size]) == payload
        finally:
            a.close()
            b.close()

    def test_corrupted_chunk_raises_block_corrupt(self):
        """Payload garbled in flight (after the crc was computed) must surface
        as a typed BlockCorruptError, not silent garbage or a generic loss."""
        from sparkucx_tpu_torch.core.operation import BlockCorruptError
        from sparkucx_tpu_torch.testing import faults

        a, b = _pair(streams=2, chunk_bytes=1024, wire_checksum=True)
        try:
            bid = ShuffleBlockId(4, 0, 0)
            b.register(bid, BytesBlock(b"q" * 4000))
            faults.arm("peer.server.chunk", faults.garble(), times=1)
            buf = _buf(4096)
            reqs = a.fetch_blocks_by_block_ids(2, [bid], [buf], [None])
            _drive(a, reqs)
            res = reqs[0].wait(0)
            assert res.status == OperationStatus.FAILURE
            assert isinstance(res.error, BlockCorruptError), type(res.error)
            assert "crc32c" in str(res.error)
        finally:
            faults.reset()
            a.close()
            b.close()



def _stage_rounds(t, sid, num_reducers=1, seed=0):
    rng = np.random.default_rng(seed)
    t.store.create_shuffle(sid, 1, num_reducers)
    w = t.store.map_writer(sid, 0)
    for r in range(num_reducers):
        w.write_partition(r, rng.integers(0, 256, 300, dtype=np.uint8).tobytes())
    w.commit()


class TestBoundedReplicator:
    def _pair_repl(self, **kw):
        kw.setdefault("staging_capacity_per_executor", 1 << 20)
        kw.setdefault("replication_factor", 1)
        conf = TpuShuffleConf(**kw)
        a = PeerTransport(conf, executor_id=0)
        b = PeerTransport(conf, executor_id=1)
        a.add_executor(1, b.init())
        a.init()
        b.add_executor(0, a.server.address_bytes())
        return a, b

    def test_single_worker_settles_many_seals(self):
        """Thread-per-seal is gone: many seals drain through ONE worker and
        all settle; the backlog gauge returns to zero."""
        from sparkucx_tpu_torch.testing import faults

        a, b = self._pair_repl()
        try:
            for sid in range(5):
                _stage_rounds(a, sid, seed=sid)
                a.store.seal(sid)
            for sid in range(5):
                assert a.replication_wait(sid, timeout=10.0, strict=True)
            assert a.replica_stats["replica_backlog_bytes"] == 0
            assert a.replica_stats["pushed_rounds"] >= 5
        finally:
            a.close()
            b.close()

    def test_backlog_cap_drops_oldest(self):
        """Backlog over replication.maxBacklogBytes: the OLDEST queued shuffle
        is dropped (accounted in dropped_rounds), never an unbounded queue."""
        from sparkucx_tpu_torch.testing import faults

        a, b = self._pair_repl(replication_max_backlog_bytes=1)
        try:
            faults.arm("replica.push", faults.stall(0.5))
            with a._tag_lock:  # simulate a stuck backlog from a slow successor
                a.replica_stats["replica_backlog_bytes"] = 10
            for sid in (21, 22, 23):
                _stage_rounds(a, sid, seed=sid)
                a.store.seal(sid)
            deadline = time.monotonic() + 3
            while a.replica_stats["dropped_rounds"] < 1 and time.monotonic() < deadline:
                time.sleep(0.02)
            assert a.replica_stats["dropped_rounds"] >= 1
            faults.reset()
            with a._tag_lock:
                a.replica_stats["replica_backlog_bytes"] = 0
        finally:
            faults.reset()
            a.close()
            b.close()

    def test_strict_wait_names_stalled_successor(self):
        """An ack lost mid-apply leaves the push unsettled; strict wait raises
        a TransportError NAMING the successor whose acks never came."""
        from sparkucx_tpu_torch.core.operation import TransportError
        from sparkucx_tpu_torch.testing import faults

        a, b = self._pair_repl()
        try:
            faults.arm("replica.apply", faults.sever(), times=1)
            _stage_rounds(a, 5)
            a.store.seal(5)
            with pytest.raises(TransportError, match=r"successor executor\(s\) \[1\]"):
                a.replication_wait(5, timeout=0.7, strict=True)
        finally:
            faults.reset()
            a.close()
            b.close()

    def test_replica_put_checksum_discards_corrupt_round(self):
        """A REPLICA_PUT whose crc trailer does not match its body is
        discarded — no replica installed, no ack — and the serving thread
        survives to install the next (valid) round.  The trailer is detected
        by header length, so the receiver needs no conf agreement with the
        pusher (hand-crafted frames over a raw socket prove it)."""
        from sparkucx_tpu_torch.core.definitions import pack_replica_put
        from sparkucx_tpu_torch.utils.checksum import crc32c

        a, b = self._pair_repl()
        sock = None
        try:
            body = b"replica-round-payload" * 16
            sock = socket.create_connection(b.server.address, timeout=10)
            # round 0 targets (map 0, reduce 0) with a deliberately wrong crc
            bad = pack_replica_put(9, 0, 0, [(0, 0, len(body))]) + struct.pack(
                "<I", crc32c(body) ^ 0xDEADBEEF
            )
            sock.sendall(pack_frame(AmId.REPLICA_PUT, bad, body))
            # round 1 targets (map 0, reduce 1) with a valid crc
            good = pack_replica_put(9, 0, 1, [(0, 1, len(body))]) + struct.pack(
                "<I", crc32c(body)
            )
            sock.sendall(pack_frame(AmId.REPLICA_PUT, good, body))
            # the first (and only) ack on the wire is for the VALID round:
            # the corrupt one produced no ack, and the conn survived it
            hdr = recv_exact(sock, FRAME_HEADER_SIZE)
            am_id, hlen, blen = unpack_frame_header(hdr)
            recv_exact(sock, hlen + blen)
            assert am_id == AmId.REPLICA_ACK
            assert b.store.replica_view(9, 0, 0) is None
            assert b.store.replica_view(9, 0, 1) is not None
        finally:
            if sock is not None:
                sock.close()
            a.close()
            b.close()

    def test_checksum_on_replica_roundtrip(self):
        """Clean wire with checksum on: replicas install and ack normally."""
        a, b = self._pair_repl(wire_checksum=True)
        try:
            _stage_rounds(a, 12)
            a.store.seal(12)
            assert a.replication_wait(12, timeout=10.0, strict=True)
            assert b.store.replica_view(12, 0, 0) is not None
        finally:
            a.close()
            b.close()


def _compressible_payloads():
    """Exchange-shaped payloads (u32 words: low-cardinality keys, runs,
    near-sequential columns) plus noise, empties, and sub-chunk blocks —
    every fallback path of the codec ext in one batch."""
    rng = np.random.default_rng(11)
    alpha = rng.integers(0, 50, size=1 << 15, dtype=np.uint64).astype("<u4")
    return [
        alpha.tobytes(),  # dictionary/rle-friendly
        bytes(1 << 16),  # zero runs
        (np.uint32(7) + np.cumsum(
            rng.integers(0, 9, size=1 << 14), dtype=np.int64
        ).astype(np.uint32)).astype("<u4").tobytes(),  # delta-friendly
        rng.integers(0, 256, size=(1 << 15) + 17, dtype=np.uint8).tobytes(),  # noise
        b"",  # empty block
        b"tiny",  # under the min-chunk gate
    ]


class TestWireCompression:
    def test_codec_wire_constants_pinned(self):
        """Codec ids and the chunk-header extension are wire format —
        renumbering or re-packing is a protocol break."""
        from sparkucx_tpu_torch.core.definitions import (
            CHUNK_CODEC_EXT_SIZE,
            CHUNK_HEADER_SIZE,
            pack_chunk_codec_ext,
        )
        from sparkucx_tpu_torch.utils.pagecodec import (
            CODEC_DELTA,
            CODEC_DICT,
            CODEC_RAW,
            CODEC_RLE,
        )

        assert (CODEC_RAW, CODEC_DICT, CODEC_RLE, CODEC_DELTA) == (0, 1, 2, 3)
        assert CHUNK_CODEC_EXT_SIZE == 8
        assert pack_chunk_codec_ext(2, 4096) == struct.pack("<II", 2, 4096)
        # header-length detection table: 24 plain, +8 codec, +4 crc (crc LAST)
        assert CHUNK_HEADER_SIZE == 24
        assert unpack_chunk_hdr(pack_chunk_hdr(9, 1, 2, 3) + pack_chunk_codec_ext(1, 8)) == (9, 1, 2, 3)

    def test_default_is_off(self):
        """codec=off is the default, keeping the golden frames above (single
        lane AND striped) byte-identical to the pre-compression protocol."""
        assert TpuShuffleConf().wire_compress_codec == "off"
        assert TpuShuffleConf().compress_min_chunk_bytes == 4096

    @pytest.mark.parametrize("codec", ["dict", "rle", "delta"])
    @pytest.mark.parametrize("streams", [1, 4])
    def test_compressed_fetch_matches_stock(self, codec, streams):
        """Oracle: a compressed fetch returns byte-for-byte what the stock
        (codec=off) wire returns, for every payload shape and lane count —
        including the raw-fallback and sub-chunk-gate paths."""
        payloads = _compressible_payloads()
        oracle = _fetch_all(1, payloads)

        a, b = _pair(
            streams=streams, chunk_bytes=16 << 10, wire_compress_codec=codec
        )
        try:
            bids = []
            for i, p in enumerate(payloads):
                bid = ShuffleBlockId(0, i, 0)
                b.register(bid, BytesBlock(p))
                bids.append(bid)
            bufs = [_buf(max(len(p), 1)) for p in payloads]
            reqs = a.fetch_blocks_by_block_ids(2, bids, bufs, [None] * len(bids))
            _drive(a, reqs)
            got = []
            for p, buf, r in zip(payloads, bufs, reqs):
                res = r.wait(0)
                assert res.status == OperationStatus.SUCCESS, str(res.error)
                got.append(bytes(buf.host_view()[: res.stats.recv_size].tobytes()))
            assert got == oracle
            snap = b.server.compress_snapshot()
            assert snap["encoded_chunks"] >= 1  # compression actually engaged
            assert snap["raw_chunks"] >= 1  # and the noise block fell back raw
            assert snap["wire_bytes"] < snap["raw_bytes"]
        finally:
            a.close()
            b.close()

    @pytest.mark.parametrize("checksum", [False, True])
    def test_garbled_compressed_chunk_raises_block_corrupt(self, checksum):
        """A compressed chunk garbled in flight surfaces as the SAME typed
        BlockCorruptError on both detection paths: the crc trailer when
        checksum is on (it covers the ENCODED bytes, so it fires before the
        decoder parses anything), the decoder's CodecError otherwise."""
        from sparkucx_tpu_torch.core.operation import BlockCorruptError
        from sparkucx_tpu_torch.testing import faults

        a, b = _pair(
            streams=2, chunk_bytes=1024,
            wire_compress_codec="rle", wire_checksum=checksum,
        )
        try:
            bid = ShuffleBlockId(4, 0, 0)
            b.register(bid, BytesBlock(bytes(64 << 10)))  # zeros: always encodes
            faults.arm("peer.server.chunk", faults.garble(), times=1)
            buf = _buf(64 << 10)
            reqs = a.fetch_blocks_by_block_ids(2, [bid], [buf], [None])
            _drive(a, reqs)
            res = reqs[0].wait(0)
            assert res.status == OperationStatus.FAILURE
            assert isinstance(res.error, BlockCorruptError), type(res.error)
            if checksum:
                assert "crc32c" in str(res.error)
        finally:
            faults.reset()
            a.close()
            b.close()


    def test_single_lane_with_codec_uses_chunk_frames(self):
        """compress.codec on forces the stripe (chunked) path even at
        streams=1 — the codec ext rides chunk headers, which the single-frame
        reply has nowhere to carry."""
        a, b = _pair(streams=1, wire_compress_codec="rle")
        try:
            bid = ShuffleBlockId(0, 0, 0)
            b.register(bid, BytesBlock(bytes(32 << 10)))
            buf = _buf(32 << 10)
            reqs = a.fetch_blocks_by_block_ids(2, [bid], [buf], [None])
            _drive(a, reqs)
            assert reqs[0].wait(0).status == OperationStatus.SUCCESS
            assert b.server._groups, "no stripe group formed for the codec path"
            assert b.server.compress_snapshot()["encoded_chunks"] >= 1
        finally:
            a.close()
            b.close()


class TestReplicaCompression:
    """REPLICA_PUT whole-round page compression: same codec ext, same
    discard-no-ack contract as a crc mismatch."""

    def _pair_repl(self, **kw):
        kw.setdefault("staging_capacity_per_executor", 1 << 20)
        kw.setdefault("replication_factor", 1)
        conf = TpuShuffleConf(**kw)
        a = PeerTransport(conf, executor_id=0)
        b = PeerTransport(conf, executor_id=1)
        a.add_executor(1, b.init())
        a.init()
        b.add_executor(0, a.server.address_bytes())
        return a, b

    def test_compressed_replica_roundtrip(self):
        """A compressible round pushed over a codec-on wire installs the
        exact original bytes on the successor (encode on push, decode on
        install)."""
        a, b = self._pair_repl(wire_compress_codec="rle")
        try:
            payload = bytes(4096)  # zero page: always encodes
            a.store.create_shuffle(31, 1, 1)
            w = a.store.map_writer(31, 0)
            w.write_partition(0, payload)
            w.commit()
            a.store.seal(31)
            assert a.replication_wait(31, timeout=10.0, strict=True)
            view = b.store.replica_view(31, 0, 0)
            assert view is not None
            arr, off, ln = view
            assert ln == len(payload)
            got = arr.reshape(-1).view(np.uint8)[off : off + ln].tobytes()
            assert got == payload
        finally:
            a.close()
            b.close()

    def test_corrupt_codec_round_discarded_no_ack(self):
        """A REPLICA_PUT whose codec ext claims an encoded body that fails to
        decode is discarded without an ack — and the serving thread survives
        to install the next (valid, raw-codec-ext) round.  Hand-crafted
        frames: the receiver needs no conf agreement with the pusher."""
        from sparkucx_tpu_torch.core.definitions import pack_chunk_codec_ext, pack_replica_put
        from sparkucx_tpu_torch.utils.pagecodec import CODEC_RAW, CODEC_RLE

        a, b = self._pair_repl()
        sock = None
        try:
            body = b"replica-round-payload" * 16
            sock = socket.create_connection(b.server.address, timeout=10)
            # round 0: codec ext claims an rle page, body is garbage for it
            bad = pack_replica_put(8, 0, 0, [(0, 0, 64)]) + pack_chunk_codec_ext(
                CODEC_RLE, 64
            )
            sock.sendall(pack_frame(AmId.REPLICA_PUT, bad, body))
            # round 1: raw codec ext with the true length — valid
            good = pack_replica_put(8, 0, 1, [(0, 1, len(body))]) + pack_chunk_codec_ext(
                CODEC_RAW, len(body)
            )
            sock.sendall(pack_frame(AmId.REPLICA_PUT, good, body))
            hdr = recv_exact(sock, FRAME_HEADER_SIZE)
            am_id, hlen, blen = unpack_frame_header(hdr)
            recv_exact(sock, hlen + blen)
            assert am_id == AmId.REPLICA_ACK  # first ack is for the VALID round
            assert b.store.replica_view(8, 0, 0) is None
            assert b.store.replica_view(8, 0, 1) is not None
        finally:
            if sock is not None:
                sock.close()
            a.close()
            b.close()


# ---------------------------------------------------------------------------
# parity: the port's frame helpers and CRC32C against the JAX package's
# ---------------------------------------------------------------------------

import sparkucx_tpu.core.definitions as jax_defs  # noqa: E402
import sparkucx_tpu.transport.peer as jax_peer  # noqa: E402
import sparkucx_tpu.utils.checksum as jax_checksum  # noqa: E402
import sparkucx_tpu_torch.core.definitions as port_defs  # noqa: E402
import sparkucx_tpu_torch.transport.peer as port_peer  # noqa: E402
import sparkucx_tpu_torch.utils.checksum as port_checksum  # noqa: E402
from sparkucx_tpu.core.block import ShuffleBlockId as JaxShuffleBlockId  # noqa: E402


def _seeded_ids(seed, n):
    rng = np.random.default_rng(seed)
    return [tuple(int(x) for x in rng.integers(0, 2**31 - 1, size=3)) for _ in range(n)]


_REQ_CASES = [
    (0, 0, None, None),
    (1, 1, None, None),
    (2, 7, "app-α", None),
    (3, 33, None, (2**64 - 1, 12345)),
    (4, 5, "tenant", (7, 9)),
    (5, 0, "x" * 300, (1, 2)),
]


class TestFrameHelpersMatchJax:
    @pytest.mark.parametrize("seed,count,app,trace", _REQ_CASES)
    def test_pack_batch_fetch_req_bytes(self, seed, count, app, trace):
        ids = _seeded_ids(seed, count)
        tag = int(np.random.default_rng(seed).integers(0, 2**63))
        port = port_peer.pack_batch_fetch_req(tag, [ShuffleBlockId(*i) for i in ids], app_id=app, trace=trace)
        ref = jax_peer.pack_batch_fetch_req(tag, [JaxShuffleBlockId(*i) for i in ids], app_id=app, trace=trace)
        assert port == ref

    @pytest.mark.parametrize("seed,count,app,trace", _REQ_CASES)
    def test_split_and_unpack_agree(self, seed, count, app, trace):
        ids = _seeded_ids(seed, count)
        hdr = jax_peer.pack_batch_fetch_req(9, [JaxShuffleBlockId(*i) for i in ids], app_id=app, trace=trace)
        p_ctx, p_rest = port_peer.split_fetch_req_trace(hdr)
        j_ctx, j_rest = jax_peer.split_fetch_req_trace(hdr)
        assert p_ctx == j_ctx and bytes(p_rest) == bytes(j_rest)
        p_tag, p_ids = port_peer.unpack_batch_fetch_req(p_rest)
        j_tag, j_ids = jax_peer.unpack_batch_fetch_req(j_rest)
        assert p_tag == j_tag and [(b.shuffle_id, b.map_id, b.reduce_id) for b in p_ids] == [
            (b.shuffle_id, b.map_id, b.reduce_id) for b in j_ids]
        assert port_peer.unpack_fetch_req_app_id(p_rest, count) == jax_peer.unpack_fetch_req_app_id(j_rest, count)

    def test_every_frame_packer_bytes(self):
        rng = np.random.default_rng(5)
        for name, args in [
            ("pack_chunk_hdr", (2**40 + 3, 17, 5, 2**33)),
            ("pack_wire_hello", (2**63 + 1, 3, 4, 1 << 22)),
            ("pack_chunk_codec_ext", (2, 123456)),
            ("pack_replica_put", (4, 1, 2, [(0, 1, 100), (3, 2, 0), (9, 9, 7)])),
            ("pack_replica_ack", (4, 1, 2)),
            ("pack_trace_ext", (2**64 - 2, 77)),
            ("pack_replica_trace_ext", (5, 6)),
            ("pack_hot_set", ({3: [2, 0, 1], 1: [4]},)),
            ("pack_member_event", (9, 2, 3)),
            ("pack_fetch_req", (1, 2, 3)),
        ]:
            assert getattr(port_defs, name)(*args) == getattr(jax_defs, name)(*args), name
        body = rng.integers(0, 256, size=1000, dtype=np.uint8).tobytes()
        for am in port_defs.AmId:
            assert int(am) == int(jax_defs.AmId[am.name])
            assert port_defs.pack_frame(am, b"hdr", body) == jax_defs.pack_frame(jax_defs.AmId[am.name], b"hdr", body)
            assert port_defs.pack_frame_prefix(am, b"h", 5) == jax_defs.pack_frame_prefix(jax_defs.AmId[am.name], b"h", 5)

    def test_recv_frame_reads_what_jax_packs(self):
        rng = np.random.default_rng(6)
        frames = [jax_defs.pack_frame(jax_defs.AmId.FETCH_BLOCK_REQ_ACK, b"\x01" * 12,
                                      rng.integers(0, 256, size=int(n), dtype=np.uint8).tobytes())
                  for n in (0, 1, 4097)]
        sock = ShortReadSock(b"".join(frames), step=7)
        for f in frames:
            am, hdr, body = port_peer.recv_frame(sock)
            assert port_defs.pack_frame(am, bytes(hdr), bytes(body)) == f
        assert port_peer.recv_frame(sock) is None


class TestCrc32cMatchesJax:
    @pytest.mark.parametrize("n", [0, 1, 3, 32, 1000, 65537])
    def test_seeded_buffers(self, n):
        data = np.random.default_rng(n).integers(0, 256, size=n, dtype=np.uint8).tobytes()
        assert port_checksum.crc32c(data) == jax_checksum.crc32c(data)
        half = n // 2
        assert port_checksum.crc32c(data[half:], port_checksum.crc32c(data[:half])) == jax_checksum.crc32c(data)

    def test_known_vectors(self):
        # google/crc32c vectors (RFC 3720 B.4)
        assert port_checksum.crc32c(b"123456789") == 0xE3069283
        assert port_checksum.crc32c(bytes(32)) == 0x8A9136AA
        assert port_checksum.crc32c(b"\xff" * 32) == 0x62A8AB43


# ---------------------------------------------------------------------------
# the benchmark CLI's wire modes (server, client, wire)
# ---------------------------------------------------------------------------

import os  # noqa: E402
import re  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import sparkucx_tpu.perf.benchmark as jax_bench  # noqa: E402
import sparkucx_tpu_torch.perf.benchmark as port_bench  # noqa: E402


def _words(text):
    """The printed lines with every number blanked: what the two CLIs print alike."""
    return [re.sub(r"\d+(\.\d+)?", "#", ln) for ln in text.splitlines()]


def test_measure_wire_keys_equal_the_jax_cores():
    port = port_bench.measure_wire((1, 2), num_blocks=3, block_bytes=64 << 10, iterations=1,
                                   chunk_bytes=16 << 10, device="cpu")
    ref = jax_bench.measure_wire((1, 2), num_blocks=3, block_bytes=64 << 10, iterations=1, chunk_bytes=16 << 10)
    assert {k: sorted(v) for k, v in port.items()} == {k: sorted(v) for k, v in ref.items()}
    assert [v["lanes"] for v in port.values()] == [v["lanes"] for v in ref.values()] == [1, 2]


def test_wire_mode_prints_the_jax_modes_lines(capsys):
    argv = ["wire", "-n", "3", "-s", "64k", "-i", "2", "--streams", "1,4", "--chunk-bytes", "16k"]
    assert port_bench.main(argv + ["--device", "cpu"]) == 0
    ours = capsys.readouterr().out
    jax_bench.main(argv)
    theirs = capsys.readouterr().out
    assert _words(ours) == _words(theirs) and len(_words(ours)) == 6


def test_server_and_client_modes_on_an_ephemeral_port(capsys):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    server = subprocess.Popen(
        [sys.executable, "-m", "sparkucx_tpu_torch.perf.benchmark", "server", "-a", "127.0.0.1:0", "-n", "4",
         "-s", "32k", "--device", "cpu"],
        cwd=repo, stdout=subprocess.PIPE, text=True,
    )
    try:
        line = server.stdout.readline().strip()
        m = re.fullmatch(r"serving 4 x 32768 B blocks on (127\.0\.0\.1:\d+)", line)
        assert m, line
        assert port_bench.main(["client", "-a", m.group(1), "-n", "4", "-s", "32k", "-i", "2", "-o", "4", "-t", "2",
                                "--device", "cpu"]) == 0
        out = capsys.readouterr().out.splitlines()
        assert len(out) == 4 and all(re.match(r"\[thread [01]\] iter [01]: 131072 bytes in ", ln) for ln in out)
    finally:
        server.terminate()
        server.wait(timeout=30)
    assert server.returncode is not None
