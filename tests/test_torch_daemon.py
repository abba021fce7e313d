"""Port twins of ``tests/test_daemon.py``: the shuffle daemon and its client
(``sparkucx_tpu_torch/shuffle/daemon.py``), the protocol surface the JVM shim
speaks, with the executors on the CPU.  Then the daemon against the JAX
package's: every ``jvm/fixtures/*.bin`` frame replayed against both gets the
same reply bytes, and a full shuffle through both at one and two executors
under ``hostRecvMode`` ``array`` and ``device`` (the block gather's plain
version on CPU tensors, one gather a fetch batch per consumer and round)
fetches the same bytes.
"""

import signal

import numpy as np
import pytest

from sparkucx_tpu_torch.config import TpuShuffleConf
from sparkucx_tpu_torch.core.block import ShuffleBlockId
from sparkucx_tpu_torch.shuffle.daemon import DaemonClient, DaemonOp
from sparkucx_tpu_torch.shuffle import daemon as _daemon_mod

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



class ShuffleDaemon(_daemon_mod.ShuffleDaemon):
    """The port's ShuffleDaemon with its executors on the CPU (its default is the card)."""

    def __init__(self, conf=None, num_executors=None, host="127.0.0.1", port=0, devices=None):
        n = num_executors if num_executors is not None else (conf.num_executors if conf is not None else 1)
        super().__init__(conf, num_executors, host, port, devices=devices or ["cpu"] * n)


@pytest.fixture(scope="module")
def daemon():
    d = ShuffleDaemon(
        TpuShuffleConf(staging_capacity_per_executor=1 << 20, num_executors=2),
        num_executors=2,
    )
    yield d
    d.close()


@pytest.fixture
def client(daemon):
    c = DaemonClient(daemon.address)
    yield c
    c.close()


class TestDaemonFlow:
    def test_full_shuffle_through_wire(self, client, rng):
        M, R, SID = 3, 4, 0
        client.create_shuffle(SID, M, R)
        oracle = {}
        for m in range(M):
            w = client.open_map_writer(SID, m)
            for r in range(R):
                payload = rng.integers(0, 256, size=int(rng.integers(1, 3000)), dtype=np.uint8).tobytes()
                oracle[(m, r)] = payload
                # stream in two chunks to exercise repeated WritePartition
                client.write_partition(w, r, payload[: len(payload) // 2])
                client.write_partition(w, r, payload[len(payload) // 2 :])
            lengths = client.commit_map(w)
            assert lengths.tolist() == [len(oracle[(m, r)]) for r in range(R)]
        stats = client.stats(SID)
        assert stats["num_mappers"] == M and not stats["exchanged"]
        client.run_exchange(SID)
        assert client.stats(SID)["exchanged"]

        bids = [ShuffleBlockId(SID, m, r) for m in range(M) for r in range(R)]
        blocks = client.fetch_blocks(bids)
        for bid, blk in zip(bids, blocks):
            assert blk == oracle[(bid.map_id, bid.reduce_id)]
        client.remove_shuffle(SID)

    def test_error_propagation(self, client):
        with pytest.raises(RuntimeError, match="unknown shuffle|KeyError"):
            client.run_exchange(777)

    def test_fetch_miss_returns_none(self, client):
        client.create_shuffle(1, 1, 1)
        w = client.open_map_writer(1, 0)
        client.write_partition(w, 0, b"only")
        client.commit_map(w)
        client.run_exchange(1)
        [hit, miss] = client.fetch_blocks([ShuffleBlockId(1, 0, 0), ShuffleBlockId(1, 0, 99)])
        assert hit == b"only"
        assert miss is None
        client.remove_shuffle(1)

    def test_two_clients_one_daemon(self, daemon, rng):
        # two executor connections writing different maps of one shuffle
        c1, c2 = DaemonClient(daemon.address), DaemonClient(daemon.address)
        try:
            c1.create_shuffle(2, 2, 2)
            w1 = c1.open_map_writer(2, 0)
            c1.write_partition(w1, 0, b"from-c1")
            c1.commit_map(w1)
            w2 = c2.open_map_writer(2, 1)
            c2.write_partition(w2, 1, b"from-c2")
            c2.commit_map(w2)
            c1.run_exchange(2)
            [a] = c2.fetch_blocks([ShuffleBlockId(2, 0, 0)])
            [b] = c1.fetch_blocks([ShuffleBlockId(2, 1, 1)])
            assert a == b"from-c1" and b == b"from-c2"
            c1.remove_shuffle(2)
        finally:
            c1.close()
            c2.close()

    def test_unknown_op_acks_error(self, daemon):
        import socket
        import struct

        s = socket.create_connection(daemon.address)
        s.sendall(struct.pack("<IQQ", 99, 2, 0) + b"{}")
        hdr = b""
        while len(hdr) < 20:
            hdr += s.recv(20 - len(hdr))
        op, hlen, blen = struct.unpack("<IQQ", hdr)
        payload = b""
        while len(payload) < hlen:
            payload += s.recv(hlen - len(payload))
        assert b'"ok": false' in payload
        s.close()

    def test_hostile_frames_cannot_take_the_daemon_down(self, daemon):
        """Protocol fuzz at the Spark-facing boundary: oversized length
        claims, truncated frames, garbage headers, and random byte storms
        each cost at most their own connection — the daemon keeps serving
        well-formed clients afterwards (the endpoint-eviction policy,
        UcxWorkerWrapper.scala:248-253)."""
        import socket
        import struct

        rng = np.random.default_rng(0)
        hostile = [
            # oversized header+body claim (the _MAX_FRAME guard): must be
            # dropped without streaming terabytes
            struct.pack("<IQQ", DaemonOp.CREATE_SHUFFLE, 1 << 60, 1 << 60),
            # truncated: header promises more bytes than ever arrive
            struct.pack("<IQQ", DaemonOp.CREATE_SHUFFLE, 64, 0) + b"{\"x\"",
            # valid frame layout, unparseable JSON header
            struct.pack("<IQQ", DaemonOp.CREATE_SHUFFLE, 7, 0) + b"not-js}",
            # random byte storm (may parse as a huge claim or garbage op)
            rng.integers(0, 256, size=333, dtype=np.uint8).tobytes(),
            # shorter than one frame header
            b"\x01\x02\x03",
        ]
        for i, frame in enumerate(hostile):
            s = socket.create_connection(daemon.address, timeout=5)
            try:
                s.settimeout(5)
                # the daemon may RST mid-send/shutdown when it drops the
                # connection — that reset IS the expected eviction behavior
                try:
                    s.sendall(frame)
                    s.shutdown(socket.SHUT_WR)
                    while s.recv(4096):  # drain any reply, bounded
                        pass
                except (socket.timeout, OSError):
                    pass
            finally:
                s.close()
            # after each hostile connection, a fresh well-formed client works
            probe = DaemonClient(daemon.address)
            try:
                sid = 900 + i
                probe.create_shuffle(sid, 1, 1)
                w = probe.open_map_writer(sid, 0)
                probe.write_partition(w, 0, b"still-alive")
                probe.commit_map(w)
                probe.run_exchange(sid)
                [blk] = probe.fetch_blocks([ShuffleBlockId(sid, 0, 0)])
                assert blk == b"still-alive"
                probe.remove_shuffle(sid)
            finally:
                probe.close()


class TestGoldenWireFixtures:
    """The jvm/fixtures/*.bin frames are the EXACT bytes the Java shim's
    DaemonClient encodes (FixtureCheck.java re-encodes them in CI).  Here the
    Python side holds up its half of the contract: the generator reproduces
    the committed files bit-for-bit (drift guard), and a live daemon driven by
    the raw fixture bytes executes a full write -> exchange -> fetch cycle."""

    def _gen(self):
        import importlib
        import os
        import sys

        scripts = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts")
        sys.path.insert(0, scripts)
        try:
            mod = importlib.import_module("gen_shim_fixtures")
            return importlib.reload(mod)
        finally:
            sys.path.remove(scripts)

    def test_fixture_files_match_generator(self):
        import os

        gen = self._gen()
        for name, frame in gen.fixtures().items():
            path = os.path.join(gen.FIXTURE_DIR, name)
            with open(path, "rb") as f:
                assert f.read() == frame, f"fixture {name} drifted — regen + sync FixtureCheck.java"

    def test_daemon_decodes_java_frames_end_to_end(self):
        import os
        import socket
        import struct

        from sparkucx_tpu_torch.shuffle.daemon import _read_frame

        gen = self._gen()
        fx = {n: open(os.path.join(gen.FIXTURE_DIR, n), "rb").read() for n in gen.fixtures()}
        d = ShuffleDaemon(
            TpuShuffleConf(staging_capacity_per_executor=1 << 20, num_executors=1),
            num_executors=1,
        )
        client = DaemonClient(d.address)  # side channel for the non-fixture maps
        raw = socket.create_connection(d.address)

        def send_fixture(name, expect_ok=True):
            raw.sendall(fx[name])
            frame = _read_frame(raw)
            assert frame is not None
            op, meta, body = frame
            if expect_ok:
                assert meta.get("ok") is True, f"{name}: {meta}"
            return meta, body

        try:
            send_fixture("01_create_shuffle.bin")  # shuffle 7: 4 maps x 8 reduces

            # burn writer handles 0-2 so the fixture writer lands on handle 3
            # (the handle baked into 03/04), and give the fetch fixture's maps
            # (0 and 3) real payloads
            burn = [client.open_map_writer(gen.SHUFFLE_ID, m) for m in (0, 1, 3)]
            assert burn == [0, 1, 2]
            payload_m0 = b"\xaa" * 100
            payload_m3 = b"\xbb" * 300
            payload_m1r6 = b"\xcc" * 77  # fixture 09's only reduce-6 block
            client.write_partition(burn[0], gen.REDUCE_ID, payload_m0)
            client.write_partition(burn[1], 6, payload_m1r6)
            client.write_partition(burn[2], gen.REDUCE_ID, payload_m3)

            meta, _ = send_fixture("02_open_map_writer.bin")  # map 2 -> handle 3
            assert meta["writer"] == gen.WRITER

            send_fixture("03_write_partition.bin")  # 256 bytes to reduce 5
            _, commit_body = send_fixture("04_commit_map.bin")
            lengths = np.frombuffer(commit_body, dtype="<i8")
            assert lengths[gen.REDUCE_ID] == len(gen.WRITE_BODY)

            for w in burn:
                client.commit_map(w)

            send_fixture("05_run_exchange.bin")

            def raw_fetch(name):
                raw.sendall(fx[name])
                hdr = b""
                while len(hdr) < 20:
                    hdr += raw.recv(20 - len(hdr))
                _, hlen, blen = struct.unpack("<IQQ", hdr)
                reply_hdr = b""
                while len(reply_hdr) < hlen:
                    reply_hdr += raw.recv(hlen - len(reply_hdr))
                body = b""
                while len(body) < blen:
                    body += raw.recv(blen - len(body))
                tag, count = struct.unpack_from("<QI", reply_hdr)
                sizes = [
                    struct.unpack_from("<q", reply_hdr, 12 + 8 * i)[0] for i in range(count)
                ]
                return tag, count, sizes, body

            # batched fetch exactly as the Java client frames it
            tag, count, sizes, body = raw_fetch("06_fetch.bin")
            assert tag == gen.FETCH_TAG and count == len(gen.FETCH_MAPS)
            assert sizes == [len(payload_m0), len(payload_m3)]
            assert body[: sizes[0]] == payload_m0
            assert body[sizes[0] :] == payload_m3

            # the AQE partial-map read (Spark 3.x startMapIndex/endMapIndex):
            # maps [1, 3) x reduce 5 — map 1 committed nothing there (empty
            # block, size 0), map 2 holds the fixture's 256-byte write
            tag, count, sizes, body = raw_fetch("08_fetch_aqe_maprange.bin")
            assert tag == gen.FETCH_TAG and count == len(gen.AQE_MAPS)
            assert sizes == [0, len(gen.WRITE_BODY)]
            assert body == gen.WRITE_BODY

            # the AQE COALESCED read (09): reduce range 5..6 across EVERY
            # mapper — present and empty cells mixed; empties must answer
            # size 0 (a real committed-empty block), never -1 (a miss)
            tag, count, sizes, body = raw_fetch("09_fetch_coalesced_empty.bin")
            assert tag == gen.FETCH_TAG and count == len(gen.COALESCE_MAPS)
            assert sizes == [
                len(payload_m0), 0,              # map 0: r5 block, r6 empty
                0, len(payload_m1r6),            # map 1: r5 empty, r6 block
                len(gen.WRITE_BODY), 0,          # map 2: the fixture write
                len(payload_m3), 0,              # map 3
            ]
            assert body == payload_m0 + payload_m1r6 + gen.WRITE_BODY + payload_m3

            send_fixture("07_remove_shuffle.bin")
            with pytest.raises(RuntimeError):
                client.stats(gen.SHUFFLE_ID)
        finally:
            raw.close()
            client.close()
            d.close()


class TestErrorEdges:
    """The error/edge wire paths the first eight fixtures skipped
    (VERDICT r4 item 6): oversized-frame rejection and daemon restart
    mid-job."""

    def test_oversized_frame_drops_connection_daemon_survives(self):
        import socket

        gen = TestGoldenWireFixtures._gen(self)
        import os

        oversized = open(
            os.path.join(gen.FIXTURE_DIR, "10_oversized_frame.bin"), "rb"
        ).read()
        d = ShuffleDaemon(
            TpuShuffleConf(staging_capacity_per_executor=1 << 18, num_executors=1),
            num_executors=1,
        )
        try:
            raw = socket.create_connection(d.address)
            raw.sendall(oversized)
            raw.settimeout(10)
            # the daemon must refuse BEFORE reading/allocating the 2 GiB body:
            # this connection is dropped (endpoint-eviction policy)
            assert raw.recv(1) == b"", "daemon accepted an oversized frame"
            raw.close()
            # ...and keeps serving new connections
            c = DaemonClient(d.address)
            c.create_shuffle(55, 1, 1)
            w = c.open_map_writer(55, 0)
            c.write_partition(w, 0, b"alive")
            c.commit_map(w)
            c.run_exchange(55)
            [blk] = c.fetch_blocks([ShuffleBlockId(55, 0, 0)])
            assert blk == b"alive"
            c.close()
        finally:
            d.close()

    def test_daemon_restart_mid_job(self, rng):
        """Kill the daemon after a partial map stage; a fresh daemon on a new
        port serves the re-run job from clean state — the task-retry
        discipline the reference never had (SURVEY §5.3: it only logs)."""
        conf = TpuShuffleConf(staging_capacity_per_executor=1 << 18, num_executors=1)
        d1 = ShuffleDaemon(conf, num_executors=1)
        c1 = DaemonClient(d1.address)
        c1.create_shuffle(9, 2, 2)
        w = c1.open_map_writer(9, 0)
        c1.write_partition(w, 0, b"lost-on-restart")
        c1.commit_map(w)  # map 0 committed; map 1 never runs
        d1.close()  # daemon dies mid-job
        c1.close()

        # driver-side retry: fresh daemon, SAME shuffle id, full re-run
        d2 = ShuffleDaemon(conf, num_executors=1)
        c2 = DaemonClient(d2.address)
        try:
            c2.create_shuffle(9, 2, 2)  # no stale state: re-create succeeds
            oracle = {}
            for m in range(2):
                w = c2.open_map_writer(9, m)
                for r in range(2):
                    payload = rng.integers(0, 256, size=200, dtype=np.uint8).tobytes()
                    oracle[(m, r)] = payload
                    c2.write_partition(w, r, payload)
                c2.commit_map(w)
            c2.run_exchange(9)
            bids = [ShuffleBlockId(9, m, r) for m in range(2) for r in range(2)]
            for bid, blk in zip(bids, c2.fetch_blocks(bids)):
                assert blk == oracle[(bid.map_id, bid.reduce_id)]
        finally:
            c2.close()
            d2.close()


# ---------------------------------------------------------------------------
# against the JAX daemon
# ---------------------------------------------------------------------------

import os  # noqa: E402
import socket  # noqa: E402
import struct  # noqa: E402

import torch  # noqa: E402

import sparkucx_tpu.config as jax_config  # noqa: E402
import sparkucx_tpu.core.block as jax_block  # noqa: E402
import sparkucx_tpu.shuffle.daemon as jax_daemon  # noqa: E402
import sparkucx_tpu_torch.store.hbm_store as port_store  # noqa: E402

FIXTURES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "jvm", "fixtures")


def _recv_n(sock, n):
    out = b""
    while len(out) < n:
        chunk = sock.recv(n - len(out))
        if not chunk:
            return None
        out += chunk
    return out


def _raw_reply(sock):
    """One whole reply frame, header included, as the bytes that arrived."""
    hdr = _recv_n(sock, 20)
    if hdr is None:
        return None
    _, hlen, blen = struct.unpack("<IQQ", hdr)
    return hdr + (_recv_n(sock, hlen + blen) if hlen + blen else b"")


def _replay_fixtures(make_daemon, make_client, shuffle_block_id):
    """Drive a daemon with the raw Java frames in the order of
    ``TestGoldenWireFixtures`` (maps 0, 1 and 3 written through a side
    client); returns every raw reply to a fixture frame, in order."""
    gen = TestGoldenWireFixtures._gen(None)
    fx = {n: open(os.path.join(gen.FIXTURE_DIR, n), "rb").read() for n in gen.fixtures()}
    d = make_daemon()
    client = make_client(d.address)
    raw = socket.create_connection(d.address, timeout=30)
    replies = []

    def send(name):
        raw.sendall(fx[name])
        replies.append(_raw_reply(raw))

    try:
        send("01_create_shuffle.bin")
        burn = [client.open_map_writer(gen.SHUFFLE_ID, m) for m in (0, 1, 3)]
        client.write_partition(burn[0], gen.REDUCE_ID, b"\xaa" * 100)
        client.write_partition(burn[1], 6, b"\xcc" * 77)
        client.write_partition(burn[2], gen.REDUCE_ID, b"\xbb" * 300)
        for name in ("02_open_map_writer.bin", "03_write_partition.bin", "04_commit_map.bin"):
            send(name)
        for w in burn:
            client.commit_map(w)
        for name in ("05_run_exchange.bin", "06_fetch.bin", "08_fetch_aqe_maprange.bin",
                     "09_fetch_coalesced_empty.bin", "07_remove_shuffle.bin"):
            send(name)
        # a fetch of the removed shuffle: every block a miss
        send("06_fetch.bin")
        oversized = socket.create_connection(d.address, timeout=30)
        oversized.sendall(fx["10_oversized_frame.bin"])
        replies.append(oversized.recv(1))  # dropped: b""
        oversized.close()
    finally:
        raw.close()
        client.close()
        d.close()
    return replies


@pytest.mark.parametrize("mode", ["array", "device"])
def test_fixture_replies_equal_the_jax_daemons(mode):
    kw = dict(staging_capacity_per_executor=1 << 20, num_executors=1, host_recv_mode=mode,
              keep_device_recv=mode == "device")
    port = _replay_fixtures(lambda: ShuffleDaemon(TpuShuffleConf(**kw), num_executors=1), DaemonClient, ShuffleBlockId)
    ref = _replay_fixtures(lambda: jax_daemon.ShuffleDaemon(jax_config.TpuShuffleConf(**kw), num_executors=1),
                           jax_daemon.DaemonClient, jax_block.ShuffleBlockId)
    assert len(port) == len(ref) == 11
    assert port == ref
    assert port[-1] == b"" and all(r for r in port[:-1])


def _shuffle_through(daemon, client_cls, block_id, seed, num_mappers, num_reducers):
    c = client_cls(daemon.address)
    rng = np.random.default_rng(seed)
    try:
        c.create_shuffle(3, num_mappers, num_reducers)
        lengths = []
        for m in range(num_mappers):
            w = c.open_map_writer(3, m)
            for r in range(num_reducers):
                n = int(rng.integers(0, 3000)) if (m + r) % 5 else 0
                if n:
                    c.write_partition(w, r, rng.integers(0, 256, size=n, dtype=np.uint8).tobytes())
            lengths.append(c.commit_map(w).tolist())
        c.run_exchange(3)
        ids = [(m, r) for r in range(num_reducers) for m in range(num_mappers)] + [(0, num_reducers + 5), (num_mappers + 1, 0)]
        got = []
        for start in range(0, len(ids), 7):
            got += c.fetch_blocks([block_id(3, m, r) for m, r in ids[start : start + 7]])
        stats = c.stats(3)
        c.remove_shuffle(3)
        return lengths, got, stats
    finally:
        c.close()


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("mode", ["array", "device"])
def test_full_shuffle_equals_the_jax_daemons(n, mode, monkeypatch):
    kw = dict(staging_capacity_per_executor=1 << 20, num_executors=n, host_recv_mode=mode,
              keep_device_recv=mode == "device")
    gathers = []
    real = port_store.block_gather

    def counting(*args, **kwargs):
        gathers.append(int(args[0].shape[0]))
        return real(*args, **kwargs)

    monkeypatch.setattr(port_store, "block_gather", counting)  # the fetches' gathers (land_device_rows), not the exchange's
    d = ShuffleDaemon(TpuShuffleConf(**kw), num_executors=n)
    try:
        port = _shuffle_through(d, DaemonClient, ShuffleBlockId, 9, 5, 6)
    finally:
        d.close()
    jd = jax_daemon.ShuffleDaemon(jax_config.TpuShuffleConf(**kw), num_executors=n)
    try:
        ref = _shuffle_through(jd, jax_daemon.DaemonClient, jax_block.ShuffleBlockId, 9, 5, 6)
    finally:
        jd.close()
    assert port == ref
    assert sum(1 for b in port[1] if b is None) == 2
    # one gather a fetch batch of 7 per consumer among its non-empty blocks
    # (reducers 0-2 on executor 0 and 3-5 on executor 1 at n = 2), none
    # where the shards are on the host
    lengths = port[0]
    ids = [(m, r) for r in range(6) for m in range(5)]
    want = sum(
        len({r // (6 // n) for m, r in ids[s : s + 7] if lengths[m][r]}) for s in range(0, len(ids), 7)
    )
    assert len(gathers) == (0 if mode == "array" else want)


def test_device_fetch_batch_is_one_gather_per_consumer(monkeypatch):
    kw = dict(staging_capacity_per_executor=1 << 20, num_executors=2, host_recv_mode="device",
              keep_device_recv=True)
    d = ShuffleDaemon(TpuShuffleConf(**kw), num_executors=2)
    c = DaemonClient(d.address)
    try:
        c.create_shuffle(1, 2, 4)
        for m in range(2):
            w = c.open_map_writer(1, m)
            for r in range(4):
                c.write_partition(w, r, bytes([m * 4 + r]) * (100 + r))
            c.commit_map(w)
        c.run_exchange(1)
        gathers = []
        real = port_store.block_gather

        def counting(*args, **kwargs):
            gathers.append(int(args[0].shape[0]))
            return real(*args, **kwargs)

        monkeypatch.setattr(port_store, "block_gather", counting)
        [a] = c.fetch_blocks([ShuffleBlockId(1, 1, 0)])
        assert a == bytes([4]) * 100 and gathers == [1]
        got = c.fetch_blocks([ShuffleBlockId(1, m, r) for r in range(4) for m in range(2)])
        assert got == [bytes([m * 4 + r]) * (100 + r) for r in range(4) for m in range(2)]
        assert gathers == [1, 4, 4]  # reducers 0-1 on executor 0, 2-3 on executor 1
    finally:
        c.close()
        d.close()


def test_control_acks_are_the_jax_daemons_bytes():
    for meta in ({"ok": True}, {"ok": False, "error": "KeyError: 'x'"}, {"ok": True, "writer": 3},
                 {"ok": True, "num_mappers": 2, "num_reducers": 4, "exchanged": False,
                  "block_lengths": {"0": [1, 2], "1": [0, 0]}}):
        assert _daemon_mod._frame(_daemon_mod.DaemonOp.ACK, meta, b"xy") == jax_daemon._frame(
            jax_daemon.DaemonOp.ACK, meta, b"xy")
    assert {k: v for k, v in vars(_daemon_mod.DaemonOp).items() if not k.startswith("_")} == {
        k: v for k, v in vars(jax_daemon.DaemonOp).items() if not k.startswith("_")}


def test_daemon_and_main_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _daemon_mod.ShuffleDaemon(TpuShuffleConf(), num_executors=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _daemon_mod.main(["--port", "0"])


def test_metrics_and_trace_ops(tmp_path):
    d = ShuffleDaemon(TpuShuffleConf(staging_capacity_per_executor=1 << 18), num_executors=1)
    c = DaemonClient(d.address)
    try:
        text = c.metrics_text()
        assert "sparkucx_tpu_obs_trace_events" in text
        path = str(tmp_path / "trace.json")
        assert c.export_trace(path) >= 0 and os.path.exists(path)
    finally:
        c.close()
        d.close()
