"""Port twins of the cases of ``tests/test_faults.py`` that need only
``PeerTransport``: the fault-injection harness (``sparkucx_tpu_torch/testing/
faults.py``), seal-time neighbour replication and its settling, the ring
placement, typed block-not-found errors and the gray-failure factories, stores
on the CPU.  Then the replica tier against the JAX package: a port peer pushes
its sealed rounds to a JAX peer and the reverse, host-staged and device-staged,
and after the source is killed the holder serves every block from its replicas,
each run equal to the all-JAX run; ``replica_source`` and the REPLICA_PUT apply
equal the JAX store's.  The reader's failover, executor-loss chaos through the
reader and the demoted-round cases wait on the reader's hedges and the eviction
manager, which are not ported.
"""

import signal
import time

import numpy as np
import pytest

from sparkucx_tpu_torch.config import TpuShuffleConf
from sparkucx_tpu_torch.core.block import MemoryBlock, ShuffleBlockId
from sparkucx_tpu_torch.core.operation import BlockNotFoundError, OperationStatus, TransportError
from sparkucx_tpu_torch.shuffle.resolver import ring_neighbors
from sparkucx_tpu_torch.testing import faults
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


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset()
    yield
    faults.reset()


def _buf(n):
    return MemoryBlock(np.zeros(n, dtype=np.uint8), size=n)


def _cluster(n, **conf_kw):
    conf_kw.setdefault("staging_capacity_per_executor", 1 << 20)
    conf = TpuShuffleConf(**conf_kw)
    ts = [PeerTransport(conf, executor_id=i) for i in range(n)]
    addrs = [t.init() for t in ts]
    for t in ts:
        for j, a in enumerate(addrs):
            if j != t.executor_id:
                t.add_executor(j, a)
    return ts


def _close_all(ts):
    for t in ts:
        t.close()


class TestHarness:
    def test_disarmed_is_noop(self):
        faults.check("nowhere", peer="x")
        assert faults.transform("nowhere", b"abc") == b"abc"
        assert not faults.active

    def test_times_and_match(self):
        hits = []
        faults.arm("p", lambda **ctx: hits.append(ctx), times=2, match={"lane": 1})
        faults.check("p", lane=0)  # match miss
        faults.check("q", lane=1)  # point miss
        for _ in range(5):
            faults.check("p", lane=1)
        assert len(hits) == 2  # times bound respected
        assert faults.fired["p"] == 2

    def test_sever_and_fail_raise(self):
        faults.arm("p", faults.sever("boom"))
        with pytest.raises(ConnectionResetError, match="boom"):
            faults.check("p")
        faults.reset()
        faults.arm("p", faults.fail(ValueError("typed")))
        with pytest.raises(ValueError, match="typed"):
            faults.check("p")

    def test_stall_sleeps(self):
        faults.arm("p", faults.stall(0.05))
        t0 = time.monotonic()
        faults.check("p")
        assert time.monotonic() - t0 >= 0.04

    def test_garble_transform_roundtrip(self):
        faults.arm("p", faults.garble(0xFF))
        out = faults.transform("p", b"\x00\x0f\xf0")
        assert bytes(out) == b"\xff\xf0\x0f"

    def test_context_manager_resets_on_error(self):
        with pytest.raises(RuntimeError):
            with faults.injected_faults(("p", faults.sever())):
                assert faults.active
                raise RuntimeError("test body explodes")
        assert not faults.active and not faults.fired

    def test_disarm_single_entry(self):
        e1 = faults.arm("p", faults.stall(0))
        faults.arm("q", faults.stall(0))
        faults.disarm(e1)
        assert faults.active  # q still armed
        faults.check("p")
        assert "p" not in faults.fired


def _stage(t, shuffle_id, num_mappers, num_reducers, seed=0):
    """Stage deterministic random blocks on executor ``t``; returns
    {(map, reduce): payload}."""
    rng = np.random.default_rng(seed)
    t.store.create_shuffle(shuffle_id, num_mappers, num_reducers)
    payloads = {}
    for m in range(num_mappers):
        w = t.store.map_writer(shuffle_id, m)
        for r in range(num_reducers):
            data = rng.integers(0, 256, size=200 + 37 * (m + r), dtype=np.uint8).tobytes()
            payloads[(m, r)] = data
            w.write_partition(r, data)
        w.commit()
    return payloads


class TestReplication:
    def test_seal_replicates_to_ring_neighbor(self):
        ts = _cluster(2, replication_factor=1)
        try:
            payloads = _stage(ts[0], 7, 2, 3)
            ts[0].store.seal(7)
            assert ts[0].replication_wait(7, timeout=10.0)
            stats = ts[1].store.replica_stats()
            assert stats["replica_sources"] == 1
            assert stats["replica_bytes"] == sum(len(p) for p in payloads.values())
            for (m, r), data in payloads.items():
                view = ts[1].store.replica_view(7, m, r)
                assert view is not None
                arr, off, ln = view
                assert arr[off : off + ln].tobytes() == data
            assert ts[0].replica_stats["acks"] == ts[0].replica_stats["pushed_rounds"] > 0
        finally:
            _close_all(ts)

    def test_factor_zero_pushes_nothing(self):
        ts = _cluster(2, replication_factor=0)
        try:
            _stage(ts[0], 7, 1, 2)
            ts[0].store.seal(7)
            assert ts[0].replication_wait(7, timeout=0.5)  # nothing pending
            assert ts[0].replica_stats["pushed_rounds"] == 0
            assert ts[1].store.replica_stats()["replica_sources"] == 0
        finally:
            _close_all(ts)

    def test_replica_serves_read_block_and_wire(self):
        """A block the holder never staged is served from its replica tier —
        both through read_block (BlockNotFoundError otherwise) and over the
        peer wire (_resolve_one's replica arm)."""
        ts = _cluster(2, replication_factor=1)
        try:
            payloads = _stage(ts[0], 3, 1, 2)
            ts[0].store.seal(3)
            assert ts[0].replication_wait(3, timeout=10.0)
            # executor 1 never created shuffle 3 locally; replica serves anyway
            got = ts[1].store.read_block(3, 0, 1)
            assert got == payloads[(0, 1)]
            # and over the wire: executor 0 fetches its own block BACK from 1
            buf = _buf(len(payloads[(0, 0)]))
            req = ts[0].fetch_block(1, 3, 0, 0, buf)
            deadline = time.monotonic() + 5
            while not req.completed() and time.monotonic() < deadline:
                ts[0].progress()
            res = req.wait(1)
            assert res.status == OperationStatus.SUCCESS, str(res.error)
            assert buf.host_view()[: buf.size].tobytes() == payloads[(0, 0)]
        finally:
            _close_all(ts)

    def test_delayed_replication_wait_blocks_until_settled(self):
        ts = _cluster(2, replication_factor=1)
        try:
            faults.arm("replica.push", faults.delay(0.3), times=1)
            _stage(ts[0], 4, 1, 1)
            ts[0].store.seal(4)
            assert not ts[0].replication_wait(4, timeout=0.05)  # still delayed
            assert ts[0].replication_wait(4, timeout=10.0)
            assert ts[1].store.replica_view(4, 0, 0) is not None
        finally:
            _close_all(ts)

    def test_apply_sever_counts_as_unsettled(self):
        """Severing the receiving server mid-apply loses the ack; the pusher's
        replication_wait reports unsettled instead of hanging forever."""
        ts = _cluster(2, replication_factor=1)
        try:
            faults.arm("replica.apply", faults.sever(), times=1)
            _stage(ts[0], 5, 1, 1)
            ts[0].store.seal(5)
            assert not ts[0].replication_wait(5, timeout=0.7)
            assert ts[1].store.replica_view(5, 0, 0) is None
        finally:
            _close_all(ts)

    def test_ring_neighbors_placement(self):
        assert ring_neighbors(1, [0, 1, 2], 1) == [2]
        assert ring_neighbors(2, [0, 1, 2], 1) == [0]
        assert ring_neighbors(1, [0, 1, 2], 2) == [2, 0]
        assert ring_neighbors(1, [0, 1, 2], 99) == [2, 0]  # capped at ring-1
        assert ring_neighbors(5, [0, 1, 2], 1) == []  # not a member
        assert ring_neighbors(0, [0], 1) == []  # alone
        assert ring_neighbors(0, [0, 1], 0) == []  # disabled

    def test_block_not_found_is_typed_and_addressed(self):
        ts = _cluster(1, replication_factor=0)
        try:
            ts[0].store.create_shuffle(9, 1, 1)
            with pytest.raises(BlockNotFoundError) as ei:
                ts[0].store.read_block(9, 0, 0)
            assert (ei.value.shuffle_id, ei.value.map_id, ei.value.reduce_id) == (9, 0, 0)
            assert isinstance(ei.value, TransportError)  # old catch-sites work
        finally:
            _close_all(ts)


class TestGrayFactories:
    def test_garble_matches_per_byte_xor(self):
        """The vectorized garble must corrupt EXACTLY like the per-byte XOR it
        replaced — chaos tests pin corrupted-frame bytes, so the fast path
        cannot drift from the reference semantics."""
        rng = np.random.default_rng(123)
        data = rng.integers(0, 256, size=1 << 16, dtype=np.uint8).tobytes()
        faults.arm("p", faults.garble(0x5A))
        out = bytes(faults.transform("p", data))
        assert out == bytes(b ^ 0x5A for b in data)

    def test_throttle_paces_and_preserves_bytes(self):
        faults.arm("p", faults.throttle(10_000))  # 10 kB/s
        data = b"z" * 1000  # ~0.1 s at the armed rate
        t0 = time.monotonic()
        out = faults.transform("p", data)
        assert time.monotonic() - t0 >= 0.08  # paced...
        assert bytes(out) == data  # ...but every byte still bit-identical

    def test_flaky_is_seed_deterministic(self):
        def pattern(seed):
            act = faults.flaky(0.5, seed=seed)
            hits = []
            for _ in range(64):
                try:
                    act()
                    hits.append(False)
                except ConnectionResetError:
                    hits.append(True)
            return hits

        assert pattern(7) == pattern(7)  # same seed replays the same failures
        assert any(pattern(7)) and not all(pattern(7))
        assert pattern(7) != pattern(8)

    def test_kill_executor_idempotent_with_health_postmortem(self):
        """kill_executor captures the dying executor's peer-health/breaker
        view into its postmortem bundle BEFORE the kill, and a second kill of
        the same transport is a no-op (real processes die once)."""
        ts = _cluster(2)
        try:
            ts[1].record_peer_failure(0, "synthetic pre-kill failure")
            faults.kill_executor(ts[1])
            pm = ts[1].recorder.last_postmortem
            assert pm is not None and pm["reason"] == "chaos_kill"
            assert pm["context"]["executor"] == 1
            assert "failures" in pm["context"]["peer_health"]
            seq = pm["seq"]
            faults.kill_executor(ts[1])  # idempotent: no second bundle
            assert ts[1].recorder.last_postmortem["seq"] == seq
        finally:
            _close_all(ts)


# ---------------------------------------------------------------------------
# parity with the JAX package: the replica tier across the two packages
# ---------------------------------------------------------------------------

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import sparkucx_tpu.config as jax_config  # noqa: E402
import sparkucx_tpu.core.block as jax_block  # noqa: E402
import sparkucx_tpu.core.operation as jax_operation  # noqa: E402
import sparkucx_tpu.store.hbm_store as jax_store  # noqa: E402
import sparkucx_tpu.testing.faults as jax_faults  # noqa: E402
import sparkucx_tpu.transport.peer as jax_peer  # noqa: E402
from sparkucx_tpu_torch.store.hbm_store import HbmBlockStore  # noqa: E402

ALIGN = 128


def _conf_kw(device_staged, factor=1):
    return dict(staging_capacity_per_executor=1 << 20, block_alignment=ALIGN, replication_factor=factor,
                device_staging=device_staged)


#: one package's pieces: transport and store makers, its faults module, its
#: block id and buffer types, and how a row array of the device write is made
PORT = dict(
    transport=lambda kw, eid: PeerTransport(TpuShuffleConf(**kw), executor_id=eid),
    store=lambda kw: HbmBlockStore(TpuShuffleConf(**kw)),
    faults=faults, bid=ShuffleBlockId, buf=_buf, rows=torch.from_numpy,
)
JAX = dict(
    transport=lambda kw, eid: jax_peer.PeerTransport(jax_config.TpuShuffleConf(gather_impl="xla", **kw),
                                                     executor_id=eid),
    store=lambda kw: jax_store.HbmBlockStore(jax_config.TpuShuffleConf(gather_impl="xla", **kw)),
    faults=jax_faults, bid=jax_block.ShuffleBlockId,
    buf=lambda n: jax_block.MemoryBlock(np.zeros(n, dtype=np.uint8), size=n), rows=jnp.asarray,
)


def _seeded_blocks(seed, num_mappers, num_reducers):
    """{(map, reduce): payload}: lengths off every alignment, every fifth empty."""
    rng = np.random.default_rng(seed)
    return {
        (m, r): rng.integers(0, 256, size=int(rng.integers(1, 3000)) if (m + r) % 5 else 0,
                             dtype=np.uint8).tobytes()
        for m in range(num_mappers) for r in range(num_reducers)
    }


def _write(store, side, payloads, shuffle_id, num_mappers, num_reducers, device_staged):
    """Stage ``payloads`` on ``store``: host writes, or ``write_partition_device``
    of (rows, lane) int32 arrays (CPU tensors for the port, jax arrays for JAX)."""
    store.create_shuffle(shuffle_id, num_mappers, num_reducers)
    for m in range(num_mappers):
        w = store.map_writer(shuffle_id, m)
        for r in range(num_reducers):
            data = payloads[(m, r)]
            if device_staged:
                buf = np.zeros(-(-len(data) // ALIGN) * ALIGN, np.uint8)
                buf[: len(data)] = np.frombuffer(data, np.uint8)
                w.write_partition_device(r, side["rows"](buf.view(np.int32).reshape(-1, ALIGN // 4)), len(data))
            else:
                w.write_partition(r, data)
        w.commit()


def _replicate_then_kill(source, holder, device_staged, seed, shuffle_id=6, num_mappers=3, num_reducers=4):
    """Executor 0 (package ``source``) stages seeded blocks and seals; the
    seal pushes its rounds to its ring neighbour, executor 1 (package
    ``holder``); executor 0 is killed; executor 2 (package ``source``) then
    fetches every block of executor 0 from executor 1's replica tier over the
    wire.  Returns (the source store's ``replica_source`` before the kill,
    the pusher's counters, the holder store's ``replica_stats``, the fetched
    bytes)."""
    payloads = _seeded_blocks(seed, num_mappers, num_reducers)
    kw = _conf_kw(device_staged)
    ts = [source["transport"](kw, 0), holder["transport"](kw, 1)]
    reader = None
    try:
        addrs = [t.init() for t in ts]
        ts[0].add_executor(1, addrs[1])
        ts[1].add_executor(0, addrs[0])
        _write(ts[0].store, source, payloads, shuffle_id, num_mappers, num_reducers, device_staged)
        ts[0].store.seal(shuffle_id)
        assert ts[0].replication_wait(shuffle_id, timeout=10.0, strict=True)
        snapshot = ts[0].store.replica_source(shuffle_id)
        pushed = dict(ts[0].replica_stats)
        held = ts[1].store.replica_stats()
        source["faults"].kill_executor(ts[0])
        reader = source["transport"](_conf_kw(device_staged, factor=0), 2)
        reader.init()
        reader.add_executor(1, addrs[1])
        keys = sorted(payloads)
        bufs = [source["buf"](max(1, len(payloads[k]))) for k in keys]
        reqs = reader.fetch_blocks_by_block_ids(1, [source["bid"](shuffle_id, m, r) for m, r in keys], bufs,
                                                [None] * len(keys))
        deadline = time.monotonic() + 20
        while not all(q.completed() for q in reqs):
            reader.progress()
            assert time.monotonic() < deadline, "the replica fetch did not complete"
            time.sleep(0.001)
        got = {}
        for k, q, b in zip(keys, reqs, bufs):
            res = q.wait(1)
            assert res.status.name == "SUCCESS", f"block {k}: {res.error}"
            got[k] = b.host_view()[: b.size].tobytes()
        assert got == payloads
        return snapshot, pushed, held, got
    finally:
        for t in ts + ([reader] if reader is not None else []):
            t.close()


class TestReplicaTierParity:
    """A port peer pushes its sealed rounds to a JAX peer and the reverse, on
    seeded host-staged and device-staged (CPU) shuffles; after the source is
    killed every block is served from the holder's replica tier.  Each run
    equals the all-JAX run: the source's ``replica_source``, the pusher's
    counters, the holder's ``replica_stats`` and the served bytes."""

    @pytest.mark.parametrize("device_staged", [False, True], ids=["host", "device"])
    @pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
    def test_push_and_failover_serving_equal_jax(self, direction, device_staged):
        source, holder = (PORT, JAX) if direction == "port_to_jax" else (JAX, PORT)
        seed = 31 + device_staged
        got = _replicate_then_kill(source, holder, device_staged, seed)
        want = _replicate_then_kill(JAX, JAX, device_staged, seed)
        assert got[0] == want[0]
        assert got[1] == want[1] and got[1]["acks"] == got[1]["pushed_rounds"] == 1
        assert got[2] == want[2] and got[2]["replica_sources"] == 1
        assert got[3] == want[3]

    @pytest.mark.parametrize("device_staged", [False, True], ids=["host", "device"])
    @pytest.mark.parametrize("sealed", [False, True])
    def test_replica_source_equals_jax_stores(self, device_staged, sealed):
        payloads = _seeded_blocks(41 + 2 * device_staged + sealed, 4, 3)
        kw = _conf_kw(device_staged)
        port, ref = PORT["store"](kw), JAX["store"](kw)
        try:
            for store, side in ((port, PORT), (ref, JAX)):
                _write(store, side, payloads, 2, 4, 3, device_staged)
                if sealed:
                    store.seal(2)
            assert port.replica_source(2) == ref.replica_source(2)
        finally:
            port.close()
            ref.close()

    def test_put_replica_then_serve_equals_jax_store(self):
        """The REPLICA_PUT apply: the same rounds installed in both stores
        give the same ``replica_stats``, ``replica_view`` bytes and
        ``replica_block`` answers, a repeated put replacing the old copy."""
        payloads = _seeded_blocks(51, 2, 3)
        entries = [(m, r, len(payloads[(m, r)])) for m, r in sorted(payloads)]
        body = b"".join(payloads[(m, r)] for m, r, _ in entries)
        kw = _conf_kw(False)
        port, ref = PORT["store"](kw), JAX["store"](kw)
        try:
            for store in (port, ref):
                store.put_replica(8, 3, 0, entries, body)
                store.put_replica(8, 3, 0, entries, bytearray(body))  # replaces the first
                store.put_replica(8, 4, 1, entries[:2], memoryview(body)[: entries[0][2] + entries[1][2]])
            assert port.replica_stats() == ref.replica_stats()
            for m, r in list(payloads) + [(9, 9)]:
                pv, jv = port.replica_view(8, m, r), ref.replica_view(8, m, r)
                assert (pv is None) == (jv is None)
                if pv is not None:
                    assert pv[0][pv[1] : pv[1] + pv[2]].tobytes() == jv[0][jv[1] : jv[1] + jv[2]].tobytes()
                for src in (3, 4, 5):
                    assert port.replica_block(8, src, m, r) == ref.replica_block(8, src, m, r)
            with pytest.raises(TransportError):
                port.put_replica(8, 3, 0, entries, body[:-1])
            with pytest.raises(jax_operation.TransportError):
                ref.put_replica(8, 3, 0, entries, body[:-1])
        finally:
            port.close()
            ref.close()
