"""Port twins of ``tests/test_serve.py``: the popularity-aware serving tier of
``sparkucx_tpu_torch`` — per-block fetch-rate EWMAs (``BlockPopularity``),
the serve-side decoded-block cache (``ServeCache`` and the store's
``serve_cache_get``/``serve_cache_offer``), hot promotion widening the replica
set over REPLICA_PUT and advertised over HOT_SET_PULL, cool-down, the
encoded-chunk pool's counters and the widened ring placement, stores on the
CPU.  Tenant quotas and the reader's load spreading and hedges are not
ported and have no twins here.  The last section runs one injected clock
through the port's ``BlockPopularity`` and the JAX package's and holds their
transitions and counters equal.
"""

import signal
import time

import numpy as np
import pytest

from sparkucx_tpu_torch.config import TpuShuffleConf
from sparkucx_tpu_torch.core.block import MemoryBlock, ShuffleBlockId
from sparkucx_tpu_torch.core.definitions import AmId, pack_hot_set, unpack_hot_set
from sparkucx_tpu_torch.core.operation import OperationStatus, TransportError
from sparkucx_tpu_torch.service.eviction import ServeCache
from sparkucx_tpu_torch.shuffle.resolver import ring_neighbors, widened_ring_neighbors
from sparkucx_tpu_torch.store.hbm_store import BlockPopularity, HbmBlockStore
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


def _stage(t, shuffle_id, num_mappers, num_reducers, seed=0):
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


def _fetch_one(t, peer, sid, m, r, size, timeout=5.0):
    buf = _buf(size)
    req = t.fetch_block(peer, sid, m, r, buf)
    deadline = time.monotonic() + timeout
    while not req.completed() and time.monotonic() < deadline:
        t.progress()
    res = req.wait(1)
    assert res.status == OperationStatus.SUCCESS, str(res.error)
    return buf.host_view()[:size].tobytes()


def _storm(t, peer, sid, m, r, size, rounds=6):
    """Hot loop on one block: back-to-back fetches push its rate EWMA far
    past any CI-realistic threshold."""
    out = None
    for _ in range(rounds):
        out = _fetch_one(t, peer, sid, m, r, size)
    return out


class TestServeKnobs:
    def test_knob_parsing_from_spark_conf(self):
        conf = TpuShuffleConf.from_spark_conf(
            {
                "spark.shuffle.tpu.serve.hotThresholdFetchesPerSec": "25",
                "spark.shuffle.tpu.serve.hotReplicas": "3",
                "spark.shuffle.tpu.serve.cacheBytes": "4m",
                "spark.shuffle.tpu.serve.holdersTtlMs": "100",
                "spark.shuffle.tpu.compress.cacheBytes": "2m",
            }
        )
        assert conf.serve_hot_threshold_fetches_per_sec == 25.0
        assert conf.serve_hot_replicas == 3
        assert conf.serve_cache_bytes == 4 << 20
        assert conf.serve_holders_ttl_ms == 100
        assert conf.compress_cache_bytes == 2 << 20

    def test_defaults_are_off(self):
        """Threshold 0 = no tracker, no HOT_SET_PULL traffic, no serve cache;
        the compress pool cap keeps its historical 128 MiB default, the
        holder-set TTL its historical 250 ms."""
        conf = TpuShuffleConf()
        assert conf.serve_hot_threshold_fetches_per_sec == 0.0
        assert conf.serve_cache_bytes == 0
        assert conf.compress_cache_bytes == 128 << 20
        assert conf.serve_hot_replicas == 4  # inert while the threshold is 0
        assert conf.serve_holders_ttl_ms == 250  # inert while the threshold is 0

    def test_validation_rejects_negative(self):
        with pytest.raises(ValueError):
            TpuShuffleConf(serve_hot_threshold_fetches_per_sec=-1).validate()
        with pytest.raises(ValueError):
            TpuShuffleConf(serve_cache_bytes=-1).validate()
        with pytest.raises(ValueError):
            TpuShuffleConf(compress_cache_bytes=-1).validate()
        with pytest.raises(ValueError):
            TpuShuffleConf(serve_holders_ttl_ms=-1).validate()

    def test_holders_ttl_governs_pull_rate(self, monkeypatch):
        """The hot_holders cache honors ``serve.holdersTtlMs``: a long TTL
        serves the cached table without a HOT_SET_PULL round-trip; TTL 0
        means every call re-pulls (the freshest-possible setting)."""
        ts = _cluster(
            2, serve_hot_threshold_fetches_per_sec=5.0, serve_holders_ttl_ms=60_000
        )
        try:
            pulls = []
            real_pull = ts[1]._pull

            def counting_pull(eid, am_id, timeout=1.0):
                if am_id == AmId.HOT_SET_PULL:
                    pulls.append(eid)
                return real_pull(eid, am_id, timeout=timeout)

            monkeypatch.setattr(ts[1], "_pull", counting_pull)
            ts[1].hot_holders(0, 0)
            ts[1].hot_holders(0, 0)
            assert len(pulls) == 1  # second call inside the TTL: cached

            ts[1].conf.serve_holders_ttl_ms = 0
            ts[1].hot_holders(0, 0)
            ts[1].hot_holders(0, 0)
            assert len(pulls) == 3  # TTL 0: every call round-trips
        finally:
            _close_all(ts)

    def test_default_transport_has_no_popularity_plane(self):
        ts = _cluster(1)
        try:
            assert ts[0].popularity is None
            assert ts[0].store.serve_cache is None
            assert ts[0].hot_holders(0, 0) == []  # tier off: no pull, ever
        finally:
            _close_all(ts)


class _Clock:
    def __init__(self):
        self.ns = 0

    def __call__(self):
        return self.ns


class TestBlockPopularity:
    def test_storm_promotes_once_per_shuffle(self):
        clk = _Clock()
        pop = BlockPopularity(100.0, now_ns=clk)
        hot, trans = pop.observe(7, 0, 0)  # first sighting only records
        assert (hot, trans) == (False, [])
        clk.ns += 1_000_000  # 1 ms apart = 1000 fetches/sec instantaneous
        hot, trans = pop.observe(7, 0, 0)
        assert hot and trans == [(7, True)]  # ewma = 0.25 * 1000 >= 100
        clk.ns += 1_000_000
        hot, trans = pop.observe(7, 0, 1)  # second block heats up
        assert trans == []  # no first sighting yet
        clk.ns += 1_000_000
        hot, trans = pop.observe(7, 0, 1)
        assert hot and trans == []  # shuffle already hot: no new transition
        assert pop.is_hot(7) and pop.hot_shuffles() == [7]
        snap = pop.snapshot()
        assert snap["promotions"] == 2 and snap["hot_blocks"] == 2
        assert snap["hot_shuffles"] == 1

    def test_slow_fetches_never_promote(self):
        clk = _Clock()
        pop = BlockPopularity(100.0, now_ns=clk)
        for _ in range(50):
            clk.ns += 1_000_000_000  # 1/sec, threshold 100/sec
            hot, trans = pop.observe(3, 0, 0)
            assert not hot and trans == []
        assert not pop.is_hot(3)

    def test_cooling_demotes_with_hysteresis(self):
        clk = _Clock()
        pop = BlockPopularity(100.0, now_ns=clk)
        pop.observe(7, 0, 0)
        clk.ns += 1_000_000
        assert pop.observe(7, 0, 0)[0]  # hot at ewma 250
        # 5 ms of silence: effective rate min(250, 200) stays over the
        # demote edge (50) -> hysteresis holds the block hot
        assert pop.sweep(clk.ns + 5_000_000) == []
        assert pop.is_hot(7)
        # 100 ms of silence: effective rate 10 < 50 -> the shuffle's last
        # hot block cools and the demote transition fires
        assert pop.sweep(clk.ns + 100_000_000) == [(7, False)]
        assert not pop.is_hot(7)
        assert pop.snapshot()["demotions"] == 1

    def test_idle_cold_entries_are_forgotten(self):
        clk = _Clock()
        pop = BlockPopularity(100.0, now_ns=clk)
        pop.observe(1, 0, 0)
        assert pop.snapshot()["tracked_blocks"] == 1
        pop.sweep(clk.ns + 61 * 1_000_000_000)  # past _IDLE_GC_NS
        assert pop.snapshot()["tracked_blocks"] == 0

    def test_maybe_sweep_is_rate_limited(self):
        clk = _Clock()
        pop = BlockPopularity(100.0, now_ns=clk)
        pop.observe(7, 0, 0)
        clk.ns += 1_000_000
        pop.observe(7, 0, 0)
        clk.ns += 200_000_000_000  # everything long cold
        assert pop.maybe_sweep() == [(7, False)]  # first scan runs
        pop.observe(7, 1, 1)
        clk.ns += 500_000  # within the 1 s interval
        assert pop.maybe_sweep() == []  # rate-limited: no scan

    def test_threshold_zero_is_inert(self):
        pop = BlockPopularity(0.0, now_ns=_Clock())
        assert pop.observe(1, 0, 0) == (False, [])
        assert pop.maybe_sweep() == []
        assert pop.snapshot()["tracked_blocks"] == 0


class TestServeCache:
    def test_lru_eviction_order_and_evicted_list(self):
        c = ServeCache(100)
        assert c.put((0, 0, 0), b"x" * 40) == []
        assert c.put((0, 0, 1), b"y" * 40) == []
        assert c.get((0, 0, 0)) == b"x" * 40  # refreshes (0,0,0) to MRU
        evicted = c.put((0, 0, 2), b"z" * 40)  # (0,0,1) is now LRU
        assert evicted == [((0, 0, 1), 40)]
        assert c.get((0, 0, 1)) is None
        assert c.get((0, 0, 0)) is not None
        assert c.used_bytes == 80 and len(c) == 2

    def test_oversized_block_rejected(self):
        c = ServeCache(10)
        assert c.put((0, 0, 0), b"a" * 11) == []
        assert len(c) == 0 and c.snapshot()["cache_rejects"] == 1

    def test_replace_refunds_previous_bytes(self):
        c = ServeCache(100)
        c.put((0, 0, 0), b"a" * 30)
        evicted = c.put((0, 0, 0), b"b" * 50)
        # the replaced payload's bytes come back so the caller releases them
        assert ((0, 0, 0), 30) in evicted
        assert c.used_bytes == 50 and c.get((0, 0, 0)) == b"b" * 50

    def test_invalidate_shuffle_drops_only_that_shuffle(self):
        c = ServeCache(1000)
        c.put((1, 0, 0), b"a" * 10)
        c.put((2, 0, 0), b"b" * 20)
        dropped = c.invalidate_shuffle(1)
        assert dropped == [((1, 0, 0), 10)]
        assert c.get((2, 0, 0)) is not None and c.used_bytes == 20





class TestHotSetWire:
    def test_pack_unpack_roundtrip(self):
        table = {3: [0, 2, 5], 1: [4], 9: []}
        assert unpack_hot_set(pack_hot_set(table)) == {3: [0, 2, 5], 1: [4], 9: []}
        assert unpack_hot_set(pack_hot_set({})) == {}

    def test_pack_is_deterministic_sorted(self):
        a = pack_hot_set({2: [1, 0], 1: [3]})
        b = pack_hot_set({1: [3], 2: [0, 1]})
        assert a == b  # sorted shuffles, sorted holders: canonical bytes

    def test_am_id_pinned(self):
        assert AmId.HOT_SET_PULL == 14


def _bare_reader(executor_id, holders_of=None, replica_of=None, **kw):
    payload_len = 64
    return TpuShuffleReader(
        _FakeTransport(),
        executor_id,
        0,
        0,
        1,
        4,
        block_sizes=lambda m, r: payload_len,
        sender_of=lambda m: 1,
        holders_of=holders_of,
        replica_of=replica_of,
        **kw,
    )


class TestEncodedPoolCounters:
    def test_hit_miss_eviction_counters_export(self):
        ts = _cluster(2, wire_compress_codec="rle")
        try:
            payloads = _stage(ts[0], 1, 1, 2, seed=3)
            ts[0].store.seal(1)
            for _ in range(2):
                for (m, r), p in sorted(payloads.items()):
                    assert _fetch_one(ts[1], 0, 1, m, r, len(p)) == p
            snap = ts[0].server.compress_snapshot()
            assert snap["cache_misses"] >= 2  # first pass encodes
            assert snap["cache_hits"] >= 2  # second pass serves the pool
            assert snap["cache_evictions"] == 0  # default cap: no pressure
            # and the counters ride the existing compress metrics family
            text = ts[0].metrics.prometheus_text()
            assert "compress" in text and "cache_misses" in text
        finally:
            _close_all(ts)

    def test_cache_bytes_zero_disables_pool(self):
        ts = _cluster(2, wire_compress_codec="rle", compress_cache_bytes=0)
        try:
            payloads = _stage(ts[0], 1, 1, 1, seed=4)
            ts[0].store.seal(1)
            p = payloads[(0, 0)]
            assert _fetch_one(ts[1], 0, 1, 0, 0, len(p)) == p
            assert _fetch_one(ts[1], 0, 1, 0, 0, len(p)) == p
            snap = ts[0].server.compress_snapshot()
            assert snap["cache_hits"] == 0  # pool off: every fetch re-encodes
            assert len(ts[0].server._encoded_pool) == 0
        finally:
            _close_all(ts)


def _serve_cluster(n=4, **kw):
    kw.setdefault("replication_factor", 1)
    # 1 fetch/sec: any back-to-back loopback storm promotes even on a
    # heavily loaded CI worker, while one-shot fetches stay cold
    kw.setdefault("serve_hot_threshold_fetches_per_sec", 1.0)
    kw.setdefault("serve_hot_replicas", 2)
    kw.setdefault("serve_cache_bytes", 1 << 20)
    return _cluster(n, **kw)


class TestPopularityLifecycle:
    def test_storm_promotes_widens_and_serves_bit_identical(self):
        ts = _serve_cluster()
        try:
            payloads = _stage(ts[0], 0, 1, 2, seed=11)
            ts[0].store.seal(0)
            assert ts[0].replication_wait(0, timeout=10.0)
            # fault-tolerance floor: base ring successor (executor 1) only
            assert ts[1].store.replica_view(0, 0, 0) is not None
            assert ts[2].store.replica_view(0, 0, 0) is None

            p = payloads[(0, 0)]
            got = _storm(ts[3], 0, 0, 0, 0, len(p))
            assert got == p  # storm payloads bit-identical throughout

            assert ts[0].popularity.is_hot(0)
            snap = ts[0]._serve_view()
            assert snap["promotions"] >= 1 and snap["advertised_hot_shuffles"] == 1

            # the widen push replicated the round onto the EXTRA holder
            assert ts[0].replication_wait(0, timeout=10.0)
            assert ts[2].store.replica_view(0, 0, 0) is not None

            # the primary advertises the full holder set over HOT_SET_PULL
            assert ts[3].hot_holders(0, 0) == [0, 1, 2]

            # every advertised holder serves the block bit-identically
            for holder in (1, 2):
                assert _fetch_one(ts[3], holder, 0, 0, 0, len(p)) == p
        finally:
            _close_all(ts)

    def test_hot_block_pins_in_serve_cache(self):
        ts = _serve_cluster()
        try:
            payloads = _stage(ts[0], 0, 1, 1, seed=12)
            ts[0].store.seal(0)
            p = payloads[(0, 0)]
            assert _storm(ts[3], 0, 0, 0, 0, len(p), rounds=8) == p
            snap = ts[0].store.serve_cache.snapshot()
            assert snap["cache_entries"] >= 1  # admitted on promotion
            assert snap["cache_hits"] >= 1  # later storm fetches hit it
            assert snap["cache_used_bytes"] == len(p)
        finally:
            _close_all(ts)


    def test_cool_down_demotes_and_drops_advertisement(self):
        ts = _serve_cluster()
        try:
            payloads = _stage(ts[0], 0, 1, 1, seed=14)
            ts[0].store.seal(0)
            p = payloads[(0, 0)]
            _storm(ts[3], 0, 0, 0, 0, len(p))
            assert ts[0].popularity.is_hot(0)
            assert ts[3].hot_holders(0, 0)

            # silence, observed through a shifted clock: the sweep demotes
            pop = ts[0].popularity
            real = time.monotonic_ns
            pop._now_ns = lambda: real() + 120 * 1_000_000_000
            ts[0].server.sweep_popularity()
            assert not pop.is_hot(0)
            assert pop.snapshot()["demotions"] >= 1
            assert ts[0]._serve_view()["advertised_hot_shuffles"] == 0

            # past the reader-side TTL the advertisement is gone...
            time.sleep(ts[3].conf.serve_holders_ttl_ms / 1e3 + 0.1)
            assert ts[3].hot_holders(0, 0) == []
            # ...but the widened replicas persist (never below the floor),
            # and the primary still serves the block bit-identically
            assert ts[2].store.replica_view(0, 0, 0) is not None
            assert _fetch_one(ts[3], 0, 0, 0, 0, len(p)) == p
        finally:
            _close_all(ts)

    def test_defaults_off_no_advertisement_no_tracking(self):
        ts = _cluster(3, replication_factor=1)
        try:
            payloads = _stage(ts[0], 0, 1, 1, seed=15)
            ts[0].store.seal(0)
            assert ts[0].replication_wait(0, timeout=10.0)
            p = payloads[(0, 0)]
            assert _storm(ts[2], 0, 0, 0, 0, len(p)) == p
            assert ts[0].popularity is None  # nothing tracked
            assert ts[0]._serve_view() == {}
            assert ts[2].hot_holders(0, 0) == []
            assert ts[2].store.replica_view(0, 0, 0) is None  # no widen push
        finally:
            _close_all(ts)


class TestWidenedRingNeighbors:
    def test_base_plus_extra_partition(self):
        members = [0, 1, 2, 3, 4]
        base, extra = widened_ring_neighbors(0, members, 1, 3)
        assert base == [1] and extra == [2, 3]
        assert base == ring_neighbors(0, members, 1)

    def test_hot_factor_never_narrows_below_floor(self):
        members = [0, 1, 2, 3]
        base, extra = widened_ring_neighbors(0, members, 2, 1)
        assert base == [1, 2] and extra == []

    def test_degenerate_rings(self):
        assert widened_ring_neighbors(0, [0], 1, 4) == ([], [])
        assert widened_ring_neighbors(9, [0, 1], 1, 4) == ([], [])  # non-member


# ---------------------------------------------------------------------------
# parity: one clock through both packages' trackers and caches
# ---------------------------------------------------------------------------

import sparkucx_tpu.service.eviction as jax_eviction  # noqa: E402
import sparkucx_tpu.store.hbm_store as jax_store  # noqa: E402


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_popularity_transitions_equal_the_jax_trackers(seed):
    rng = np.random.default_rng(seed)
    clock = {"t": 0}
    port = BlockPopularity(5.0, now_ns=lambda: clock["t"])
    ref = jax_store.BlockPopularity(5.0, now_ns=lambda: clock["t"])
    for _ in range(400):
        clock["t"] += int(rng.integers(1, 4)) * int(rng.choice([10_000_000, 100_000_000, 900_000_000]))
        key = tuple(int(x) for x in rng.integers(0, 3, size=3))
        if rng.random() < 0.1:
            assert port.sweep() == ref.sweep()
        else:
            assert port.observe(*key) == ref.observe(*key)
        assert port.maybe_sweep() == ref.maybe_sweep()
    assert port.snapshot() == ref.snapshot() and port.hot_shuffles() == ref.hot_shuffles()


def test_serve_cache_evictions_equal_the_jax_caches():
    rng = np.random.default_rng(4)
    port, ref = ServeCache(10_000), jax_eviction.ServeCache(10_000)
    for _ in range(300):
        key = tuple(int(x) for x in rng.integers(0, 4, size=3))
        if rng.random() < 0.5:
            data = bytes(int(rng.integers(0, 4000)))
            assert port.put(key, data) == ref.put(key, data)
        elif rng.random() < 0.1:
            assert port.invalidate_shuffle(key[0]) == ref.invalidate_shuffle(key[0])
        else:
            assert port.get(key) == ref.get(key)
    assert port.snapshot() == ref.snapshot()
