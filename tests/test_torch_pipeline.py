"""The port's round pipeline (sparkucx_tpu_torch/transport/pipeline.py):
ordering, overlap, backpressure and error propagation as in the JAX
package's engine, the credit gate, and multi-round shuffles through the
port's cluster that must be bit-identical at every pipeline depth."""

import threading
import time

import numpy as np
import pytest

from sparkucx_tpu.transport.pipeline import CreditGate as JaxCreditGate
from sparkucx_tpu.transport.pipeline import RoundPipeline as JaxRoundPipeline
from sparkucx_tpu_torch.config import TpuShuffleConf
from sparkucx_tpu_torch.core.operation import TransportError
from sparkucx_tpu_torch.transport.pipeline import CreditGate, RoundPipeline
from sparkucx_tpu_torch.transport.tpu import TpuShuffleCluster
from sparkucx_tpu_torch.utils.stats import StatsAggregator


@pytest.mark.parametrize("depth", [1, 2, 3, 8])
def test_results_in_round_order_match_jax(depth):
    ours = RoundPipeline(depth, lambda r: r * 10, lambda r, t: t + r).run(6)
    theirs = JaxRoundPipeline(depth, lambda r: r * 10, lambda r, t: t + r).run(6)
    assert ours == theirs == [r * 11 for r in range(6)]


def test_depth_one_is_strictly_serial():
    events = []
    RoundPipeline(1, lambda r: events.append(("submit", r)), lambda r, t: events.append(("drain", r))).run(3)
    assert events == [("submit", 0), ("drain", 0), ("submit", 1), ("drain", 1), ("submit", 2), ("drain", 2)]


def test_depth_two_overlaps_submit_with_drain():
    order = []
    lock = threading.Lock()

    def submit(r):
        with lock:
            order.append(("submit", r))
        return r

    def drain(r, t):
        time.sleep(0.02)
        with lock:
            order.append(("drain", r))
        return t

    RoundPipeline(2, submit, drain).run(3)
    assert order.index(("submit", 1)) < order.index(("drain", 0))
    assert [e for e in order if e[0] == "drain"] == [("drain", r) for r in range(3)]


def test_backpressure_bounds_inflight_window():
    depth = 2
    inflight, peak = [], []
    lock = threading.Lock()

    def submit(r):
        with lock:
            inflight.append(r)
            peak.append(len(inflight))
        return r

    def drain(r, t):
        time.sleep(0.01)
        with lock:
            inflight.remove(r)
        return t

    RoundPipeline(depth, submit, drain).run(8)
    assert max(peak) <= depth + 1


def test_drain_error_propagates_earliest_first():
    def drain(r, t):
        if r in (1, 3):
            raise TransportError(f"boom round {r}")
        return t

    with pytest.raises(TransportError, match="boom round 1"):
        RoundPipeline(3, lambda r: r, drain).run(5)


@pytest.mark.parametrize("depth", [1, 3])
def test_submit_error_propagates(depth):
    def submit(r):
        if r == 2:
            raise ValueError("submit died")
        return r

    with pytest.raises(ValueError, match="submit died"):
        RoundPipeline(depth, submit, lambda r, t: t).run(4)


def test_zero_rounds_and_depth_validation():
    assert RoundPipeline(4, lambda r: r, lambda r, t: t).run(0) == []
    with pytest.raises(ValueError, match="depth"):
        RoundPipeline(0, lambda r: r, lambda r, t: t)
    with pytest.raises(ValueError, match="round_bytes"):
        RoundPipeline(2, lambda r: r, lambda r, t: t, credits=CreditGate(10))


def test_interrupt_stops_submission():
    submitted = []

    def interrupt():
        return RuntimeError("plan went stale") if len(submitted) >= 2 else None

    with pytest.raises(RuntimeError, match="stale"):
        RoundPipeline(2, lambda r: submitted.append(r) or r, lambda r, t: t, interrupt=interrupt).run(5)
    assert submitted == [0, 1]


def test_credit_gate_matches_jax():
    for gate in (CreditGate(100), JaxCreditGate(100)):
        assert gate.acquire(60) and gate.try_acquire(40)
        assert not gate.try_acquire(1)
        assert not gate.acquire(10, timeout=0.01)
        gate.release(100)
        assert gate.used == 0
        assert gate.try_acquire(500)  # oversized, admitted alone
        assert not gate.try_acquire(1)
        gate.release(500)
    with pytest.raises(ValueError, match="positive"):
        CreditGate(0)


def test_credits_bound_bytes_in_flight():
    gate = CreditGate(30)
    peak, lock = [], threading.Lock()

    def submit(r):
        with lock:
            peak.append(gate.used)
        return r

    def drain(r, t):
        time.sleep(0.005)
        return t

    out = RoundPipeline(2, submit, drain, credits=gate, round_bytes=lambda r: 15).run(8)
    assert out == list(range(8)) and max(peak) <= 30 and gate.used == 0


def test_stage_stats_recorded():
    stats = StatsAggregator()
    RoundPipeline(2, lambda r: r, lambda r, t: t, name="p", stats=stats, result_bytes=lambda r: 100).run(4)
    assert stats.summary("p.submit").ops == 4
    drain = stats.summary("p.drain")
    assert drain.ops == 4 and drain.bytes == 400


# ----------------------------------------------------------------------
# the port's cluster: multi-round shuffles at every depth


def _run_spill_shuffle(n, depth, mode, *, uneven=False, quota=0, tmp_path=None):
    conf = TpuShuffleConf(
        staging_capacity_per_executor=n * 4096,  # 4 KiB per peer region
        block_alignment=128,
        num_executors=n,
        pipeline_depth=depth,
        host_recv_mode=mode,
        keep_device_recv=(mode == "device"),
        slot_quota_rows=quota,
        spill_dir=str(tmp_path) if tmp_path is not None else None,
    )
    cluster = TpuShuffleCluster(conf, devices=["cpu"] * n)
    M, R = 3 * n, 2 * n
    meta = cluster.create_shuffle(0, M, R)
    rng = np.random.default_rng(7)
    oracle = {}
    for m in range(M):
        t = cluster.transport(meta.map_owner[m])
        w = t.store.map_writer(0, m)
        for r in range(R):
            # uneven: executor 0's maps write 4x more, so it spills more rounds
            size = 2000 if (not uneven or meta.map_owner[m] == 0) else 500
            payload = rng.integers(0, 256, size=size, dtype=np.uint8).tobytes()
            oracle[(m, r)] = payload
            w.write_partition(r, payload)
        t.commit_block(w.commit().pack())
    rounds = [t.store.num_rounds(0) for t in cluster.transports]
    assert max(rounds) > 1, "the test should spill"
    if uneven and n > 1:
        assert rounds[0] > min(rounds), "rounds should be uneven"
    cluster.run_exchange(0)
    blocks = {}
    for (m, r) in oracle:
        view, length = cluster.locate_received_block(meta.owner_of_reduce(r), 0, m, r)
        blocks[(m, r)] = bytes(view[:length])
        assert blocks[(m, r)] == oracle[(m, r)], f"block {(m, r)} corrupted"
    sizes = [np.asarray(s).copy() for s in cluster.meta(0).recv_sizes]
    cluster.remove_shuffle(0)
    return max(rounds), sizes, blocks


@pytest.mark.parametrize("mode", ["array", "memmap", "device"])
@pytest.mark.parametrize("quota", [0, 8])
def test_depths_match_serial(mode, quota, tmp_path):
    base = _run_spill_shuffle(8, 1, mode, quota=quota, tmp_path=tmp_path)
    for depth in (2, 3):
        rounds, sizes, blocks = _run_spill_shuffle(8, depth, mode, quota=quota, tmp_path=tmp_path)
        assert rounds == base[0] and len(sizes) == len(base[1])
        for a, b in zip(sizes, base[1]):
            assert np.array_equal(a, b)
        assert blocks == base[2]


@pytest.mark.parametrize("mode", ["array", "memmap"])
def test_single_executor(mode, tmp_path):
    base = _run_spill_shuffle(1, 1, mode, tmp_path=tmp_path)
    for depth in (2, 3):
        got = _run_spill_shuffle(1, depth, mode, tmp_path=tmp_path)
        assert got[0] == base[0] and got[2] == base[2]


def test_uneven_spill_rounds():
    base = _run_spill_shuffle(4, 1, "array", uneven=True)
    got = _run_spill_shuffle(4, 2, "array", uneven=True)
    assert got[0] == base[0] and got[2] == base[2]
