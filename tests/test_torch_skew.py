"""Skew-aware exchange planning in the port (sparkucx_tpu_torch/ops/skew.py)
against the JAX package's ops/skew.py on the same seeded numpy inputs, and the
port's quota-capped cluster run against its single-shot run and against the
JAX cluster.  Exact comparison throughout: the quota reshapes staging
geometry, never bytes."""

import os

import numpy as np
import pytest
import torch

from sparkucx_tpu.ops import skew as jax_skew
from sparkucx_tpu.utils.stats import StatsAggregator as JaxStats
from sparkucx_tpu_torch.config import TpuShuffleConf
from sparkucx_tpu_torch.core.block import MemoryBlock, ShuffleBlockId
from sparkucx_tpu_torch.core.operation import OperationStatus
from sparkucx_tpu_torch.ops import skew
from sparkucx_tpu_torch.transport.pipeline import RoundPipeline
from sparkucx_tpu_torch.transport.tpu import TpuShuffleCluster
from sparkucx_tpu_torch.utils.stats import StatsAggregator, StatsSummary

N_EXEC = 4


# ----------------------------------------------------------------------
# geometry, held against the JAX helpers


@pytest.mark.parametrize("slot,quota", [(100, 0), (64, 0), (1, 0), (100, 64), (100, 50), (8, 1000), (23, 8)])
def test_quota_slot_rows_matches_jax(slot, quota):
    assert skew.quota_slot_rows(slot, quota) == jax_skew.quota_slot_rows(slot, quota)


def test_quota_slot_rows_rejects_nonpositive_slot():
    with pytest.raises(ValueError, match="slot_rows"):
        skew.quota_slot_rows(0, 16)


@pytest.mark.parametrize("maxes,slot,quota", [([100, 0, 5], 128, 32), ([0], 128, 32), ([2200], 4096, 256), ([7, 70, 700], 1024, 100)])
def test_plan_exchange_matches_jax(maxes, slot, quota):
    ours = skew.plan_exchange(maxes, slot, quota)
    theirs = jax_skew.plan_exchange(maxes, slot, quota)
    assert ours.describe() == theirs.describe()
    assert ours.subrounds() == theirs.subrounds()
    assert ours.staged_rows(8) == theirs.staged_rows(8)


def test_plan_order_and_permutation_check():
    plan = skew.ExchangePlan(slot_rows=16, chunks_per_round=(2, 1), round_order=(1, 0))
    theirs = jax_skew.ExchangePlan(slot_rows=16, chunks_per_round=(2, 1), round_order=(1, 0))
    assert plan.ordered_subrounds() == theirs.ordered_subrounds() == [(1, 0, 1), (0, 0, 2), (0, 1, 2)]
    with pytest.raises(ValueError, match="permutation"):
        skew.ExchangePlan(slot_rows=16, chunks_per_round=(2, 1), round_order=(0, 0)).ordered_subrounds()


@pytest.mark.parametrize("seed", range(4))
def test_chunk_size_rows_matches_jax_and_conserves_rows(seed):
    rng = np.random.default_rng(seed)
    for _ in range(10):
        n = int(rng.integers(1, 9))
        slot = int(rng.integers(1, 200))
        sizes = rng.integers(0, slot + 1, size=n).astype(np.int32)
        q = skew.quota_slot_rows(slot, int(rng.integers(1, slot + 1)))
        nchunks = skew.plan_exchange([int(sizes.max())], slot, q).chunks_per_round[0]
        chunks = [skew.chunk_size_rows(sizes, c, q) for c in range(nchunks)]
        for c, got in enumerate(chunks):
            assert got.dtype == np.int32
            np.testing.assert_array_equal(got, jax_skew.chunk_size_rows(sizes, c, q))
            assert int(got.max(initial=0)) <= q
        np.testing.assert_array_equal(np.sum(chunks, axis=0), sizes)


@pytest.mark.parametrize("n,slot,q,chunk", [(5, 23, 8, 0), (5, 23, 8, 2), (2, 4, 2, 2), (3, 16, 32, 0), (1, 7, 4, 1)])
def test_slice_subround_matches_jax(n, slot, q, chunk):
    rng = np.random.default_rng(n * 100 + slot)
    payload = rng.integers(-100, 100, size=(n * slot, 4), dtype=np.int32)
    got = skew.slice_subround(torch.from_numpy(payload), n, chunk, q)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), jax_skew.slice_subround(payload, n, chunk, q))


def test_slice_subround_rejects_ragged_payload():
    with pytest.raises(ValueError, match="not a multiple"):
        skew.slice_subround(torch.zeros((7, 4), dtype=torch.int32), 2, 0, 2)


@pytest.mark.parametrize("seed", range(3))
def test_slice_reassemble_matches_jax_and_direct_oracle(seed):
    """Sender slicing + a simulated compacting exchange + receiver splicing
    reproduces the single-shot receive buffer, through the port's helpers
    and through the JAX ones, byte for byte."""
    rng = np.random.default_rng(seed)
    n, lane, slot, q = 5, 4, 23, 8
    row_bytes = lane * 4
    nchunks = skew.plan_exchange([slot], slot, q).chunks_per_round[0]
    sizes = rng.integers(0, slot + 1, size=(n, n)).astype(np.int32)
    payloads = [rng.integers(-100, 100, size=(n * slot, lane), dtype=np.int32) for _ in range(n)]
    subs = [np.stack([skew.chunk_size_rows(sizes[i], c, q) for i in range(n)]) for c in range(nchunks)]
    for j in range(n):
        shards = []
        for c in range(nchunks):
            pieces = [
                skew.slice_subround(torch.from_numpy(payloads[i]), n, c, q)[j * q : j * q + int(subs[c][i, j])]
                for i in range(n)
            ]
            shards.append(torch.cat(pieces).numpy().reshape(-1).view(np.uint8))
        cols = [m[:, j] for m in subs]
        assert skew.piece_slices(cols) == jax_skew.piece_slices(cols)
        got = skew.reassemble_round(shards, cols, row_bytes)
        want = np.concatenate([payloads[i][j * slot : j * slot + int(sizes[i, j])] for i in range(n)])
        assert bytes(got) == bytes(want.reshape(-1).view(np.uint8))
        assert bytes(got) == bytes(jax_skew.reassemble_round(shards, cols, row_bytes))


def test_piece_slices_and_empty_reassembly():
    subs = [np.array([2, 0, 1]), np.array([0, 0, 3])]
    assert skew.piece_slices(subs) == jax_skew.piece_slices(subs) == [(0, 0, 2), (0, 2, 1), (1, 0, 3)]
    out = skew.reassemble_round([np.zeros(0, np.uint8)], [np.array([0, 0])], 16)
    assert out.dtype == np.uint8 and out.size == 0


@pytest.mark.parametrize("rows", [0, 1, 4, 5, 9])
def test_pad_rows_pow2_and_occupancy_match_jax(rows):
    a = np.arange(rows * 2, dtype=np.int32).reshape(rows, 2) + 1
    got = skew.pad_rows_pow2(torch.from_numpy(a))
    np.testing.assert_array_equal(got.numpy(), jax_skew.pad_rows_pow2(a))
    sizes = np.arange(rows + 1)
    assert skew.staging_occupancy(sizes, 8) == jax_skew.staging_occupancy(sizes, 8)


# ----------------------------------------------------------------------
# padding telemetry (utils/stats.py)


def test_record_rows_and_padding_fraction_match_jax():
    ours, theirs = StatsAggregator(), JaxStats()
    for s in (ours, theirs):
        s.record_rows("exchange.lanes", used_rows=6, padded_rows=2)
        s.record_rows("exchange.lanes", used_rows=2, padded_rows=6)
        s.record_counters("ici_n4", supersteps=3, busy_link_slots=5)
    got = ours.summary("exchange.lanes")
    assert (got.used_rows, got.padded_rows, got.padding_fraction) == (8, 8, 0.5)
    assert ours.report() == theirs.report()
    assert "padding=50.0%" in ours.report()
    assert StatsSummary().padding_fraction == 0.0


def test_pipeline_drain_carries_occupancy():
    stats = StatsAggregator()
    pipe = RoundPipeline(1, lambda rnd: rnd, lambda rnd, t: t, name="p", stats=stats, result_rows=lambda r: (10, 6))
    pipe.run(2)
    s = stats.summary("p.drain")
    assert (s.used_rows, s.padded_rows) == (20, 12)
    assert s.padding_fraction == pytest.approx(12 / 32)


# ----------------------------------------------------------------------
# the port's cluster: quota against the single-shot default


def _buf(n):
    return MemoryBlock(np.zeros(n, dtype=np.uint8), size=n)


def _write_skewed(cluster, shuffle_id, M, R, seed=77, device=False):
    """Reduce 0 is hot (big blocks), the rest cold; same seed, same bytes."""
    meta = cluster.create_shuffle(shuffle_id, M, R)
    rng = np.random.default_rng(seed)
    oracle = {}
    for m in range(M):
        t = cluster.transport(meta.map_owner[m])
        w = t.store.map_writer(shuffle_id, m)
        for r in range(R):
            size = int(rng.integers(2000, 3000)) if r == 0 else int(rng.integers(1, 300))
            payload = rng.integers(0, 256, size=size, dtype=np.uint8).tobytes()
            oracle[(m, r)] = payload
            if device:
                rows = np.zeros(-(-size // 128) * 128, dtype=np.uint8)
                rows[:size] = np.frombuffer(payload, dtype=np.uint8)
                w.write_partition_device(r, torch.from_numpy(rows.view(np.int32).reshape(-1, 32)), length=size)
            else:
                w.write_partition(r, payload)
        t.commit_block(w.commit().pack())
    return meta, oracle


def _fetch_all(cluster, meta, shuffle_id, M, R, oracle):
    for r in range(R):
        consumer = meta.owner_of_reduce(r)
        t = cluster.transport(consumer)
        bufs = [_buf(8192) for _ in range(M)]
        reqs = t.fetch_blocks_by_block_ids(consumer, [ShuffleBlockId(shuffle_id, m, r) for m in range(M)], bufs, [None] * M)
        for m in range(M):
            res = reqs[m].wait(5)
            assert res.status == OperationStatus.SUCCESS, str(res.error)
            assert bufs[m].host_view()[: bufs[m].size].tobytes() == oracle[(m, r)]


def _conf(quota, mode="array", **kw):
    return TpuShuffleConf(
        staging_capacity_per_executor=N_EXEC * 4096,
        block_alignment=128,
        num_executors=N_EXEC,
        host_recv_mode=mode,
        slot_quota_rows=quota,
        **kw,
    )


def _exchange(conf, M=3 * N_EXEC, R=8, device=False):
    cluster = TpuShuffleCluster(conf, devices=["cpu"] * N_EXEC)
    meta, oracle = _write_skewed(cluster, 0, M, R, device=device)
    cluster.run_exchange(0)
    return cluster, meta, oracle


def test_quota_array_mode_matches_default_bitwise():
    base_cluster, base_meta, oracle = _exchange(_conf(0))
    q_cluster, q_meta, _ = _exchange(_conf(8))
    assert len(base_meta.recv_sizes) > 1, "should spill multiple rounds"
    assert len(q_meta.recv_sizes) == len(base_meta.recv_sizes)
    for rnd in range(len(base_meta.recv_sizes)):
        np.testing.assert_array_equal(q_meta.recv_sizes[rnd], base_meta.recv_sizes[rnd])
        for j in range(N_EXEC):
            used = int(base_meta.recv_sizes[rnd][j].sum()) * 128
            assert q_meta.recv_shards[rnd][j].nbytes == used  # tight, no padding
            assert bytes(q_meta.recv_shards[rnd][j]) == bytes(base_meta.recv_shards[rnd][j][:used])
    _fetch_all(q_cluster, q_meta, 0, 3 * N_EXEC, 8, oracle)
    drain = q_cluster.stats.summary("exchange.pipeline.drain")
    assert drain.used_rows > 0 and drain.padded_rows > 0


def test_quota_memmap_mode_spills_and_cleans_up(tmp_path):
    cluster, meta, oracle = _exchange(_conf(8, mode="memmap", spill_dir=str(tmp_path)))
    for rnd in meta.recv_shards:
        for shard in rnd:
            assert isinstance(shard, np.memmap) or shard.nbytes == 0
            if isinstance(shard, np.memmap):
                assert not shard.flags.writeable
    spilled = [p for p, _ in meta.recv_spill_paths]
    assert spilled and all(os.path.exists(p) for p in spilled)
    _fetch_all(cluster, meta, 0, 3 * N_EXEC, 8, oracle)
    cluster.remove_shuffle(0)
    assert not any(os.path.exists(p) for p in spilled), "spill leaked"
    assert cluster._recv_spill_bytes == 0


@pytest.mark.parametrize("device_staging", [False, True])
def test_quota_device_mode(device_staging):
    conf = _conf(8, mode="device", keep_device_recv=True, device_staging=device_staging)
    cluster, meta, oracle = _exchange(conf, device=device_staging)
    assert meta.recv_shards is None, "device mode keeps no host copy"
    for shards in meta.recv_device:
        for shard in shards:  # spliced shards carry pow2 rows
            rows = shard.shape[0]
            assert rows & (rows - 1) == 0
    _fetch_all(cluster, meta, 0, 3 * N_EXEC, 8, oracle)


def test_quota_above_slot_matches_default():
    _, base_meta, oracle = _exchange(_conf(0))
    q_cluster, q_meta, _ = _exchange(_conf(1 << 20))
    for rnd in range(len(base_meta.recv_sizes)):
        np.testing.assert_array_equal(q_meta.recv_sizes[rnd], base_meta.recv_sizes[rnd])
    _fetch_all(q_cluster, q_meta, 0, 3 * N_EXEC, 8, oracle)
