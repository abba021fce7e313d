"""``run_exchange`` of the port against the JAX ``TpuShuffleCluster`` on the
8-device CPU mesh: chunked plans (``slot_quota_rows > 0``) and single-shot
ones, at pipeline depths 1 and 2, in the ``array``, ``memmap`` and ``device``
receive modes, under ``exchange.impl`` stock (and pallas for the chunked
plans), over seeded skewed writes (one hot reducer).  The received
bytes (the valid prefix of every receiver's shard, host or device) and every
``recv_sizes`` matrix must be equal; then every fetched block equals the
written one.  Also the memmap disk cap and the device mode's conditions."""

import os

import numpy as np
import pytest

from sparkucx_tpu.config import TpuShuffleConf as JaxConf
from sparkucx_tpu.transport.tpu import TpuShuffleCluster as JaxCluster
from sparkucx_tpu_torch.config import TpuShuffleConf
from sparkucx_tpu_torch.core.block import MemoryBlock, ShuffleBlockId
from sparkucx_tpu_torch.core.operation import OperationStatus, TransportError
from sparkucx_tpu_torch.transport.tpu import TpuShuffleCluster

N_EXEC = 4
ALIGN = 128
M, R = 3 * N_EXEC, 8


def _payloads(seed):
    """Reduce 0 is hot (2-3 KB blocks), the rest cold (1-300 B)."""
    rng = np.random.default_rng(seed)
    out = {}
    for m in range(M):
        for r in range(R):
            size = int(rng.integers(2000, 3000)) if r == 0 else int(rng.integers(1, 300))
            out[(m, r)] = rng.integers(0, 256, size=size, dtype=np.uint8).tobytes()
    return out


def _kw(quota, depth, mode, spill_dir, impl="stock"):
    return dict(
        exchange_impl=impl,
        staging_capacity_per_executor=N_EXEC * 4096,  # spills: several staging rounds
        block_alignment=ALIGN,
        num_executors=N_EXEC,
        host_recv_mode=mode,
        keep_device_recv=(mode == "device"),
        slot_quota_rows=quota,
        pipeline_depth=depth,
        spill_dir=spill_dir,
    )


def _shuffle(cluster, payloads):
    meta = cluster.create_shuffle(0, M, R)
    for m in range(M):
        t = cluster.transport(meta.map_owner[m])
        w = t.store.map_writer(0, m)
        for r in range(R):
            w.write_partition(r, payloads[(m, r)])
        t.commit_block(w.commit().pack())
    cluster.run_exchange(0)
    return meta


def _fetch_all(cluster, meta, payloads):
    for r in range(R):
        consumer = meta.owner_of_reduce(r)
        t = cluster.transport(consumer)
        bufs = [MemoryBlock(np.zeros(8192, dtype=np.uint8), size=8192) for _ in range(M)]
        reqs = t.fetch_blocks_by_block_ids(consumer, [ShuffleBlockId(0, m, r) for m in range(M)], bufs, [None] * M)
        for m in range(M):
            res = reqs[m].wait(5)
            assert res.status == OperationStatus.SUCCESS, str(res.error)
            assert bufs[m].host_view()[: bufs[m].size].tobytes() == payloads[(m, r)]


_CASES = [(quota, depth, mode, "stock") for quota in (8, 0) for depth in (1, 2) for mode in ("array", "memmap", "device")]
_CASES += [(8, depth, mode, "pallas") for depth in (1, 2) for mode in ("array", "memmap", "device")]


@pytest.mark.parametrize("quota,depth,mode,impl", _CASES)
def test_run_exchange_matches_jax(quota, depth, mode, impl, tmp_path):
    payloads = _payloads(seed=quota + depth)
    theirs = JaxCluster(JaxConf(**_kw(quota, depth, mode, str(tmp_path / "jax"), impl)), num_executors=N_EXEC)
    ours = TpuShuffleCluster(TpuShuffleConf(**_kw(quota, depth, mode, str(tmp_path / "torch"), impl)),
                             devices=["cpu"] * N_EXEC)
    jmeta = _shuffle(theirs, payloads)
    tmeta = _shuffle(ours, payloads)
    assert len(tmeta.recv_sizes) == len(jmeta.recv_sizes) > 1
    for rnd, (ts, js) in enumerate(zip(tmeta.recv_sizes, jmeta.recv_sizes)):
        assert np.array_equal(ts, js)
        for j in range(N_EXEC):
            used = int(js[j].sum()) * ALIGN
            if mode == "device":
                assert tmeta.recv_shards is None and jmeta.recv_shards is None
                got = tmeta.recv_device[rnd][j].numpy().reshape(-1).view(np.uint8)[:used]
                want = np.asarray(jmeta.recv_device[rnd][j]).reshape(-1).view(np.uint8)[:used]
            else:
                got, want = tmeta.recv_shards[rnd][j][:used], jmeta.recv_shards[rnd][j][:used]
                if mode == "memmap":
                    assert isinstance(tmeta.recv_shards[rnd][j], np.memmap) or tmeta.recv_shards[rnd][j].nbytes == 0
            assert bytes(got) == bytes(want), f"round {rnd}, receiver {j}"
    if quota:  # chunked plans keep tight shards
        for rnd, ts in enumerate(tmeta.recv_sizes):
            for j in range(N_EXEC):
                if mode != "device":
                    assert tmeta.recv_shards[rnd][j].nbytes == int(ts[j].sum()) * ALIGN
    _fetch_all(ours, tmeta, payloads)
    ours.remove_shuffle(0)
    theirs.remove_shuffle(0)
    assert ours._recv_spill_bytes == 0


@pytest.mark.parametrize("impl", ["stock", "pallas"])
def test_single_shot_receive_sized_by_its_fullest_receiver(impl):
    """A single-shot round's device shards hold the rows its fullest
    receiver got, not the worst case of every region full."""
    payloads = _payloads(seed=9)
    cluster = TpuShuffleCluster(TpuShuffleConf(**_kw(0, 1, "device", None, impl)), devices=["cpu"] * N_EXEC)
    meta = _shuffle(cluster, payloads)
    staged = cluster.conf.staging_capacity_per_executor // ALIGN
    for rnd, sizes in enumerate(meta.recv_sizes):
        fullest = int(sizes.sum(axis=1).max())
        assert 0 < fullest < staged
        assert all(int(shard.shape[0]) == fullest for shard in meta.recv_device[rnd]), f"round {rnd}"
    _fetch_all(cluster, meta, payloads)


def test_memmap_spill_charged_against_cap(tmp_path):
    conf = TpuShuffleConf(
        staging_capacity_per_executor=1 << 18, block_alignment=ALIGN, num_executors=N_EXEC,
        host_recv_mode="memmap", spill_dir=str(tmp_path), spill_disk_cap_bytes=4096,
    )
    cluster = TpuShuffleCluster(conf, devices=["cpu"] * N_EXEC)
    with pytest.raises(TransportError, match="spill_disk_cap_bytes"):
        _shuffle(cluster, _payloads(seed=5))
    assert not os.listdir(tmp_path), "a refused spill left a file"


def test_memmap_cap_released_on_remove(tmp_path):
    conf = TpuShuffleConf(
        staging_capacity_per_executor=1 << 18, block_alignment=ALIGN, num_executors=N_EXEC,
        host_recv_mode="memmap", spill_dir=str(tmp_path), spill_disk_cap_bytes=1 << 20,
    )
    cluster = TpuShuffleCluster(conf, devices=["cpu"] * N_EXEC)
    for seed in range(3):  # three sequential shuffles reuse the budget
        payloads = _payloads(seed)
        meta = _shuffle(cluster, payloads)
        on_disk = sum(os.path.getsize(p) for p, _ in meta.recv_spill_paths)
        assert cluster._recv_spill_bytes == on_disk > 0
        _fetch_all(cluster, meta, payloads)
        cluster.remove_shuffle(0)
        assert cluster._recv_spill_bytes == 0 and not os.listdir(tmp_path)


def test_device_mode_requires_keep_device_recv():
    conf = TpuShuffleConf(staging_capacity_per_executor=1 << 18, num_executors=N_EXEC, host_recv_mode="device")
    cluster = TpuShuffleCluster(conf, devices=["cpu"] * N_EXEC)
    with pytest.raises(TransportError, match="keep_device_recv"):
        _shuffle(cluster, _payloads(seed=1))


def test_unknown_mode_rejected():
    conf = TpuShuffleConf(staging_capacity_per_executor=1 << 18, num_executors=N_EXEC, host_recv_mode="ram")
    cluster = TpuShuffleCluster(conf, devices=["cpu"] * N_EXEC)
    with pytest.raises(ValueError, match="host_recv_mode"):
        _shuffle(cluster, _payloads(seed=1))
