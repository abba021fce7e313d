"""The slice as a whole: one seeded shuffle through the JAX package and through
the port, compared byte for byte.

* ``TpuShuffleCluster``: stage (host or device writes) -> commit ->
  ``run_exchange`` -> ``fetch_blocks_by_block_ids`` and ``fetch_blocks_device``
  on every reducer, n = 1 and 4 executors (the port's executors share the CPU;
  the JAX ones are devices of the virtual CPU mesh);
* ``TpuShuffleManager``: ``get_writer`` -> encoded records -> commit ->
  ``run_exchange`` -> ``get_reader().read()``, plain, aggregated and ordered;
* interop: rounds sealed by the JAX store exchanged and fetched by the port.

Exact comparison throughout (integer data movement)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkucx_tpu.config import TpuShuffleConf as JaxConf
from sparkucx_tpu.core.block import MemoryBlock as JaxMemoryBlock
from sparkucx_tpu.core.block import ShuffleBlockId as JaxBlockId
from sparkucx_tpu.shuffle.manager import TpuShuffleManager as JaxManager
from sparkucx_tpu.store.hbm_store import HbmBlockStore as JaxStore
from sparkucx_tpu.transport.tpu import TpuShuffleCluster as JaxCluster
from sparkucx_tpu.utils.codec import encode_records as jax_encode_records
from sparkucx_tpu_torch import interop
from sparkucx_tpu_torch.config import TpuShuffleConf
from sparkucx_tpu_torch.core.block import MemoryBlock, ShuffleBlockId
from sparkucx_tpu_torch.core.operation import OperationStatus
from sparkucx_tpu_torch.ops.block_kernels import block_gather, plan_tensors
from sparkucx_tpu_torch.ops.exchange import ExchangeSpec, build_exchange
from sparkucx_tpu_torch.shuffle.manager import TpuShuffleManager
from sparkucx_tpu_torch.store.hbm_store import default_peer_ranges
from sparkucx_tpu_torch.transport.tpu import TpuShuffleCluster
from sparkucx_tpu_torch.utils.codec import encode_records

ALIGN = 128
LANE = ALIGN // 4
M, R = 6, 8


def _conf(cls, n, device, cap=1 << 20, mode="array"):
    return cls(
        staging_capacity_per_executor=cap,
        block_alignment=ALIGN,
        num_executors=n,
        device_staging=device,
        keep_device_recv=True,
        host_recv_mode=mode,
        gather_impl="xla",
    )


def _payloads(seed, max_block=1500):
    rng = np.random.default_rng(seed)
    return {
        (m, r): rng.integers(0, 256, size=int(rng.integers(0, max_block)), dtype=np.uint8).tobytes()
        for m in range(M)
        for r in range(R)
    }


def _rows(payload):
    buf = np.zeros(-(-len(payload) // ALIGN) * ALIGN, dtype=np.uint8)
    buf[: len(payload)] = np.frombuffer(payload, dtype=np.uint8)
    return buf.view(np.int32).reshape(-1, LANE)


def _shuffle(cluster, payloads, device, as_rows):
    meta = cluster.create_shuffle(0, M, R)
    for m in range(M):
        t = cluster.transport(meta.map_owner[m])
        w = t.store.map_writer(0, m)
        for r in range(R):
            data = payloads[(m, r)]
            if device:
                w.write_partition_device(r, as_rows(_rows(data)), length=len(data))
            else:
                w.write_partition(r, data)
        t.commit_block(w.commit().pack())
    cluster.run_exchange(0)
    return meta


def _fetch_host(cluster, meta, block_id_cls, buf_cls, r):
    consumer = meta.owner_of_reduce(r)
    t = cluster.transport(consumer)
    bids = [block_id_cls(0, m, r) for m in range(M)]
    bufs = [buf_cls(np.zeros(2048, dtype=np.uint8), size=2048) for _ in range(M)]
    reqs = t.fetch_blocks_by_block_ids(consumer, bids, bufs, [None] * M)
    while not all(q.completed() for q in reqs):
        t.progress()
    out = []
    for q, b in zip(reqs, bufs):
        res = q.wait(1)
        assert res.status.value == "SUCCESS", str(res.error)
        out.append(b.host_view()[: b.size].tobytes())
    return out


CASES = [
    # (executors, device writes, staging capacity, host_recv_mode of the port)
    (1, False, 1 << 20, "array"),
    (1, True, 1 << 20, "device"),
    (4, False, 1 << 20, "array"),
    (4, True, 1 << 20, "array"),
    (4, True, 8 << 10, "device"),  # rollover: several staging rounds
]


@pytest.mark.parametrize("n,device,cap,mode", CASES)
def test_cluster_fetches_match_jax(n, device, cap, mode):
    payloads = _payloads(seed=10 * n + device)
    theirs = JaxCluster(_conf(JaxConf, n, device, cap), num_executors=n)
    ours = TpuShuffleCluster(_conf(TpuShuffleConf, n, device, cap, mode), devices=["cpu"] * n)
    jmeta = _shuffle(theirs, payloads, device, jnp.asarray)
    tmeta = _shuffle(ours, payloads, device, torch.from_numpy)
    assert len(tmeta.recv_sizes) == len(jmeta.recv_sizes)
    for ts, js in zip(tmeta.recv_sizes, jmeta.recv_sizes):
        assert np.array_equal(ts, js)
    for r in range(R):
        got = _fetch_host(ours, tmeta, ShuffleBlockId, MemoryBlock, r)
        assert got == _fetch_host(theirs, jmeta, JaxBlockId, JaxMemoryBlock, r)
        assert got == [payloads[(m, r)] for m in range(M)]
    for consumer in range(n):
        lo, hi = tmeta.peer_ranges[consumer]
        keys = [(m, r) for r in range(lo, hi) for m in range(M)]
        tpacked, tentries = ours.transport(consumer).fetch_blocks_device(
            [ShuffleBlockId(0, m, r) for m, r in keys]
        )
        jpacked, jentries = theirs.transport(consumer).fetch_blocks_device(
            [JaxBlockId(0, m, r) for m, r in keys]
        )
        assert isinstance(tpacked, torch.Tensor)
        assert np.array_equal(tpacked.numpy(), np.asarray(jpacked))
        assert np.array_equal(tentries, jentries)


def test_cluster_pull_fallback_reads_the_store():
    payloads = _payloads(seed=3)
    ours = TpuShuffleCluster(_conf(TpuShuffleConf, 2, False), devices=["cpu", "cpu"])
    _shuffle(ours, payloads, False, None)
    buf = MemoryBlock(np.zeros(2048, dtype=np.uint8), size=2048)
    req = ours.transport(1).fetch_block(0, 0, 2, 5, buf)
    while not req.completed():
        ours.transport(1).progress()
    assert req.wait(1).status == OperationStatus.SUCCESS
    assert buf.host_view()[: buf.size].tobytes() == payloads[(2, 5)]


def _records(seed, n_records=200):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 40, size=n_records)
    vals = rng.integers(-1000, 1000, size=n_records)
    return [(int(k), int(v)) for k, v in zip(keys, vals)]


def _manager_shuffle(manager, records, encode):
    n_maps = 3
    manager.register_shuffle(0, n_maps, R)
    for m in range(n_maps):
        mine = records[m::n_maps]
        writer = manager.get_writer(0, m)
        for r in range(R):
            part = [kv for kv in mine if kv[0] % R == r]
            stream = writer.get_partition_writer(r).open_stream()
            if part:
                stream.write(encode(part))
            stream.close()
        writer.commit_all_partitions()
    manager.run_exchange(0)


@pytest.mark.parametrize("n", [1, 4])
@pytest.mark.parametrize("combine", ["plain", "sum_ordered", "ordered"])
def test_manager_read_matches_jax(n, combine):
    records = _records(seed=n)
    kwargs = {
        "plain": {},
        "sum_ordered": {"aggregator": lambda a, b: a + b, "key_ordering": True},
        "ordered": {"key_ordering": True},
    }[combine]
    theirs = JaxManager(_conf(JaxConf, n, False), num_executors=n)
    ours = TpuShuffleManager(_conf(TpuShuffleConf, n, False), devices=["cpu"] * n)
    try:
        _manager_shuffle(theirs, records, jax_encode_records)
        _manager_shuffle(ours, records, encode_records)
        for r in range(R):
            got = list(ours.get_reader(0, r, r + 1, **kwargs).read())
            assert got == list(theirs.get_reader(0, r, r + 1, **kwargs).read())
            if combine == "plain":
                assert sorted(got) == sorted(kv for kv in records if kv[0] % R == r)
    finally:
        ours.stop()
        theirs.stop()


def test_interop_exchanges_rounds_sealed_by_jax():
    """Two JAX stores stage and seal; the port imports their rounds, runs its
    exchange on them and gathers every block by the JAX commit blobs."""
    n = 2
    payloads = _payloads(seed=77)
    ranges = default_peer_ranges(R, n)
    conf = JaxConf(staging_capacity_per_executor=1 << 16, block_alignment=ALIGN)
    stores = [JaxStore(conf, executor_id=e) for e in range(n)]
    blobs = {}
    for s in stores:
        s.create_shuffle(0, M, R, peer_ranges=ranges)
    for m in range(M):
        w = stores[m % n].map_writer(0, m)
        for r in range(R):
            w.write_partition(r, payloads[(m, r)])
        blobs[m] = w.commit().pack()
    imported = [
        interop.import_sealed_round(np.asarray(p), sz, "cpu")
        for p, sz in (s.seal(0)[0] for s in stores)
    ]
    send_rows = imported[0][0].shape[0]
    fn = build_exchange(["cpu"] * n, ExchangeSpec(n, send_rows, send_rows, lane=LANE))
    recv, recv_sizes = fn(torch.cat([p for p, _ in imported]), np.stack([s for _, s in imported]))
    region = conf.staging_capacity_per_executor // n
    for r in range(R):
        j = next(e for e, (lo, hi) in enumerate(ranges) if lo <= r < hi)
        shard = recv[j * send_rows : (j + 1) * send_rows]
        starts, counts = [], []
        for m in range(M):
            info = interop.mapper_info_from_blob(blobs[m])
            off, ln = info.partitions[r]
            chunk = int(recv_sizes[j, : m % n].sum())
            starts.append(chunk + (off - j * region) // ALIGN)
            counts.append(-(-ln // ALIGN))
        outs = np.cumsum(counts) - counts
        packed = block_gather(*plan_tensors(starts, counts, outs, "cpu"), shard, int(sum(counts)))
        flat = packed.numpy().reshape(-1).view(np.uint8)
        for m in range(M):
            data = payloads[(m, r)]
            lo = int(outs[m]) * ALIGN
            assert flat[lo : lo + len(data)].tobytes() == data


def test_interop_conf_matches_jax_parsing():
    spark = {
        "spark.shuffle.tpu.stagingCapacity": "8m",
        "spark.shuffle.tpu.blockAlignment": "256",
        "spark.shuffle.tpu.deviceStaging": "true",
        "spark.shuffle.tpu.hostRecvMode": "device",
        "spark.shuffle.tpu.keepDeviceRecv": "true",
    }
    ours = dataclasses.asdict(interop.conf_from_spark(spark))
    theirs = dataclasses.asdict(JaxConf.from_spark_conf(spark))
    assert ours == theirs
    assert ours["block_alignment"] == 256
