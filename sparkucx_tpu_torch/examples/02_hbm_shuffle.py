"""The device data plane: stage map output on the device, exchange, fetch.

Port of ``examples/02_hbm_shuffle.py``.  The reference's full write -> serve
cycle is: map tasks write partitions through NVKV to DPU NVMe, commit a
MapperInfo offset table, and reducers fetch blocks back over UCX active
messages.  Here the store is device memory, the commit is the same
offset-table idea, and ALL reducers' fetches are satisfied by ONE superstep
over the executors (two executors sharing the device; the exchange gathers
each receiver's blocks with K1) — after which every fetch is a local read.
The device-side fetch packs many blocks into one device buffer with K1.

Run: python sparkucx_tpu_torch/examples/02_hbm_shuffle.py [--device cpu|cuda]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np

from sparkucx_tpu_torch.config import TpuShuffleConf
from sparkucx_tpu_torch.core.block import MemoryBlock, ShuffleBlockId
from sparkucx_tpu_torch.core.operation import OperationStatus
from sparkucx_tpu_torch.transport.tpu import TpuShuffleCluster


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda", choices=("cpu", "cuda"), help="where the executors run")
    args = parser.parse_args(argv)
    n = 2
    conf = TpuShuffleConf(
        staging_capacity_per_executor=1 << 20,
        num_executors=n,
        keep_device_recv=True,  # keep received bytes on the device for the device-side fetch
    )
    cluster = TpuShuffleCluster(conf, devices=[args.device] * n)
    M, R = 4, 6  # 4 map tasks x 6 reduce partitions
    meta = cluster.create_shuffle(0, M, R)

    # Map side: each map task writes its R partition payloads through a
    # sequential-partition writer, then commits (the MapperInfo analogue).
    rng = np.random.default_rng(11)
    oracle = {}
    for m in range(M):
        t = cluster.transport(meta.map_owner[m])
        w = t.store.map_writer(0, m)
        for r in range(R):
            payload = rng.integers(0, 256, size=int(rng.integers(100, 3000)), dtype=np.uint8).tobytes()
            oracle[(m, r)] = payload
            w.write_partition(r, payload)
        t.commit_block(w.commit().pack())

    # The superstep: one exchange moves every block to its reducer's owner.
    cluster.run_exchange(0)
    print("OK: exchange complete (one superstep)")

    # Reduce side, host path: batched fetch into caller buffers — now a local
    # read on the owning executor.
    for eid in range(n):
        t = cluster.transport(eid)
        lo, hi = cluster.meta(0).peer_ranges[eid]
        for r in range(lo, hi):
            for m in range(M):
                buf = MemoryBlock(np.zeros(4096, dtype=np.uint8), size=4096)
                [req] = t.fetch_blocks_by_block_ids(0, [ShuffleBlockId(0, m, r)], [buf], [None])
                res = req.wait(30)
                assert res.status == OperationStatus.SUCCESS, str(res.error)
                assert buf.host_view()[: buf.size].tobytes() == oracle[(m, r)]
    print(f"OK: all {M * R} blocks fetched byte-identical on their owners")

    # Reduce side, device path: pack many blocks into ONE device buffer
    # without the bytes visiting the host (K1 on the card, its plain version
    # on the CPU).
    t = cluster.transport(0)
    lo, _ = cluster.meta(0).peer_ranges[0]
    bids = [ShuffleBlockId(0, m, lo) for m in range(M)]
    packed, entries = t.fetch_blocks_device(bids)
    packed_bytes = packed.cpu().numpy().reshape(-1).view(np.uint8)
    for (row_start, length), bid in zip(entries, bids):
        start = int(row_start) * cluster.row_bytes
        assert packed_bytes[start : start + int(length)].tobytes() == oracle[(bid.map_id, bid.reduce_id)]
    print(f"OK: device-side batch fetch packed the blocks on {packed.device}")

    cluster.remove_shuffle(0)


if __name__ == "__main__":
    main()
