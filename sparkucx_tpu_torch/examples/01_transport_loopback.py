"""The ShuffleTransport trait, end to end, with the in-process backend.

Port of ``examples/01_transport_loopback.py``.  The reference documents its
transport usage flow at ShuffleTransport.scala:95-109: a server-side executor
``register``s blocks, a client calls ``fetch_blocks_by_block_ids`` and drives
completion with explicit ``progress()`` polling.  That contract is preserved
here; the loopback fabric is the unit-test backend the reference never had.
The loopback transport is host code: it moves no byte through ``--device``,
which is checked as the other walkthroughs check it.

Run: python sparkucx_tpu_torch/examples/01_transport_loopback.py [--device cpu|cuda]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np

from sparkucx_tpu_torch.config import TpuShuffleConf
from sparkucx_tpu_torch.core.block import BytesBlock, MemoryBlock, ShuffleBlockId
from sparkucx_tpu_torch.core.operation import OperationStatus
from sparkucx_tpu_torch.transport.loopback import LoopbackFabric, LoopbackTransport
from sparkucx_tpu_torch.utils.devices import resolve_devices


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda", choices=("cpu", "cuda"), help="checked; the transport is host code")
    resolve_devices([parser.parse_args(argv).device], None)  # no card: an error, never the CPU in its place
    conf = TpuShuffleConf()
    fabric = LoopbackFabric()
    server = LoopbackTransport(conf, executor_id=0, fabric=fabric)
    client = LoopbackTransport(conf, executor_id=1, fabric=fabric)
    server_addr = server.init()
    client.init()
    client.add_executor(0, server_addr)  # the ExecutorAdded handshake

    # Server side: register three blocks of a shuffle (what the map-output
    # commit hook does after a map task finishes).
    rng = np.random.default_rng(7)
    payloads = {r: rng.integers(0, 256, size=1000 + r, dtype=np.uint8).tobytes() for r in range(3)}
    for r, data in payloads.items():
        server.register(ShuffleBlockId(shuffle_id=0, map_id=0, reduce_id=r), BytesBlock(data))

    # Client side: one batched fetch for all three blocks into caller-owned
    # receive buffers; requests complete under progress() (fetches are
    # deferred by design — poll, then wait).
    bids = [ShuffleBlockId(0, 0, r) for r in range(3)]
    bufs = [MemoryBlock(np.zeros(4096, dtype=np.uint8), size=4096) for _ in bids]
    reqs = client.fetch_blocks_by_block_ids(0, bids, bufs, [None] * len(bids))
    while not all(r.completed() for r in reqs):
        client.progress()
    for bid, buf, req in zip(bids, bufs, reqs):
        res = req.wait(5)
        assert res.status == OperationStatus.SUCCESS, res.error
        assert buf.host_view()[: buf.size].tobytes() == payloads[bid.reduce_id]
    print("OK: 3 blocks fetched byte-identical through the transport trait")

    # A fetch of an unregistered block is a FAILURE result, not an exception
    # (the contract fetch retry is built on).
    [req] = client.fetch_blocks_by_block_ids(
        0, [ShuffleBlockId(0, 9, 9)], [MemoryBlock(np.zeros(16, dtype=np.uint8), size=16)], [None]
    )
    while not req.completed():
        client.progress()
    assert req.wait(5).status == OperationStatus.FAILURE
    print("OK: missing block surfaces as a FAILURE result")

    client.close()
    server.close()


if __name__ == "__main__":
    main()
