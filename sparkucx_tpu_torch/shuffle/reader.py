"""Reduce-side reader (L5) — windowed fetch, retries, aggregation, ordering.

Port of ``sparkucx_tpu/shuffle/reader.py``, cut to the serial path.
Counterpart of ``UcxShuffleReader`` + ``UcxShuffleClient``
(compat/spark_3_0/UcxShuffleReader.scala:74-199, UcxShuffleClient.scala:17-96):

* batch fetch of this reducer's blocks in request windows of
  ``max_blocks_per_request`` (the client's splitter, UcxShuffleClient.scala:53-58),
* a pull loop that spins ``transport.progress()`` while results are pending
  and charges the wait to ``fetch_wait_ns`` (UcxShuffleReader.scala:110-134),
* a failed batch fetch retries through the per-block pull path
  ``transport.fetch_block``, up to ``fetch_retries`` attempts,
* then deserialize -> aggregate -> sort (UcxShuffleReader.scala:137-199), in
  memory: an aggregator folds values per key in first-seen key order, and
  ``key_ordering`` sorts by key — the order the JAX package's
  ``ExternalCombiner`` yields when nothing spills.

Hedged fetches, circuit breakers, replica failover, credit-pipelined windows
and the spilling combiner are not part of this port yet.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Iterable, Iterator, List, Optional, Tuple

import numpy as np

from sparkucx_tpu_torch.core.block import MemoryBlock, ShuffleBlockId
from sparkucx_tpu_torch.core.operation import OperationStatus, Request, TransportError
from sparkucx_tpu_torch.core.transport import ExecutorId, ShuffleTransport
from sparkucx_tpu_torch.memory.pool import MemoryPool
from sparkucx_tpu_torch.utils.codec import decode_records, encode_records


@dataclass
class ShuffleReadMetrics:
    """UcxShuffleReader.scala:118-123,148-153 reporter fields (+ retry count)."""

    records_read: int = 0
    remote_bytes_read: int = 0
    remote_blocks_fetched: int = 0
    fetch_wait_ns: int = 0
    blocks_retried: int = 0


def default_deserializer(payload) -> Iterable[Any]:
    """Record stream per block: the typed, non-executing codec of utils/codec.py."""
    yield from decode_records(payload)


def serialize_records(records: Iterable[Any]) -> bytes:
    """Writer-side twin of ``default_deserializer``."""
    return encode_records(records)


class TpuShuffleReader:
    """Reads the blocks of reduce partitions [start_partition, end_partition)
    for one reducer — ``ShuffleReader.read()`` (UcxShuffleReader.scala:74)."""

    def __init__(
        self,
        transport: ShuffleTransport,
        executor_id: ExecutorId,
        shuffle_id: int,
        start_partition: int,
        end_partition: int,
        num_mappers: int,
        block_sizes: Callable[[int, int], int],
        max_blocks_per_request: int = 50,
        pool: Optional[MemoryPool] = None,
        deserializer: Callable[[Any], Iterable[Any]] = default_deserializer,
        aggregator: Optional[Callable[[Any, Any], Any]] = None,
        key_ordering: bool = False,
        sender_of: Optional[Callable[[int], ExecutorId]] = None,
        fetch_retries: int = 1,
    ) -> None:
        self.transport = transport
        self.executor_id = executor_id
        self.shuffle_id = shuffle_id
        self.start_partition = start_partition
        self.end_partition = end_partition
        self.num_mappers = num_mappers
        self.block_sizes = block_sizes
        self.max_blocks_per_request = max(1, max_blocks_per_request)
        self.pool = pool
        self.deserializer = deserializer
        self.aggregator = aggregator
        self.key_ordering = key_ordering
        self.sender_of = sender_of or (lambda m: self.executor_id)
        self.fetch_retries = max(0, fetch_retries)
        self.metrics = ShuffleReadMetrics()

    # -- raw block iterator ------------------------------------------------

    def _block_ids(self) -> List[ShuffleBlockId]:
        return [
            ShuffleBlockId(self.shuffle_id, m, r)
            for r in range(self.start_partition, self.end_partition)
            for m in range(self.num_mappers)
            if self.block_sizes(m, r) > 0
        ]

    def _alloc(self, sizes: List[int]) -> List[MemoryBlock]:
        if self.pool is not None:
            return self.pool.get_many(sizes)
        return [MemoryBlock(np.zeros(s, dtype=np.uint8), size=s) for s in sizes]

    def fetch_blocks(self) -> Iterator[Tuple[ShuffleBlockId, bytes]]:
        """Windowed fetch of all non-empty blocks; yields ``(block_id, bytes)``
        as windows complete (UcxShuffleConf.scala:88-93 maxBlocksPerRequest)."""
        bids = self._block_ids()
        for w in range(0, len(bids), self.max_blocks_per_request):
            window = bids[w : w + self.max_blocks_per_request]
            buffers = self._alloc([self.block_sizes(b.map_id, b.reduce_id) for b in window])
            groups: dict = {}
            for bid, buf in zip(window, buffers):
                groups.setdefault(self.sender_of(bid.map_id), []).append((bid, buf))
            requests: List[Tuple[ShuffleBlockId, MemoryBlock, Request]] = []
            for sender, items in groups.items():
                reqs = self.transport.fetch_blocks_by_block_ids(
                    sender, [b for b, _ in items], [buf for _, buf in items], [None] * len(items)
                )
                requests.extend((b, buf, req) for (b, buf), req in zip(items, reqs))
            t0 = time.monotonic_ns()
            while not all(req.completed() for _, _, req in requests):
                self.transport.progress()
            self.metrics.fetch_wait_ns += time.monotonic_ns() - t0
            try:
                for bid, buf, req in requests:
                    result = req.wait(0)
                    if result.status != OperationStatus.SUCCESS:
                        result = self._retry_fetch(bid, buf, result)
                    size = int(result.stats.recv_size)
                    self.metrics.remote_bytes_read += size
                    self.metrics.remote_blocks_fetched += 1
                    yield bid, buf.host_view()[:size].tobytes()
            finally:
                for buf in buffers:
                    buf.close()

    def _retry_fetch(self, bid: ShuffleBlockId, buf: MemoryBlock, failed):
        """Per-block pull-path retry (the per-block AM ids 3/4 analogue), up
        to ``fetch_retries`` attempts against the block's sender."""
        last_error = failed.error
        for _ in range(self.fetch_retries):
            req = self.transport.fetch_block(
                self.sender_of(bid.map_id), bid.shuffle_id, bid.map_id, bid.reduce_id, buf
            )
            t0 = time.monotonic_ns()
            while not req.completed():
                self.transport.progress()
            self.metrics.fetch_wait_ns += time.monotonic_ns() - t0
            result = req.wait(0)
            if result.status == OperationStatus.SUCCESS:
                self.metrics.blocks_retried += 1
                return result
            last_error = result.error
        raise TransportError(
            f"fetch of {bid} failed after {self.fetch_retries} retr"
            f"{'y' if self.fetch_retries == 1 else 'ies'}: {last_error}"
        )

    # -- record pipeline ---------------------------------------------------

    def read(self) -> Iterator[Any]:
        """deserialize -> combine -> sort (UcxShuffleReader.scala:137-199)."""

        def records() -> Iterator[Any]:
            for _, payload in self.fetch_blocks():
                for rec in self.deserializer(payload):
                    self.metrics.records_read += 1
                    yield rec

        if self.aggregator is None and not self.key_ordering:
            return records()
        if self.aggregator is not None:
            combined: dict = {}
            for k, v in records():
                combined[k] = self.aggregator(combined[k], v) if k in combined else v
            pairs = list(combined.items())
        else:
            pairs = list(records())
        if self.key_ordering:
            pairs.sort(key=lambda kv: kv[0])
        return iter(pairs)
