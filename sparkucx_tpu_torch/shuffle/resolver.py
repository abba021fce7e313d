"""Block resolver (L4) — map-side commit hook + local block serving.

Port of ``sparkucx_tpu/shuffle/resolver.py`` without ``degraded_plan`` (the
elastic path, ROADMAP queue A item 6).  Counterpart of ``CommonUcxShuffleBlockResolver`` + the compat
resolvers (CommonUcxShuffleBlockResolver.scala:37-77,
compat/spark_3_0/UcxShuffleBlockResolver.scala:28-97):

* after a map task commits, register its blocks with the transport so the
  peer-serving path can serve them (writeIndexFileAndCommitCommon),
* ``get_block_data``: serve a local block from the staged store
  (``serve_from_store=True``) or from the registered Block — the
  ``spark.dpuTest.enabled`` A/B switch (UcxShuffleBlockResolver.scala:86-97),
* track shuffles for cleanup (``removeShuffle`` -> ``unregisterShuffle``),
* ``ring_neighbors`` / ``widened_ring_neighbors``: the replica placement the
  peer transport's replicator and popularity tier derive from membership.
"""

from __future__ import annotations

import threading
from typing import List, Sequence, Set, Tuple

import numpy as np

from sparkucx_tpu_torch.config import TpuShuffleConf
from sparkucx_tpu_torch.core.block import Block, ShuffleBlockId
from sparkucx_tpu_torch.core.operation import BlockNotFoundError, TransportError
from sparkucx_tpu_torch.core.transport import ShuffleTransport
from sparkucx_tpu_torch.store.hbm_store import HbmBlockStore


def ring_neighbors(executor_id, executors: Sequence, factor: int) -> List:
    """The ``factor`` ring successors of ``executor_id`` in the sorted
    executor ring — where this executor's sealed rounds are replicated
    (``spark.shuffle.tpu.replication.factor``), and therefore where a reducer
    re-resolves a block when its primary dies.  Shared by the replicator
    (transport/peer.py) and the reader's failover path so both sides derive
    the same placement from membership alone, with no placement-metadata
    exchange (the redistribution-plan determinism of arXiv:2112.01075)."""
    ring = sorted(set(executors))
    if executor_id not in ring or len(ring) < 2 or factor <= 0:
        return []
    idx = ring.index(executor_id)
    out = []
    for k in range(1, min(factor, len(ring) - 1) + 1):
        out.append(ring[(idx + k) % len(ring)])
    return out


def widened_ring_neighbors(
    executor_id, executors: Sequence, base_factor: int, hot_factor: int
) -> Tuple[List, List]:
    """Ring placement for a popularity-promoted (hot) block's replica set:
    ``(base, extra)`` where ``base`` is the fault-tolerance floor
    (``ring_neighbors`` at ``replication.factor``) and ``extra`` the
    ADDITIONAL successors a hot promotion widens onto
    (``spark.shuffle.tpu.serve.hotReplicas``, never narrower than the
    floor).  Derived from membership alone — the same determinism contract
    as :func:`ring_neighbors`, so the promoting server, its peers, and any
    reader agree on the widened set without a placement exchange."""
    base = ring_neighbors(executor_id, executors, base_factor)
    widened = ring_neighbors(executor_id, executors, max(hot_factor, base_factor))
    extra = [e for e in widened if e not in base]
    return base, extra


class _StoreBackedBlock(Block):
    """A registered Block serving lazily from the staged store
    (CommonUcxShuffleBlockResolver.scala:37-61 FileBackedMemoryBlock)."""

    def __init__(self, store: HbmBlockStore, shuffle_id: int, map_id: int, reduce_id: int) -> None:
        super().__init__()
        self._store = store
        self._key = (shuffle_id, map_id, reduce_id)

    def get_size(self) -> int:
        return self._store.block_length(*self._key)

    def get_block(self, dest) -> None:
        payload = self._store.read_block(*self._key)
        view = (
            dest.reshape(-1).view(np.uint8)
            if isinstance(dest, np.ndarray)
            else np.frombuffer(dest, dtype=np.uint8)
        )
        view[: len(payload)] = np.frombuffer(payload, dtype=np.uint8)


class TpuShuffleBlockResolver:
    def __init__(
        self,
        conf: TpuShuffleConf,
        transport: ShuffleTransport,
        store: HbmBlockStore,
    ) -> None:
        self.conf = conf
        self.transport = transport
        self.store = store
        self._shuffles: Set[int] = set()  #: guarded by self._lock
        self._lock = threading.Lock()

    def on_map_committed(self, shuffle_id: int, map_id: int, num_reducers: int) -> None:
        """Register each non-empty partition with the transport for peer serving
        (the writeIndexFileAndCommit hook, CommonUcxShuffleBlockResolver.scala:37-61)."""
        with self._lock:
            self._shuffles.add(shuffle_id)
        for r in range(num_reducers):
            if self.store.block_length(shuffle_id, map_id, r) > 0:
                self.transport.register(
                    ShuffleBlockId(shuffle_id, map_id, r),
                    _StoreBackedBlock(self.store, shuffle_id, map_id, r),
                )

    def get_block_data(self, shuffle_id: int, map_id: int, reduce_id: int) -> bytes:
        """Local serving of a block (IndexShuffleBlockResolver.getBlockData
        role).  An unknown shuffle/map raises the typed, addressed
        :class:`BlockNotFoundError`."""
        if self.conf.serve_from_store:
            try:
                return self.store.read_block(shuffle_id, map_id, reduce_id)
            except BlockNotFoundError:
                raise
            except TransportError as e:
                if "unknown shuffle" in str(e):
                    raise BlockNotFoundError(shuffle_id, map_id, reduce_id, str(e)) from e
                raise
        blk = self.transport.registered_block(ShuffleBlockId(shuffle_id, map_id, reduce_id))
        if blk is None:
            raise BlockNotFoundError(shuffle_id, map_id, reduce_id, "not registered")
        return blk.get_memory_block().to_bytes()

    def remove_shuffle(self, shuffle_id: int) -> None:
        """removeShuffle -> unregister all the shuffle's blocks
        (CommonUcxShuffleBlockResolver.scala:63-77)."""
        with self._lock:
            self._shuffles.discard(shuffle_id)
        self.transport.unregister_shuffle(shuffle_id)
        self.store.remove_shuffle(shuffle_id)

    def stop(self) -> None:
        with self._lock:
            doomed = list(self._shuffles)
        for sid in doomed:
            self.remove_shuffle(sid)
