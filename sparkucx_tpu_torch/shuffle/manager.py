"""TpuShuffleManager (L7/L6) — the plugin boundary.

Port of ``sparkucx_tpu/shuffle/manager.py``.  Counterpart of
``UcxShuffleManager`` + ``CommonUcxShuffleManager``
(compat/spark_3_0/UcxShuffleManager.scala:25-80, CommonUcxShuffleManager.scala:37-124):
the single object a host engine instantiates to run shuffles, with Spark's
``ShuffleManager`` SPI — ``register_shuffle`` / ``get_writer`` / ``get_reader``
/ ``unregister_shuffle`` / ``stop`` — plus ``run_exchange``, the superstep
boundary UCX's one-by-one pulls have no counterpart for.

Executors run on CUDA unless ``devices`` names others (``["cpu"] * n`` runs
them on the CPU); a missing card raises.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Sequence

from sparkucx_tpu_torch.config import TpuShuffleConf
from sparkucx_tpu_torch.core.transport import ExecutorId
from sparkucx_tpu_torch.memory.pool import MemoryPool
from sparkucx_tpu_torch.shuffle.reader import TpuShuffleReader, default_deserializer
from sparkucx_tpu_torch.shuffle.resolver import TpuShuffleBlockResolver
from sparkucx_tpu_torch.shuffle.writer import TpuShuffleMapOutputWriter
from sparkucx_tpu_torch.transport.tpu import TpuShuffleCluster


class TpuShuffleManager:
    """Single-controller manager: owns the cluster and per-executor components."""

    def __init__(
        self,
        conf: Optional[TpuShuffleConf] = None,
        num_executors: Optional[int] = None,
        devices: Optional[Sequence] = None,
    ) -> None:
        self.conf = conf or TpuShuffleConf()
        self.cluster = TpuShuffleCluster(self.conf, num_executors=num_executors, devices=devices)
        # page-locked bounce buffers when any executor is a CUDA device
        pin = any(d.type == "cuda" for d in self.cluster.devices)
        self.pool = MemoryPool(self.conf, pin=pin)
        self.pool.preallocate_from_conf()
        self.resolvers: List[TpuShuffleBlockResolver] = [
            TpuShuffleBlockResolver(self.conf, t, t.store) for t in self.cluster.transports
        ]
        self._shuffle_dims: Dict[int, tuple] = {}  #: guarded by self._lock
        self._lock = threading.Lock()
        self._stopped = False

    @property
    def num_executors(self) -> int:
        return self.cluster.num_executors

    # -- ShuffleManager SPI -------------------------------------------------

    def register_shuffle(
        self,
        shuffle_id: int,
        num_mappers: int,
        num_reducers: int,
        map_owner: Optional[List[ExecutorId]] = None,
    ) -> None:
        """registerShuffle (dependency bookkeeping only)."""
        meta = self.cluster.create_shuffle(shuffle_id, num_mappers, num_reducers, map_owner)
        with self._lock:
            self._shuffle_dims[shuffle_id] = (num_mappers, num_reducers, meta)

    def get_writer(self, shuffle_id: int, map_id: int) -> TpuShuffleMapOutputWriter:
        """getWriter (compat/spark_3_0/UcxShuffleManager.scala:32-53): the
        staged-store map-output writer of the executor owning this map task;
        its commit also registers the blocks with the resolver."""
        _, num_reducers, meta = self._dims(shuffle_id)
        owner = meta.map_owner[map_id]
        transport = self.cluster.transport(owner)
        writer = TpuShuffleMapOutputWriter(
            transport.store, transport, shuffle_id, map_id, num_reducers
        )
        resolver = self.resolvers[owner]
        orig_commit = writer.commit_all_partitions

        def commit_and_register():
            lengths = orig_commit()
            resolver.on_map_committed(shuffle_id, map_id, num_reducers)
            return lengths

        writer.commit_all_partitions = commit_and_register
        return writer

    def get_reader(
        self,
        shuffle_id: int,
        start_partition: int,
        end_partition: int,
        executor_id: Optional[ExecutorId] = None,
        deserializer: Callable = default_deserializer,
        aggregator=None,
        key_ordering: bool = False,
        merge_combiners=None,
    ) -> TpuShuffleReader:
        """getReader (compat/spark_3_0/UcxShuffleManager.scala:55-60).  The
        reduce range must be owned by one executor; defaults to the owner of
        ``start_partition``."""
        num_mappers, _, meta = self._dims(shuffle_id)
        if executor_id is None:
            executor_id = meta.owner_of_reduce(start_partition)

        def block_sizes(m: int, r: int) -> int:
            info = meta.mapper_infos.get(m)
            return info.partitions[r][1] if info is not None else 0

        return TpuShuffleReader(
            self.cluster.transport(executor_id),
            executor_id,
            shuffle_id,
            start_partition,
            end_partition,
            num_mappers,
            block_sizes,
            max_blocks_per_request=self.conf.max_blocks_per_request,
            pool=self.pool,
            deserializer=deserializer,
            aggregator=aggregator,
            key_ordering=key_ordering,
            fetch_retries=self.conf.fetch_retries,
            memory_budget=self.conf.reduce_memory_budget,
            spill_dir=self.conf.spill_dir,
            merge_combiners=merge_combiners,
        )

    def unregister_shuffle(self, shuffle_id: int) -> None:
        """unregisterShuffle -> resolver.removeShuffle
        (CommonUcxShuffleManager.scala:103-106)."""
        with self._lock:
            self._shuffle_dims.pop(shuffle_id, None)
        for resolver in self.resolvers:
            resolver.remove_shuffle(shuffle_id)
        self.cluster.drop_meta(shuffle_id)

    def stop(self) -> None:
        """stop() closes transports/resolvers (CommonUcxShuffleManager.scala:111-124)."""
        if self._stopped:
            return
        self._stopped = True
        for resolver in self.resolvers:
            resolver.stop()
        for t in self.cluster.transports:
            t.close()
        self.pool.close()

    # -- superstep boundary -------------------------------------------------

    def run_exchange(self, shuffle_id: int) -> None:
        """Run the superstep once all map tasks committed."""
        self.cluster.run_exchange(shuffle_id)

    def exchange_ready(self, shuffle_id: int) -> bool:
        meta = self._dims(shuffle_id)[2]
        return len(meta.mapper_infos) == meta.num_mappers

    # ----------------------------------------------------------------------

    def _dims(self, shuffle_id: int):
        with self._lock:
            dims = self._shuffle_dims.get(shuffle_id)
        if dims is None:
            raise KeyError(f"shuffle {shuffle_id} not registered")
        return dims

    def __enter__(self) -> "TpuShuffleManager":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
