"""The transport trait — the framework's central abstraction.

Port of ``sparkucx_tpu/core/transport.py`` (a verbatim copy).

Counterpart of the ``ShuffleTransport`` trait (ShuffleTransport.scala:110-167) plus the
fork's DPU extensions ``initExecuter``/``commitBlock``/``fetchBlock``
(UcxShuffleTransport.scala:281-298).  Usage flow (ShuffleTransport.scala:95-109):

1. ``init()`` on each executor; exchange ``executor_id -> address`` via the control
   plane (parallel/bootstrap.py) and ``add_executor`` peers.
2. Map side ``register``\\ s produced blocks (or writes them through the staged
   store + ``commit_block``).
3. Reduce side calls ``fetch_blocks_by_block_ids`` and drives ``progress()``
   until the requests complete.
4. ``unregister_shuffle``/``close`` tear down.

The trait is deliberately implementation-neutral so that a loopback transport can
back unit tests (the reference documents exactly this intent on ``addExecutor``,
ShuffleTransport.scala:124-128) while the real implementation lowers batched fetches
to a block gather over the executors' device memory (transport/tpu.py).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Dict, List, Optional, Sequence

from sparkucx_tpu_torch.core.block import Block, BlockId, MemoryBlock
from sparkucx_tpu_torch.core.operation import OperationCallback, Request

ExecutorId = int


class ShuffleTransport(ABC):
    """ShuffleTransport.scala:110-167."""

    # -- lifecycle ---------------------------------------------------------

    @abstractmethod
    def init(self) -> bytes:
        """Initialize the transport; returns the serialized local address blob
        other executors use to connect (ShuffleTransport.scala:113-117)."""

    @abstractmethod
    def close(self) -> None:
        ...

    # -- membership --------------------------------------------------------

    @abstractmethod
    def add_executor(self, executor_id: ExecutorId, address: bytes) -> None:
        """Register a peer executor's address (ShuffleTransport.scala:124-131)."""

    def add_executors(self, executors: Dict[ExecutorId, bytes]) -> None:
        for eid, addr in executors.items():
            self.add_executor(eid, addr)

    @abstractmethod
    def remove_executor(self, executor_id: ExecutorId) -> None:
        ...

    def pre_connect(self) -> None:
        """Eagerly establish connections to all known peers
        (UcxWorkerWrapper.preconnect semantics via UcxExecutorRpcEndpoint.scala:19-39)."""

    # -- server side (map output) -----------------------------------------

    @abstractmethod
    def register(self, block_id: BlockId, block: Block) -> None:
        """Publish a block for serving (ShuffleTransport.scala:133-138)."""

    @abstractmethod
    def mutate(self, block_id: BlockId, block: Block, callback: Optional[OperationCallback]) -> None:
        """Replace a registered block under its lock (ShuffleTransport.scala:140-146)."""

    @abstractmethod
    def unregister(self, block_id: BlockId) -> None:
        ...

    @abstractmethod
    def unregister_shuffle(self, shuffle_id: int) -> None:
        """Bulk-remove a shuffle's blocks (UcxShuffleTransport.scala:249-259)."""

    # -- client side (reduce fetch) ---------------------------------------

    @abstractmethod
    def fetch_blocks_by_block_ids(
        self,
        executor_id: ExecutorId,
        block_ids: Sequence[BlockId],
        result_buffers: Sequence[MemoryBlock],
        callbacks: Sequence[Optional[OperationCallback]],
    ) -> List[Request]:
        """Batch fetch of remote blocks into caller-provided buffers
        (ShuffleTransport.scala:148-156)."""

    @abstractmethod
    def progress(self) -> None:
        """Advance outstanding operations; requests complete only under progress
        (ShuffleTransport.scala:158-165).  For the device transport this polls
        outstanding work instead of a UCX worker."""

    # -- fork extensions (staged-store path) -------------------------------

    def init_executor(self, num_mappers: int, num_reducers: int) -> None:
        """Executor<->store handshake (UcxShuffleTransport.scala:281-284).

        In the reference this ships the NVKV context to the DPU daemon
        (InitExecutorReq/Ack); here it sizes/creates the HBM staged store."""
        raise NotImplementedError

    def commit_block(self, mapper_info_blob: bytes, callback: Optional[OperationCallback] = None) -> None:
        """Commit map-output metadata (UcxShuffleTransport.scala:286-291)."""
        raise NotImplementedError

    def fetch_block(
        self,
        executor_id: ExecutorId,
        shuffle_id: int,
        map_id: int,
        reduce_id: int,
        result_buffer: MemoryBlock,
        callback: Optional[OperationCallback] = None,
    ) -> Request:
        """Fetch a single staged block (UcxShuffleTransport.scala:293-298)."""
        raise NotImplementedError
