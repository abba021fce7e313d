"""In-process loopback transport (L3a) — the testing backend.

Port of ``sparkucx_tpu/transport/loopback.py`` (host code, copied: the port
imports nothing of the JAX package).  It holds no device state.

The reference's ``ShuffleTransport`` trait was explicitly designed to admit a
standalone/test implementation (ShuffleTransport.scala:124-128) but the repo never
shipped one (SURVEY.md section 4: no unit tests).  This loopback transport is that
missing piece: a fully in-process implementation of the trait, including the fork's
staged-store extensions, so every layer above L3 is unit-testable without TPU
hardware or sockets.

Fidelity notes:

* Block registry is a concurrent dict keyed by BlockId — the reference's ``TrieMap``
  registry (UcxShuffleTransport.scala:88, register/unregister/unregisterShuffle
  :229-269).
* Fetches are *deferred*: they complete only under ``progress()``, reproducing the
  reference's explicit-poll contract (ShuffleTransport.scala:158-165) so tests
  exercise the same spin loops the real reader uses
  (UcxShuffleReader.scala:116-134).
* Executor addressing: peers are other ``LoopbackTransport`` instances registered in
  a shared in-process "fabric" dict, standing in for the socket-address endpoint
  cache (UcxWorkerWrapper.scala:64,233-276).
* Staged-store extensions (init_executor/commit_block/fetch_block) are backed by a
  plain in-memory store keyed by (shuffle, map, reduce) with a MapperInfo-driven
  offset table — the NvkvHandler offset-table semantics (NvkvHandler.scala:258-265)
  without a device.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from sparkucx_tpu_torch.config import TpuShuffleConf
from sparkucx_tpu_torch.core.block import Block, BlockId, MemoryBlock, ShuffleBlockId
from sparkucx_tpu_torch.core.operation import (
    OperationCallback,
    OperationResult,
    OperationStats,
    OperationStatus,
    Request,
    TransportError,
)
from sparkucx_tpu_torch.core.transport import ExecutorId, ShuffleTransport


class LoopbackFabric:
    """Shared address space connecting LoopbackTransports (the test 'wire')."""

    def __init__(self) -> None:
        self._members: Dict[ExecutorId, "LoopbackTransport"] = {}
        self._lock = threading.Lock()

    def attach(self, executor_id: ExecutorId, transport: "LoopbackTransport") -> bytes:
        with self._lock:
            self._members[executor_id] = transport
        return f"loopback:{executor_id}".encode()

    def detach(self, executor_id: ExecutorId) -> None:
        with self._lock:
            self._members.pop(executor_id, None)

    def resolve(self, executor_id: ExecutorId) -> "LoopbackTransport":
        with self._lock:
            t = self._members.get(executor_id)
        if t is None:
            raise TransportError(f"no executor {executor_id} on fabric")
        return t


class LoopbackTransport(ShuffleTransport):
    """See module docstring."""

    def __init__(
        self,
        conf: Optional[TpuShuffleConf] = None,
        executor_id: ExecutorId = 0,
        fabric: Optional[LoopbackFabric] = None,
    ) -> None:
        self.conf = conf or TpuShuffleConf()
        self.executor_id = executor_id
        self.fabric = fabric or LoopbackFabric()
        self._registry: Dict[BlockId, Block] = {}
        self._registry_lock = threading.Lock()
        self._peers: Dict[ExecutorId, bytes] = {}
        # (op, request) so close() can cancel what it drops instead of orphaning
        # callers spinning in Request.wait().
        self._pending: Deque[Tuple[Callable[[], None], Request]] = deque()
        self._pending_lock = threading.Lock()
        self._initialized = False
        # staged-store state (NVKV analogue)
        self._store: Dict[Tuple[int, int, int], bytes] = {}
        self._store_lock = threading.Lock()
        self.progress_count = 0

    # -- lifecycle ---------------------------------------------------------

    def init(self) -> bytes:
        addr = self.fabric.attach(self.executor_id, self)
        self._initialized = True
        return addr

    def close(self) -> None:
        self.fabric.detach(self.executor_id)
        with self._pending_lock:
            doomed = list(self._pending)
            self._pending.clear()
        for _, req in doomed:
            req.cancel()
        self._initialized = False

    # -- membership --------------------------------------------------------

    def add_executor(self, executor_id: ExecutorId, address: bytes) -> None:
        self._peers[executor_id] = address

    def remove_executor(self, executor_id: ExecutorId) -> None:
        self._peers.pop(executor_id, None)

    # -- server side -------------------------------------------------------

    def register(self, block_id: BlockId, block: Block) -> None:
        with self._registry_lock:
            self._registry[block_id] = block

    def mutate(self, block_id: BlockId, block: Block, callback: Optional[OperationCallback]) -> None:
        with self._registry_lock:
            old = self._registry.get(block_id)
            if old is not None:
                with old.lock:
                    self._registry[block_id] = block
            else:
                self._registry[block_id] = block
        if callback is not None:
            callback(OperationResult(OperationStatus.SUCCESS))

    def unregister(self, block_id: BlockId) -> None:
        with self._registry_lock:
            self._registry.pop(block_id, None)

    def unregister_shuffle(self, shuffle_id: int) -> None:
        with self._registry_lock:
            doomed = [
                b
                for b in self._registry
                if isinstance(b, ShuffleBlockId) and b.shuffle_id == shuffle_id
            ]
            for b in doomed:
                del self._registry[b]
        with self._store_lock:
            for k in [k for k in self._store if k[0] == shuffle_id]:
                del self._store[k]

    def staged_payload(self, shuffle_id: int, map_id: int, reduce_id: int):
        """Peer-visible read of one staged block (the loopback analogue of a
        served FetchBlockReq); returns None when the block is absent."""
        with self._store_lock:
            return self._store.get((shuffle_id, map_id, reduce_id))

    def registered_block(self, block_id: BlockId) -> Optional[Block]:
        with self._registry_lock:
            return self._registry.get(block_id)

    # -- client side -------------------------------------------------------

    def fetch_blocks_by_block_ids(
        self,
        executor_id: ExecutorId,
        block_ids: Sequence[BlockId],
        result_buffers: Sequence[MemoryBlock],
        callbacks: Sequence[Optional[OperationCallback]],
    ) -> List[Request]:
        if len(block_ids) != len(result_buffers) or len(block_ids) != len(callbacks):
            raise ValueError("block_ids / result_buffers / callbacks length mismatch")
        requests: List[Request] = []
        for bid, buf, cb in zip(block_ids, result_buffers, callbacks):
            req = Request(OperationStats())
            requests.append(req)
            self._enqueue(lambda b=bid, o=buf, c=cb, r=req, e=executor_id: self._serve(e, b, o, c, r), req)
        return requests

    def _serve(
        self,
        executor_id: ExecutorId,
        block_id: BlockId,
        out: MemoryBlock,
        callback: Optional[OperationCallback],
        req: Request,
    ) -> None:
        try:
            peer = self.fabric.resolve(executor_id)
            block = peer.registered_block(block_id)
            if block is None:
                raise TransportError(f"block {block_id} not registered on executor {executor_id}")
            with block.lock:  # size + copy under one lock: mutate() can swap the payload
                nbytes = block.get_size()
                if nbytes > out.host_view().size:
                    raise TransportError(
                        f"block {block_id} ({nbytes} B) exceeds result buffer ({out.host_view().size} B)"
                    )
                block.get_block(out.host_view())
            out.size = nbytes  # shrink to received length (peer/tpu contract)
            req.stats.mark_done(recv_size=nbytes)
            result = OperationResult(OperationStatus.SUCCESS, stats=req.stats, data=out)
        except Exception as e:  # any serve failure must complete the request
            req.stats.mark_done()
            err = e if isinstance(e, TransportError) else TransportError(str(e))
            result = OperationResult(OperationStatus.FAILURE, error=err, stats=req.stats)
        req.complete(result)
        if callback is not None:
            callback(result)

    def progress(self) -> None:
        """Drain one pending op per call — fetches never complete without progress
        (the trait's contract, ShuffleTransport.scala:158-165)."""
        self.progress_count += 1
        with self._pending_lock:
            entry = self._pending.popleft() if self._pending else None
        if entry is not None:
            entry[0]()

    def _enqueue(self, op: Callable[[], None], req: Request) -> None:
        with self._pending_lock:
            self._pending.append((op, req))

    # -- staged-store extensions ------------------------------------------

    def init_executor(self, num_mappers: int, num_reducers: int) -> None:
        self.num_mappers = num_mappers
        self.num_reducers = num_reducers

    def store_write(self, shuffle_id: int, map_id: int, reduce_id: int, payload: bytes) -> None:
        """Direct write into the in-memory staged store (test convenience)."""
        with self._store_lock:
            self._store[(shuffle_id, map_id, reduce_id)] = bytes(payload)

    def commit_block(self, mapper_info_blob: bytes, callback: Optional[OperationCallback] = None) -> None:
        from sparkucx_tpu_torch.core.definitions import MapperInfo

        MapperInfo.unpack(mapper_info_blob)  # validate the wire format
        if callback is not None:
            callback(OperationResult(OperationStatus.SUCCESS))

    def fetch_block(
        self,
        executor_id: ExecutorId,
        shuffle_id: int,
        map_id: int,
        reduce_id: int,
        result_buffer: MemoryBlock,
        callback: Optional[OperationCallback] = None,
    ) -> Request:
        req = Request(OperationStats())

        def serve() -> None:
            try:
                peer = self.fabric.resolve(executor_id)
                payload = peer.staged_payload(shuffle_id, map_id, reduce_id)
                if payload is None:
                    raise TransportError(
                        f"no staged block ({shuffle_id},{map_id},{reduce_id}) on executor {executor_id}"
                    )
                view = result_buffer.host_view()
                if len(payload) > view.size:
                    raise TransportError(
                        f"staged block ({len(payload)} B) exceeds result buffer ({view.size} B)"
                    )
                view[: len(payload)] = np.frombuffer(payload, dtype=np.uint8)
                result_buffer.size = len(payload)
                req.stats.mark_done(recv_size=len(payload))
                result = OperationResult(OperationStatus.SUCCESS, stats=req.stats, data=result_buffer)
            except Exception as e:  # any serve failure must complete the request
                req.stats.mark_done()
                err = e if isinstance(e, TransportError) else TransportError(str(e))
                result = OperationResult(OperationStatus.FAILURE, error=err, stats=req.stats)
            req.complete(result)
            if callback is not None:
                callback(result)

        self._enqueue(serve, req)
        return req
