"""Size-bucketed pool of host bounce buffers (L1).

Port of ``sparkucx_tpu/memory/pool.py``.  Counterpart of
``shuffle/ucx/memory/MemoryPool.scala`` (147 LoC):

* sizes rounded up to powers of two with floor ``min_buffer_size``
  (MemoryPool.scala:34-49),
* a per-size free stack backed by real allocations (MemoryPool.scala:55-110),
* small sizes batch-preallocated in ``min_allocation_size`` slabs carved into
  refcounted views (MemoryPool.scala:64-70,84-95),
* ``preallocate(size, count)`` warm-up from config (MemoryPool.scala:141-147),
* ``close()`` releases every allocation (MemoryPool.scala:97-109).

Slabs are torch host tensors, page-locked (``pin_memory``) when the pool serves
a CUDA executor so device-to-host copies into them run as asynchronous DMA.
Where the reference registers host memory with the RDMA NIC
(``ucxContext.memoryMap``), pinning is the registration here.  Callers see each
buffer as a numpy uint8 view of its slab.  The JAX package's native arena and
buffer sanitizer are not part of this port.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from sparkucx_tpu_torch.config import TpuShuffleConf
from sparkucx_tpu_torch.core.block import MemoryBlock
from sparkucx_tpu_torch.core.operation import ResourceExhaustedError


def round_up_to_next_power_of_two(size: int) -> int:
    """MemoryPool.scala:34-41."""
    if size <= 0:
        return 1
    return 1 << (size - 1).bit_length()


class _PoolBudget:
    """Pool-wide backing-allocation budget (``store.hardWatermark``), shared by
    every :class:`AllocatorStack` of one pool.  The lock is a leaf."""

    __slots__ = ("hard", "allocated", "lock")

    def __init__(self, hard: int) -> None:
        self.hard = int(hard)
        self.allocated = 0  #: guarded by self.lock
        self.lock = threading.Lock()

    def charge(self, nbytes: int) -> None:
        """Admit a slab allocation or raise the retryable typed error."""
        with self.lock:
            if self.hard > 0 and self.allocated + nbytes > self.hard:
                raise ResourceExhaustedError(
                    requested=nbytes,
                    used=self.allocated,
                    watermark=self.hard,
                    detail="memory pool hard watermark",
                )
            self.allocated += nbytes


class _Slab:
    """One backing host tensor, possibly shared by many pooled views; the
    refcount counts checked-out views (MemoryPool.scala:64-70)."""

    __slots__ = ("tensor", "array", "refcount", "lock")

    def __init__(self, tensor: torch.Tensor) -> None:
        self.tensor = tensor
        self.array = tensor.numpy()
        self.refcount = 0
        self.lock = threading.Lock()

    def release(self) -> None:
        self.array = None
        self.tensor = None


class AllocatorStack:
    """Free-stack of equal-sized buffers for one bucket (MemoryPool.scala:55-110)."""

    def __init__(
        self,
        size: int,
        min_allocation_size: int,
        pin: bool = False,
        budget: Optional[_PoolBudget] = None,
    ) -> None:
        self.size = size
        self.min_allocation_size = min_allocation_size
        self.pin = pin
        self.budget = budget
        self._free: List[MemoryBlock] = []  #: guarded by self._lock
        self._slabs: List[_Slab] = []  #: guarded by self._lock
        self._lock = threading.Lock()
        self.total_allocated = 0  #: guarded by self._lock (bytes of backing allocations)
        self.total_requested = 0  #: guarded by self._lock (get() count for stats)

    def _wrap(self, view: np.ndarray, slab: _Slab) -> MemoryBlock:
        def recycle(mb: MemoryBlock, _slab=slab) -> None:
            # _closed stays True while the block sits in the free stack
            # (re-armed at checkout) so a stale holder's second close() is a
            # no-op instead of a double-free.
            with _slab.lock:
                _slab.refcount -= 1
            with self._lock:
                self._free.append(mb)

        mb = MemoryBlock(data=view, size=self.size, is_host_memory=True, _on_close=recycle)
        mb.allocator_token = slab
        return mb

    def _allocate_more(self) -> None:
        """Grow the free list by one slab; caller holds ``self._lock``.  Small
        buckets carve a ``min_allocation_size`` slab, large ones allocate one
        buffer (MemoryPool.scala:64-70)."""
        alloc_size = max(self.size, self.min_allocation_size)
        if self.budget is not None:
            self.budget.charge(alloc_size)
        slab = _Slab(torch.empty(alloc_size, dtype=torch.uint8, pin_memory=self.pin))
        self._slabs.append(slab)
        self.total_allocated += alloc_size
        for i in range(alloc_size // self.size):
            view = slab.array[i * self.size : (i + 1) * self.size]
            self._free.append(self._wrap(view, slab))

    def get_n(self, count: int) -> List[MemoryBlock]:
        """Batch checkout: ``count`` blocks for one lock round-trip."""
        out: List[MemoryBlock] = []
        with self._lock:
            self.total_requested += count
            while len(self._free) < count:
                self._allocate_more()
            for _ in range(count):
                mb = self._free.pop()
                slab = mb.allocator_token
                with slab.lock:
                    slab.refcount += 1
                mb.rearm()
                out.append(mb)
        return out

    def preallocate(self, count: int) -> None:
        """MemoryPool.scala:141-147 warm-up."""
        with self._lock:
            while len(self._free) < count:
                self._allocate_more()

    @property
    def num_free(self) -> int:
        with self._lock:
            return len(self._free)

    def close(self) -> None:
        with self._lock:
            leaked = [s for s in self._slabs if s.refcount > 0]
            self._free.clear()
            for s in self._slabs:
                if s.refcount == 0:
                    s.release()
            self._slabs.clear()
        if leaked:
            raise ResourceWarning(
                f"AllocatorStack(size={self.size}): {len(leaked)} slabs still referenced at close"
            )


class MemoryPool:
    """Bucketed host bounce-buffer pool (``UcxHostBounceBuffersPool`` analogue).

    ``get(size)`` returns a MemoryBlock whose ``size`` is the *requested* size
    but whose backing buffer is the power-of-two bucket (MemoryPool.scala:117-131).
    ``put``/``MemoryBlock.close()`` recycles.  ``pin`` page-locks the slabs —
    the manager sets it when its executors are CUDA devices.
    """

    def __init__(self, conf: Optional[TpuShuffleConf] = None, pin: bool = False) -> None:
        self.conf = conf or TpuShuffleConf()
        self.pin = pin
        #: pool-wide slab budget (store.hardWatermark); 0 = unbounded
        self._budget = _PoolBudget(self.conf.store_hard_watermark)
        self._stacks: Dict[int, AllocatorStack] = {}  #: guarded by self._lock
        self._lock = threading.Lock()
        self._closed = False  #: guarded by self._lock

    def _bucket(self, size: int) -> int:
        return max(round_up_to_next_power_of_two(size), self.conf.min_buffer_size)

    def _stack_for(self, bucket: int) -> AllocatorStack:
        with self._lock:
            if self._closed:
                raise RuntimeError("MemoryPool is closed")
            stack = self._stacks.get(bucket)
            if stack is None:
                stack = AllocatorStack(
                    bucket, self.conf.min_allocation_size, pin=self.pin, budget=self._budget
                )
                self._stacks[bucket] = stack
            return stack

    def get(self, size: int) -> MemoryBlock:
        return self.get_many([size])[0]

    def get_many(self, sizes) -> List[MemoryBlock]:
        """Order-preserving batch checkout, one stack-lock round-trip per bucket."""
        sizes = list(sizes)
        for s in sizes:
            if s <= 0:
                raise ValueError(f"invalid allocation size {s}")
        by_bucket: Dict[int, List[int]] = {}
        for i, s in enumerate(sizes):
            by_bucket.setdefault(self._bucket(s), []).append(i)
        out: List[Optional[MemoryBlock]] = [None] * len(sizes)
        for bucket, idxs in by_bucket.items():
            for i, mb in zip(idxs, self._stack_for(bucket).get_n(len(idxs))):
                mb.size = sizes[i]  # sized view over the bucket buffer
                out[i] = mb
        return out

    def put(self, mb: MemoryBlock) -> None:
        mb.close()

    def preallocate(self, size: int, count: int) -> None:
        self._stack_for(self._bucket(size)).preallocate(count)

    def preallocate_from_conf(self) -> None:
        """spark.shuffle.tpu.memory.preAllocateBuffers warm-up (MemoryPool.scala:141-147)."""
        for size, count in self.conf.prealloc_buffers.items():
            self.preallocate(size, count)

    def stats(self) -> Dict[int, Dict[str, int]]:
        with self._lock:
            stacks = sorted(self._stacks.items())
        return {
            b: {"allocated_bytes": s.total_allocated, "requests": s.total_requested, "free": s.num_free}
            for b, s in stacks
        }

    def close(self) -> None:
        with self._lock:
            stacks, self._stacks = list(self._stacks.values()), {}
            self._closed = True
        errors = []
        for s in stacks:
            try:
                s.close()
            except ResourceWarning as e:  # collect, keep closing (MemoryPool.scala:97-109)
                errors.append(e)
        if errors:
            raise ResourceWarning("; ".join(str(e) for e in errors))

    def __enter__(self) -> "MemoryPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
