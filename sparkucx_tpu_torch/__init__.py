"""sparkucx_tpu_torch — the shuffle framework on PyTorch and CUDA.

A port of ``sparkucx_tpu`` (the JAX package beside it, which stays the
reference) to one NVIDIA GPU: map output is staged into device memory in the
per-peer slot layout, one superstep moves every block to its reducer, and
reducers fetch host slices or one packed device gather.  The two device steps
are hand-written Hopper kernels (``csrc/block_copy.cu``, wrapped by
``ops/block_kernels.py``); on CPU tensors their plain PyTorch versions run.
TeraSort runs on the device too (``ops/sort.py``, with the columnar shuffle
of ``ops/columnar.py``), sorting through the LSD radix kernel of
``csrc/radix_sort.cu`` (wrapped by ``ops/radix.py``).

Layer map (the JAX package's, for the modules ported so far):

====  =====================================  =========================================
L7    shuffle/manager.py                     plugin boundary (ShuffleManager SPI)
L5    shuffle/reader.py                      reduce-side read path
L4    shuffle/writer.py, shuffle/resolver.py map-side write path + block resolver
L3    core/transport.py, transport/tpu.py    transport trait + the device cluster
L2    store/hbm_store.py, ops/*              staged store, exchange, block kernels,
                                             columnar shuffle, sort, radix kernel
L1    memory/pool.py                         host bounce-buffer pool
L0    config.py, core/*, utils/*             contracts, config, low-level utils
====  =====================================  =========================================

Executors run on CUDA unless the caller passes ``devices=["cpu"] * n``.
"""

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
from sparkucx_tpu_torch.core.transport import ShuffleTransport

__all__ = [
    "TpuShuffleConf",
    "Block",
    "BlockId",
    "MemoryBlock",
    "ShuffleBlockId",
    "OperationCallback",
    "OperationResult",
    "OperationStats",
    "OperationStatus",
    "Request",
    "TransportError",
    "ShuffleTransport",
]
