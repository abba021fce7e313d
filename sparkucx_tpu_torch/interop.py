"""State carried between the JAX package and this one.

The shuffle system has no weights: its state is the conf, the commit table
and the staged rounds.  These helpers take each in the JAX package's form —
Spark conf keys, ``MapperInfo.pack()`` blobs, and a sealed slot-layout round
as numpy (``np.asarray(store.seal(...)[r][0])``) — and return this package's,
so a shuffle sealed by one package can be exchanged and fetched by the other.
"""

from __future__ import annotations

from typing import Mapping, Tuple

import numpy as np
import torch

from sparkucx_tpu_torch.config import TpuShuffleConf
from sparkucx_tpu_torch.core.definitions import MapperInfo


def conf_from_spark(conf: Mapping[str, str]) -> TpuShuffleConf:
    """The conf for ``spark.shuffle.tpu.*`` keys, parsed as the JAX
    ``TpuShuffleConf.from_spark_conf`` parses them."""
    return TpuShuffleConf.from_spark_conf(conf)


def mapper_info_from_blob(blob: bytes) -> MapperInfo:
    """A commit record from its packed blob (byte-compatible across packages)."""
    return MapperInfo.unpack(blob)


def import_sealed_round(
    payload: np.ndarray, sizes: np.ndarray, device
) -> Tuple[torch.Tensor, np.ndarray]:
    """A sealed round ``(rows, lane)`` int32 payload and its per-peer used-row
    counts -> ``(staging tensor on device, int32 size row)``, the shapes the
    store's ``seal`` returns.  The payload is copied (a numpy view of a JAX
    array is read-only)."""
    payload = np.asarray(payload)
    if payload.ndim != 2 or payload.dtype != np.int32:
        raise ValueError(f"sealed payload must be (rows, lane) int32, got {payload.shape} {payload.dtype}")
    sizes = np.asarray(sizes, dtype=np.int32).reshape(-1)
    return torch.from_numpy(np.array(payload, copy=True)).to(device), sizes.copy()
