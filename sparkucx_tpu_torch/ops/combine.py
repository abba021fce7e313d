"""Receive-side combine math of the compute-in-exchange path.

Port of ``sparkucx_tpu/ops/combine.py``.  The fused grouped-aggregate
exchange does not keep received rows: every landed window is dequantized and
folded into a dense per-group accumulator, so the receive side holds
O(groups) instead of O(rows).

Windows fold in ONE canonical order (own slot first, then the ring
schedule's items in step order): K4's plain version (ops/ring_kernels.py)
calls :func:`combine_window` window by window, and the Hopper kernel K4
(``csrc/ring_exchange.cu``) folds in that order too.  Integer results are
therefore identical across the two and against the unfused path.

Window row layout is the partial-aggregate exchange row
(ops/relational.py): ``[key (uint32 bits) | payload | count (int32 bits)]``,
every lane a 32-bit word of the aggregate dtype.  A row is valid exactly
when ``count > 0`` (staging padding rows are all-zero); a valid row whose key
lies outside ``[0, num_groups)`` hits no group.  The payload is ``width``
value lanes, or the quantized packing (ops/compress.py) dequantized as the
window lands.

:func:`combine_window` is a ``scatter_reduce_`` of the valid rows keyed by
group — never a ``(rows, groups)`` one-hot mask, which cannot be built at
millions of groups.  For int32 it is exact; for float32 it equals the JAX
fold whenever no key repeats inside a window, which holds on the GROUP BY
path (partial rows carry one row per key and sender).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

import numpy as np
import torch

from sparkucx_tpu_torch.ops.compress import QuantizeSpec, dequantize_rows

#: aggregates the dense combine accumulator can fold (avg lanes carry SUM
#: until the host divides)
COMBINE_AGGS: Tuple[str, ...] = ("sum", "min", "max", "avg")

#: scatter_reduce_ reduction of each aggregate
_REDUCE = {"sum": "sum", "avg": "sum", "min": "amin", "max": "amax"}


def agg_identity(agg: str, dtype):
    """The fold identity of one aggregate column (numpy scalar)."""
    dtype = np.dtype(dtype)
    if agg == "min":
        info = np.finfo(dtype) if np.issubdtype(dtype, np.floating) else np.iinfo(dtype)
        return dtype.type(info.max)
    if agg == "max":
        info = np.finfo(dtype) if np.issubdtype(dtype, np.floating) else np.iinfo(dtype)
        return dtype.type(info.min)
    return dtype.type(0)


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype."""
    return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype


@dataclass(frozen=True)
class CombineSpec:
    """Static geometry of one dense fused-combine accumulator."""

    #: dense key-domain size: keys are uint32 in [0, num_groups)
    num_groups: int
    #: per value column, in column order
    aggs: Tuple[str, ...]
    #: aggregate value dtype (int32, or float32 under quantization)
    dtype: Any = np.int32
    #: lossy payload packing of the landed windows ('off' = plain lanes)
    quantize_mode: str = "off"
    quantize_block: int = 128

    @property
    def width(self) -> int:
        return len(self.aggs)

    @property
    def qspec(self) -> Optional[QuantizeSpec]:
        if self.quantize_mode == "off":
            return None
        return QuantizeSpec(mode=self.quantize_mode, block_size=self.quantize_block)

    @property
    def payload_width(self) -> int:
        """Value lanes of one exchange row (quantized packing included)."""
        q = self.qspec
        return q.quantized_width(self.width) if q is not None else self.width

    @property
    def row_width(self) -> int:
        """Total lanes of one exchange row: key + payload + count."""
        return 1 + self.payload_width + 1

    @property
    def acc_bytes(self) -> int:
        """Accumulator bytes per executor — the O(groups) quantity that
        replaces the O(rows) receive staging."""
        return self.num_groups * (self.width * np.dtype(self.dtype).itemsize + 4)

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    def validate(self) -> None:
        if self.num_groups <= 0:
            raise ValueError("num_groups must be positive")
        bad = [a for a in self.aggs if a not in COMBINE_AGGS]
        if bad:
            raise ValueError(f"aggregates {bad} not dense-combinable {COMBINE_AGGS}")
        if np.dtype(self.dtype) not in (np.dtype(np.int32), np.dtype(np.float32)):
            raise ValueError("combine dtype must be int32 or float32")
        q = self.qspec
        if q is not None:
            q.validate()
            if not np.issubdtype(np.dtype(self.dtype), np.floating):
                raise ValueError("quantized combine requires a float dtype")


def acc_init(spec: CombineSpec, device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """Fresh accumulator ``(acc_vals (G, width), acc_counts (G, 1) int32)`` —
    every column at its fold identity, counts zero."""
    idents = torch.tensor(
        [agg_identity(a, spec.dtype) for a in spec.aggs], dtype=spec.torch_dtype
    ).to(device)
    vals = idents.expand(spec.num_groups, spec.width).contiguous()
    return vals, torch.zeros((spec.num_groups, 1), dtype=torch.int32, device=device)


def window_rows(spec: CombineSpec, window: torch.Tensor):
    """Split one landed window ``(rows, row_width)`` into (uint32 keys as
    int64, count lane as int32, payload values ``(rows, width)`` of the spec
    dtype, dequantized when the spec quantizes)."""
    keys = window[:, 0].view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    counts = window[:, -1].view(torch.int32)
    payload = window[:, 1:-1]
    q = spec.qspec
    if q is not None:
        payload = dequantize_rows(q, payload.view(torch.int32), spec.width).to(spec.torch_dtype)
    return keys, counts, payload


def combine_window(spec: CombineSpec, window: torch.Tensor, acc_vals: torch.Tensor, acc_counts: torch.Tensor):
    """Fold ONE landed exchange window into the dense accumulator, IN PLACE
    (the JAX fold returns new arrays; nothing else holds the accumulator).

    ``window``: ``(rows, spec.row_width)`` lanes of ``spec.dtype``.  Each
    valid row is folded into its group's lanes in row order; invalid rows
    (count == 0) and keys outside the domain hit no group.  Returns
    ``(acc_vals, acc_counts)``."""
    keys, counts, payload = window_rows(spec, window)
    valid = (counts > 0) & (keys < spec.num_groups)
    idx = keys[valid]
    acc_counts.view(-1).index_add_(0, idx, counts[valid])
    rows = payload[valid]
    for c, agg in enumerate(spec.aggs):
        acc_vals[:, c].scatter_reduce_(0, idx, rows[:, c], _REDUCE[agg], include_self=True)
    return acc_vals, acc_counts


def merge_accumulators(spec: CombineSpec, a, b):
    """Merge two dense accumulators into new tensors: sum/avg columns add in
    argument order (running accumulator first, so float merges are
    deterministic), min/max take the minimum/maximum, counts add."""
    (av, ac), (bv, bc) = a, b
    cols = []
    for c, agg in enumerate(spec.aggs):
        if _REDUCE[agg] == "sum":
            cols.append(av[:, c] + bv[:, c])
        elif agg == "min":
            cols.append(torch.minimum(av[:, c], bv[:, c]))
        else:
            cols.append(torch.maximum(av[:, c], bv[:, c]))
    vals = torch.stack(cols, dim=1) if cols else av.new_zeros(av.shape)
    return vals, ac + bc
