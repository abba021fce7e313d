"""Device-resident columnar shuffle — the ``GpuColumnarExchange`` analogue.

Port of ``sparkucx_tpu/ops/columnar.py``.  Map output that is already a
tensor of fixed-width rows is repartitioned without leaving device memory:
each executor stably sorts its rows by destination executor, the (n, n) size
matrix is gathered from the owner vectors, and every receiver takes exactly
its rows, sender-major, in tight layout.

When every executor lives on ONE device (a single card, or the CPU in the
tests) the data movement is K1: receiver j's shard is one ``block_gather``
launch over the n compact segments ``(i * capacity + input_offsets_i[j],
sizes[i, j])`` of the concatenated sorted rows.  This is the JAX
``columnar_shard_dense`` output contract: the first ``recv_capacity`` rows
of the sender-major concatenation, zero rows after the received total.
Executors on different devices need a collective (NCCL), which is not
ported yet.  The JAX ``axis_name`` field has no counterpart here.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Sequence, Tuple

import numpy as np
import torch

from sparkucx_tpu_torch.ops.block_kernels import block_gather, plan_tensors
from sparkucx_tpu_torch.ops.exchange import exclusive_cumsum, ragged_params, same_device
from sparkucx_tpu_torch.utils.devices import resolve_devices

_CROSS_DEVICE = (
    "executors on different devices need the NCCL exchange, which is not ported yet "
    "(ROADMAP queue A item 4, executors in separate processes)"
)


@dataclass(frozen=True)
class ColumnarSpec:
    """Static description of one columnar shuffle.

    ``capacity`` / ``recv_capacity`` are per-executor row counts (pad the
    input with ``owner = num_executors`` rows — they are never sent).
    ``width`` is the row width in elements of ``dtype``.  ``impl``: ``auto``
    or ``shared`` (every executor on one device, the exchange is K1);
    ``ragged`` (the collective across devices) is not ported yet.
    """

    num_executors: int
    capacity: int
    recv_capacity: int
    width: int
    dtype: np.dtype = np.dtype(np.float32)
    impl: str = "auto"

    def resolve_impl(self) -> "ColumnarSpec":
        if self.impl == "auto":
            return replace(self, impl="shared")
        return self

    def validate(self) -> None:
        if self.impl == "ragged":
            raise NotImplementedError(f"impl='ragged': {_CROSS_DEVICE}")
        if self.impl != "shared":
            raise ValueError(f"unknown impl {self.impl!r}")


def size_matrix_from_owners(num_executors: int, owners: torch.Tensor):
    """Every executor's owner vector -> the (n, n) size matrix and each
    executor's exchange parameters, the collective MapperInfo analogue shared
    by the columnar shuffle and the distributed sort.

    ``owners``: ``(n, capacity)`` (or ``(n * capacity,)``) integer tensor;
    rows with ``owner == num_executors`` are padding and counted nowhere.
    Returns numpy int64 ``(sizes, send_sizes, recv_sizes, output_offsets)``:
    ``sizes[i, j]`` = rows i sends j, and row ``me`` of each of the other
    three is executor ``me``'s compact-layout ``ragged_params``."""
    n = num_executors
    owners = owners.reshape(n, -1).to(torch.int64)
    flat = owners + torch.arange(n, device=owners.device)[:, None] * (n + 1)
    counts = torch.bincount(flat.reshape(-1), minlength=n * (n + 1))
    sizes = counts.view(n, n + 1)[:, :n].cpu().numpy().astype(np.int64)
    params = [ragged_params(sizes, me, None) for me in range(n)]
    send_sizes = np.stack([p[1] for p in params])
    output_offsets = np.stack([p[2] for p in params])
    recv_sizes = np.stack([p[3] for p in params])
    return sizes, send_sizes, recv_sizes, output_offsets


def receive_plan(sizes: np.ndarray, receiver: int, capacity: int, recv_capacity: int):
    """Gather plan of one receiver over the concatenated, destination-sorted
    rows: sender i's segment starts at ``i * capacity`` plus the rows i sends
    to lower receivers, packed sender-major and cut at ``recv_capacity``
    rows.  Returns (starts, counts, outs)."""
    n = sizes.shape[0]
    starts = np.arange(n, dtype=np.int64) * capacity + exclusive_cumsum(sizes, axis=1)[:, receiver]
    ends = np.minimum(np.cumsum(sizes[:, receiver]), recv_capacity)
    outs = np.minimum(exclusive_cumsum(sizes[:, receiver]), recv_capacity)
    return starts, ends - outs, outs


def exchange_sorted_rows(spec: ColumnarSpec, rows: torch.Tensor, sizes: np.ndarray):
    """The exchange of rows already grouped by destination: executor i's rows
    ``[i * capacity, (i + 1) * capacity)`` hold its rows for receiver 0, then
    1, ..., then padding (``sizes`` is the (n, n) matrix).  Returns
    ``(recv (n * recv_capacity, W), recv_sizes (n, n))``: shard j holds what j
    received, sender-major, zero rows after its total; ``recv_sizes[j, i]`` =
    rows j received from i (the true count, which may exceed
    ``recv_capacity``: the caller's overflow signal)."""
    n, rc = spec.num_executors, spec.recv_capacity
    recv = torch.empty((n * rc, rows.shape[1]), dtype=rows.dtype, device=rows.device)
    for j in range(n):
        starts, counts, outs = receive_plan(sizes, j, spec.capacity, rc)
        shard = recv[j * rc : (j + 1) * rc]  # each receiver lands in place
        block_gather(*plan_tensors(starts, counts, outs, rows.device), rows, rc, out=shard)
        shard[min(int(sizes[:, j].sum()), rc):] = 0
    return recv, np.ascontiguousarray(sizes.T)


def take_rows(rows: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``rows.index_select(0, index)`` for a contiguous (R, W) tensor.  Rows
    of exactly 16 bytes are taken as ONE complex128 element each, a move of
    their bits that computes nothing: PyTorch's row gather of 16-byte rows
    runs more than ten times slower on an NVIDIA H100 80GB HBM3 at 700 W
    than the same gather of complex128 elements (``chip_smoke.py`` phase 18
    times both on its orders exchange; PERF.md)."""
    if rows.dim() == 2 and rows.shape[1] * rows.element_size() == 16 and rows.is_contiguous():
        return rows.view(torch.complex128).reshape(-1).index_select(0, index).view(rows.dtype).view(-1, rows.shape[1])
    return rows.index_select(0, index)


def _sort_by_owner(spec: ColumnarSpec, rows: torch.Tensor, owners: torch.Tensor) -> torch.Tensor:
    """Each executor's rows stably sorted by destination (padding, owner == n, last)."""
    n, cap = spec.num_executors, spec.capacity
    order = torch.sort(owners.reshape(n, cap), dim=1, stable=True).indices
    order = order + torch.arange(n, device=rows.device)[:, None] * cap
    return take_rows(rows, order.reshape(-1))


def build_columnar_shuffle(devices: Sequence, spec: ColumnarSpec):
    """The columnar shuffle for executors on ``devices`` (one entry per
    executor; ``None`` puts every executor on ``cuda``).

    Returns ``fn(rows, owners) -> (recv_rows, recv_counts)``:

    * ``rows``: ``(n * capacity, width)`` tensor on the executors' device —
      executor i's local rows are ``[i * capacity, (i + 1) * capacity)``;
    * ``owners``: ``(n * capacity,)`` integer tensor — destination executor
      per row, ``num_executors`` for padding rows (never sent);
    * ``recv_rows``: ``(n * recv_capacity, width)`` — executor j's shard holds
      all rows destined to it, sender-major, each sender's rows in its input
      order, zero rows after;
    * ``recv_counts``: (n, n) int32 host tensor — row j = rows j received from
      each sender i.
    """
    devices = resolve_devices(devices, spec.num_executors)
    spec = spec.resolve_impl()
    spec.validate()
    if not same_device(devices):
        raise NotImplementedError(_CROSS_DEVICE)
    n, cap = spec.num_executors, spec.capacity

    def shuffle(rows: torch.Tensor, owners: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        if tuple(rows.shape) != (n * cap, spec.width):
            raise ValueError(f"rows shape {tuple(rows.shape)} != {(n * cap, spec.width)}")
        if tuple(owners.shape) != (n * cap,):
            raise ValueError(f"owners shape {tuple(owners.shape)} != {(n * cap,)}")
        if owners.numel() and not 0 <= int(owners.min()) <= int(owners.max()) <= n:
            raise ValueError(f"owners must lie in [0, {n}] ({n} marks padding)")
        sizes = size_matrix_from_owners(n, owners)[0]
        recv, recv_sizes = exchange_sorted_rows(spec, _sort_by_owner(spec, rows, owners), sizes)
        return recv, torch.from_numpy(recv_sizes.astype(np.int32))

    shuffle.spec = spec
    return shuffle


def run_columnar_shuffle(devices: Sequence, spec: ColumnarSpec, rows, owners, max_attempts: int = 3):
    """Overflow-retry wrapper: runs the shuffle and doubles ``recv_capacity``
    while a destination's row count exceeds it.  ``rows``/``owners`` may be
    numpy arrays or tensors; they go to the executors' device.  Returns
    (recv_rows, recv_counts) at the final (possibly enlarged) capacity."""
    devices = resolve_devices(devices, spec.num_executors)
    rows = torch.as_tensor(rows).to(devices[0])
    owners = torch.as_tensor(owners).to(devices[0])
    attempt_spec = spec
    for _ in range(max_attempts):
        recv, counts = build_columnar_shuffle(devices, attempt_spec)(rows, owners)
        if (counts.sum(dim=1) <= attempt_spec.recv_capacity).all():
            return recv, counts
        attempt_spec = replace(attempt_spec, recv_capacity=2 * attempt_spec.recv_capacity)
    raise RuntimeError(
        f"columnar shuffle overflowed recv_capacity {attempt_spec.recv_capacity // 2} "
        f"after {max_attempts} doublings — destination skew too extreme"
    )


def shard_rows_host(
    keys: np.ndarray,
    values: np.ndarray,
    num_shards: int,
    capacity: int,
    key_fill: int = 0,
    value_dtype=None,
):
    """Deal host (keys, value-rows) into the padded per-shard layout: contiguous
    near-equal shares, shard s padded to ``capacity`` with ``key_fill`` keys /
    zero rows.  Returns (padded_keys (n*cap,) uint32, padded_values (n*cap,
    width), num_valid (n,) int32) — the JAX package's convention, unchanged."""
    n, cap = num_shards, capacity
    total = len(keys)
    if values.shape[0] != total:
        raise ValueError(
            f"keys/values row mismatch: {total} keys vs {values.shape[0]} value rows"
        )
    if total > n * cap:
        raise ValueError(f"{total} rows exceed {n} x {cap} capacity")
    width = values.shape[1]
    pk = np.full(n * cap, key_fill, np.uint32)
    pv = np.zeros((n * cap, width), value_dtype or values.dtype)
    nv = np.zeros(n, np.int32)
    base, rem = divmod(total, n)
    start = 0
    for s in range(n):
        take = base + (1 if s < rem else 0)
        pk[s * cap : s * cap + take] = keys[start : start + take]
        pv[s * cap : s * cap + take] = values[start : start + take]
        nv[s] = take
        start += take
    return pk, pv, nv


def unpack_shard_prefixes(arrays, counts, capacity: int):
    """Inverse of :func:`shard_rows_host`: concatenate each shard's valid
    prefix from per-shard padded layouts (host arrays shaped (n * capacity,
    ...); ``counts``: (n,) valid rows per shard)."""
    n = len(counts)
    outs = []
    for a in arrays:
        a2 = np.asarray(a).reshape(n, capacity, *np.asarray(a).shape[1:])
        outs.append(np.concatenate([a2[s, : counts[s]] for s in range(n)]))
    return outs


def owners_from_partitions(
    partition_ids: torch.Tensor, num_partitions: int, num_executors: int
) -> torch.Tensor:
    """Map reduce-partition ids to owning executors (the contiguous ranges of
    store/hbm_store.default_peer_ranges).  Padding rows (partition_id < 0 or
    >= num_partitions) map to ``num_executors``.  Returns int32."""
    base, rem = divmod(num_partitions, num_executors)
    starts = torch.tensor(
        [e * base + min(e, rem) for e in range(num_executors + 1)],
        dtype=torch.int64, device=partition_ids.device,
    )
    pids = partition_ids.to(torch.int64)
    owner = torch.searchsorted(starts, pids, right=True) - 1
    invalid = (pids < 0) | (pids >= num_partitions)
    return torch.where(invalid, num_executors, owner).to(torch.int32)
