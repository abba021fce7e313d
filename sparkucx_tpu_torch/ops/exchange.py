"""The shuffle exchange — one superstep moving every executor's staged blocks.

Port of ``sparkucx_tpu/ops/exchange.py``.  The data unit is unchanged: rows of
``lane`` 32-bit words (default 128 -> one 512-byte row), in the slot layout
the store stages — executor i's peer-j chunk starts at row ``j * slot_rows``
of its staging — and the receive side is tight and sender-major.

Two phases, as in the JAX package: the n x n size matrix (row i = rows
executor i sends each peer) is known before any data moves, then the payload
moves.  When every executor lives on ONE device (a single card, or the CPU in
the tests) the payload phase is a device-local copy: receiver j's buffer is
one ``block_gather`` launch over the n segments
``(i * send_rows + j * slot_rows, sizes[i, j])`` of the concatenated staging.
At n = 1 that is exactly the JAX ``'local'`` tier (``_build_local_exchange``).
Executors on different devices need a collective (NCCL ``all_to_all_single``),
which is not ported yet.

Rows of each receive shard past its received total are UNSPECIFIED (as under
the JAX ``'local'`` tier); every consumer slices by ``recv_sizes``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch

from sparkucx_tpu_torch.ops.block_kernels import block_gather, plan_tensors
from sparkucx_tpu_torch.utils.devices import normalize_device


def exclusive_cumsum(x, axis: int = -1):
    x = np.asarray(x)
    return np.cumsum(x, axis=axis) - x


@dataclass(frozen=True)
class ExchangeSpec:
    """Static description of one exchange.

    ``send_rows`` / ``recv_rows`` are per-executor staging and receive sizes in
    rows of ``lane`` 32-bit words (``row_bytes`` = 4*lane).  Layout is always
    *slot*: peer j's chunk starts at row ``j * slot_rows`` of the sender's
    staging, exactly the per-peer region layout the store stages.
    """

    num_executors: int
    send_rows: int
    recv_rows: int
    lane: int = 128

    @property
    def row_bytes(self) -> int:
        return self.lane * 4

    @property
    def slot_rows(self) -> int:
        """Per-peer region size in rows."""
        return self.send_rows // self.num_executors

    def validate(self) -> None:
        if self.num_executors <= 0:
            raise ValueError("num_executors must be positive")
        if self.send_rows % self.num_executors:
            raise ValueError("send_rows must be divisible by num_executors (slot layout)")
        if self.recv_rows < 0:
            raise ValueError("recv_rows must be >= 0")
        if self.lane <= 0:
            raise ValueError("lane must be positive")


def ragged_params(sizes, me: int, slot_rows):
    """The offsets and sizes executor ``me`` exchanges with, from the full
    (n, n) size matrix (``sizes[i, j]`` = rows i sends j) — the same formulas
    as the JAX ``ragged_params`` with ``xp=np``:

    * ``input_offsets[j]`` — where j's chunk starts in my send buffer: the
      slot start ``j * slot_rows``, or the compact exclusive cumsum when
      ``slot_rows`` is None;
    * ``send_sizes[j]`` — rows I send j: row ``me``;
    * ``output_offsets[j]`` — where my chunk lands in receiver j's buffer:
      the exclusive cumsum down column j, row ``me``;
    * ``recv_sizes[i]`` — rows I receive from i: column ``me``.
    """
    sizes = np.asarray(sizes)
    n = sizes.shape[0]
    send_sizes = sizes[me]
    recv_sizes = sizes[:, me]
    output_offsets = exclusive_cumsum(sizes, axis=0)[me]
    if slot_rows is None:
        input_offsets = exclusive_cumsum(send_sizes)
    else:
        input_offsets = np.arange(n, dtype=np.int32) * slot_rows
    return input_offsets, send_sizes, output_offsets, recv_sizes


def same_device(devices: Sequence) -> bool:
    """True when every executor's device is one device (a bare ``cuda`` means
    the current CUDA device)."""
    return len({normalize_device(d) for d in devices}) == 1


def receive_plan(sizes: np.ndarray, receiver: int, send_rows: int, slot_rows: int):
    """Gather plan of one receiver over the concatenated staging: one segment
    per sender i at row ``i * send_rows + receiver * slot_rows``, packed
    sender-major.  Returns (starts, counts, outs, total)."""
    counts = np.ascontiguousarray(sizes[:, receiver], dtype=np.int32)
    n = counts.shape[0]
    starts = (np.arange(n, dtype=np.int64) * send_rows + receiver * slot_rows).astype(np.int32)
    outs = (np.cumsum(counts) - counts).astype(np.int32)
    return starts, counts, outs, int(counts.sum())


def build_exchange(devices: Sequence, spec: ExchangeSpec):
    """The superstep for executors on ``devices`` (one entry per executor).

    Returns ``fn(data, size_matrix) -> (recv, recv_sizes)`` with the contract
    of the JAX ``build_exchange``:

    * ``data``: ``(n * send_rows, lane)`` tensor on the executors' device —
      executor i's staging is rows ``[i * send_rows, (i + 1) * send_rows)``,
      slot layout;
    * ``size_matrix``: (n, n) int32 (numpy or tensor) — row i is executor i's
      send sizes in rows;
    * ``recv``: ``(n * recv_rows, lane)`` — rows ``[j * recv_rows, ...)`` hold
      everything executor j received, tightly packed sender-major, rows past
      its total unspecified;
    * ``recv_sizes``: (n, n) int32 host tensor — row j = rows j received from
      each sender i.
    """
    spec.validate()
    n = spec.num_executors
    if len(devices) != n:
        raise ValueError(f"spec.num_executors={n} != {len(devices)} devices")
    if not same_device(devices):
        raise NotImplementedError(
            "executors on different devices need the NCCL exchange, which is not "
            "ported yet (ROADMAP queue A item 4, executors in separate processes)"
        )

    def exchange(data: torch.Tensor, size_matrix) -> Tuple[torch.Tensor, torch.Tensor]:
        if tuple(data.shape) != (n * spec.send_rows, spec.lane):
            raise ValueError(
                f"data shape {tuple(data.shape)} != {(n * spec.send_rows, spec.lane)}"
            )
        if isinstance(size_matrix, torch.Tensor):
            size_matrix = size_matrix.cpu().numpy()
        sizes = np.asarray(size_matrix, dtype=np.int32).reshape(n, n)
        if (sizes > spec.slot_rows).any():
            raise ValueError(f"a chunk exceeds its slot of {spec.slot_rows} rows")
        received = sizes.sum(axis=0)
        if received.max(initial=0) > spec.recv_rows:
            raise ValueError(
                f"receiver gets {int(received.max())} rows > recv_rows={spec.recv_rows}"
            )
        # each receiver's rows land in place in the one receive buffer
        recv = torch.empty((n * spec.recv_rows, spec.lane), dtype=data.dtype, device=data.device)
        for j in range(n):
            starts, counts, outs, _ = receive_plan(sizes, j, spec.send_rows, spec.slot_rows)
            s, c, o = plan_tensors(starts, counts, outs, data.device)
            block_gather(s, c, o, data, spec.recv_rows, out=recv[j * spec.recv_rows : (j + 1) * spec.recv_rows])
        return recv, torch.from_numpy(np.ascontiguousarray(sizes.T))

    exchange.spec = spec
    return exchange


# ----------------------------------------------------------------------------
# Host-side planning helpers (used by the writer/transport and by tests)
# ----------------------------------------------------------------------------


def bucket_send_rows(send_rows: int, num_executors: int) -> int:
    """Round the per-peer slot capacity up to the next power of two and rescale
    to a full staging size (the JAX package's compile-cache bucketing; kept for
    parity — nothing recompiles here, so the port's own exchange does not
    bucket)."""
    if send_rows <= 0:
        raise ValueError("send_rows must be positive")
    slot = -(-send_rows // num_executors)
    bucket = 1
    while bucket < slot:
        bucket <<= 1
    return bucket * num_executors


def rebucket_slots(payload, num_executors: int, bucketed_rows: int):
    """Relocate a ``(send_rows, lane)`` slot-layout payload (numpy array or
    tensor) into a ``(bucketed_rows, lane)`` buffer: each peer's region moves to
    its new slot origin and zero rows fill the grown slot tails."""
    rows, lane = payload.shape
    if rows == bucketed_rows:
        return payload
    n = num_executors
    if rows % n or bucketed_rows % n or bucketed_rows < rows:
        raise ValueError(
            f"cannot rebucket {rows} rows to {bucketed_rows} over {n} executors "
            "(both must be executor multiples, and buckets only grow)"
        )
    grow = (bucketed_rows - rows) // n
    if isinstance(payload, torch.Tensor):
        grid = payload.reshape(n, rows // n, lane)
        padded = torch.nn.functional.pad(grid, (0, 0, 0, grow))
    else:
        grid = payload.reshape(n, rows // n, lane)
        padded = np.pad(grid, ((0, 0), (0, grow), (0, 0)))
    return padded.reshape(bucketed_rows, lane)


def pack_chunks_slots(
    chunks: Sequence[bytes],
    slot_rows: int,
    row_bytes: int = 512,
) -> Tuple[np.ndarray, np.ndarray]:
    """Pack per-peer byte chunks into a slot-layout staging buffer: chunk j
    starts at row ``j * slot_rows``, padded to a whole row with zeros.  Rows
    between the sized prefix and the slot end are left uninitialized.

    Returns ((n*slot_rows, row_bytes/4) int32 buffer, per-peer sizes in rows).
    """
    n = len(chunks)
    buf = np.empty(n * slot_rows * row_bytes, dtype=np.uint8)
    sizes = np.empty(n, dtype=np.int32)
    for j, chunk in enumerate(chunks):
        nbytes = len(chunk)
        rows = -(-nbytes // row_bytes)
        if rows > slot_rows:
            raise ValueError(f"chunk for peer {j} ({rows} rows) exceeds slot {slot_rows} rows")
        start = j * slot_rows * row_bytes
        buf[start : start + nbytes] = np.frombuffer(chunk, dtype=np.uint8)
        buf[start + nbytes : start + rows * row_bytes] = 0  # final-row tail only
        sizes[j] = rows
    return buf.view(np.int32).reshape(n * slot_rows, row_bytes // 4), sizes


def unpack_received(
    recv_shard_bytes: bytes, recv_sizes_row: np.ndarray, row_bytes: int = 512
) -> List[bytes]:
    """Split one receiver's tight sender-major buffer into per-sender chunks
    (row padding still attached)."""
    out: List[bytes] = []
    pos = 0
    for sz in recv_sizes_row:
        nbytes = int(sz) * row_bytes
        out.append(recv_shard_bytes[pos : pos + nbytes])
        pos += nbytes
    return out


def oracle_exchange(per_device_chunks: Sequence[Sequence[bytes]]) -> List[bytes]:
    """Reference: device j receives concat over senders i of chunk[i][j]
    (each chunk row-padded by the sender)."""
    n = len(per_device_chunks)
    return [b"".join(per_device_chunks[i][j] for i in range(n)) for j in range(n)]
