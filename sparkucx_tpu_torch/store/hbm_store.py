"""Device-staged shuffle block store — the NVKV/DPU-NVMe analogue.

Port of the core of ``sparkucx_tpu/store/hbm_store.py``.  Counterpart of
``NvkvHandler`` (NvkvHandler.scala): map output is staged in **per-peer
regions** — host staging bytes, or device tensors when
``conf.device_staging`` — and sealed into device memory in the exact slot
layout the exchange consumes, with a numMappers x numReducers offset table
(:258-265) exported per map task as a ``MapperInfo`` blob
(NvkvShuffleMapOutputWriter.scala:116-148).

Kept from the JAX store: peer-major append-only regions, ``block_alignment``
padding per block, first-commit-wins retries, multi-round rollover when a
region fills (completed rounds become host snapshots, moved to an
``np.memmap`` disk tier when ``conf.spill_to_disk``), device rounds placed by
the block-scatter kernel at seal, and ``read_block`` serving any round.
Popularity tracking, replicas, the serve cache, eviction tiers, memory
watermarks, tenants and shared-memory staging are not part of this port yet.

Device memory is a ``torch.Tensor`` of ``(rows, lane)`` int32 words, one row
per ``block_alignment`` bytes.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import threading
import weakref
from bisect import bisect_right
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sparkucx_tpu_torch.config import TpuShuffleConf
from sparkucx_tpu_torch.core.definitions import MapperInfo
from sparkucx_tpu_torch.core.operation import BlockNotFoundError, TransportError
from sparkucx_tpu_torch.ops.block_kernels import block_scatter, plan_tensors
from sparkucx_tpu_torch.utils.devices import normalize_device


def default_peer_ranges(num_reducers: int, num_peers: int) -> List[Tuple[int, int]]:
    """Contiguous reducer ownership: peer p owns [start, end), balanced like
    Spark's range partitioning of reduce ids over executors."""
    base, rem = divmod(num_reducers, num_peers)
    ranges = []
    start = 0
    for p in range(num_peers):
        n = base + (1 if p < rem else 0)
        ranges.append((start, start + n))
        start += n
    return ranges


def _purge_spill_dir(holder: Dict[str, Optional[str]]) -> None:
    """Remove a store's private spill tempdir (module-level so the store's
    ``weakref.finalize`` holds no reference to the store)."""
    path = holder.get("dir")
    if path is not None:
        shutil.rmtree(path, ignore_errors=True)
        holder["dir"] = None


def tensor_bytes(payload: torch.Tensor, offset: int, length: int) -> bytes:
    """Bytes ``[offset, offset + length)`` of a row tensor, copying only the
    rows that hold them off the device."""
    row_bytes = payload.shape[1] * payload.element_size()
    r0 = offset // row_bytes
    r1 = -(-(offset + length) // row_bytes)
    rows = payload[r0:r1].cpu().numpy()
    skip = offset - r0 * row_bytes
    return rows.reshape(-1).view(np.uint8)[skip : skip + length].tobytes()


@dataclass
class _BlockEntry:
    offset: int  # absolute offset in the staging buffer (of its round)
    length: int  # true payload bytes
    padded: int  # bytes including alignment padding
    round: int = 0  # staging round (multi-round spill; round 0 = common case)


class _ShuffleState:
    def __init__(
        self,
        shuffle_id: int,
        num_mappers: int,
        num_reducers: int,
        peer_ranges: List[Tuple[int, int]],
        capacity: int,
        alignment: int,
    ) -> None:
        self.shuffle_id = shuffle_id
        self.num_mappers = num_mappers
        self.num_reducers = num_reducers
        self.peer_ranges = peer_ranges
        self.alignment = alignment
        n = len(peer_ranges)
        self.region_size = (capacity // n) // alignment * alignment
        if self.region_size <= 0:
            raise ValueError(f"staging capacity {capacity} too small for {n} regions")
        self._staging: Optional[np.ndarray] = None  # allocated on first host-path touch
        #: Write-path mode latch: None until the first partition lands, then
        #: False (host MapWriter.write) or True (write_partition_device).
        self.device_mode: Optional[bool] = None
        #: Current device round: (dst_row, rows, tensor) in append order, and
        #: per-block tensors serving reads of the not-yet-sealed round.
        self.device_pending: List[Tuple[int, int, torch.Tensor]] = []
        self.device_blocks: Dict[Tuple[int, int], torch.Tensor] = {}
        #: Completed rounds: (uint8 staging snapshot or memmap, region_used).
        self.round = 0
        self.prev_rounds: List[Tuple[np.ndarray, np.ndarray]] = []
        self.spill_files: List[Tuple[str, int]] = []
        self.region_used = np.zeros(n, dtype=np.int64)
        self.blocks: Dict[Tuple[int, int], _BlockEntry] = {}  # (map, reduce) -> entry
        self.committed_maps: set = set()
        self.sealed_payload: Optional[List[torch.Tensor]] = None
        self._range_starts = [r[0] for r in peer_ranges]

    @property
    def staging(self) -> np.ndarray:
        """Host staging buffer, allocated on first touch — device-staged
        shuffles never allocate it."""
        if self._staging is None:
            self._staging = np.zeros(len(self.peer_ranges) * self.region_size, dtype=np.uint8)
        return self._staging

    @staging.setter
    def staging(self, value: Optional[np.ndarray]) -> None:
        self._staging = value

    @property
    def host_staging_allocated(self) -> bool:
        return self._staging is not None

    def owner_of(self, reduce_id: int) -> int:
        if not (0 <= reduce_id < self.num_reducers):
            raise ValueError(f"reduce_id {reduce_id} out of range [0, {self.num_reducers})")
        return bisect_right(self._range_starts, reduce_id) - 1

    @property
    def sealed(self) -> bool:
        return self.sealed_payload is not None


class MapWriter:
    """Sequential per-map partition writer handle
    (``NvkvShufflePartitionWriter``/``PartitionWriterStream`` protocol:
    partitions in increasing reduce order, NvkvShuffleMapOutputWriter.scala:108).

    Streamed bytes buffer writer-locally and the region allocate + copy +
    table record happen atomically at close, so map tasks can write
    concurrently and a rollover never interleaves a half-written partition."""

    def __init__(
        self, store: "HbmBlockStore", state: _ShuffleState, map_id: int, discard: bool = False
    ) -> None:
        self._store = store
        self._state = state
        self.map_id = map_id
        self._last_reduce = -1
        self._open_reduce: Optional[int] = None
        self._chunks: List[bytes] = []
        self._written = 0
        #: First-commit-wins task-retry semantics
        #: (IndexShuffleBlockResolver.scala:161-217): a retry attempt's writes
        #: are swallowed and commit() returns the first attempt's table.
        self._discard = discard

    def open_partition(self, reduce_id: int) -> None:
        if self._open_reduce is not None:
            raise TransportError("previous partition still open")
        if reduce_id <= self._last_reduce:
            raise TransportError(
                f"partitions must be opened in increasing reduce order "
                f"(got {reduce_id} after {self._last_reduce})"
            )
        self._state.owner_of(reduce_id)  # validate range
        self._open_reduce = reduce_id
        self._chunks = []
        self._written = 0

    def write(self, data: bytes) -> None:
        if self._open_reduce is None:
            raise TransportError("no open partition")
        if self._written + len(data) > self._state.region_size and not self._discard:
            raise TransportError(
                f"single partition ({self.map_id},{self._open_reduce}) exceeds a "
                f"whole region ({self._state.region_size} B) — raise stagingCapacity"
            )
        if not self._discard:
            self._chunks.append(bytes(data))
        self._written += len(data)

    def close_partition(self) -> None:
        if self._open_reduce is None:
            raise TransportError("no open partition")
        st = self._state
        reduce_id = self._open_reduce
        peer = st.owner_of(reduce_id)
        if not self._discard:
            padded = -(-self._written // st.alignment) * st.alignment
            with self._store._lock:
                if st.device_mode:
                    raise TransportError(
                        f"shuffle {st.shuffle_id} already has device-staged rounds — "
                        "host and device writes cannot mix"
                    )
                st.device_mode = False
                if int(st.region_used[peer]) + padded > st.region_size:
                    self._store._rollover(st)
                start = peer * st.region_size + int(st.region_used[peer])
                pos = start
                for chunk in self._chunks:
                    st.staging[pos : pos + len(chunk)] = np.frombuffer(chunk, dtype=np.uint8)
                    pos += len(chunk)
                st.blocks[(self.map_id, reduce_id)] = _BlockEntry(
                    offset=start, length=self._written, padded=padded, round=st.round
                )
                st.region_used[peer] += padded
        self._last_reduce = reduce_id
        self._open_reduce = None
        self._chunks = []

    def write_partition(self, reduce_id: int, data: bytes) -> None:
        """Convenience: open + write + close in one call."""
        self.open_partition(reduce_id)
        if data:
            self.write(data)
        self.close_partition()

    def write_partition_device(
        self, reduce_id: int, rows: torch.Tensor, length: Optional[int] = None
    ) -> None:
        """Device-path partition write (conf.device_staging): ``rows`` is a
        ``(r, lane)`` int32 tensor on the store's device, one row per
        ``alignment`` bytes.  It stays there until the block-scatter kernel
        places the whole round into device staging at seal (or at rollover,
        where the completed round is copied to the host).  Same protocol and
        offset table as the host path.  ``length`` is the true payload byte
        count when the last row is padding-tailed (defaults to all rows)."""
        if self._open_reduce is not None:
            raise TransportError("previous partition still open")
        if reduce_id <= self._last_reduce:
            raise TransportError(
                f"partitions must be opened in increasing reduce order "
                f"(got {reduce_id} after {self._last_reduce})"
            )
        st = self._state
        peer = st.owner_of(reduce_id)
        lane = st.alignment // 4
        if (
            not isinstance(rows, torch.Tensor)
            or rows.dim() != 2
            or rows.shape[1] != lane
            or rows.dtype != torch.int32
        ):
            raise TransportError(
                f"device partition must be a (rows, {lane}) int32 tensor, got "
                f"{getattr(rows, 'shape', None)} {getattr(rows, 'dtype', type(rows).__name__)}"
            )
        store_dev = self._store.device
        if store_dev is not None and normalize_device(rows.device) != store_dev:
            raise TransportError(
                f"device partition is on {rows.device}, the store stages on {store_dev}"
            )
        nrows = int(rows.shape[0])
        padded = nrows * st.alignment
        if length is None:
            length = padded
        min_len = (nrows - 1) * st.alignment + 1 if nrows else 0
        if not (min_len <= length <= padded):
            raise TransportError(
                f"length {length} inconsistent with {nrows} staged rows of "
                f"{st.alignment} B each"
            )
        if not self._discard:
            if padded > st.region_size:
                raise TransportError(
                    f"single partition ({self.map_id},{reduce_id}) exceeds a "
                    f"whole region ({st.region_size} B) — raise stagingCapacity"
                )
            with self._store._lock:
                if st.device_mode is False:
                    raise TransportError(
                        f"shuffle {st.shuffle_id} already has host-staged blocks — "
                        "host and device writes cannot mix"
                    )
                st.device_mode = True
                if int(st.region_used[peer]) + padded > st.region_size:
                    self._store._rollover_device(st)
                start = peer * st.region_size + int(st.region_used[peer])
                if nrows:
                    st.device_pending.append((start // st.alignment, nrows, rows))
                    st.device_blocks[(self.map_id, reduce_id)] = rows
                st.blocks[(self.map_id, reduce_id)] = _BlockEntry(
                    offset=start, length=length, padded=padded, round=st.round
                )
                st.region_used[peer] += padded
        self._last_reduce = reduce_id

    def commit(self) -> MapperInfo:
        """Commit this map task's outputs — the ``commitAllPartitions`` packing
        (NvkvShuffleMapOutputWriter.scala:116-148).  A retry attempt (discard
        mode) returns the FIRST successful attempt's table."""
        if self._open_reduce is not None:
            raise TransportError("commit with open partition")
        st = self._state
        with self._store._lock:
            st.committed_maps.add(self.map_id)
        return self._store.mapper_info(st.shuffle_id, self.map_id)

    @property
    def is_retry_discard(self) -> bool:
        return self._discard


class HbmBlockStore:
    """Per-executor staged shuffle store.  See module docstring.

    ``device`` is where sealed rounds live (None: host rounds seal as CPU
    tensors and device rounds stay on their blocks' device)."""

    def __init__(
        self, conf: Optional[TpuShuffleConf] = None, device=None, executor_id: int = 0
    ) -> None:
        self.conf = conf or TpuShuffleConf()
        self.device = normalize_device(device) if device is not None else None
        self.executor_id = executor_id
        self._shuffles: Dict[int, _ShuffleState] = {}  #: guarded by self._lock
        # Commits that raced ahead of create_shuffle; applied at creation.
        self._pending_infos: Dict[int, List[MapperInfo]] = {}  #: guarded by self._lock
        self._lock = threading.RLock()
        self._spill_holder: Dict[str, Optional[str]] = {"dir": None}  #: guarded by self._lock
        self._spill_finalizer = weakref.finalize(self, _purge_spill_dir, self._spill_holder)
        self._spill_bytes = 0  #: guarded by self._lock

    # -- lifecycle ---------------------------------------------------------

    def create_shuffle(
        self,
        shuffle_id: int,
        num_mappers: int,
        num_reducers: int,
        peer_ranges: Optional[Sequence[Tuple[int, int]]] = None,
        capacity: Optional[int] = None,
    ) -> None:
        with self._lock:
            if shuffle_id in self._shuffles:
                raise TransportError(f"shuffle {shuffle_id} already exists")
            ranges = (
                list(peer_ranges)
                if peer_ranges is not None
                else default_peer_ranges(num_reducers, 1)
            )
            cap = capacity if capacity is not None else self.conf.staging_capacity_per_executor
            self._shuffles[shuffle_id] = _ShuffleState(
                shuffle_id, num_mappers, num_reducers, ranges, cap, self.conf.block_alignment
            )
            pending = self._pending_infos.pop(shuffle_id, [])
        for info in pending:
            self.apply_mapper_info(info)

    def remove_shuffle(self, shuffle_id: int) -> None:
        """unregisterShuffle analogue (UcxShuffleTransport.scala:249-259)."""
        with self._lock:
            st = self._shuffles.pop(shuffle_id, None)
            if st is not None:
                self._release_spill(st)

    def close(self) -> None:
        with self._lock:
            states, self._shuffles = list(self._shuffles.values()), {}
            for st in states:
                self._release_spill(st)
            _purge_spill_dir(self._spill_holder)
            self._spill_bytes = 0

    def _state(self, shuffle_id: int) -> _ShuffleState:
        with self._lock:
            st = self._shuffles.get(shuffle_id)
        if st is None:
            raise TransportError(f"unknown shuffle {shuffle_id}")
        return st

    # -- rounds ------------------------------------------------------------

    def _rollover(self, st: _ShuffleState) -> None:
        """Snapshot the current host staging round and start a fresh one
        (caller holds self._lock).  With ``conf.spill_to_disk`` the completed
        round moves to an ``np.memmap`` file and its RAM is released."""
        snap = st.staging
        if self.conf.spill_to_disk:
            snap = self._spill_round(st, snap)
        st.prev_rounds.append((snap, st.region_used))
        st.staging = np.zeros_like(st.staging)
        st.region_used = np.zeros_like(st.region_used)
        st.round += 1

    def _rollover_device(self, st: _ShuffleState) -> None:
        """Device-round rollover: place the full round with the scatter kernel,
        copy it to the host once as the round snapshot (the one point where a
        host copy is unavoidable — the device cannot hold every round), and
        continue in a fresh device round (caller holds self._lock)."""
        payload = self._materialize_device_round(st)
        snap = payload.cpu().numpy().reshape(-1).view(np.uint8)
        if self.conf.spill_to_disk:
            snap = self._spill_round(st, snap)
        st.prev_rounds.append((snap, st.region_used))
        st.region_used = np.zeros_like(st.region_used)
        st.device_pending = []
        st.device_blocks = {}
        st.round += 1

    def _spill_round(self, st: _ShuffleState, staging: np.ndarray) -> np.ndarray:
        """Write the live round's staging to the disk tier; returns the memmap
        that replaces the RAM snapshot (caller holds self._lock).  Only each
        region's used prefix is written — the rest stays a sparse hole."""
        if self._spill_holder["dir"] is None:
            if self.conf.spill_dir is not None:
                os.makedirs(self.conf.spill_dir, exist_ok=True)
            self._spill_holder["dir"] = tempfile.mkdtemp(
                prefix=f"sparkucx_tpu_torch_spill_e{self.executor_id}_",
                dir=self.conf.spill_dir,
            )
        cap = self.conf.spill_disk_cap_bytes
        nbytes = int(st.region_used.sum())
        if cap and self._spill_bytes + nbytes > cap:
            raise TransportError(
                f"disk spill cap exceeded: {self._spill_bytes} B spilled + "
                f"{nbytes} B round > spillDiskCap {cap} B"
            )
        path = os.path.join(self._spill_holder["dir"], f"s{st.shuffle_id}_r{st.round}.bin")
        mm = np.memmap(path, dtype=np.uint8, mode="w+", shape=staging.shape)
        for p in range(len(st.peer_ranges)):
            used = int(st.region_used[p])
            if used:
                start = p * st.region_size
                mm[start : start + used] = staging[start : start + used]
        mm.flush()
        st.spill_files.append((path, nbytes))
        self._spill_bytes += nbytes
        return mm

    def _release_spill(self, st: _ShuffleState) -> None:
        """Unlink a removed shuffle's spill files (caller holds self._lock).
        Open memmaps stay readable after unlink."""
        for path, nbytes in st.spill_files:
            self._spill_bytes -= nbytes
            try:
                os.unlink(path)
            except OSError:
                pass
        st.spill_files = []

    def _materialize_device_round(self, st: _ShuffleState) -> torch.Tensor:
        """Place the current device round's pending blocks into one zeroed
        slot-layout ``(total_rows, lane)`` tensor with the block-scatter kernel
        (caller holds self._lock).  No host byte moves."""
        lane = st.alignment // 4
        total_rows = len(st.peer_ranges) * (st.region_size // st.alignment)
        pending = st.device_pending
        device = self.device
        if device is None:
            device = pending[0][2].device if pending else torch.device("cpu")
        dst = torch.zeros((total_rows, lane), dtype=torch.int32, device=device)
        if not pending:
            return dst
        starts = np.asarray([p[0] for p in pending], dtype=np.int32)
        counts = np.asarray([p[1] for p in pending], dtype=np.int32)
        outs = (np.cumsum(counts) - counts).astype(np.int32)
        blocks = [p[2] for p in pending]
        packed = (blocks[0] if len(blocks) == 1 else torch.cat(blocks)).contiguous()
        s, c, o = plan_tensors(starts, counts, outs, device)
        return block_scatter(s, c, o, packed, dst)

    # -- write path --------------------------------------------------------

    def map_writer(self, shuffle_id: int, map_id: int) -> MapWriter:
        st = self._state(shuffle_id)
        if st.sealed:
            raise TransportError(f"shuffle {shuffle_id} already sealed")
        if not (0 <= map_id < st.num_mappers):
            raise ValueError(f"map_id {map_id} out of range [0, {st.num_mappers})")
        with self._lock:
            discard = map_id in st.committed_maps  # first commit wins (task retry)
        return MapWriter(self, st, map_id, discard=discard)

    def apply_mapper_info(self, info: MapperInfo) -> None:
        """Install commit metadata received from a peer (AM id 2 inbound).
        Commits for a shuffle not created yet are applied at creation."""
        with self._lock:
            if info.shuffle_id not in self._shuffles:
                self._pending_infos.setdefault(info.shuffle_id, []).append(info)
                return
        st = self._state(info.shuffle_id)
        with self._lock:
            for r, (off, ln) in enumerate(info.partitions):
                if ln:
                    padded = -(-ln // st.alignment) * st.alignment
                    st.blocks[(info.map_id, r)] = _BlockEntry(off, ln, padded, info.round_of(r))
            st.committed_maps.add(info.map_id)

    # -- seal + exchange hand-off -----------------------------------------

    def seal(self, shuffle_id: int) -> List[Tuple[torch.Tensor, np.ndarray]]:
        """Freeze the staging area.  Returns one ``(payload, send_sizes)`` per
        staging round: ``payload`` is the round's slot-layout ``(total_rows,
        lane)`` int32 tensor and ``send_sizes[p]`` the used rows of peer p's
        region (the round's size-matrix row).

        Completed rounds stay host-resident (zero-copy CPU tensors over their
        snapshots or memmaps) — the exchange uploads them one round at a time.
        A single host round is copied to ``self.device``; a device round seals
        as the scatter kernel's output, with no host copy at all.  Sealed
        payloads stay valid until ``remove_shuffle``."""
        st = self._state(shuffle_id)
        with self._lock:
            if st.sealed:
                raise TransportError(f"shuffle {shuffle_id} already sealed")
            lane = st.alignment // 4
            out = []
            for staging, used in st.prev_rounds:
                payload = torch.from_numpy(staging.view(np.int32).reshape(-1, lane))
                out.append((payload, (used // st.alignment).astype(np.int32)))
            final_sizes = (st.region_used // st.alignment).astype(np.int32)
            if st.device_mode:
                payload = self._materialize_device_round(st)
            else:
                payload = torch.from_numpy(st.staging.view(np.int32).reshape(-1, lane))
                if self.device is not None and not st.prev_rounds:
                    payload = payload.to(self.device)
            out.append((payload, final_sizes))
            st.sealed_payload = [p for p, _ in out]
        return out

    def num_rounds(self, shuffle_id: int) -> int:
        return self._state(shuffle_id).round + 1

    def region_bytes(self, shuffle_id: int) -> int:
        """Per-peer region size in bytes (the transports' offset math)."""
        return self._state(shuffle_id).region_size

    def host_staging_allocated(self, shuffle_id: int) -> bool:
        """False for device-staged shuffles: their host staging buffer is
        never allocated (rollover snapshots live in the spill tier)."""
        return self._state(shuffle_id).host_staging_allocated

    def mapper_info(self, shuffle_id: int, map_id: int) -> MapperInfo:
        """A committed map's MapperInfo, rebuilt from the offset table."""
        st = self._state(shuffle_id)
        with self._lock:
            if map_id not in st.committed_maps:
                raise TransportError(f"map {map_id} not committed in shuffle {shuffle_id}")
            parts, rounds = [], []
            for r in range(st.num_reducers):
                e = st.blocks.get((map_id, r))
                parts.append((e.offset, e.length) if e is not None else (0, 0))
                rounds.append(e.round if e is not None else 0)
        return MapperInfo(
            shuffle_id, map_id, tuple(parts), tuple(rounds) if any(rounds) else None
        )

    # -- read path (serve staged blocks) ----------------------------------

    def read_block(self, shuffle_id: int, map_id: int, reduce_id: int) -> bytes:
        """Direct block read — the sealed round after seal, staging before
        (UcxShuffleBlockResolver.getBlockData, compat/spark_3_0/
        UcxShuffleBlockResolver.scala:86-97).  The pull-fallback/retry path."""
        with self._lock:
            st = self._shuffles.get(shuffle_id)
        e = st.blocks.get((map_id, reduce_id)) if st is not None else None
        if e is None:
            if st is None:
                raise TransportError(f"unknown shuffle {shuffle_id}")
            raise BlockNotFoundError(shuffle_id, map_id, reduce_id, "not staged")
        if e.length == 0:
            return b""
        with self._lock:
            if st.sealed:
                return tensor_bytes(st.sealed_payload[e.round], e.offset, e.length)
            if e.round < len(st.prev_rounds):
                staging = st.prev_rounds[e.round][0]
            elif st.device_mode:
                rows = st.device_blocks.get((map_id, reduce_id))
                if rows is None:
                    raise TransportError(
                        f"device block ({shuffle_id},{map_id},{reduce_id}) no longer resident"
                    )
                return tensor_bytes(rows, 0, e.length)
            else:
                staging = st.staging
            return staging[e.offset : e.offset + e.length].tobytes()

    def block_length(self, shuffle_id: int, map_id: int, reduce_id: int) -> int:
        """getPartitonLength analogue (NvkvHandler.scala:258-265)."""
        e = self._state(shuffle_id).blocks.get((map_id, reduce_id))
        return e.length if e is not None else 0

    def block_offset(self, shuffle_id: int, map_id: int, reduce_id: int) -> int:
        """getPartitonOffset analogue."""
        e = self._state(shuffle_id).blocks.get((map_id, reduce_id))
        if e is None:
            raise TransportError(f"no block ({shuffle_id},{map_id},{reduce_id}) staged")
        return e.offset

    # -- introspection -----------------------------------------------------

    def stats(self, shuffle_id: int) -> Dict[str, object]:
        st = self._state(shuffle_id)
        with self._lock:
            return {
                "num_blocks": len(st.blocks),
                "bytes_staged": int(sum(e.length for e in st.blocks.values())),
                "bytes_padded": int(sum(e.padded for e in st.blocks.values())),
                "region_used": st.region_used.tolist(),
                "region_size": st.region_size,
                "rounds": st.round + 1,
                "committed_maps": sorted(st.committed_maps),
                "sealed": st.sealed,
                "device_mode": st.device_mode,
                "host_staging_allocated": st.host_staging_allocated,
            }
