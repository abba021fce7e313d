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

The serving hooks the peer wire plane (transport/peer.py) calls are ported
too: ``BlockPopularity`` (per-block fetch rates), the serve cache
(``serve_cache_get``/``serve_cache_offer`` over service/eviction.py
``ServeCache``), the replica tier (``put_replica``, ``replica_view``,
``replica_block``, ``replica_source``, ``replica_stats``), the ``on_seal``
hook, and ``block_staging_view``.  A block whose bytes lie on the device (a
device-staged round) is handed out as ``DeviceRows`` by
``block_device_rows`` so that a server packs a whole batch of them with one
block-gather launch and copies it to the host once (``land_device_rows``).
Eviction tiers, memory watermarks, tenants and shared-memory staging are not
part of this port yet.

Device memory is a ``torch.Tensor`` of ``(rows, lane)`` int32 words, one row
per ``block_alignment`` bytes.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import threading
import time
import weakref
from bisect import bisect_right
from dataclasses import dataclass
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from sparkucx_tpu_torch.config import TpuShuffleConf
from sparkucx_tpu_torch.core.definitions import MapperInfo
from sparkucx_tpu_torch.core.operation import BlockNotFoundError, TransportError
from sparkucx_tpu_torch.ops.block_kernels import block_gather, block_scatter, plan_tensors
from sparkucx_tpu_torch.service.eviction import ServeCache
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


class DeviceRows(NamedTuple):
    """A block whose bytes lie in device memory: ``rows`` rows of ``src``
    from row ``start``, the first ``length`` bytes of them its payload.
    ``round_buffer`` is True when ``src`` holds a whole round (a sealed
    round, the block-scatter kernel's output, or a received shard kept on
    the card), False when it is the block's own tensor (a round not sealed
    yet)."""

    src: torch.Tensor
    start: int
    rows: int
    length: int
    round_buffer: bool


def land_device_rows(items: Sequence[DeviceRows]) -> List[Tuple[np.ndarray, int, int]]:
    """Host ``(uint8 array, offset, length)`` serving handles of
    device-resident blocks, landed together: the blocks of one round buffer
    are packed by one block-gather launch, blocks that are tensors of their
    own (a round not sealed yet) by one concatenation, and all of it comes to
    page-locked host memory in one copy (:func:`rows_to_host`).  The arrays
    keep that buffer alive for as long as any handle is held."""
    out: List[Tuple[np.ndarray, int, int]] = [(np.empty(0, dtype=np.uint8), 0, 0)] * len(items)
    rounds: Dict[int, List[int]] = {}
    loose: List[int] = []
    for i, d in enumerate(items):
        if d.rows:
            if d.round_buffer:
                rounds.setdefault(id(d.src), []).append(i)
            else:
                loose.append(i)
    segments: List[torch.Tensor] = []
    where: Dict[int, int] = {}
    base = 0
    for idxs in rounds.values():
        counts = np.asarray([items[i].rows for i in idxs], dtype=np.int32)
        outs = (np.cumsum(counts) - counts).astype(np.int32)
        src = items[idxs[0]].src
        s, c, o = plan_tensors([items[i].start for i in idxs], counts, outs, src.device)
        segments.append(block_gather(s, c, o, src, int(counts.sum())))
        for i, row in zip(idxs, outs.tolist()):
            where[i] = base + row
        base += int(counts.sum())
    for i in loose:
        segments.append(items[i].src[items[i].start : items[i].start + items[i].rows])
        where[i] = base
        base += items[i].rows
    if segments:
        packed = segments[0] if len(segments) == 1 else torch.cat(segments)
        flat = rows_to_host(packed)
        row_bytes = packed.shape[1] * packed.element_size()
        for i, row in where.items():
            out[i] = (flat, row * row_bytes, items[i].length)
    return out


def rows_to_host(rows: torch.Tensor) -> np.ndarray:
    """A device row tensor's bytes on the host as one flat uint8 view: one
    copy into page-locked memory on the calling thread's current stream,
    waited for through its event (a reader of the view never sees the buffer
    before the copy lands).  A CPU tensor is viewed as it is."""
    if rows.device.type != "cuda":
        return rows.numpy().reshape(-1).view(np.uint8)
    host = torch.empty(rows.shape, dtype=rows.dtype, pin_memory=True)
    host.copy_(rows, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(rows.device))
    done.synchronize()
    return host.numpy().reshape(-1).view(np.uint8)


@dataclass
class _BlockEntry:
    offset: int  # absolute offset in the staging buffer (of its round)
    length: int  # true payload bytes
    padded: int  # bytes including alignment padding
    round: int = 0  # staging round (multi-round spill; round 0 = common case)
    #: False for entries installed from a peer's MapperInfo — their offsets are
    #: sender-relative, so the bytes live on the SENDER, not in local staging.
    #: The replicator only pushes local entries.
    local: bool = True


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


class _BlockRate:
    """One block's fetch-rate state (all fields guarded by the owning
    tracker's ``_lock``)."""

    __slots__ = ("ewma", "last_ns", "hot")

    def __init__(self, now_ns: int) -> None:
        self.ewma = 0.0  # fetches/sec EWMA of instantaneous 1/dt rates
        self.last_ns = now_ns
        self.hot = False


class BlockPopularity:
    """Per-block fetch-rate EWMAs driving the popularity-aware serving tier.

    The same EWMA shape as the transport's ``_PeerHealth`` latency tracker,
    pointed at demand instead of health: every served fetch folds its
    instantaneous rate (``1e9 / dt_ns`` since the block's previous fetch)
    into a per-block EWMA.  A block whose rate crosses
    ``serve.hotThresholdFetchesPerSec`` is *hot*; the serving plane reacts at
    shuffle granularity (replication pushes whole sealed rounds), so
    :meth:`observe` reports shuffle-level transitions — the first block of a
    shuffle to heat up promotes the shuffle, and the shuffle demotes only
    when :meth:`sweep` finds every one of its blocks cooled below HALF the
    threshold (hysteresis: the promote and demote edges never chatter on a
    rate hovering at the threshold).  Cooling is rate-decay aware: a block
    that simply stops being fetched demotes once ``1e9 / elapsed_ns`` falls
    under the demote edge, even though no new sample ever arrives.

    ``now_ns`` is injectable for deterministic tests.  ``_lock`` is a LEAF:
    no calls out while held (the lock-order pass pins this via
    LOCK_ATTR_CLASSES).
    """

    #: demote edge = threshold * _COOL_FRACTION (hysteresis band)
    _COOL_FRACTION = 0.5
    #: cold entries idle this long are forgotten (memory bound)
    _IDLE_GC_NS = 60 * 1_000_000_000

    def __init__(
        self,
        hot_threshold_per_sec: float,
        alpha: float = 0.25,
        now_ns: Optional[Callable[[], int]] = None,
    ) -> None:
        self.hot_threshold = float(hot_threshold_per_sec)
        self.alpha = float(alpha)
        self._now_ns = now_ns if now_ns is not None else time.monotonic_ns
        self._rates: Dict[Tuple[int, int, int], _BlockRate] = {}  #: guarded by self._lock
        self._hot_counts: Dict[int, int] = {}  #: shuffle -> hot-block count; guarded by self._lock
        self.stats: Dict[str, int] = {"promotions": 0, "demotions": 0}  #: guarded by self._lock
        self._last_sweep_ns = 0  #: guarded by self._lock
        self._lock = threading.Lock()  # LEAF: no calls out while held

    def observe(
        self, shuffle_id: int, map_id: int, reduce_id: int
    ) -> Tuple[bool, List[Tuple[int, bool]]]:
        """Fold one served fetch into the block's EWMA.  Returns
        ``(block_is_hot, [(shuffle_id, True)] when this fetch promoted the
        shuffle)`` — the serving plane widens the shuffle's replica set on
        that transition and admits the block to the serve cache while hot."""
        if self.hot_threshold <= 0:
            return False, []
        now = self._now_ns()
        key = (shuffle_id, map_id, reduce_id)
        with self._lock:
            r = self._rates.get(key)
            if r is None:
                self._rates[key] = _BlockRate(now)
                return False, []
            dt = max(now - r.last_ns, 1)
            r.last_ns = now
            r.ewma = self.alpha * (1e9 / dt) + (1.0 - self.alpha) * r.ewma
            transitions: List[Tuple[int, bool]] = []
            if not r.hot and r.ewma >= self.hot_threshold:
                r.hot = True
                self.stats["promotions"] += 1
                n = self._hot_counts.get(shuffle_id, 0)
                self._hot_counts[shuffle_id] = n + 1
                if n == 0:
                    transitions.append((shuffle_id, True))
            return r.hot, transitions

    def sweep(self, now_ns: Optional[int] = None) -> List[Tuple[int, bool]]:
        """Cool-down pass: demote hot blocks whose effective rate —
        ``min(ewma, 1e9 / elapsed_ns)``, so silence decays the rate — fell
        below the demote edge, and forget long-idle cold blocks.  Returns
        ``[(shuffle_id, False)]`` for every shuffle whose LAST hot block
        cooled (the serving plane drops the widened advertisement then)."""
        now = self._now_ns() if now_ns is None else now_ns
        cool_edge = self.hot_threshold * self._COOL_FRACTION
        transitions: List[Tuple[int, bool]] = []
        with self._lock:
            for key, r in list(self._rates.items()):
                elapsed = max(now - r.last_ns, 1)
                effective = min(r.ewma, 1e9 / elapsed)
                if r.hot:
                    if effective < cool_edge:
                        r.hot = False
                        r.ewma = effective
                        self.stats["demotions"] += 1
                        n = self._hot_counts.get(key[0], 1) - 1
                        if n <= 0:
                            self._hot_counts.pop(key[0], None)
                            transitions.append((key[0], False))
                        else:
                            self._hot_counts[key[0]] = n
                elif elapsed > self._IDLE_GC_NS:
                    del self._rates[key]
        return transitions

    def maybe_sweep(
        self, min_interval_ns: int = 1_000_000_000
    ) -> List[Tuple[int, bool]]:
        """Rate-limited :meth:`sweep`, safe to call on every served batch:
        at most one cool-down pass per ``min_interval_ns`` actually scans."""
        if self.hot_threshold <= 0:
            return []
        now = self._now_ns()
        with self._lock:
            if now - self._last_sweep_ns < min_interval_ns:
                return []
            self._last_sweep_ns = now
        return self.sweep(now)

    def is_hot(self, shuffle_id: int) -> bool:
        with self._lock:
            return self._hot_counts.get(shuffle_id, 0) > 0

    def hot_shuffles(self) -> List[int]:
        with self._lock:
            return sorted(self._hot_counts)

    def snapshot(self) -> Dict[str, int]:
        """Counter snapshot for MetricsRegistry export (``serve`` family)."""
        with self._lock:
            return {
                "promotions": self.stats["promotions"],
                "demotions": self.stats["demotions"],
                "tracked_blocks": len(self._rates),
                "hot_blocks": sum(self._hot_counts.values()),
                "hot_shuffles": len(self._hot_counts),
            }


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
        #: Bounded serve-side decoded-block cache (popularity tier).  None when
        #: serve.cacheBytes is 0 (default): the off path allocates nothing.
        self.serve_cache: Optional[ServeCache] = (
            ServeCache(self.conf.serve_cache_bytes) if self.conf.serve_cache_bytes > 0 else None
        )
        #: Neighbor-replication tier (REPLICA_PUT landing zone):
        #: (shuffle_id, src_executor) -> round -> ((map, reduce) -> (offset,
        #: length) index, contiguous body array).
        self._replicas: Dict[Tuple[int, int], Dict[int, Tuple[Dict[Tuple[int, int], Tuple[int, int]], np.ndarray]]] = {}  #: guarded by self._lock
        self._replica_bytes = 0  #: guarded by self._lock
        #: Post-seal hook (PeerTransport installs its replication push here),
        #: invoked by seal() after the store lock is released.
        self.on_seal: Optional[Callable[[int], None]] = None

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
            for key in [k for k in self._replicas if k[0] == shuffle_id]:
                for _index, arr in self._replicas[key].values():
                    self._replica_bytes -= int(arr.size)
                del self._replicas[key]
        # the cache lock is a leaf, never nested under self._lock
        if self.serve_cache is not None:
            self.serve_cache.invalidate_shuffle(shuffle_id)

    def close(self) -> None:
        with self._lock:
            states, self._shuffles = list(self._shuffles.values()), {}
            self._replicas.clear()
            self._replica_bytes = 0
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
                    st.blocks[(info.map_id, r)] = _BlockEntry(off, ln, padded, info.round_of(r), local=False)
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
        # replication hook, outside the lock: the sealed rounds are immutable now
        cb = self.on_seal
        if cb is not None:
            cb(shuffle_id)
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
            # replica tier: a ring neighbor's pushed copy serves even for a
            # shuffle this executor never created locally (failover serving)
            replica = self.replica_view(shuffle_id, map_id, reduce_id)
            if replica is not None:
                arr, off, ln = replica
                return arr[off : off + ln].tobytes()
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

    # -- serving hooks (transport/peer.py) ---------------------------------

    def block_device_rows(self, shuffle_id: int, map_id: int, reduce_id: int) -> Optional[DeviceRows]:
        """Where a locally staged block's bytes lie when they lie in device
        memory — the device-staged round, sealed (rows of the block-scatter
        kernel's output) or not (the block's own tensor) — else None.  A
        server lands a batch of these with :func:`land_device_rows`."""
        st = self._state(shuffle_id)
        e = st.blocks.get((map_id, reduce_id))
        if e is None or not e.local:
            return None
        with self._lock:
            return self._device_rows_locked(st, e, map_id, reduce_id)

    def _device_rows_locked(self, st: _ShuffleState, e: _BlockEntry, map_id: int, reduce_id: int) -> Optional[DeviceRows]:
        """Caller holds self._lock.  None off the device round, and for a
        committed empty block of it: ``write_partition_device`` keeps no
        tensor for one, so it is answered as missing, as in the JAX store."""
        rows = -(-e.length // st.alignment)
        if e.round < len(st.prev_rounds) or not st.device_mode or not rows:
            return None
        if st.sealed:
            return DeviceRows(st.sealed_payload[e.round], e.offset // st.alignment, rows, e.length, True)
        block = st.device_blocks.get((map_id, reduce_id))
        return None if block is None else DeviceRows(block, 0, rows, e.length, False)

    def block_staging_view(
        self, shuffle_id: int, map_id: int, reduce_id: int
    ) -> Optional[Tuple[np.ndarray, int, int]]:
        """Zero-copy serving handle: (host staging uint8 array, offset, length)
        for a staged block, or None when unknown.  Host staging is append-only
        and retained until ``remove_shuffle``, so the view stays valid for the
        shuffle's lifetime.  A block of the device-staged round has no host
        staging: it comes back as a private host copy of its rows, as from the
        JAX store (servers land such blocks a batch at a time through
        ``block_device_rows`` and never reach this arm)."""
        st = self._state(shuffle_id)
        e = st.blocks.get((map_id, reduce_id))
        if e is None:
            return None
        with self._lock:
            if e.round >= len(st.prev_rounds) and st.device_mode:
                d = self._device_rows_locked(st, e, map_id, reduce_id)
                if d is None:
                    return None
                return np.frombuffer(tensor_bytes(d.src, d.start * st.alignment, d.length), np.uint8), 0, d.length
            staging = st.prev_rounds[e.round][0] if e.round < len(st.prev_rounds) else st.staging
        return staging, e.offset, e.length

    # -- serve-side decoded-block cache (popularity tier) -----------------

    def serve_cache_get(
        self, shuffle_id: int, map_id: int, reduce_id: int
    ) -> Optional[Tuple[np.ndarray, int, int]]:
        """Serving handle from the hot-block cache, shaped like
        ``block_staging_view``, or None on a miss or with the cache off."""
        cache = self.serve_cache
        if cache is None:
            return None
        data = cache.get((shuffle_id, map_id, reduce_id))
        if data is None:
            return None
        return np.frombuffer(data, dtype=np.uint8), 0, len(data)

    def serve_cache_offer(self, shuffle_id: int, map_id: int, reduce_id: int, data: bytes) -> bool:
        """Pin one hot decoded block in the serve cache.  False when the cache
        is off or the block outsizes the whole budget (the fetch still serves
        from staging).  No tenant is charged: tenants are not ported."""
        cache = self.serve_cache
        if cache is None or not data or len(data) > cache.capacity_bytes:
            return False
        cache.put((shuffle_id, map_id, reduce_id), data)
        return True

    # -- neighbor-replication tier (REPLICA_PUT/failover serving) ----------

    def replica_source(self, shuffle_id: int) -> List[Tuple[int, List[Tuple[int, int, int]], bytes]]:
        """Snapshot this executor's sealed rounds for replication: one
        ``(round, [(map, reduce, length)...], body bytes)`` per staging round,
        body = the unpadded block payloads concatenated in table order.  Only
        locally staged entries are included.  The device-staged round's
        blocks come off the device together (``land_device_rows``)."""
        st = self._state(shuffle_id)
        out: List[Tuple[int, List[Tuple[int, int, int]], bytes]] = []
        with self._lock:
            for rnd in range(st.round + 1):
                keys = sorted(k for k, e in st.blocks.items() if e.round == rnd and e.local)
                entries = [(m, r, st.blocks[(m, r)].length) for m, r in keys]
                keys = [k for k in keys if st.blocks[k].length]  # an empty block adds no bytes
                if rnd >= len(st.prev_rounds) and st.device_mode:
                    items = []
                    for m, r in keys:
                        d = self._device_rows_locked(st, st.blocks[(m, r)], m, r)
                        if d is None:
                            raise TransportError(
                                f"device block ({shuffle_id},{m},{r}) no longer resident — cannot replicate"
                            )
                        items.append(d)
                    views = land_device_rows(items)
                else:
                    staging = st.prev_rounds[rnd][0] if rnd < len(st.prev_rounds) else st.staging
                    views = [(staging, st.blocks[k].offset, st.blocks[k].length) for k in keys]
                body = b"".join(arr[off : off + ln].tobytes() for arr, off, ln in views)
                if entries:
                    out.append((rnd, entries, body))
        return out

    def put_replica(
        self,
        shuffle_id: int,
        src_executor: int,
        round_idx: int,
        entries: Sequence[Tuple[int, int, int]],
        body,
    ) -> None:
        """Install one replicated round pushed by a ring neighbor.  ``body``
        is the concatenated unpadded payloads in ``entries`` order; a repeated
        put for the same (shuffle, src, round) replaces the old copy."""
        index: Dict[Tuple[int, int], Tuple[int, int]] = {}
        pos = 0
        for m, r, ln in entries:
            index[(m, r)] = (pos, ln)
            pos += ln
        if pos != len(body):
            raise TransportError(
                f"replica round (shuffle={shuffle_id}, src={src_executor}, "
                f"round={round_idx}) table claims {pos} B but body is {len(body)} B"
            )
        if not len(body):
            arr = np.empty(0, dtype=np.uint8)
        elif isinstance(body, (bytes, bytearray)):
            arr = np.frombuffer(body, dtype=np.uint8)
        else:
            arr = np.frombuffer(bytes(body), dtype=np.uint8)
        with self._lock:
            rounds = self._replicas.setdefault((shuffle_id, src_executor), {})
            old = rounds.get(round_idx)
            if old is not None:
                self._replica_bytes -= int(old[1].size)
            rounds[round_idx] = (index, arr)
            self._replica_bytes += int(arr.size)

    def replica_view(
        self, shuffle_id: int, map_id: int, reduce_id: int
    ) -> Optional[Tuple[np.ndarray, int, int]]:
        """Zero-copy serving handle into a replicated round, or None when no
        replica of the block has landed."""
        with self._lock:
            for (sid, _src), rounds in self._replicas.items():
                if sid != shuffle_id:
                    continue
                for index, arr in rounds.values():
                    hit = index.get((map_id, reduce_id))
                    if hit is not None:
                        return arr, hit[0], hit[1]
        return None

    def replica_block(
        self, shuffle_id: int, src_executor: int, map_id: int, reduce_id: int
    ) -> Optional[bytes]:
        """The replicated bytes of one block from a named source executor, or
        None when no replica of (src, block) landed here."""
        with self._lock:
            rounds = self._replicas.get((shuffle_id, src_executor))
            if not rounds:
                return None
            for index, arr in rounds.values():
                hit = index.get((map_id, reduce_id))
                if hit is not None:
                    return arr[hit[0] : hit[0] + hit[1]].tobytes()
        return None

    def replica_stats(self) -> Dict[str, int]:
        """Replica-tier accounting across all shuffles."""
        with self._lock:
            return {
                "replica_bytes": self._replica_bytes,
                "replica_rounds": sum(len(r) for r in self._replicas.values()),
                "replica_sources": len(self._replicas),
            }

    # -- introspection -----------------------------------------------------

    def stats(self, shuffle_id: int) -> Dict[str, object]:
        st = self._state(shuffle_id)
        with self._lock:
            replica_bytes = sum(
                int(arr.size)
                for (sid, _src), rounds in self._replicas.items()
                if sid == shuffle_id
                for _index, arr in rounds.values()
            )
            return {
                "replica_bytes": replica_bytes,
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
