"""TpuShuffleCluster / TpuShuffleTransport — the device data plane (L3b).

Port of ``sparkucx_tpu/transport/tpu.py``, single-shot static plan only.
Counterpart of ``UcxShuffleTransport`` + ``UcxWorkerWrapper``
(UcxShuffleTransport.scala / UcxWorkerWrapper.scala), rebuilt around a bulk
superstep instead of per-block RDMA active messages:

* every executor stages map output into its store; ``run_exchange`` seals the
  stores and runs one exchange per staging round, in order (the plan the JAX
  ``StaticPlanner`` returns at ``slot_quota_rows = 0``, ops/planner.py:352-364);
  the exchange is ops/exchange.py, a ``block_gather`` per receiver when the
  executors share a device;
* ``fetch_blocks_by_block_ids`` afterwards is a local slice of the received
  shard (``host_recv_mode='array'``: one asynchronous copy per shard into
  page-locked host memory, completed through a CUDA event), or of the
  device-resident shard (``'device'``: only the requested block leaves the
  device);
* ``fetch_blocks_device`` packs requested blocks into one device buffer with
  the gather kernel — the reference's reply packing
  (UcxWorkerWrapper.scala:397-448) without the host;
* ``fetch_block`` is the pull fallback reading a store directly.

Single-controller topology: one cluster owns N per-executor transports
(CommonUcxShuffleManager.scala:67-99).  ``devices`` gives each executor's
device and may repeat one device; it defaults to CUDA for every executor.
The pipelined and chunked executor, elastic recovery, replication and the
``'memmap'`` receive mode are not ported yet.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sparkucx_tpu_torch.config import TpuShuffleConf
from sparkucx_tpu_torch.core.block import Block, BlockId, MemoryBlock, ShuffleBlockId
from sparkucx_tpu_torch.core.definitions import MapperInfo
from sparkucx_tpu_torch.core.operation import (
    OperationCallback,
    OperationResult,
    OperationStats,
    OperationStatus,
    Request,
    TransportError,
)
from sparkucx_tpu_torch.core.transport import ExecutorId, ShuffleTransport
from sparkucx_tpu_torch.ops.block_kernels import block_gather, plan_tensors
from sparkucx_tpu_torch.ops.exchange import ExchangeSpec, build_exchange
from sparkucx_tpu_torch.store.hbm_store import HbmBlockStore, default_peer_ranges
from sparkucx_tpu_torch.utils.devices import resolve_devices
from sparkucx_tpu_torch.utils.trace import span

#: host_recv_mode vocabulary (config.py) and the modes this transport serves
HOST_RECV_MODES = ("array", "memmap", "device")
SUPPORTED_RECV_MODES = ("array", "device")


def validate_host_recv_mode(mode: str) -> str:
    """The ``host_recv_mode`` gate, called before any staging allocation."""
    if mode not in HOST_RECV_MODES:
        raise ValueError(f"unknown host_recv_mode {mode!r} (array|memmap|device)")
    if mode not in SUPPORTED_RECV_MODES:
        raise ValueError(
            f"host_recv_mode {mode!r} is not supported by this transport "
            f"({'|'.join(SUPPORTED_RECV_MODES)})"
        )
    return mode


@dataclass
class _ShuffleMeta:
    """Cluster-wide shuffle metadata — the DPU daemon's committed offset tables
    plus Spark's MapOutputTracker (UcxShuffleReader.scala:75-76)."""

    shuffle_id: int
    num_mappers: int
    num_reducers: int
    map_owner: List[ExecutorId]  # map task -> executor
    peer_ranges: List[Tuple[int, int]]  # reducer ownership
    mapper_infos: Dict[int, MapperInfo] = field(default_factory=dict)
    #: per-peer staging region size in bytes (block-offset math)
    region_bytes: int = 0
    #: post-exchange receive state, one entry per staging round, each per
    #: executor: host uint8 shards ('array'; None under 'device'), the (n, n)
    #: received-size matrices (row j = rows j received from each sender), and
    #: the device-resident shards (conf.keep_device_recv)
    recv_shards: Optional[List[List[np.ndarray]]] = None
    recv_sizes: Optional[List[np.ndarray]] = None
    recv_device: Optional[List[List[torch.Tensor]]] = None
    exchanged: bool = False
    #: device-stream times of the superstep's seal and exchange phases
    timer: Optional["_StreamTimer"] = None

    def owner_of_reduce(self, reduce_id: int) -> ExecutorId:
        for p, (s, e) in enumerate(self.peer_ranges):
            if s <= reduce_id < e:
                return p
        raise ValueError(f"reduce_id {reduce_id} unowned")


def _copy_to_host(shard: torch.Tensor):
    """Start one shard's device-to-host copy into page-locked memory; returns
    (host tensor, CUDA event marking the copy's end, or None on the CPU)."""
    if shard.device.type != "cuda":
        return shard, None
    host = torch.empty(shard.shape, dtype=shard.dtype, pin_memory=True)
    host.copy_(shard, non_blocking=True)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(shard.device))
    return host, event


class _StreamTimer:
    """CUDA-event timing of named sections on a device's current stream.  The
    events are read only when asked (no host sync on the hot path); on the
    CPU nothing is recorded."""

    def __init__(self, device: torch.device) -> None:
        self._device = device if device.type == "cuda" else None
        self._events: List[Tuple[str, torch.cuda.Event, torch.cuda.Event]] = []

    def _record(self) -> torch.cuda.Event:
        event = torch.cuda.Event(enable_timing=True)
        event.record(torch.cuda.current_stream(self._device))
        return event

    @contextmanager
    def section(self, name: str):
        if self._device is None:
            yield
            return
        start = self._record()
        yield
        self._events.append((name, start, self._record()))

    def totals_ms(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, start, end in self._events:
            end.synchronize()
            out[name] = out.get(name, 0.0) + start.elapsed_time(end)
        return out


class TpuShuffleCluster:
    """Owns the executors' devices, their transports and shuffle metadata."""

    def __init__(
        self,
        conf: Optional[TpuShuffleConf] = None,
        num_executors: Optional[int] = None,
        devices: Optional[Sequence] = None,
    ) -> None:
        self.conf = conf or TpuShuffleConf()
        if num_executors is None and devices is None:
            num_executors = self.conf.num_executors
        self.devices: List[torch.device] = resolve_devices(devices, num_executors)
        self.num_executors = len(self.devices)
        self.transports: List[TpuShuffleTransport] = [
            TpuShuffleTransport(self, eid, device=d) for eid, d in enumerate(self.devices)
        ]
        self._meta: Dict[int, _ShuffleMeta] = {}  #: guarded by self._lock
        self._lock = threading.RLock()

    # -- lookup ------------------------------------------------------------

    def transport(self, executor_id: ExecutorId) -> "TpuShuffleTransport":
        return self.transports[executor_id]

    def meta(self, shuffle_id: int) -> _ShuffleMeta:
        with self._lock:
            m = self._meta.get(shuffle_id)
        if m is None:
            raise TransportError(f"unknown shuffle {shuffle_id}")
        return m

    @property
    def row_bytes(self) -> int:
        return self.conf.block_alignment

    # -- shuffle lifecycle -------------------------------------------------

    def create_shuffle(
        self,
        shuffle_id: int,
        num_mappers: int,
        num_reducers: int,
        map_owner: Optional[Sequence[ExecutorId]] = None,
        capacity: Optional[int] = None,
    ) -> _ShuffleMeta:
        """Declare a shuffle cluster-wide: reducer ownership is contiguous
        ranges over executors; map tasks are assigned round-robin unless given.
        ``capacity`` overrides ``conf.staging_capacity_per_executor``."""
        n = self.num_executors
        owners = list(map_owner) if map_owner is not None else [m % n for m in range(num_mappers)]
        if len(owners) != num_mappers:
            raise ValueError("map_owner length != num_mappers")
        ranges = default_peer_ranges(num_reducers, n)
        meta = _ShuffleMeta(shuffle_id, num_mappers, num_reducers, owners, ranges)
        with self._lock:
            if shuffle_id in self._meta:
                raise TransportError(f"shuffle {shuffle_id} already exists")
            self._meta[shuffle_id] = meta
        for t in self.transports:
            t.store.create_shuffle(
                shuffle_id, num_mappers, num_reducers, peer_ranges=ranges, capacity=capacity
            )
        meta.region_bytes = self.transports[0].store.region_bytes(shuffle_id)
        return meta

    def remove_shuffle(self, shuffle_id: int) -> None:
        self.drop_meta(shuffle_id)
        for t in self.transports:
            t.store.remove_shuffle(shuffle_id)

    def drop_meta(self, shuffle_id: int) -> None:
        """Forget cluster-level metadata only (the unregisterShuffle split,
        CommonUcxShuffleManager.scala:103-106)."""
        with self._lock:
            self._meta.pop(shuffle_id, None)

    def commit_mapper(self, info: MapperInfo) -> None:
        """AM id 2 sink — the cluster is the 'daemon' holding the commit table."""
        meta = self.meta(info.shuffle_id)
        with self._lock:
            meta.mapper_infos[info.map_id] = info

    # -- the superstep -----------------------------------------------------

    def run_exchange(self, shuffle_id: int) -> None:
        """Seal every executor's staging and run one exchange per staging
        round.  After this, every block is resident on its consuming executor
        and fetches are local."""
        with span("exchange.superstep", shuffle_id=shuffle_id):
            self._run_exchange(shuffle_id)

    def _run_exchange(self, shuffle_id: int) -> None:
        meta = self.meta(shuffle_id)
        if meta.exchanged:
            raise TransportError(f"shuffle {shuffle_id} already exchanged")
        committed = len(meta.mapper_infos)
        if committed != meta.num_mappers:
            raise TransportError(
                f"exchange before all maps committed ({committed}/{meta.num_mappers})"
            )
        mode = validate_host_recv_mode(self.conf.host_recv_mode)
        if mode == "device" and not self.conf.keep_device_recv:
            raise TransportError(
                "host_recv_mode='device' serves fetches from the device shards — "
                "it requires conf.keep_device_recv=true"
            )
        if self.conf.slot_quota_rows > 0:
            raise TransportError(
                "slot_quota_rows > 0 needs the chunked exchange executor, which is not "
                "ported yet (ROADMAP queue A: planner/skew/executor/pipeline)"
            )

        meta.timer = timer = _StreamTimer(self.devices[0])
        with span("exchange.seal", shuffle_id=shuffle_id), timer.section("seal"):
            sealed = [t.store.seal(shuffle_id) for t in self.transports]
        num_rounds = max(len(s) for s in sealed)
        send_rows, lane = (int(x) for x in sealed[0][0][0].shape)
        for eid, s in enumerate(sealed):
            for rnd, (payload, _) in enumerate(s):
                shape = (int(payload.shape[0]), int(payload.shape[1]))
                if shape != (send_rows, lane):
                    raise TransportError(
                        f"executor {eid} sealed round {rnd} with shape {shape}, "
                        f"expected {(send_rows, lane)} — mismatched staging "
                        "geometry (stagingCapacity/blockAlignment) across executors"
                    )

        n = self.num_executors
        device = self.devices[0]
        keep_device = self.conf.keep_device_recv
        tickets = []
        for rnd in range(num_rounds):
            sizes = np.zeros((n, n), dtype=np.int32)
            pieces = []
            for i, s in enumerate(sealed):
                if rnd < len(s):
                    payload, size_row = s[rnd]
                    sizes[i] = size_row
                    pieces.append(payload.to(device))
                else:  # executor had fewer spill rounds: empty contribution
                    pieces.append(torch.zeros((send_rows, lane), dtype=torch.int32, device=device))
            data = pieces[0] if n == 1 else torch.cat(pieces)
            recv_rows = int(sizes.sum(axis=0).max(initial=0))
            spec = ExchangeSpec(n, send_rows, recv_rows, lane)
            fn = build_exchange(self.devices, spec)
            with span(
                "exchange.collective", shuffle_id=shuffle_id, round=rnd, rows=send_rows
            ), timer.section("exchange"):
                recv, recv_sizes = fn(data, sizes)
            del data, pieces
            shards = [recv[j * recv_rows : (j + 1) * recv_rows] for j in range(n)]
            host = [_copy_to_host(sh) for sh in shards] if mode == "array" else None
            tickets.append((recv_sizes.numpy(), host, shards if keep_device else None))

        meta.recv_shards = [] if mode == "array" else None
        meta.recv_sizes = []
        for sizes_host, host, dev_shards in tickets:
            if host is not None:
                with span("exchange.d2h", shuffle_id=shuffle_id):
                    parts = []
                    for tensor, event in host:
                        if event is not None:
                            event.synchronize()
                        parts.append(tensor.numpy().reshape(-1).view(np.uint8))
                meta.recv_shards.append(parts)
            meta.recv_sizes.append(sizes_host)
            if dev_shards is not None:
                if meta.recv_device is None:
                    meta.recv_device = []
                meta.recv_device.append(dev_shards)
        meta.exchanged = True

    def device_times_ms(self, shuffle_id: int) -> Dict[str, float]:
        """Device-stream milliseconds of the last superstep's ``seal`` and
        ``exchange`` phases (summed over rounds); empty on the CPU."""
        timer = self.meta(shuffle_id).timer
        return timer.totals_ms() if timer is not None else {}

    # -- post-exchange block lookup ---------------------------------------

    def locate_received_block(
        self, consumer: ExecutorId, shuffle_id: int, map_id: int, reduce_id: int
    ) -> Tuple[np.ndarray, int]:
        """Block (map_id, reduce_id) inside ``consumer``'s received shard:
        (uint8 host view or copy of the payload, length)."""
        meta = self.meta(shuffle_id)
        if not meta.exchanged:
            raise TransportError(f"shuffle {shuffle_id} not exchanged yet")
        rnd, src_row, rows = self._locate_rows(meta, consumer, map_id, reduce_id)
        if rows == 0:
            return np.empty(0, dtype=np.uint8), 0
        length = meta.mapper_infos[map_id].partitions[reduce_id][1]
        if meta.recv_shards is None:
            # host_recv_mode='device': copy just this block's rows off the device
            shard = meta.recv_device[rnd][consumer]
            block_rows = shard[src_row : src_row + rows].cpu().numpy()
            return block_rows.reshape(-1).view(np.uint8)[:length], length
        shard = meta.recv_shards[rnd][consumer]
        start = src_row * self.row_bytes
        return shard[start : start + length], length

    def _locate_rows(
        self, meta: _ShuffleMeta, consumer: ExecutorId, map_id: int, reduce_id: int
    ) -> Tuple[int, int, int]:
        """(round, src_row, row_count) of a block in ``consumer``'s received
        shard: the sender's chunk starts after earlier senders' receive sizes;
        inside it the block keeps its region-relative offset."""
        if meta.owner_of_reduce(reduce_id) != consumer:
            raise TransportError(
                f"reducer {reduce_id} is owned by executor "
                f"{meta.owner_of_reduce(reduce_id)}, not {consumer}"
            )
        info = meta.mapper_infos.get(map_id)
        if info is None:
            raise TransportError(f"map {map_id} never committed")
        abs_offset, length = info.partitions[reduce_id]
        if length == 0:
            return 0, 0, 0
        rnd = info.round_of(reduce_id)
        sender = meta.map_owner[map_id]
        region_bytes = meta.region_bytes
        region_rel = abs_offset - consumer * region_bytes
        if not (0 <= region_rel < region_bytes):
            raise TransportError(
                f"block ({meta.shuffle_id},{map_id},{reduce_id}) offset {abs_offset} "
                f"not in consumer {consumer}'s region"
            )
        row = self.row_bytes
        chunk_start = int(meta.recv_sizes[rnd][consumer, :sender].sum())
        return rnd, chunk_start + region_rel // row, -(-length // row)

    def fetch_blocks_to_device(
        self, consumer: ExecutorId, shuffle_id: int, block_ids: Sequence[ShuffleBlockId]
    ) -> Tuple[torch.Tensor, np.ndarray]:
        """Device-side batch fetch: pack the requested blocks into ONE buffer on
        ``consumer``'s device with the gather kernel — the bytes never visit
        the host.  Returns ``(packed, entries)``: ``packed`` is a (rows, lane)
        int32 tensor; ``entries`` is (B, 2) int64 — per requested block its
        starting ROW in ``packed`` and its true byte length.  Requires
        ``conf.keep_device_recv``."""
        meta = self.meta(shuffle_id)
        if not meta.exchanged:
            raise TransportError(f"shuffle {shuffle_id} not exchanged yet")
        if meta.recv_device is None:
            raise TransportError("device shards not retained (conf.keep_device_recv=false)")
        with span("fetch.device_gather", shuffle_id=shuffle_id, blocks=len(block_ids)):
            return self._fetch_blocks_to_device(meta, consumer, shuffle_id, block_ids)

    def _fetch_blocks_to_device(self, meta, consumer, shuffle_id, block_ids):
        located = []  # (round, src_row, rows) per request
        for bid in block_ids:
            if bid.shuffle_id != shuffle_id:
                raise TransportError(f"block {bid} not from shuffle {shuffle_id}")
            located.append(self._locate_rows(meta, consumer, bid.map_id, bid.reduce_id))
        entries = np.zeros((len(located), 2), dtype=np.int64)
        segments = []
        base = 0
        for rnd in sorted({r for r, _, c in located if c}):
            idxs = [i for i, (r, _, c) in enumerate(located) if r == rnd and c]
            starts = np.asarray([located[i][1] for i in idxs], dtype=np.int32)
            counts = np.asarray([located[i][2] for i in idxs], dtype=np.int32)
            outs = (np.cumsum(counts) - counts).astype(np.int32)
            total = int(counts.sum())
            for i, o in zip(idxs, outs):
                bid = block_ids[i]
                entries[i] = (base + int(o), meta.mapper_infos[bid.map_id].partitions[bid.reduce_id][1])
            src = meta.recv_device[rnd][consumer]
            s, c, o = plan_tensors(starts, counts, outs, src.device)
            segments.append(block_gather(s, c, o, src, total))
            base += total
        if not segments:
            lane = self.row_bytes // 4
            return torch.zeros((0, lane), dtype=torch.int32, device=self.devices[consumer]), entries
        packed = segments[0] if len(segments) == 1 else torch.cat(segments)
        return packed, entries


class TpuShuffleTransport(ShuffleTransport):
    """Per-executor facet of the cluster — implements the transport trait."""

    def __init__(self, cluster: TpuShuffleCluster, executor_id: ExecutorId, device=None) -> None:
        self.cluster = cluster
        self.executor_id = executor_id
        self.device = device
        self.store = HbmBlockStore(cluster.conf, device=device, executor_id=executor_id)
        self._registry: Dict[BlockId, Block] = {}  #: guarded by self._registry_lock
        self._registry_lock = threading.Lock()
        self._outstanding: List[Request] = []  #: guarded by self._outstanding_lock
        self._outstanding_lock = threading.Lock()

    # -- lifecycle ---------------------------------------------------------

    def init(self) -> bytes:
        return f"torch:{self.executor_id}".encode()

    def close(self) -> None:
        with self._outstanding_lock:
            for req in self._outstanding:
                if not req.completed():
                    req.cancel()
            self._outstanding.clear()
        self.store.close()

    def add_executor(self, executor_id: ExecutorId, address: bytes) -> None:
        pass  # single controller: membership is the cluster's device list

    def remove_executor(self, executor_id: ExecutorId) -> None:
        pass

    # -- server side (peer-serving registry) -------------------------------

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
            block = self._registry.pop(block_id, None)
        if block is not None:
            block.close()

    def unregister_shuffle(self, shuffle_id: int) -> None:
        with self._registry_lock:
            doomed = [
                b for b in self._registry
                if isinstance(b, ShuffleBlockId) and b.shuffle_id == shuffle_id
            ]
            blocks = [self._registry.pop(b) for b in doomed]
        for block in blocks:
            block.close()

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
        """Post-exchange batch fetch: each block is a local slice of this
        executor's received shard (``executor_id`` names the sender, kept for
        trait parity; the data already arrived in the superstep)."""
        if not (len(block_ids) == len(result_buffers) == len(callbacks)):
            raise ValueError("length mismatch")
        requests = []
        for bid, buf, cb in zip(block_ids, result_buffers, callbacks):
            req = Request(OperationStats())
            try:
                if not isinstance(bid, ShuffleBlockId):
                    raise TransportError(f"this transport fetches ShuffleBlockIds, got {bid!r}")
                view, length = self.cluster.locate_received_block(
                    self.executor_id, bid.shuffle_id, bid.map_id, bid.reduce_id
                )
                dest = buf.host_view()
                if length > dest.size:
                    raise TransportError(
                        f"block {bid} ({length} B) exceeds result buffer ({dest.size} B)"
                    )
                dest[:length] = view
                buf.size = length
                req.stats.mark_done(recv_size=length)
                result = OperationResult(OperationStatus.SUCCESS, stats=req.stats, data=buf)
            except Exception as e:
                req.stats.mark_done()
                err = e if isinstance(e, TransportError) else TransportError(str(e))
                result = OperationResult(OperationStatus.FAILURE, error=err, stats=req.stats)
            req.complete(result)
            if cb is not None:
                cb(result)
            requests.append(req)
        return requests

    def fetch_blocks_device(
        self, block_ids: Sequence[ShuffleBlockId]
    ) -> Tuple[torch.Tensor, np.ndarray]:
        """Device-resident batch fetch onto this executor's device (see
        ``TpuShuffleCluster.fetch_blocks_to_device``); one shuffle per call."""
        if not block_ids:
            raise ValueError("no block ids")
        sid = block_ids[0].shuffle_id
        return self.cluster.fetch_blocks_to_device(self.executor_id, sid, block_ids)

    def progress(self) -> None:
        """Poll outstanding work (non-blocking): post-exchange fetches complete
        synchronously, so this drives the pull-fallback path."""
        with self._outstanding_lock:
            self._outstanding = [r for r in self._outstanding if not r.completed()]

    # -- staged-store extensions ------------------------------------------

    def init_executor(self, num_mappers: int, num_reducers: int) -> None:
        pass  # store sizing happens in cluster.create_shuffle

    def commit_block(self, mapper_info_blob: bytes, callback: Optional[OperationCallback] = None) -> None:
        info = MapperInfo.unpack(mapper_info_blob)
        self.cluster.commit_mapper(info)
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
        """Pull fallback: direct read of an executor's staged store (the
        per-block AM path, ids 3/4 — the straggler/retry escape hatch)."""
        req = Request(OperationStats())

        def poll() -> bool:
            try:
                payload = self.cluster.transports[executor_id].store.read_block(
                    shuffle_id, map_id, reduce_id
                )
                dest = result_buffer.host_view()
                if len(payload) > dest.size:
                    raise TransportError(
                        f"staged block ({len(payload)} B) exceeds result buffer ({dest.size} B)"
                    )
                dest[: len(payload)] = np.frombuffer(payload, dtype=np.uint8)
                result_buffer.size = len(payload)
                req.stats.mark_done(recv_size=len(payload))
                result = OperationResult(OperationStatus.SUCCESS, stats=req.stats, data=result_buffer)
            except Exception as e:
                req.stats.mark_done()
                err = e if isinstance(e, TransportError) else TransportError(str(e))
                result = OperationResult(OperationStatus.FAILURE, error=err, stats=req.stats)
            req.complete(result)
            if callback is not None:
                callback(result)
            return True

        req.attach_poll(poll)
        with self._outstanding_lock:
            self._outstanding.append(req)
        return req
