"""TpuShuffleCluster / TpuShuffleTransport — the device data plane (L3b).

Port of ``sparkucx_tpu/transport/tpu.py``.  Counterpart of
``UcxShuffleTransport`` + ``UcxWorkerWrapper`` (UcxShuffleTransport.scala /
UcxWorkerWrapper.scala), rebuilt around a bulk superstep instead of
per-block RDMA active messages:

* every executor stages map output into its store; ``run_exchange`` seals
  the stores, asks the planner (ops/planner.py ``make_planner``) for an
  ``ExchangePlan`` and runs it through the plan executor
  (transport/executor.py ``execute_plan`` over transport/pipeline.py
  ``RoundPipeline``): one exchange per staging round, or, with
  ``conf.slot_quota_rows > 0``, quota-sized sub-rounds per staging round,
  spliced back into the single-shot receive layout (ops/skew.py);
  ``conf.pipeline_depth`` sub-rounds are in flight at once.  The exchange
  is ops/exchange.py (``exchange.impl=stock``, a ``block_gather`` per
  receiver when the executors share a device) or the scheduled ring of
  ops/ici_exchange.py (``pallas``, K3 then K1);
* ``fetch_blocks_by_block_ids`` afterwards is a local slice of the received
  shard: ``host_recv_mode='array'`` keeps one page-locked host copy per
  shard (copied asynchronously, completed through a CUDA event on the drain
  worker), ``'memmap'`` writes it to a disk-backed ``np.memmap`` under
  ``conf.spill_dir`` (charged against ``spill_disk_cap_bytes``), and
  ``'device'`` serves from the device-resident shard (only the requested
  block leaves the device);
* ``fetch_blocks_device`` packs requested blocks into one device buffer with
  the gather kernel — the reference's reply packing
  (UcxWorkerWrapper.scala:397-448) without the host;
* ``fetch_block`` is the pull fallback reading a store directly;
* ``received_block_views`` resolves a batch of received blocks to host views
  for a server (shuffle/daemon.py): zero-copy slices of host shards, and the
  blocks of shards kept on the card landed together — one gather launch per
  staging round, one copy to page-locked host memory;
* ``metrics`` / ``metrics_text`` / ``export_trace`` are the obs plane's
  cluster surfaces (the daemon's ``Metrics`` and ``ExportTrace`` ops).

Single-controller topology: one cluster owns N per-executor transports
(CommonUcxShuffleManager.scala:67-99).  ``devices`` gives each executor's
device and may repeat one device; it defaults to CUDA for every executor.
Elastic recovery and replication are not ported yet.
"""

from __future__ import annotations

import os
import tempfile
import threading
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

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
from sparkucx_tpu_torch.obs.metrics import MetricsRegistry, stats_aggregator_provider, tracer_provider
from sparkucx_tpu_torch.obs.recorder import FlightRecorder
from sparkucx_tpu_torch.ops.block_kernels import block_gather, plan_tensors
from sparkucx_tpu_torch.ops.ici_exchange import resolve_exchange_impl
from sparkucx_tpu_torch.ops.planner import PlanContext, PlanSignals, make_planner
from sparkucx_tpu_torch.ops.skew import (
    chunk_size_rows,
    pad_rows_pow2,
    piece_slices,
    reassemble_round,
    slice_subround,
)
from sparkucx_tpu_torch.store.hbm_store import DeviceRows, HbmBlockStore, default_peer_ranges, land_device_rows
from sparkucx_tpu_torch.transport.executor import (
    build_plan_exchange,
    execute_plan,
    validate_host_recv_mode,
)
from sparkucx_tpu_torch.utils.devices import resolve_devices
from sparkucx_tpu_torch.utils.stats import StatsAggregator
from sparkucx_tpu_torch.utils.trace import TRACER, instant, merge_events, span

#: exchanges a cluster keeps built; the least recently used one goes first
EXCHANGE_CACHE_SIZE = 32


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
    #: executor: host uint8 shards (the used prefix; plain arrays under
    #: 'array', np.memmap views under 'memmap', None under 'device'), the
    #: (n, n) received-size matrices (row j = rows j received from each
    #: sender), and the device-resident shards (conf.keep_device_recv)
    recv_shards: Optional[List[List[np.ndarray]]] = None
    recv_sizes: Optional[List[np.ndarray]] = None
    recv_device: Optional[List[List[torch.Tensor]]] = None
    #: memmap backing (path, bytes) to unlink on remove_shuffle ('memmap'),
    #: appended from the pipeline's drain worker
    recv_spill_paths: List[Tuple[str, int]] = field(default_factory=list)  #: guarded by the cluster's _lock
    exchanged: bool = False
    #: device-stream times of the superstep's seal and exchange phases
    timer: Optional["_StreamTimer"] = None

    def owner_of_reduce(self, reduce_id: int) -> ExecutorId:
        for p, (s, e) in enumerate(self.peer_ranges):
            if s <= reduce_id < e:
                return p
        raise ValueError(f"reduce_id {reduce_id} unowned")


def _copy_to_host(shard: torch.Tensor) -> torch.Tensor:
    """Queue one shard's device-to-host copy into page-locked memory (the
    shard itself on the CPU); read it only after the event that
    :func:`_record_event` records behind it."""
    if shard.device.type != "cuda":
        return shard
    host = torch.empty(shard.shape, dtype=shard.dtype, pin_memory=True)
    host.copy_(shard, non_blocking=True)
    return host


def _record_event(device: torch.device) -> Optional[torch.cuda.Event]:
    """A CUDA event behind everything queued so far on ``device``'s current
    stream of the calling thread, or None on the CPU."""
    if device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return event


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
        #: the exchange planner (ops/planner.py): conf.planner_mode selects
        #: the static mapping of the conf knobs or the adaptive one
        self.planner = make_planner(self.conf)
        self._meta: Dict[int, _ShuffleMeta] = {}  #: guarded by self._lock
        self._exchange_cache: Dict[Tuple[int, int, str], Callable] = {}  #: guarded by self._lock
        self._lock = threading.RLock()
        #: per-stage pipeline and exchange timings and staging occupancy
        self.stats = StatsAggregator()
        #: bytes of received-shard spill on disk (host_recv_mode='memmap'),
        #: charged against conf.spill_disk_cap_bytes; the drain worker
        #: charges, remove_shuffle refunds
        self._recv_spill_bytes = 0  #: guarded by self._lock
        #: Obs plane: the cluster-level registry (the planner reads its
        #: signals from it) and a flight recorder that captures on request
        #: only — it does not hook TransportError construction, which each
        #: PeerTransport covers on the wire.  No elastic family: elastic
        #: recovery is not ported.
        self.metrics = MetricsRegistry()
        self.metrics.register("ops", stats_aggregator_provider(self.stats))
        self.metrics.register("obs", tracer_provider(TRACER))
        self.recorder = FlightRecorder(
            TRACER,
            postmortem_dir=self.conf.obs_postmortem_dir or None,
            ring_capacity=self.conf.obs_ring_capacity,
        )
        self.recorder.attach_registry(self.metrics)

    # -- obs plane ---------------------------------------------------------

    def export_trace(self, path: str, extra_buffers: Optional[List[List[dict]]] = None) -> int:
        """Merge every executor's trace events into ONE Perfetto file with
        pid = executor id; returns the event count.  The executors share the
        process-wide TRACER (tracks split by the ``executor_scope`` eid tag);
        peers' buffers pulled over TRACE_PULL (``PeerTransport.pull_trace``)
        come in through ``extra_buffers``."""
        import json

        merged = merge_events([TRACER.events] + list(extra_buffers or []))
        with open(path, "w") as f:
            json.dump({"traceEvents": merged, "displayTimeUnit": "ms"}, f)
        return len(merged)

    def metrics_text(self) -> str:
        """The cluster registry's Prometheus exposition."""
        return self.metrics.prometheus_text()

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
        """Forget cluster-level metadata (the unregisterShuffle split,
        CommonUcxShuffleManager.scala:103-106), unlinking the shuffle's
        received-shard spill files ('memmap') and refunding their bytes."""
        with self._lock:
            meta = self._meta.pop(shuffle_id, None)
        if meta is None:
            return
        meta.recv_shards = None  # drop the memmap views before unlinking
        with self._lock:
            spilled = list(meta.recv_spill_paths)
        for path, size in spilled:
            try:
                os.unlink(path)
            except FileNotFoundError:
                pass  # already gone: the bytes are not on disk
            except OSError:
                continue  # still on disk: keep it charged
            with self._lock:
                self._recv_spill_bytes -= size

    def commit_mapper(self, info: MapperInfo) -> None:
        """AM id 2 sink — the cluster is the 'daemon' holding the commit table."""
        meta = self.meta(info.shuffle_id)
        with self._lock:
            meta.mapper_infos[info.map_id] = info

    # -- the superstep -----------------------------------------------------

    def _exchange_fn(self, send_rows: int, recv_rows: int, lowering: str):
        """The exchange of ``send_rows`` staged rows per executor into
        ``recv_rows`` received rows per executor under the plan's
        ``lowering`` (resolved against the executors' device), cached by
        (rows, resolved impl); the cache keeps the ``EXCHANGE_CACHE_SIZE``
        most recently used."""
        impl = resolve_exchange_impl(lowering, self.devices[0].type, self.num_executors)
        key = (send_rows, recv_rows, impl)
        with self._lock:
            fn = self._exchange_cache.pop(key, None)
            if fn is None:
                fn = build_plan_exchange(
                    self.devices,
                    num_executors=self.num_executors,
                    send_rows=send_rows,
                    lane=self.row_bytes // 4,
                    impl=impl,
                    num_slices=self.conf.num_slices,
                    recv_rows=recv_rows,
                )
            self._exchange_cache[key] = fn
            while len(self._exchange_cache) > EXCHANGE_CACHE_SIZE:
                del self._exchange_cache[next(iter(self._exchange_cache))]
        return fn

    def run_exchange(self, shuffle_id: int) -> None:
        """Seal every executor's staging and run the planned exchange.  After
        this, every block is resident on its consuming executor and fetches
        are local."""
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

        n = self.num_executors
        device = self.devices[0]
        meta.timer = timer = _StreamTimer(device)
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
        staging_slot = send_rows // n

        # the plan, from the sealed size matrices only (metadata before data)
        round_maxes = tuple(
            max((int(np.max(s[rnd][1], initial=0)) for s in sealed if rnd < len(s)), default=0)
            for rnd in range(num_rounds)
        )
        used_total = sum(int(np.sum(sr[1])) for s in sealed for sr in s)
        signals = PlanSignals.from_registry(self.metrics)
        ctx = PlanContext(
            num_executors=n,
            staging_slot_rows=staging_slot,
            round_max_rows=round_maxes,
            used_rows_total=used_total,
            row_bytes=self.row_bytes,
            platform=device.type,
            signals=signals,
        )
        plan = self.planner.plan(ctx)
        instant(
            "exchange.plan",
            shuffle_id=shuffle_id,
            planner=type(self.planner).__name__,
            **plan.describe(),
            **{f"signal_{k}": v for k, v in signals.describe().items()},
        )
        # A single-shot plan exchanges the sealed payloads as they are, at the
        # staging slot: the JAX package pads the slot to its pow2 bucket so
        # that one compiled executable serves nearby sizes, and the port,
        # which compiles nothing, would only pay a relocation copy for it.
        # A chunked plan runs quota-sized sub-rounds of plan.slot_rows.
        q = staging_slot if plan.single_shot else plan.slot_rows
        bucketed = q * n  # staged rows per executor per sub-round
        keep_device = self.conf.keep_device_recv

        def _submit(rnd, chunk, nchunks):
            """Assemble one sub-round on the device, queue its exchange and
            the host copies of every receiver's used rows, and record the
            event the drain waits on — all on this thread's stream."""
            pieces, size_rows = [], []
            for s in sealed:
                if rnd < len(s):
                    payload, size_row = s[rnd]
                    if not plan.single_shot:
                        payload = slice_subround(payload, n, chunk, q)
                    pieces.append(payload.to(device))
                    size_rows.append(size_row)
                else:  # executor had fewer spill rounds: empty contribution
                    pieces.append(torch.zeros((bucketed, lane), dtype=torch.int32, device=device))
                    size_rows.append(np.zeros(n, dtype=np.int32))
            sub_sizes = np.stack([chunk_size_rows(sr, chunk, q) for sr in size_rows])
            data = pieces[0] if n == 1 else torch.cat(pieces)
            del pieces
            # a single-shot round receives at most what its fullest receiver
            # gets; a sub-round keeps the worst case, one geometry per plan
            recv_rows = int(sub_sizes.sum(axis=0).max(initial=0)) if plan.single_shot else bucketed
            fn = self._exchange_fn(bucketed, recv_rows, plan.lowering)
            with span(
                "exchange.collective", shuffle_id=shuffle_id, round=rnd, chunk=chunk, rows=bucketed
            ), timer.section("exchange"):
                recv, recv_sizes = fn(data, sub_sizes)
            del data
            sizes_host = recv_sizes.numpy()
            shards = [recv[j * recv_rows : (j + 1) * recv_rows] for j in range(n)]
            host = None
            if mode != "device":
                host = [_copy_to_host(shards[j][: int(sizes_host[j].sum())]) for j in range(n)]
            return sizes_host, host, shards if keep_device else None, _record_event(device)

        def _drain_chunk(rnd, chunk, nchunks, ticket):
            """Complete one sub-round host-side (the drain worker at depth >
            1): wait on the submit's event, then read the page-locked copies.
            Nothing is launched here."""
            sizes_host, host, dev_shards, event = ticket
            if event is not None:
                event.synchronize()
            if host is None:
                return sizes_host, None, dev_shards
            with span("exchange.d2h", shuffle_id=shuffle_id, round=rnd, chunk=chunk):
                return sizes_host, [t.numpy().reshape(-1).view(np.uint8) for t in host], dev_shards

        def _finish_round(rnd, nchunks, parts):
            """One staging round's receive state: a single-shot round passes
            its only chunk through; a chunked round splices its sub-round
            shards back into the single-shot layout — on the host here, and
            for the device shards as a list of row slices per receiver that
            the caller's thread concatenates (no launch on the drain worker).
            Under 'memmap' the round's host shards then go to disk."""
            if plan.single_shot:
                logical, shards, dev = parts[0]
            else:
                sub_size_mats = [p[0] for p in parts]
                logical = np.sum(sub_size_mats, axis=0).astype(np.int32)
                shards = dev = None
                if mode != "device":
                    shards = [
                        reassemble_round([p[1][j] for p in parts], [m[j] for m in sub_size_mats], self.row_bytes)
                        for j in range(n)
                    ]
                if keep_device:
                    dev = [
                        [parts[c][2][j][start : start + rows]
                         for c, start, rows in piece_slices([m[j] for m in sub_size_mats])]
                        for j in range(n)
                    ]
            if mode == "memmap":
                with span("exchange.d2h_memmap", shuffle_id=shuffle_id, round=rnd):
                    shards = self._memmap_round(meta, rnd, iter(shards))
            used = int(logical.sum())
            return shards, logical, dev, (used, nchunks * n * bucketed - used)

        results = execute_plan(
            plan,
            submit=_submit,
            drain_chunk=_drain_chunk,
            finish_round=_finish_round,
            result_bytes=lambda r: int(r[1].sum()) * self.row_bytes,
            # staging occupancy per round: used rows vs. the slot padding the
            # planner's quota and chunking decisions exist to shrink
            occupancy=lambda r: r[3],
            stats=self.stats,
        )

        meta.recv_shards = None if mode == "device" else []
        meta.recv_sizes = []
        for shards, sizes_host, dev, _occ in results:
            if shards is not None:
                meta.recv_shards.append(shards)
            meta.recv_sizes.append(sizes_host)
            active = int(np.count_nonzero(sizes_host))
            self.stats.record_rows("exchange.lanes", active, sizes_host.size - active)
            if dev is not None:
                if not plan.single_shot:
                    # pow2 rows, the JAX package's device-shard shapes
                    dev = [
                        pad_rows_pow2(torch.cat(p)) if p else torch.zeros((1, lane), dtype=torch.int32, device=device)
                        for p in dev
                    ]
                if meta.recv_device is None:
                    meta.recv_device = []
                meta.recv_device.append(dev)
        meta.exchanged = True

    def _memmap_round(self, meta: _ShuffleMeta, rnd: int, host_views):
        """Spill one round's received shards to disk-backed mappings and
        return read-only uint8 ``np.memmap`` views (host_recv_mode='memmap').

        ``host_views`` yields one flat uint8 array per executor; a generator
        keeps host memory at about one transient shard.  Each file is charged
        against ``conf.spill_disk_cap_bytes`` before it is written (refunded
        and removed if the write fails); a zero-byte shard is kept as the
        empty array, since a zero-byte file cannot be mapped."""
        spill_dir = self.conf.spill_dir
        if spill_dir:
            os.makedirs(spill_dir, exist_ok=True)
        views = []
        for j, host in enumerate(host_views):
            cap = self.conf.spill_disk_cap_bytes
            nbytes = int(host.nbytes)
            if nbytes == 0:
                views.append(host)
                continue
            with self._lock:
                if cap and self._recv_spill_bytes + nbytes > cap:
                    raise TransportError(
                        f"received-shard spill would exceed spill_disk_cap_bytes "
                        f"({self._recv_spill_bytes + nbytes} > {cap}); raise the "
                        f"cap or use host_recv_mode='device'"
                    )
                self._recv_spill_bytes += nbytes
            fd, path = tempfile.mkstemp(
                prefix=f"sparkucx_tpu_torch_recv_s{meta.shuffle_id}_r{rnd}_e{j}_", dir=spill_dir
            )
            os.close(fd)
            shape = host.shape
            try:
                mm = np.memmap(path, dtype=np.uint8, mode="w+", shape=shape)
                mm[:] = host
                mm.flush()
            except BaseException:
                with self._lock:
                    self._recv_spill_bytes -= nbytes
                try:
                    os.unlink(path)
                except OSError:
                    pass
                raise
            # reopen read-only: the dirty pages are unmapped, and fetches
            # fault in only the pages they touch
            del mm, host
            with self._lock:
                meta.recv_spill_paths.append((path, nbytes))
            views.append(np.memmap(path, dtype=np.uint8, mode="r", shape=shape))
        return views

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

    def received_block_views(
        self, block_ids: Sequence[ShuffleBlockId]
    ) -> List[Optional[Tuple[np.ndarray, int, int]]]:
        """Serving handles ``(uint8 array, offset, length)`` of received
        blocks, each read by the executor that owns its reducer, or None for a
        block that cannot be served (unknown shuffle, map or reducer).  Host
        shards ('array', 'memmap') are sliced in place.  Blocks of shards
        kept on the card ('device') are landed together
        (``land_device_rows``): one block-gather launch per received shard
        (round and consumer) the batch touches, then one copy to page-locked
        host memory; the arrays keep that buffer alive."""
        out: List[Optional[Tuple[np.ndarray, int, int]]] = [None] * len(block_ids)
        on_device: List[int] = []
        items: List[DeviceRows] = []
        for i, bid in enumerate(block_ids):
            try:
                meta = self.meta(bid.shuffle_id)
                consumer = meta.owner_of_reduce(bid.reduce_id)
                if meta.exchanged and meta.recv_shards is None:
                    rnd, row, rows = self._locate_rows(meta, consumer, bid.map_id, bid.reduce_id)
                    length = meta.mapper_infos[bid.map_id].partitions[bid.reduce_id][1]
                    items.append(DeviceRows(meta.recv_device[rnd][consumer], row, rows, length, True))
                    on_device.append(i)
                    continue
                view, length = self.locate_received_block(consumer, bid.shuffle_id, bid.map_id, bid.reduce_id)
                out[i] = (np.ascontiguousarray(view[:length]).reshape(-1).view(np.uint8), 0, int(length))
            except (TransportError, ValueError, IndexError, KeyError):
                pass  # answered as a miss (size -1), as the JAX daemon answers it
        for i, view in zip(on_device, land_device_rows(items)):
            out[i] = view
        return out

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
