"""Scheduled ring exchange — FAST-style flow scheduling of the superstep.

Port of ``sparkucx_tpu/ops/ici_exchange.py``: the schedule model (verbatim,
pure Python) and the flat builders, for executors that share one device.

* **Schedule model**: a :class:`RingSchedule` is a sequence of supersteps;
  each step carries at most one :class:`SendItem` per ring direction.  Items
  are enumerated chunk-major (chunk 0 of every destination before chunk 1 of
  any), offsets take the short way around the ring, antipodal offsets
  alternate direction by chunk parity.
* **One route**: K3 (ops/ring_kernels.py ``ring_exchange_grid``) moves
  every window of the schedule in one launch; K4 (``ring_combine_grid``)
  folds them into the accumulator as well; K5 (``fused_scatter_ring_grid``)
  places the packed map-output blocks into the staging first, in the same
  launch (``build_fused_ici_exchange``, the fused send side).  On CPU tensors these wrappers
  run their plain versions.  The lowering names of the JAX package stay in
  the signatures (``resolve_ici_lowering``): ``'auto'`` and ``'dma'`` name
  the kernels; ``'xla'`` and ``'interpret'`` are accepted on CPU executors,
  where every name runs the same plain versions, and refused on the card,
  which has no second route.  The grid is sender-major, the layout the
  dense all-to-all produces, and its compaction by the receive sizes (K1)
  makes the result equal the stock exchange (ops/exchange.py) bit for bit.

Executors that share one device ride one ring whose hops never leave the
device, so the fabric kind is always ``'ici'``.  Executors on different
devices need NCCL (ROADMAP queue A item 4) and raise
``NotImplementedError``.  The hierarchical and quantized builders are not
ported yet.

Selection: ``spark.shuffle.tpu.exchange.impl`` = ``stock`` (default) |
``pallas`` (this module) | ``auto`` (``pallas`` only on a TPU, so ``stock``
here).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sparkucx_tpu_torch.ops.block_kernels import block_gather, plan_tensors
from sparkucx_tpu_torch.ops.columnar import _CROSS_DEVICE
from sparkucx_tpu_torch.ops.combine import CombineSpec, merge_accumulators
from sparkucx_tpu_torch.ops.exchange import ExchangeSpec, build_exchange, same_device
from sparkucx_tpu_torch.ops.ring_kernels import fused_scatter_ring_grid, ring_combine_grid, ring_exchange_grid
from sparkucx_tpu_torch.utils.devices import resolve_devices

# Per-destination chunks the transports request (clamped per phase by
# schedule_chunks): 2 gives one level of FAST interleaving without inflating
# the step count.
DEFAULT_CHUNKS_PER_DEST = 2

# ----------------------------------------------------------------------------
# Schedule model (pure python)
# ----------------------------------------------------------------------------


@dataclass(frozen=True)
class SendItem:
    """One scheduled transfer: every device sends its chunk ``chunk`` of the
    slot destined ``offset`` hops ahead on the ring, riding the links of
    ``direction`` (+1 / -1).  ``kind`` labels the fabric ('ici' | 'dcn')."""

    offset: int
    chunk: int
    direction: int
    kind: str = "ici"


@dataclass(frozen=True)
class RingSchedule:
    """Supersteps over one ring axis; each step holds <= 1 item per direction.

    SPMD-symmetric: every device executes the same item list, so item
    ``(offset d, chunk c)`` simultaneously means "send my window for ``me+d``"
    and "receive the matching window from ``me-d``"."""

    dim: int
    chunks: int
    kind: str
    steps: Tuple[Tuple[SendItem, ...], ...]

    @property
    def num_steps(self) -> int:
        return len(self.steps)

    def items(self) -> List[SendItem]:
        return [item for step in self.steps for item in step]

    def raw_steps(self) -> Tuple[Tuple[Tuple[int, int, int], ...], ...]:
        """Plain-tuple view for the kernels (ops/ring_kernels.py)."""
        return tuple(
            tuple((it.offset, it.chunk, it.direction) for it in step)
            for step in self.steps
        )


def schedule_chunks(group_rows: int, requested: int) -> int:
    """Clamp a requested per-destination chunk count to a pow2 divisor of the
    transfer group, so chunk windows stay equal."""
    if group_rows <= 0:
        raise ValueError(f"group_rows must be positive, got {group_rows}")
    r = max(1, int(requested))
    c = 1 << (r - 1).bit_length()  # pow2 ceil
    c = min(c, group_rows)
    return math.gcd(c, group_rows)  # largest pow2 divisor of group_rows <= c


def ring_schedule(dim: int, chunks_per_dest: int = 1, kind: str = "ici") -> RingSchedule:
    """Build the bidirectional-ring flow schedule for ``dim`` devices.

    Enumeration is chunk-major — chunk 0 of EVERY destination before chunk 1
    of any (the FAST hot-lane interleaving) — split into a '+' and a '-'
    queue by short-way routing; step i pairs the i-th item of each queue, so
    "<= 1 chunk per link direction per step" holds by construction and every
    ``(offset, chunk)`` appears exactly once by enumeration."""
    if dim < 2:
        raise ValueError(f"ring schedule needs dim >= 2, got {dim}")
    if chunks_per_dest < 1:
        raise ValueError(f"chunks_per_dest must be >= 1, got {chunks_per_dest}")
    plus: List[SendItem] = []
    minus: List[SendItem] = []
    for c in range(chunks_per_dest):
        for d in range(1, dim):
            if 2 * d < dim:
                direction = 1
            elif 2 * d > dim:
                direction = -1
            else:  # antipodal offset: alternate by chunk so both rings share it
                direction = 1 if c % 2 == 0 else -1
            item = SendItem(offset=d, chunk=c, direction=direction, kind=kind)
            (plus if direction > 0 else minus).append(item)
    steps = tuple(
        tuple(q[i] for q in (plus, minus) if i < len(q))
        for i in range(max(len(plus), len(minus)))
    )
    return RingSchedule(dim=dim, chunks=chunks_per_dest, kind=kind, steps=steps)


def simulate_ring(schedule: RingSchedule):
    """Pure-python executor for schedule property tests.

    Returns ``(deliveries, link_load)``: ``deliveries[(src, dst, chunk)]`` =
    times that window was sent (must be exactly 1 for every src != dst);
    ``link_load[(step, src, direction)]`` = windows device ``src`` injected
    into that ring direction at that step (must be <= 1)."""
    n = schedule.dim
    deliveries: Dict[Tuple[int, int, int], int] = {}
    link_load: Dict[Tuple[int, int, int], int] = {}
    for si, step in enumerate(schedule.steps):
        for item in step:
            for src in range(n):
                dst = (src + item.offset) % n
                key = (src, dst, item.chunk)
                deliveries[key] = deliveries.get(key, 0) + 1
                lkey = (si, src, item.direction)
                link_load[lkey] = link_load.get(lkey, 0) + 1
    return deliveries, link_load


def step_occupancy(schedule: RingSchedule) -> List[Tuple[int, int]]:
    """Per-superstep (used, idle) link-direction slots per device."""
    return [(len(step), 2 - len(step)) for step in schedule.steps]


def resolve_exchange_impl(impl: str, platform: str, num_executors: int) -> str:
    """conf.exchange_impl -> concrete engine: 'stock' | 'pallas'.

    ``auto`` picks the scheduled kernel only on multi-chip TPU meshes, as in
    the JAX package; everywhere else the stock exchange stays the default."""
    if impl == "stock":
        return "stock"
    if impl == "pallas":
        return "pallas"
    if impl == "auto":
        return "pallas" if platform == "tpu" and num_executors > 1 else "stock"
    raise ValueError(f"unknown exchange impl {impl!r}")


def resolve_ici_lowering(lowering: str, platform: str) -> str:
    """The JAX package's lowering names -> ``'dma'``, the kernels' route.
    ``'xla'`` and ``'interpret'`` are aliases of it on CPU executors (the
    wrappers run their plain versions there) and an error on the card."""
    if lowering not in ("auto", "dma", "xla", "interpret"):
        raise ValueError(f"unknown ici lowering {lowering!r}")
    if platform == "cuda" and lowering in ("xla", "interpret"):
        raise ValueError(f"ici lowering {lowering!r}: on the card the ring runs its kernels ('auto' or 'dma')")
    return "dma"


def resolve_schedule_lowering(lowering: str, kind: str) -> str:
    """Fabric guard: a ring whose hops cross slices ('dcn') never rides the
    kernel tier; 'interpret' is left alone."""
    if kind == "dcn" and lowering == "dma":
        return "xla"
    return lowering


# ----------------------------------------------------------------------------
# The superstep
# ----------------------------------------------------------------------------


def compact_plan(sizes: np.ndarray, receiver: int, slot_rows: int, recv_rows: int):
    """K1's plan for one receiver's compaction: ``(starts, counts, outs)``
    (numpy int64, one segment per sender, rows of the whole grid) and the
    rows it fills.  Sender i's ``sizes[i, receiver]`` rows sit at the start
    of its slot; they land after the senders before it, cut at
    ``recv_rows``."""
    n = sizes.shape[0]
    counts = np.minimum(sizes[:, receiver], slot_rows).astype(np.int64)
    ends = np.minimum(np.cumsum(counts), recv_rows)
    outs = np.minimum(np.cumsum(counts) - counts, recv_rows)
    starts = receiver * n * slot_rows + np.arange(n, dtype=np.int64) * slot_rows
    return starts, ends - outs, outs, int(ends[-1]) if n else 0


def compact_slots(grid: torch.Tensor, sizes: np.ndarray, slot_rows: int, recv_rows: int) -> torch.Tensor:
    """Pack every receiver's sender-major slot grid into the tight layout
    (``sizes[i, j]`` rows from sender i to receiver j): receiver j's
    ``recv_rows`` rows hold sender 0's rows, then sender 1's, ..., then
    zeros — one K1 launch per receiver."""
    n = sizes.shape[0]
    recv = torch.empty((n * recv_rows, grid.shape[1]), dtype=grid.dtype, device=grid.device)
    for j in range(n):
        starts, counts, outs, filled = compact_plan(sizes, j, slot_rows, recv_rows)
        shard = recv[j * recv_rows : (j + 1) * recv_rows]
        block_gather(*plan_tensors(starts, counts, outs, grid.device), grid, recv_rows, out=shard)
        shard[filled:] = 0
    return recv


def _flat_schedule(devices: Sequence, spec: ExchangeSpec, lowering: str, chunks_per_dest: int, schedule):
    """Shared checks of the flat builders: one device, a lowering name the
    device takes, an 'ici' ring schedule whose chunks divide the slot.
    Returns (lowering, schedule)."""
    n = spec.num_executors
    if not same_device(devices):
        raise NotImplementedError(_CROSS_DEVICE)
    low = resolve_ici_lowering(lowering, devices[0].type)
    if schedule is None:
        # executors sharing one device: every hop stays on the device
        schedule = ring_schedule(n, schedule_chunks(spec.slot_rows, chunks_per_dest), kind="ici")
    if not isinstance(schedule, RingSchedule):
        raise ValueError("flat mesh needs a RingSchedule")
    if schedule.dim != n:
        raise ValueError(f"schedule dim {schedule.dim} != num_executors {n}")
    if spec.slot_rows % schedule.chunks:
        raise ValueError(f"chunks {schedule.chunks} must divide slot_rows {spec.slot_rows}")
    if resolve_schedule_lowering(low, schedule.kind) != low:
        # a 'dcn' ring crosses slices: no hop of it stays on one device
        raise NotImplementedError(f"a {schedule.kind!r} ring schedule: {_CROSS_DEVICE}")
    return low, schedule


def _size_matrix(spec: ExchangeSpec, size_matrix) -> np.ndarray:
    n = spec.num_executors
    if isinstance(size_matrix, torch.Tensor):
        size_matrix = size_matrix.cpu().numpy()
    sizes = np.asarray(size_matrix, dtype=np.int32).reshape(n, n)
    if (sizes < 0).any() or (sizes > spec.slot_rows).any():
        raise ValueError(f"a chunk exceeds its slot of {spec.slot_rows} rows")
    return sizes


# ----------------------------------------------------------------------------
# Builders (the contract of ops/exchange.build_exchange)
# ----------------------------------------------------------------------------


def build_ici_exchange(
    devices: Optional[Sequence],
    spec: ExchangeSpec,
    *,
    chunks_per_dest: int = 1,
    lowering: str = "auto",
    schedule=None,
):
    """The scheduled exchange: ``fn(data, size_matrix) -> (recv, recv_sizes)``
    with the contract of ``ops/exchange.build_exchange`` — ``data`` is
    ``(n * send_rows, lane)``, executor i's slot-layout staging at rows
    ``[i * send_rows, ...)``; ``recv`` is ``(n * recv_rows, lane)``, receiver
    j's rows tight and sender-major, zero after its total; ``recv_sizes`` the
    (n, n) host tensor whose row j counts what j received from each sender.
    The superstep is the ring grid (K3) and its compaction (K1).  ``chunks_per_dest`` is clamped by ``schedule_chunks``; pass
    ``schedule`` to override it.  One executor needs no schedule: that is
    ``build_exchange``."""
    devices = resolve_devices(devices, spec.num_executors)
    spec.validate()
    if spec.num_executors == 1:
        return build_exchange(devices, spec)
    n, slot = spec.num_executors, spec.slot_rows
    low, schedule = _flat_schedule(devices, spec, lowering, chunks_per_dest, schedule)

    def exchange(data: torch.Tensor, size_matrix) -> Tuple[torch.Tensor, torch.Tensor]:
        if tuple(data.shape) != (n * spec.send_rows, spec.lane):
            raise ValueError(f"data shape {tuple(data.shape)} != {(n * spec.send_rows, spec.lane)}")
        sizes = _size_matrix(spec, size_matrix)
        received = sizes.sum(axis=0)
        if received.max(initial=0) > spec.recv_rows:
            raise ValueError(f"receiver gets {int(received.max())} rows > recv_rows={spec.recv_rows}")
        grid = ring_exchange_grid(n, slot, slot // schedule.chunks, schedule.raw_steps(), data.contiguous())
        recv = compact_slots(grid, sizes, slot, spec.recv_rows)
        return recv, torch.from_numpy(np.ascontiguousarray(sizes.T))

    exchange.spec = spec
    exchange.schedule = schedule
    exchange.lowering = low
    return exchange


def build_fused_ici_exchange(
    devices: Optional[Sequence],
    spec: ExchangeSpec,
    num_blocks: int,
    *,
    chunks_per_dest: int = 1,
    lowering: str = "auto",
    schedule=None,
    max_block_rows: Optional[int] = None,
):
    """The fused send side: ``fn(starts, counts, outs, packed, staging,
    size_matrix) -> (recv, recv_sizes)`` — block scatter + scheduled exchange
    in ONE launch (K5), then the compaction (K1, one launch per receiver).

    The plan triple follows ``block_scatter``, one row per executor: ``(n,
    num_blocks)`` int32 tensors on the executors' device, ``starts`` the
    slot-layout destination rows in the executor's staging, ``counts`` the
    rows, ``outs`` the packed source offsets in its packed rows (zero-count
    blocks are no-ops).  ``packed`` is ``(n * P, lane)``, executor i's packed
    map output at rows ``[i * P, (i + 1) * P)``; ``staging`` is ``(n *
    send_rows, lane)``, the slot-layout staging, updated IN PLACE (the JAX
    builder donated it), its untouched rows carried through.  The result has
    ``build_ici_exchange``'s contract.  ``max_block_rows`` bounds the largest
    block, as it sizes the JAX package's portable scatter window; when given,
    a larger block raises (a check that reads the counts back to the host).
    Executors sharing one device only, and more than one."""
    devices = resolve_devices(devices, spec.num_executors)
    spec.validate()
    if spec.num_executors == 1:
        raise ValueError("fused ici exchange needs num_executors > 1")
    n, slot = spec.num_executors, spec.slot_rows
    low, schedule = _flat_schedule(devices, spec, lowering, chunks_per_dest, schedule)

    def exchange(starts, counts, outs, packed: torch.Tensor, staging: torch.Tensor, size_matrix):
        if tuple(staging.shape) != (n * spec.send_rows, spec.lane):
            raise ValueError(f"staging shape {tuple(staging.shape)} != {(n * spec.send_rows, spec.lane)}")
        if tuple(starts.shape) != (n, num_blocks):
            raise ValueError(f"plan shape {tuple(starts.shape)} != {(n, num_blocks)}")
        sizes = _size_matrix(spec, size_matrix)
        received = sizes.sum(axis=0)
        if received.max(initial=0) > spec.recv_rows:
            raise ValueError(f"receiver gets {int(received.max())} rows > recv_rows={spec.recv_rows}")
        if max_block_rows is not None and num_blocks and int(counts.max()) > max(1, max_block_rows):
            raise ValueError(f"a block of {int(counts.max())} rows exceeds max_block_rows={max_block_rows}")
        grid = fused_scatter_ring_grid(
            n, slot, slot // schedule.chunks, schedule.raw_steps(), starts, counts, outs, packed, staging
        )
        recv = compact_slots(grid, sizes, slot, spec.recv_rows)
        return recv, torch.from_numpy(np.ascontiguousarray(sizes.T))

    exchange.spec = spec
    exchange.schedule = schedule
    exchange.lowering = low
    return exchange


def combine_axis_grid(n: int, slot_rows: int, sched: RingSchedule, flat: torch.Tensor, cspec: CombineSpec):
    """Every receiver's identity-seeded accumulator ``(n * G, width)`` +
    ``(n * G, 1)`` of one fused-combine exchange: K4, whose grid the fold
    does not need.  Also the entry point of the fused GROUP BY
    (ops/relational.py)."""
    _grid, accv, accc = ring_combine_grid(n, slot_rows, slot_rows // sched.chunks, sched.raw_steps(), cspec, flat)
    return accv, accc


def build_combine_exchange(
    devices: Optional[Sequence],
    spec: ExchangeSpec,
    cspec: CombineSpec,
    *,
    chunks_per_dest: int = 1,
    lowering: str = "auto",
    schedule=None,
):
    """The fused-combine exchange: ``fn(data, size_matrix, acc_vals,
    acc_counts) -> (acc_vals, acc_counts, recv_sizes)`` — the scheduled ring
    whose receive side is the dense per-group fold (ops/combine.py), never a
    receive buffer.

    * ``data``: ``(n * send_rows, lane)`` slot-layout staging of
      ``[key | payload | count]`` rows (``cspec.row_width`` lanes);
    * ``acc_vals`` ``(n * num_groups, width)`` / ``acc_counts``
      ``(n * num_groups, 1)`` — the running accumulator; the merged one is
      returned as new tensors (the JAX builder donated the inputs);
    * ``recv_sizes``: the (n, n) receive-size matrix, row j = rows j received
      from each sender."""
    devices = resolve_devices(devices, spec.num_executors)
    spec.validate()
    cspec.validate()
    if spec.lane != cspec.row_width:
        raise ValueError(
            f"spec.lane={spec.lane} != combine row width {cspec.row_width} (key + payload + count)"
        )
    if spec.num_executors == 1:
        raise ValueError("combine ici exchange needs num_executors > 1")
    n, slot = spec.num_executors, spec.slot_rows
    low, schedule = _flat_schedule(devices, spec, lowering, chunks_per_dest, schedule)

    def exchange(data: torch.Tensor, size_matrix, acc_vals: torch.Tensor, acc_counts: torch.Tensor):
        if tuple(data.shape) != (n * spec.send_rows, spec.lane):
            raise ValueError(f"data shape {tuple(data.shape)} != {(n * spec.send_rows, spec.lane)}")
        sizes = _size_matrix(spec, size_matrix)
        av, ac = combine_axis_grid(n, slot, schedule, data.contiguous(), cspec)
        acc_vals, acc_counts = merge_accumulators(cspec, (acc_vals, acc_counts), (av, ac))
        return acc_vals, acc_counts, torch.from_numpy(np.ascontiguousarray(sizes.T))

    exchange.spec = spec
    exchange.schedule = schedule
    exchange.lowering = low
    exchange.cspec = cspec
    return exchange
