"""The scheduled ring exchange (K3), its receive-side combine (K4) and the
fused send side (K5).

Port of the ring section of ``sparkucx_tpu/ops/pallas_kernels.py``
(``ring_exchange_grid``, ``ring_combine_grid``, ``fused_scatter_ring_grid``
and their schedule walk ``_ring_exchange_steps``).  On the TPU each device
pushed its windows into its peers' memory by remote DMA, one ``(offset,
chunk)`` window per ring direction per step.  Here every executor shares one card, so a remote window is a
device-local copy and one launch moves all of them.

Layouts, for ``n`` executors and ``slot`` rows per destination:

* ``data``: ``(n * n * slot, lane)`` — executor i's staging is rows
  ``[i * n * slot, (i + 1) * n * slot)``, destination-major (its region for
  receiver j starts at row ``j * slot``);
* the grid, same shape — receiver j's is rows ``[j * n * slot, ...)``,
  sender-major: its row ``i * slot + r`` is row ``j * slot + r`` of sender
  i's staging, the dense all-to-all's output layout;
* K5's packed map output ``(n * P, lane)`` — executor i's is rows
  ``[i * P, (i + 1) * P)`` — and its plan, three ``(n, num_blocks)`` int32
  tensors: row i holds executor i's blocks, ``starts`` local to its staging,
  ``outs`` local to its packed rows (``block_scatter``'s contract).

The schedule (``ops/ici_exchange.ring_schedule``: steps of ``(offset, chunk,
direction)`` items) becomes a window table, receiver-major and in the
canonical fold order within a receiver: the own slot, then one window of
``window_rows`` rows per item, from sender ``(j - offset) mod n`` at chunk
``chunk``.  K4 folds the windows in exactly that order (ops/combine.py).

Each wrapper takes CUDA or CPU tensors.  On a CUDA tensor it launches the
hand-written Hopper kernels of ``csrc/ring_exchange.cu`` (built on first use,
ops/cuda_build.py) or raises; on a CPU tensor it runs the plain PyTorch
version beside it, which is also what the kernels are held against on the
card.  Each wrapper's ``launches`` counts the calls that launched its kernels.

K3 keeps its window table on the device, looked up by schedule in a bounded
cache (:func:`window_table`), and passes the receivers' grid pointers by
value in its launch's parameters: a call checks its operands, allocates the
grid and launches, and uploads nothing.  One launch addresses at most
``MAX_EXECUTORS`` receivers, so a call launches once per group of them
(:func:`receiver_groups`); any number of executors runs, as on the TPU.
K4's global tier runs on the same launches (folding as it copies, or
landing the grid for its ordered fold); K4's shared tier and K5 build their
tables per call (``_Launch``).
"""

from __future__ import annotations

import ctypes
import threading
from collections import OrderedDict
from typing import List, NamedTuple

import numpy as np
import torch

from sparkucx_tpu_torch.ops.block_kernels import block_scatter_ref
from sparkucx_tpu_torch.ops.combine import CombineSpec, acc_init, combine_window
from sparkucx_tpu_torch.utils.devices import upload

#: rows one CTA copies (and folds) at most; spans never cross a window
MAX_SPAN_ROWS = 1 << 16
#: the least span, and the number of spans a launch aims for (a few per SM)
MIN_SPAN_ROWS = 256
TARGET_SPANS = 1024
#: K4 keeps its per-span accumulator in shared memory up to this size, and
#: folds into the accumulator in device memory beyond it
SMEM_FOLD_BYTES = 64 * 1024
#: scratch the shared-memory tier may spend on per-span partials
PARTIALS_BUDGET_BYTES = 256 << 20
#: aggregate columns the kernel folds (``kMaxWidth`` in the source)
MAX_WIDTH = 16
#: receivers one K3 launch addresses (``kMaxExecs`` in the source): their
#: grid pointers travel in the launch's parameters
MAX_EXECUTORS = 64
#: K3 window tables kept on the devices, by schedule (as many exchange
#: functions as ``transport/tpu.py`` caches)
WINDOW_CACHE_SIZE = 32
_OPS = {"sum": 0, "avg": 0, "min": 1, "max": 2}
_INT_MAX = 2**31 - 1

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_INTS = ctypes.POINTER(ctypes.c_int)


def ring_windows(num_devices: int, slot_rows: int, window_rows: int, steps) -> np.ndarray:
    """The ``(num_windows, 5)`` int64 window table ``(receiver, sender,
    src_row, dst_row, rows)``: receiver-major, and within a receiver the own
    slot first, then one window per schedule item in step order.  ``src_row``
    is the row in the sender's staging, ``dst_row`` the row in the receiver's
    grid."""
    n, slot, w = num_devices, slot_rows, window_rows
    table = []
    for j in range(n):
        table.append((j, j, j * slot, j * slot, slot))
        for step in steps:
            for offset, chunk, _direction in step:
                i = (j - offset) % n
                table.append((j, i, j * slot + chunk * w, i * slot + chunk * w, w))
    return np.asarray(table, dtype=np.int64).reshape(-1, 5)


class WindowTable(NamedTuple):
    """K3's window table on one device: ``tensor`` holds, as int64, the
    ``(num_windows, 5)`` :func:`ring_windows` table, then its row prefix
    (``num_windows + 1`` entries, the last ``total_rows``)."""

    tensor: torch.Tensor
    num_windows: int
    total_rows: int


_window_tables: "OrderedDict[tuple, WindowTable]" = OrderedDict()  #: guarded by _window_lock
_window_lock = threading.Lock()


def window_table(num_devices: int, slot_rows: int, window_rows: int, steps, device) -> WindowTable:
    """K3's window table for this schedule on ``device``: built, checked and
    uploaded on first use, then taken from a cache of the
    ``WINDOW_CACHE_SIZE`` most recently used schedules."""
    if not isinstance(device, torch.device):
        device = torch.device(device)
    key = (num_devices, slot_rows, window_rows, steps, device)
    try:
        hash(key)  # RingSchedule.raw_steps() is hashable as it is
    except TypeError:
        steps = tuple(tuple(tuple(item) for item in step) for step in steps)
        key = (num_devices, slot_rows, window_rows, steps, device)
    with _window_lock:
        hit = _window_tables.get(key)
        if hit is not None:
            _window_tables.move_to_end(key)
            return hit
    _check_schedule(num_devices, slot_rows, window_rows, steps)
    table = ring_windows(num_devices, slot_rows, window_rows, steps)
    prefix = np.concatenate([[0], np.cumsum(table[:, 4])]).astype(np.int64)
    entry = WindowTable(upload(np.concatenate([table.reshape(-1), prefix]), device), table.shape[0], int(prefix[-1]))
    with _window_lock:
        _window_tables[key] = entry
        _window_tables.move_to_end(key)
        while len(_window_tables) > WINDOW_CACHE_SIZE:
            _window_tables.popitem(last=False)
    return entry


class ReceiverGroup(NamedTuple):
    """The receivers one K3 launch (or K4 global-tier launch) addresses."""

    first: int  #: its first receiver
    receivers: int  #: how many, at most MAX_EXECUTORS
    first_window: int  #: its first row of the window table
    windows: int  #: its rows of the window table


def receiver_groups(num_devices: int, num_windows: int) -> List[ReceiverGroup]:
    """Receivers ``[0, num_devices)`` cut into groups of at most
    ``MAX_EXECUTORS``, each with its windows: the table is receiver-major with
    ``num_windows / num_devices`` windows a receiver, so a group's windows are
    one contiguous run of it."""
    per = num_windows // num_devices
    groups = []
    for first in range(0, num_devices, MAX_EXECUTORS):
        receivers = min(MAX_EXECUTORS, num_devices - first)
        groups.append(ReceiverGroup(first, receivers, first * per, receivers * per))
    return groups


def _check_data(name: str, data: torch.Tensor, num_devices: int, slot_rows: int) -> None:
    if not isinstance(data, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(data).__name__}")
    if data.dim() != 2 or data.element_size() != 4 or not data.is_contiguous():
        raise ValueError(f"{name} must be a contiguous (rows, lane) tensor of 32-bit words")
    if data.shape[0] != num_devices * num_devices * slot_rows:
        raise ValueError(
            f"{name} has {data.shape[0]} rows, expected n * n * slot = "
            f"{num_devices * num_devices * slot_rows}"
        )


def _check_schedule(num_devices: int, slot_rows: int, window_rows: int, steps) -> None:
    if num_devices < 1 or slot_rows < 1 or window_rows < 1:
        raise ValueError("num_devices, slot_rows and window_rows must be positive")
    for step in steps:
        for offset, chunk, _direction in step:
            if not (0 < offset < num_devices) or chunk < 0 or (chunk + 1) * window_rows > slot_rows:
                raise ValueError(f"schedule item ({offset}, {chunk}) outside {num_devices} x {slot_rows}")


# -- plain versions ----------------------------------------------------------


def ring_exchange_grid_ref(
    num_devices: int, slot_rows: int, window_rows: int, steps, data: torch.Tensor
) -> torch.Tensor:
    """Plain version of K3: one slice copy per window, in schedule order.
    Grid rows that no window covers (an incomplete schedule) are unspecified."""
    ns = num_devices * slot_rows
    grid = torch.empty_like(data)
    for j, i, s, d, r in ring_windows(num_devices, slot_rows, window_rows, steps).tolist():
        grid[j * ns + d : j * ns + d + r] = data[i * ns + s : i * ns + s + r]
    return grid


def ring_combine_grid_ref(
    num_devices: int, slot_rows: int, window_rows: int, steps, cspec: CombineSpec, data: torch.Tensor
):
    """Plain version of K4: the K3 grid, and every receiver's accumulator
    ``(n * G, width)`` + ``(n * G, 1)`` with the windows of the schedule
    folded in canonical order by :func:`combine_window`, read straight from
    the staging."""
    n, g, ns = num_devices, cspec.num_groups, num_devices * slot_rows
    grid = ring_exchange_grid_ref(n, slot_rows, window_rows, steps, data)
    vals, counts = acc_init(cspec, data.device)
    acc_vals, acc_counts = vals.repeat(n, 1), counts.repeat(n, 1)
    for j, i, s, _d, r in ring_windows(n, slot_rows, window_rows, steps).tolist():
        combine_window(
            cspec, data[i * ns + s : i * ns + s + r],
            acc_vals[j * g : (j + 1) * g], acc_counts[j * g : (j + 1) * g],
        )
    return grid, acc_vals, acc_counts


# -- the kernels -------------------------------------------------------------


_lib = None  #: the configured library, once loaded


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    from sparkucx_tpu_torch.ops import cuda_build

    lib = cuda_build.load("ring_exchange")
    span = [_P, _P, _I, _L, _L, _P, _P, _L, _I]  # windows .. row_bytes, wide
    copy = [_P, _I, _I, _I, _L, _I, _I, _L, _L, _L, _L]  # table .. row_bytes (ring_exchange_args)
    fold = [_INTS, _I, _I, _I, _I, _I, _P, _P]  # ops, width, G, is_float, qblock, wq4, acc_vals, acc_counts
    lib.ring_exchange_launch.argtypes = copy + [_P]
    lib.ring_combine_global_launch.argtypes = copy + fold + [_P]
    lib.ring_ordered_fold_launch.argtypes = [
        _P, _I, _I, _I, _L, _L, _L, _L, _P, _P, _P, _P, _INTS, _I, _I, _I, _I, _P, _P, _P,
    ]
    lib.ring_acc_launch.argtypes = [_INTS, _I, _I, _L, _P, _P]
    lib.fused_scatter_launch.argtypes = [_P, _P, _P, _I, _I, _P, _L, _L, _P, _P, _I, _L, _L, _I, _P]
    lib.fused_scatter_grid_size.argtypes = [_I]
    lib.fused_scatter_grid_size.restype = ctypes.c_int
    lib.ring_fold_launch.argtypes = span + [_INTS, _I, _I, _I, _I, _I, _P, _P]
    lib.ring_merge_launch.argtypes = [_P, _I, _I, _P, _INTS, _I, _I, _I, _P, _P, _P]
    for fn in (lib.ring_exchange_launch, lib.ring_fold_launch, lib.ring_merge_launch,
               lib.ring_combine_global_launch, lib.ring_ordered_fold_launch, lib.ring_acc_launch,
               lib.fused_scatter_launch, lib.ring_max_width, lib.ring_max_execs):
        fn.restype = ctypes.c_int
    if lib.ring_max_width() != MAX_WIDTH:
        raise RuntimeError(f"ring_exchange.cu folds {lib.ring_max_width()} columns, MAX_WIDTH is {MAX_WIDTH}")
    if lib.ring_max_execs() != MAX_EXECUTORS:
        raise RuntimeError(f"ring_exchange.cu addresses {lib.ring_max_execs()} executors, MAX_EXECUTORS is {MAX_EXECUTORS}")
    lib.ring_error_string.argtypes = [ctypes.c_int]
    lib.ring_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def _check(lib, name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} failed: {lib.ring_error_string(rc).decode()}")


def span_rows_for(total_rows: int, part_bytes: int = 0) -> int:
    """Rows per span: enough spans to fill the card (about TARGET_SPANS), at
    most MAX_SPAN_ROWS rows each, and, when each span keeps a ``part_bytes``
    partial, no more spans than PARTIALS_BUDGET_BYTES holds."""
    rows = max(MIN_SPAN_ROWS, min(MAX_SPAN_ROWS, -(-total_rows // TARGET_SPANS)))
    if part_bytes:
        rows = max(rows, -(-total_rows * part_bytes // PARTIALS_BUDGET_BYTES))
    return -(-rows // MIN_SPAN_ROWS) * MIN_SPAN_ROWS


class _Launch:
    """Device tables of one K4 fold or K5 launch: the window table, its span
    prefix and the per-executor pointer tables of the staging and the grid.
    K5 also passes ``packed``; its tables then run, as int64, packed,
    staging and grid pointers, and a zero barrier counter (``self.fused``)."""

    def __init__(self, num_devices, slot_rows, window_rows, steps, data, grid, part_bytes=0, packed=None):
        device = data.device
        table = ring_windows(num_devices, slot_rows, window_rows, steps)
        self.num_windows = table.shape[0]
        self.per_receiver = self.num_windows // num_devices
        self.window_rows = table[:, 4]
        self.span_rows = span_rows_for(int(self.window_rows.sum()), part_bytes)
        spans = -(-self.window_rows // self.span_rows)
        span_start = np.concatenate([[0], np.cumsum(spans)]).astype(np.int64)
        self.total_spans = int(span_start[-1])
        self.row_bytes = data.shape[1] * 4
        stride = num_devices * slot_rows * self.row_bytes
        src = [data.data_ptr() + i * stride for i in range(num_devices)]
        dst = [grid.data_ptr() + i * stride for i in range(num_devices)]
        front, back, ptrs = [], [], src + dst
        if packed is not None:
            pstride = packed.shape[0] // num_devices * self.row_bytes
            pk = [packed.data_ptr() + i * pstride for i in range(num_devices)]
            front, back, ptrs = pk, [0], ptrs + pk
        self.wide = int(self.row_bytes % 16 == 0 and all(p % 16 == 0 for p in ptrs))
        packed_tables = np.concatenate([
            table.reshape(-1), span_start, np.asarray(front + src + dst + back, np.int64),
        ])
        self.tables = upload(packed_tables, device)  # one upload, not waiting for the stream
        nt = table.size
        self.windows = self.tables.data_ptr()
        self.span_start = self.windows + nt * 8
        self.fused = self.span_start + span_start.size * 8
        self.src = self.fused + len(front) * 8
        self.dst = self.src + num_devices * 8
        with torch.cuda.device(device):
            self.stream = torch.cuda.current_stream(device).cuda_stream

    def span_args(self):
        return (
            self.windows, self.span_start, self.num_windows, self.total_spans, self.span_rows,
            self.src, self.dst, self.row_bytes, self.wide,
        )


def _check_device(data: torch.Tensor, name: str) -> None:
    if data.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, got {data.device}")


def ring_exchange_args(num_devices: int, slot_rows: int, window_rows: int, steps, data, grid) -> List[tuple]:
    """The arguments of K3's launches (``ring_exchange_launch`` in the source)
    from ``data`` into ``grid`` on the current stream, one tuple a receiver
    group (:func:`receiver_groups`): the cached window table, the group's
    windows, rows and receivers, the staging and grid bases and the bytes of
    one executor's part, the stream."""
    table = window_table(num_devices, slot_rows, window_rows, steps, data.device)
    row_bytes = data.shape[1] * 4
    rows = table.total_rows // num_devices  # every receiver lands the same rows
    # the raw stream handle, without building a torch.cuda.Stream: a call's host
    # time before its launch shows in its time when the stream is idle
    stream = torch._C._cuda_getCurrentRawStream(data.device.index)
    bases = (data.data_ptr(), grid.data_ptr(), num_devices * slot_rows * row_bytes, row_bytes)
    return [(table.tensor.data_ptr(), table.num_windows, g.first_window, g.windows, g.receivers * rows, g.first,
             g.receivers) + bases + (stream,) for g in receiver_groups(num_devices, table.num_windows)]


def ring_exchange_grid(
    num_devices: int, slot_rows: int, window_rows: int, steps, data: torch.Tensor
) -> torch.Tensor:
    """K3: every executor's destination-major staging -> every receiver's
    sender-major grid (module docstring), all windows of the schedule in one
    launch per group of ``MAX_EXECUTORS`` receivers.  ``steps``: the raw
    schedule, steps of ``(offset, chunk, direction)``
    (``RingSchedule.raw_steps()``).  Returns a new ``(n * n * slot, lane)``
    tensor."""
    _check_data("data", data, num_devices, slot_rows)
    if data.device.type == "cpu":
        _check_schedule(num_devices, slot_rows, window_rows, steps)
        return ring_exchange_grid_ref(num_devices, slot_rows, window_rows, steps, data)
    _check_device(data, "ring_exchange_grid")
    grid = torch.empty_like(data)
    lib = _library()
    for args in ring_exchange_args(num_devices, slot_rows, window_rows, steps, data, grid):
        _check(lib, "ring_exchange_launch", lib.ring_exchange_launch(*args))
    ring_exchange_grid.launches += 1
    return grid


ring_exchange_grid.launches = 0


def _check_fused(num_devices: int, slot_rows: int, starts, counts, outs, packed, staging) -> None:
    """K5's operand checks (types, shapes, devices).  The plan's contents are
    ``block_scatter``'s contract, checked where a plan is built
    (``plan_tensors``), not here: reading it back would stall the stream.
    The kernel copies no row outside its executor's packed rows or staging."""
    n = num_devices
    _check_data("staging", staging, n, slot_rows)
    if not isinstance(packed, torch.Tensor) or packed.dim() != 2 or not packed.is_contiguous():
        raise ValueError("packed must be a contiguous (rows, lane) tensor")
    if packed.dtype != staging.dtype or packed.shape[1] != staging.shape[1] or packed.device != staging.device:
        raise ValueError(
            f"packed {tuple(packed.shape)} {packed.dtype} {packed.device} must share lane width, dtype "
            f"and device with staging {tuple(staging.shape)} {staging.dtype} {staging.device}"
        )
    if packed.shape[0] % n:
        raise ValueError(f"packed has {packed.shape[0]} rows, not a multiple of {n} executors")
    for name, t in (("starts", starts), ("counts", counts), ("outs", outs)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.int32 or t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous (num_devices, num_blocks) int32 tensor")
        if t.shape[0] != n or t.shape != starts.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected ({n}, num_blocks) like starts")
        if t.device != staging.device:
            raise ValueError(f"{name} is on {t.device}, staging on {staging.device}")


def fused_scatter_ring_grid_ref(
    num_devices: int, slot_rows: int, window_rows: int, steps, starts, counts, outs,
    packed: torch.Tensor, staging: torch.Tensor,
) -> torch.Tensor:
    """Plain version of K5: ``block_scatter_ref`` into each executor's staging,
    in place, then ``ring_exchange_grid_ref`` out of it."""
    n, ns, p = num_devices, num_devices * slot_rows, packed.shape[0] // num_devices
    for i in range(n):
        block_scatter_ref(starts[i], counts[i], outs[i], packed[i * p : (i + 1) * p], staging[i * ns : (i + 1) * ns])
    return ring_exchange_grid_ref(n, slot_rows, window_rows, steps, staging)


def fused_scatter_ring_grid(
    num_devices: int, slot_rows: int, window_rows: int, steps, starts, counts, outs,
    packed: torch.Tensor, staging: torch.Tensor,
) -> torch.Tensor:
    """K5, the fused send side: every executor's packed map-output blocks
    scattered into its slot-layout staging — IN PLACE, where the JAX kernel
    aliased the staging to its second output — then K3's schedule run
    straight out of that staging, in one launch.  ``starts``/``counts``/
    ``outs``: ``(n, num_blocks)`` int32 on the data's device (module
    docstring), each row a packed plan as ``plan_tensors`` checks it;
    ``packed``: ``(n * P, lane)``; ``staging``: ``(n * n * slot, lane)``,
    whose rows no block covers carry into the grid unchanged.  Returns the
    ``(n * n * slot, lane)`` sender-major grid."""
    _check_schedule(num_devices, slot_rows, window_rows, steps)
    _check_fused(num_devices, slot_rows, starts, counts, outs, packed, staging)
    if staging.device.type == "cpu":
        return fused_scatter_ring_grid_ref(
            num_devices, slot_rows, window_rows, steps, starts, counts, outs, packed, staging
        )
    _check_device(staging, "fused_scatter_ring_grid")
    grid = torch.empty_like(staging)
    launch = _Launch(num_devices, slot_rows, window_rows, steps, staging, grid, packed=packed)
    lib = _library()
    _check(lib, "fused_scatter_launch", lib.fused_scatter_launch(
        starts.data_ptr(), counts.data_ptr(), outs.data_ptr(), starts.shape[1], num_devices, launch.fused,
        packed.shape[0] // num_devices, num_devices * slot_rows, launch.windows, launch.span_start,
        launch.num_windows, launch.span_rows, launch.row_bytes, launch.wide, launch.stream))
    fused_scatter_ring_grid.launches += 1
    return grid


fused_scatter_ring_grid.launches = 0


def fused_scatter_grid_ctas(wide: bool = True) -> int:
    """CTAs one cooperative K5 launch uses on the current CUDA device: all
    that can be resident at once (occupancy x SMs)."""
    ctas = _library().fused_scatter_grid_size(int(wide))
    if ctas <= 0:
        raise RuntimeError(f"no cooperative K5 launch on this device: {_library().ring_error_string(-ctas).decode()}")
    return ctas


def _fold_args(cspec: CombineSpec):
    q = cspec.qspec
    ops = (ctypes.c_int * max(1, cspec.width))(*[_OPS[a] for a in cspec.aggs])
    is_float = int(np.issubdtype(np.dtype(cspec.dtype), np.floating))
    qblock = q.block_size if q is not None else 0
    wq4 = q.padded_width(cspec.width) // 4 if q is not None else 0
    return ops, is_float, qblock, wq4


def ring_combine_grid(
    num_devices: int, slot_rows: int, window_rows: int, steps, cspec: CombineSpec, data: torch.Tensor
):
    """K4: K3's grid, and every landed window of ``[key | payload | count]``
    rows folded (dequantized first when ``cspec`` quantizes) into its
    receiver's dense accumulator, own slot first, then the items in step
    order.  Returns ``(grid (n * n * slot, lane), acc_vals (n * G, width) of
    cspec.dtype, acc_counts (n * G, 1) int32)``: receiver j's accumulator is
    rows ``[j * G, (j + 1) * G)``.  Deterministic: two calls on the same
    inputs return the same bits.  Float min and max fold as
    ``combine_window`` does (-0.0 below +0.0, a NaN's own bits passed on).  On the card
    the global tier (see :func:`ring_combine_tier`) issues a fixed number of
    launches and never waits for the device: one per group of
    ``MAX_EXECUTORS`` receivers (two where a float sum keeps its order)."""
    cspec.validate()
    _check_data("data", data, num_devices, slot_rows)
    _check_schedule(num_devices, slot_rows, window_rows, steps)
    if data.shape[1] != cspec.row_width or data.dtype != cspec.torch_dtype:
        raise ValueError(
            f"data {tuple(data.shape)} {data.dtype} must have {cspec.row_width} lanes "
            f"(key + payload + count) of {cspec.torch_dtype}"
        )
    if data.device.type == "cpu":
        return ring_combine_grid_ref(num_devices, slot_rows, window_rows, steps, cspec, data)
    if cspec.width > MAX_WIDTH:
        raise ValueError(f"the ring combine kernel folds at most {MAX_WIDTH} columns, got {cspec.width}")
    tier = ring_combine_tier(cspec)
    _check_device(data, "ring_combine_grid")
    n, g, w = num_devices, cspec.num_groups, cspec.width
    grid = torch.empty_like(data)
    acc_vals = torch.empty((n * g, w), dtype=cspec.torch_dtype, device=data.device)
    acc_counts = torch.empty((n * g, 1), dtype=torch.int32, device=data.device)
    lib = _library()
    if tier == "shared":
        ops, is_float, qblock, wq4 = _fold_args(cspec)
        launch = _Launch(n, slot_rows, window_rows, steps, data, grid, part_bytes=g * (w + 1) * 4)
        partials = torch.empty(launch.total_spans * g * (w + 1), dtype=torch.int32, device=data.device)
        _check(lib, "ring_fold_launch", lib.ring_fold_launch(
            *launch.span_args(), ops, w, g, is_float, qblock, wq4, partials.data_ptr(), launch.stream))
        _check(lib, "ring_merge_launch", lib.ring_merge_launch(
            launch.span_start, n, launch.per_receiver, partials.data_ptr(), ops, w, g, is_float,
            acc_vals.data_ptr(), acc_counts.data_ptr(), launch.stream))
    else:
        _combine_global(lib, n, slot_rows, window_rows, steps, cspec, data, grid, acc_vals, acc_counts)
    ring_combine_grid.launches += 1
    return grid, acc_vals, acc_counts


ring_combine_grid.launches = 0


def _combine_global(lib, n, slot_rows, window_rows, steps, cspec, data, grid, acc_vals, acc_counts) -> None:
    """K4's global tier on the current stream (``ring_combine_grid``): the
    identities, then per receiver group either one launch that copies and
    folds with atomics, or, with a float sum column, K3's copy and one
    cooperative fold in canonical order; no host sync."""
    ops, is_float, qblock, wq4 = _fold_args(cspec)
    w, g = cspec.width, cspec.num_groups
    av, ac = acc_vals.data_ptr(), acc_counts.data_ptr()
    groups = ring_exchange_args(n, slot_rows, window_rows, steps, data, grid)
    stream = groups[0][-1]
    acc_counts.zero_()
    _check(lib, "ring_acc_launch", lib.ring_acc_launch(ops, w, is_float, n * g, av, stream))
    ordered = bool(is_float) and any(_OPS[a] == _OPS["sum"] for a in cspec.aggs)
    if not ordered:
        for args in groups:
            _check(lib, "ring_combine_global_launch", lib.ring_combine_global_launch(
                *args[:-1], ops, w, g, is_float, qblock, wq4, av, ac, stream))
        return
    per_receiver = groups[0][3] // groups[0][6]  # a group's windows over its receivers
    done = torch.zeros(n * slot_rows, dtype=torch.int32, device=data.device)
    owner = torch.full((n * g,), _INT_MAX, dtype=torch.int32, device=data.device)
    sync = torch.zeros(1 + len(groups), dtype=torch.int32, device=data.device)  # barrier, pending a group
    for k, args in enumerate(groups):
        _check(lib, "ring_exchange_launch", lib.ring_exchange_launch(*args))
        table, _nw, first_window, _windows, _rows, _first, receivers, _src, grid_base, exec_bytes, row_bytes, _s = args
        _check(lib, "ring_ordered_fold_launch", lib.ring_ordered_fold_launch(
            table, first_window, per_receiver, receivers, grid_base, exec_bytes, row_bytes, slot_rows,
            done.data_ptr(), owner.data_ptr(), sync.data_ptr(), sync.data_ptr() + 4 * (1 + k),
            ops, w, g, qblock, wq4, av, ac, stream))


def ring_combine_tier(cspec: CombineSpec) -> str:
    """Which accumulator K4 uses for ``cspec``: ``'shared'`` (per-span
    partials in shared memory, merged in canonical order) or ``'global'``
    (rounds over the accumulator in device memory)."""
    return "shared" if cspec.num_groups * (cspec.width + 1) * 4 <= SMEM_FOLD_BYTES else "global"
