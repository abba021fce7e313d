"""Ragged block gather and block scatter — the block data plane's two kernels.

Port of ``sparkucx_tpu/ops/pallas_kernels.py`` ``build_block_gather`` /
``build_block_scatter`` (and ``pack_plan``).  The gather packs B
variable-length row runs of a device buffer back to back; it is the whole
shared-device superstep (ops/exchange.py) and the device batch fetch
(transport/tpu.py).  The scatter is its in-place inverse; it places a packed
buffer of map-output blocks at their slot-layout staging rows when a
device-staged round seals (store/hbm_store.py).

Each wrapper takes the plan as three ``(B,)`` int32 tensors on the data's
device — ``starts`` (row of each block on the unpacked side), ``counts`` (rows
per block) and ``outs`` (row of each block on the packed side, the exclusive
cumsum of ``counts``) — and row tensors ``(rows, lane)`` of 32-bit words.
On a CUDA tensor it launches the hand-written Hopper kernel in
``csrc/block_copy.cu`` (built on first use, see ops/cuda_build.py) or raises;
on a CPU tensor it runs the plain PyTorch version beside it, which is also
what the kernel is held against on the card.  Each wrapper's ``launches``
counts its kernel launches.

Bound: both kernels read each packed row once and write it once, so their
least time is ``2 * packed_rows * row_bytes`` over the card's memory
bandwidth; the kernel source says how its design goes after that bound.
The gather copies byte spans and takes any row width of 32-bit words.

A launch costs host time that shows on an idle stream, so the wrappers do
little besides their checks: the library is configured once, the stream is
the raw handle of the device's current stream, and ``torch.cuda.device`` is
entered only when the tensors lie on another device than the current one.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from sparkucx_tpu_torch.utils.devices import upload

_LAUNCHER_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # starts, counts, outs
    ctypes.c_int,  # num_blocks
    ctypes.c_void_p, ctypes.c_void_p,  # src, dst
    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,  # packed, unpacked rows, row bytes
    ctypes.c_void_p,  # stream
]


def pack_plan(
    offsets_lengths: Sequence[Tuple[int, int]], row_bytes: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Host-side plan: byte (offset, length) pairs -> row-granular (starts,
    counts, outs, total_rows).  Offsets must be row-aligned; lengths are padded
    up to whole rows (NvkvShuffleMapOutputWriter.scala:236-246)."""
    starts, counts = [], []
    for off, ln in offsets_lengths:
        if off % row_bytes:
            raise ValueError(f"block offset {off} not {row_bytes}-byte aligned")
        starts.append(off // row_bytes)
        counts.append(-(-ln // row_bytes))
    counts_a = np.asarray(counts, dtype=np.int32)
    outs = (np.cumsum(counts_a) - counts_a).astype(np.int32)
    return np.asarray(starts, dtype=np.int32), counts_a, outs, int(counts_a.sum())


def plan_tensors(starts, counts, outs, device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Validate a host plan and upload it in one ``(3, B)`` copy that does
    not wait for the device (``utils/devices.upload``); returns its three
    rows.  The plan must be packed: every non-empty block's ``outs`` is
    the exclusive cumsum of the counts before it, and ``outs + counts`` never
    decreases (zero-count pads go at the packed end), which the kernels'
    block search relies on."""
    plan = np.stack([np.asarray(a, dtype=np.int64).reshape(-1) for a in (starts, counts, outs)])
    s, c, o = plan
    live = c > 0
    if (c < 0).any() or (s[live] < 0).any():
        raise ValueError("plan starts and counts must be non-negative")
    if (np.diff(o + c) < 0).any() or not np.array_equal(o[live], (np.cumsum(c) - c)[live]):
        raise ValueError("plan is not packed: outs must be the exclusive cumsum of counts")
    if plan.size and (plan.max() >= 2**31 or (s + c).max() >= 2**31):
        raise ValueError("plan rows must fit in int32")
    plan = upload(plan.astype(np.int32), torch.device(device))
    return plan[0], plan[1], plan[2]


_lib = None  #: the configured library, once loaded


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from sparkucx_tpu_torch.ops import cuda_build

        lib = cuda_build.load("block_copy")
        for fn in (lib.block_gather_launch, lib.block_scatter_launch):
            fn.argtypes = _LAUNCHER_ARGTYPES
            fn.restype = ctypes.c_int
        lib.block_copy_error_string.argtypes = [ctypes.c_int]
        lib.block_copy_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check_rows(name: str, t: torch.Tensor) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.dim() != 2 or t.element_size() != 4 or not t.is_contiguous():
        raise ValueError(
            f"{name} must be a contiguous (rows, lane) tensor of 32-bit words, got "
            f"shape {tuple(t.shape)} {t.dtype} contiguous={t.is_contiguous()}"
        )


def _check_plan(starts, counts, outs, device: torch.device) -> int:
    for name, t in (("starts", starts), ("counts", counts), ("outs", outs)):
        # one test on the fast path: a launch's host time shows on an idle stream
        if not (isinstance(t, torch.Tensor) and t.dtype == torch.int32 and t.dim() == 1 and t.is_contiguous()
                and t.device == device):
            if not isinstance(t, torch.Tensor) or t.dtype != torch.int32 or t.dim() != 1:
                raise ValueError(f"{name} must be a 1-D int32 tensor")
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
            raise ValueError(f"{name} is on {t.device}, the rows are on {device}")
    num_blocks = starts.shape[0]
    if counts.shape[0] != num_blocks or outs.shape[0] != num_blocks:
        raise ValueError("starts, counts and outs must have one entry per block")
    return num_blocks


def _launch_args(starts, counts, outs, num_blocks, src, dst, packed_rows, unpacked_rows) -> tuple:
    return (starts.data_ptr(), counts.data_ptr(), outs.data_ptr(), num_blocks, src.data_ptr(), dst.data_ptr(),
            packed_rows, unpacked_rows, src.shape[1] * src.element_size(),
            torch._C._cuda_getCurrentRawStream(src.device.index))


def _launch(fn_name: str, *args) -> None:
    lib = _library()
    fn = getattr(lib, fn_name)
    device = args[4].device
    if device.index == torch.cuda.current_device():
        rc = fn(*_launch_args(*args))
    else:
        with torch.cuda.device(device):
            rc = fn(*_launch_args(*args))
    if rc != 0:
        raise RuntimeError(f"{fn_name} failed: {lib.block_copy_error_string(rc).decode()}")


# -- gather ----------------------------------------------------------------


def _gather_out(src: torch.Tensor, out_rows: int, out: Optional[torch.Tensor]) -> torch.Tensor:
    if out is None:
        return torch.empty((out_rows, src.shape[1]), dtype=src.dtype, device=src.device)
    _check_rows("out", out)
    if out.shape != (out_rows, src.shape[1]) or out.dtype != src.dtype or out.device != src.device:
        raise ValueError(
            f"out {tuple(out.shape)} {out.dtype} {out.device} must be ({out_rows}, {src.shape[1]}) "
            f"{src.dtype} on {src.device}"
        )
    return out


def block_gather_ref(
    starts, counts, outs, src: torch.Tensor, out_rows: int, out: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Plain version: one slice copy per non-empty block.  Rows past the packed
    total are unspecified (``torch.empty``, or what ``out`` held)."""
    out = _gather_out(src, out_rows, out)
    for s, c, o in zip(starts.tolist(), counts.tolist(), outs.tolist()):
        if c > 0:
            out[o : o + c] = src[s : s + c]
    return out


def block_gather(
    starts, counts, outs, src: torch.Tensor, out_rows: int, out: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """``out[outs[b] + k] = src[starts[b] + k]`` for ``k < counts[b]``; returns
    the ``(out_rows, lane)`` output, a new tensor unless the caller passes a
    contiguous ``out`` (a row slice of a larger buffer, say, at any row
    offset).  Its rows past the packed total are UNSPECIFIED (the contract of
    ``build_block_gather``; the kernel leaves them as they were).  The plan is
    packed (``plan_tensors`` checks it) and its blocks lie inside ``src``,
    which ``out`` must not overlap; zero-count entries are no-ops."""
    _check_rows("src", src)
    num_blocks = _check_plan(starts, counts, outs, src.device)
    if out_rows < 0:
        raise ValueError(f"out_rows must be >= 0, got {out_rows}")
    if src.device.type == "cpu":
        return block_gather_ref(starts, counts, outs, src, out_rows, out)
    if src.device.type != "cuda":
        raise ValueError(f"block_gather runs on cuda or cpu tensors, got {src.device}")
    out = _gather_out(src, out_rows, out)
    if num_blocks and out_rows:
        _launch("block_gather_launch", starts, counts, outs, num_blocks, src, out, out_rows, src.shape[0])
        block_gather.launches += 1
    return out


block_gather.launches = 0


def block_gather_args(starts, counts, outs, src: torch.Tensor, out: torch.Tensor) -> tuple:
    """The arguments of one ``block_gather_launch`` (the kernel's C entry)
    on the current stream, for timing the launch alone: ``block_gather``
    without its checks, allocation and count."""
    return _launch_args(starts, counts, outs, int(starts.shape[0]), src, out, out.shape[0], src.shape[0])


# -- scatter ---------------------------------------------------------------


def block_scatter_ref(starts, counts, outs, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Plain version: one slice copy per non-empty block, into ``dst`` in place."""
    for s, c, o in zip(starts.tolist(), counts.tolist(), outs.tolist()):
        if c > 0:
            dst[s : s + c] = src[o : o + c]
    return dst


def block_scatter(starts, counts, outs, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """``dst[starts[b] + k] = src[outs[b] + k]`` for ``k < counts[b]``, IN
    PLACE — the JAX kernel aliased and donated ``dst`` for the same effect
    (``input_output_aliases={4: 0}``).  Rows no block covers keep their
    contents.  Returns ``dst``."""
    _check_rows("src", src)
    _check_rows("dst", dst)
    if src.shape[1] != dst.shape[1] or src.dtype != dst.dtype or src.device != dst.device:
        raise ValueError(
            f"src {tuple(src.shape)} {src.dtype} {src.device} and dst {tuple(dst.shape)} "
            f"{dst.dtype} {dst.device} must share lane width, dtype and device"
        )
    num_blocks = _check_plan(starts, counts, outs, src.device)
    if src.device.type == "cpu":
        return block_scatter_ref(starts, counts, outs, src, dst)
    if src.device.type != "cuda":
        raise ValueError(f"block_scatter runs on cuda or cpu tensors, got {src.device}")
    if num_blocks and src.shape[0]:
        _launch(
            "block_scatter_launch", starts, counts, outs, num_blocks, src, dst, src.shape[0], dst.shape[0]
        )
        block_scatter.launches += 1
    return dst


block_scatter.launches = 0
