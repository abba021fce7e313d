"""Device LSD radix sort of fused (key | payload) rows — kernel K6.

Port of ``sparkucx_tpu/ops/radix.py``.  Rows are ``(N, L)`` tensors of any
32-bit dtype; they sort stably by the uint32 bitcast of word 0, and the key
moves with its payload.  Each pass is a stable counting sort on one
``BITS``-wide digit:

1. the per-tile digit histogram, stored bucket-major ``(NUM_BUCKETS, tiles)``
   (a kernel on the card);
2. ``pass_dests``: the first output row of every (bucket, tile) segment —
   the rows of smaller buckets plus the rows of this bucket in earlier tiles,
   which in bucket-major order is one flat exclusive cumsum (a torch op, as
   the JAX package does its two cumsums in XLA outside its kernel);
3. the scatter: every row goes to its segment's row plus its stable rank in
   the segment, all its words at once.

``radix_pass`` is the wrapper: on a CUDA tensor it launches the hand-written
Hopper kernels of ``csrc/radix_sort.cu`` (built on first use, see
ops/cuda_build.py) or raises; on a CPU tensor it runs ``radix_pass_ref``, the
plain PyTorch version beside it, which the kernel is held against on the card.
``radix_pass.launches`` counts the passes that launched the kernels.

The port's digit is 8 bits (four passes), where the TPU kernel used 4 bits
(eight passes): a stable sort gives the same rows either way, and four passes
move half the bytes.  The tile, ``TILE_ROWS`` rows a CTA, is a constant of
the kernels; rows need no padding to a multiple of it: the kernels mask the
last tile's edge.

Bound: each pass reads and writes every row once and reads the key word once,
so a pass takes at least ``(2 * N * row_bytes + 4 * N)`` over the card's
memory bandwidth, and the whole sort ``NUM_PASSES`` times that.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

#: digit width per pass; must equal kBits in csrc/radix_sort.cu
BITS = 8
NUM_BUCKETS = 1 << BITS
NUM_PASSES = 32 // BITS
#: rows per CTA tile; must equal kTileRows in csrc/radix_sort.cu (the kernel
#: walks its tile in 256-row chunks)
TILE_ROWS = 8192

_U32_MASK = 0xFFFFFFFF


def clamped_tile_rows(tile_rows: int, n: int) -> int:
    """The JAX package's tile clamp, kept for API parity: shrink an oversized
    tile toward ``n`` while staying an 8-row multiple."""
    return min(tile_rows, -(-max(8, n) // 8) * 8)


def digits(rows: torch.Tensor, shift: int) -> torch.Tensor:
    """This pass's digit of every row's uint32 key (word 0), as int64."""
    key = rows[:, 0].view(torch.int32).to(torch.int64) & _U32_MASK
    return (key >> shift) & (NUM_BUCKETS - 1)


def pass_dests(hist: torch.Tensor) -> torch.Tensor:
    """Bucket-major ``(B, tiles)`` digit counts -> ``(B, tiles)`` int64 first
    output row of each (bucket, tile) segment: the rows of smaller buckets,
    plus the rows of this bucket in earlier tiles (the JAX package's
    ``bucket_start + tile_prefix``, ``radix.py:270-278``).  Segments are laid
    out in bucket-major order, so that is one flat exclusive cumsum."""
    flat = hist.reshape(-1).to(torch.int64)
    return (torch.cumsum(flat, dim=0) - flat).view(hist.shape)


def _check(rows: torch.Tensor, shift: int) -> None:
    if not isinstance(rows, torch.Tensor):
        raise TypeError(f"rows must be a torch.Tensor, got {type(rows).__name__}")
    if rows.dim() != 2 or rows.element_size() != 4 or not rows.is_contiguous() or rows.shape[1] < 1:
        raise ValueError(
            f"rows must be a contiguous (N, L>=1) tensor of 32-bit words, got shape "
            f"{tuple(rows.shape)} {rows.dtype} contiguous={rows.is_contiguous()}"
        )
    if not 0 <= shift < 32:
        raise ValueError(f"shift must be in [0, 32), got {shift}")


def radix_pass_ref(rows: torch.Tensor, shift: int) -> torch.Tensor:
    """Plain version of one pass: what a stable counting pass computes, the
    rows stably sorted by this pass's digit.  Returns a new tensor."""
    return rows.index_select(0, torch.argsort(digits(rows, shift), stable=True))


def _library() -> ctypes.CDLL:
    from sparkucx_tpu_torch.ops import cuda_build

    lib = cuda_build.load("radix_sort")
    common = [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int]
    lib.radix_histogram_launch.argtypes = [ctypes.c_void_p, *common, ctypes.c_void_p, ctypes.c_void_p]
    lib.radix_scatter_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, *common, ctypes.c_void_p, ctypes.c_void_p,
    ]
    for fn in (lib.radix_histogram_launch, lib.radix_scatter_launch, lib.radix_bits):
        fn.restype = ctypes.c_int
    lib.radix_tile_rows.restype = ctypes.c_longlong
    lib.radix_sort_error_string.argtypes = [ctypes.c_int]
    lib.radix_sort_error_string.restype = ctypes.c_char_p
    if lib.radix_bits() != BITS:
        raise RuntimeError(f"csrc/radix_sort.cu sorts {lib.radix_bits()}-bit digits, the wrapper {BITS}")
    if lib.radix_tile_rows() != TILE_ROWS:
        raise RuntimeError(f"csrc/radix_sort.cu has tiles of {lib.radix_tile_rows()} rows, the wrapper {TILE_ROWS}")
    return lib


def _raise_on(lib, name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} failed: {lib.radix_sort_error_string(rc).decode()}")


def _histogram(rows: torch.Tensor, shift: int) -> torch.Tensor:
    """Launch the histogram kernel: (B, tiles) int32 digit counts, bucket-major."""
    lib = _library()
    tiles = -(-rows.shape[0] // TILE_ROWS)
    hist = torch.empty((NUM_BUCKETS, tiles), dtype=torch.int32, device=rows.device)
    _raise_on(lib, "radix_histogram_launch", lib.radix_histogram_launch(
        rows.data_ptr(), rows.shape[0], rows.shape[1], shift, hist.data_ptr(),
        torch.cuda.current_stream(rows.device).cuda_stream))
    return hist


def _scatter(rows: torch.Tensor, shift: int, dests: torch.Tensor, out: torch.Tensor) -> None:
    """Launch the scatter kernel: ``out`` <- rows placed by ``dests``."""
    lib = _library()
    _raise_on(lib, "radix_scatter_launch", lib.radix_scatter_launch(
        rows.data_ptr(), out.data_ptr(), rows.shape[0], rows.shape[1], shift, dests.data_ptr(), torch.cuda.current_stream(rows.device).cuda_stream))


def radix_pass(rows: torch.Tensor, shift: int, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One stable counting pass on the digit ``(key >> shift) & (B - 1)`` of
    the uint32 key in word 0: rows with smaller digits first, equal digits in
    input order.  Writes ``out`` (a new tensor when None; it must not overlap
    ``rows``) and returns it."""
    _check(rows, shift)
    if out is None:
        out = torch.empty_like(rows)
    elif out.shape != rows.shape or out.dtype != rows.dtype or out.device != rows.device or not out.is_contiguous():
        raise ValueError("out must be a contiguous tensor of the rows' shape, dtype and device")
    elif out.data_ptr() == rows.data_ptr() and rows.numel():
        raise ValueError("out must not be the rows tensor")
    if rows.device.type == "cpu":
        out.copy_(radix_pass_ref(rows, shift))
        return out
    if rows.device.type != "cuda":
        raise ValueError(f"radix_pass runs on cuda or cpu tensors, got {rows.device}")
    if rows.shape[0] == 0:
        return out
    with torch.cuda.device(rows.device):
        _scatter(rows, shift, pass_dests(_histogram(rows, shift)), out)
    radix_pass.launches += 1
    return out


radix_pass.launches = 0


def _passes(src: torch.Tensor, bufs) -> torch.Tensor:
    cur = src
    for p in range(NUM_PASSES):
        cur = radix_pass(cur, p * BITS, out=bufs[p % 2])
    return cur


def radix_sort_rows(rows: torch.Tensor, tile_rows: Optional[int] = None) -> torch.Tensor:
    """Stable-sort fused (key | payload) rows by the uint32 key bitcast in
    word 0 — ``NUM_PASSES`` counting passes.  Returns a new tensor; ``rows``
    is left as it was (the JAX function is pure).  ``tile_rows`` is accepted
    for the JAX package's signature and changes nothing: the kernels' tile is
    ``TILE_ROWS``, and a stable sort gives the same rows at any tile."""
    _check(rows, 0)
    return _passes(rows, (torch.empty_like(rows), torch.empty_like(rows)))


def radix_sort_rows_(rows: torch.Tensor) -> torch.Tensor:
    """In-place ``radix_sort_rows``: the passes ping-pong between ``rows`` and
    one scratch tensor, and the result ends in ``rows`` (the pass count is
    even).  For callers that own ``rows``, as the distributed sort does."""
    _check(rows, 0)
    return _passes(rows, (torch.empty_like(rows), rows))


def build_radix_sort(n_rows: int, lanes: int, tile_rows: Optional[int] = None):
    """``fn(rows (n_rows, lanes)) -> stably sorted rows``, for API parity with
    the JAX package (nothing is compiled ahead here; the kernels build on first
    launch; ``tile_rows`` changes nothing, as in :func:`radix_sort_rows`)."""

    def fn(rows: torch.Tensor) -> torch.Tensor:
        if tuple(rows.shape) != (n_rows, lanes):
            raise ValueError(f"rows shape {tuple(rows.shape)} != {(n_rows, lanes)}")
        return radix_sort_rows(rows)

    fn.impl = "radix"
    return fn
