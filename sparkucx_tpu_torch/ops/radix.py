"""Device LSD radix sort of fused (key | payload) rows — kernel K6.

Port of ``sparkucx_tpu/ops/radix.py``.  Rows are ``(N, L)`` tensors of any
32-bit dtype; they sort stably by the uint32 bitcast of word 0, and the key
moves with its payload.  The JAX package moves every whole row in each of
its digit passes; on the card (``csrc/radix_sort.cu``) the passes sort
8-byte (key, row number) pairs instead and each row moves once:

1. the digit counts of every pass at once: one read of each row's key word,
   which also writes the keys (``radix_counts_launch``);
2. one launch a pass, ``NUM_PASSES`` in all: a one-sweep counting pass over
   the pairs, each tile's exclusive prefix per digit taken by a decoupled
   look-back over earlier tiles (``radix_onesweep_launch``); the first pass
   makes the row numbers, the last writes only them: the permutation;
3. one row permutation, ``out[i] = rows[perm[i]]`` (``radix_permute_launch``).

``radix_sort_rows`` and ``radix_pass`` are the wrappers: on a CUDA tensor
they launch those kernels (built on first use, see ops/cuda_build.py) or
raise; on a CPU tensor they run the plain PyTorch versions beside them
(``radix_sort_rows_ref``, ``radix_pass_ref``), which the kernels are held
against on the card.  Each wrapper's ``launches`` counts the calls that
launched the kernels.  Row numbers are uint32: at most ``2**32 - 1`` rows.

The port's digit is 8 bits (four passes), where the TPU kernel used 4 bits
(eight passes): a stable sort gives the same rows either way.  The tile,
``TILE_ROWS`` pairs a CTA, is a constant of the kernels; rows need no
padding to a multiple of it.

Bound: the function reads every row once and writes it once, so it takes at
least ``2 * N * row_bytes`` over the card's memory bandwidth (5.97 ms for
100M rows of 100 B on an H100).  This design moves about 33 GB there (keys
read by sector, pairs, rows read by sector and written), where a design that
moves whole rows in four passes moves 81.6 GB.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

#: digit width per pass; must equal kBits in csrc/radix_sort.cu
BITS = 8
NUM_BUCKETS = 1 << BITS
NUM_PASSES = 32 // BITS
#: pairs per CTA tile of a pass; must equal kTileRows in csrc/radix_sort.cu
TILE_ROWS = 4096
#: rows a sort takes at most: row numbers are uint32
MAX_ROWS = 2**32 - 1

_U32_MASK = 0xFFFFFFFF
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def clamped_tile_rows(tile_rows: int, n: int) -> int:
    """The JAX package's tile clamp, kept for API parity: shrink an oversized
    tile toward ``n`` while staying an 8-row multiple."""
    return min(tile_rows, -(-max(8, n) // 8) * 8)


def digits(rows: torch.Tensor, shift: int) -> torch.Tensor:
    """This pass's digit of every row's uint32 key (word 0), as int64."""
    key = rows[:, 0].view(torch.int32).to(torch.int64) & _U32_MASK
    return (key >> shift) & (NUM_BUCKETS - 1)


def _check(rows: torch.Tensor, shift: int) -> None:
    if not isinstance(rows, torch.Tensor):
        raise TypeError(f"rows must be a torch.Tensor, got {type(rows).__name__}")
    if rows.dim() != 2 or rows.element_size() != 4 or not rows.is_contiguous() or rows.shape[1] < 1:
        raise ValueError(
            f"rows must be a contiguous (N, L>=1) tensor of 32-bit words, got shape "
            f"{tuple(rows.shape)} {rows.dtype} contiguous={rows.is_contiguous()}"
        )
    if rows.shape[0] > MAX_ROWS:
        raise ValueError(f"rows has {rows.shape[0]} rows; row numbers are uint32, so at most {MAX_ROWS}")
    if not 0 <= shift < 32:
        raise ValueError(f"shift must be in [0, 32), got {shift}")
    if rows.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the radix sort runs on cuda or cpu tensors, got {rows.device}")


def radix_pass_ref(rows: torch.Tensor, shift: int) -> torch.Tensor:
    """Plain version of one pass: what a stable counting pass computes, the
    rows stably sorted by this pass's digit.  Returns a new tensor."""
    return rows.index_select(0, torch.argsort(digits(rows, shift), stable=True))


def radix_sort_rows_ref(rows: torch.Tensor) -> torch.Tensor:
    """Plain version of the sort: ``NUM_PASSES`` plain passes."""
    for p in range(NUM_PASSES):
        rows = radix_pass_ref(rows, p * BITS)
    return rows


def _library() -> ctypes.CDLL:
    from sparkucx_tpu_torch.ops import cuda_build

    lib = cuda_build.load("radix_sort")
    lib.radix_counts_launch.argtypes = [_P, _L, _L, _I, _I, _P, _P, _P]
    lib.radix_onesweep_launch.argtypes = [_P, _P, _P, _P, _L, _I, _P, _P, _P, _P]
    lib.radix_permute_launch.argtypes = [_P, _P, _P, _L, _L, _P]
    for fn in (lib.radix_counts_launch, lib.radix_onesweep_launch, lib.radix_permute_launch, lib.radix_bits):
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


class _Sort:
    """The device buffers and the launches of one sort of ``rows`` on
    ``passes`` digits from ``shift``: keys and row numbers, two of each (the
    passes ping-pong), and one zeroed block holding the digit counts
    (``passes x 256`` uint32), a tile ticket a pass and the passes'
    look-back arrays (``passes x tiles x 256`` uint64)."""

    def __init__(self, rows: torch.Tensor, shift: int, passes: int):
        self.lib = _library()
        self.rows, self.shift, self.passes = rows, shift, passes
        n = rows.shape[0]
        self.tiles = -(-n // TILE_ROWS)
        self.keys = torch.empty((2, n), dtype=torch.int32, device=rows.device)
        self.vals = torch.empty((2, n), dtype=torch.int32, device=rows.device)
        # int64 words: counts (passes * 128), tickets (passes), look-back
        self.state = torch.empty(passes * (NUM_BUCKETS // 2 + 1 + self.tiles * NUM_BUCKETS),
                                 dtype=torch.int64, device=rows.device)
        self.stream = torch.cuda.current_stream(rows.device).cuda_stream

    def reset(self) -> None:
        self.state.zero_()

    def counts(self, p: int) -> int:
        return self.state.data_ptr() + p * NUM_BUCKETS * 4

    def _ticket(self, p: int) -> int:
        return self.state.data_ptr() + 8 * (self.passes * NUM_BUCKETS // 2 + p)

    def _lookback(self, p: int) -> int:
        return self.state.data_ptr() + 8 * (self.passes * (NUM_BUCKETS // 2 + 1) + p * self.tiles * NUM_BUCKETS)

    def count(self) -> None:
        """Step 1: the keys, and every pass's digit counts."""
        rows = self.rows
        _raise_on(self.lib, "radix_counts_launch", self.lib.radix_counts_launch(
            rows.data_ptr(), rows.shape[0], rows.shape[1], self.shift, self.passes,
            self.keys[0].data_ptr(), self.counts(0), self.stream))

    def sweep(self, p: int) -> None:
        """Step 2, pass ``p``: pairs ``p % 2`` -> pairs ``(p + 1) % 2``."""
        src, dst = p % 2, (p + 1) % 2
        _raise_on(self.lib, "radix_onesweep_launch", self.lib.radix_onesweep_launch(
            self.keys[src].data_ptr(), None if p == 0 else self.vals[src].data_ptr(),
            None if p == self.passes - 1 else self.keys[dst].data_ptr(), self.vals[dst].data_ptr(),
            self.rows.shape[0], self.shift + p * BITS, self.counts(p), self._lookback(p), self._ticket(p),
            self.stream))

    def permute(self, out: torch.Tensor) -> None:
        """Step 3: ``out[i] = rows[perm[i]]``."""
        rows = self.rows
        _raise_on(self.lib, "radix_permute_launch", self.lib.radix_permute_launch(
            rows.data_ptr(), out.data_ptr(), self.vals[self.passes % 2].data_ptr(), rows.shape[0],
            rows.shape[1], self.stream))

    def run(self, out: torch.Tensor) -> torch.Tensor:
        self.reset()
        self.count()
        for p in range(self.passes):
            self.sweep(p)
        self.permute(out)
        return out


def _sort_on_card(rows: torch.Tensor, shift: int, passes: int, out: torch.Tensor) -> torch.Tensor:
    with torch.cuda.device(rows.device):
        return _Sort(rows, shift, passes).run(out)


def radix_pass(rows: torch.Tensor, shift: int, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One stable counting pass on the digit ``(key >> shift) & (B - 1)`` of
    the uint32 key in word 0: rows with smaller digits first, equal digits in
    input order.  Writes ``out`` (a new tensor when None; it must not overlap
    ``rows``) and returns it.  On the card: the counts, one pass over the
    pairs, the permutation."""
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
    if rows.shape[0]:
        _sort_on_card(rows, shift, 1, out)
        radix_pass.launches += 1
    return out


radix_pass.launches = 0


def radix_sort_rows(rows: torch.Tensor, tile_rows: Optional[int] = None) -> torch.Tensor:
    """Stable-sort fused (key | payload) rows by the uint32 key bitcast in
    word 0.  Returns a new tensor; ``rows`` is left as it was (the JAX
    function is pure).  On the card: the counts, ``NUM_PASSES`` passes over
    the pairs and one row permutation; the buffers besides the output are
    the pairs, 16 bytes a row.  ``tile_rows`` is accepted for the JAX
    package's signature and changes nothing: the kernels' tile is
    ``TILE_ROWS``, and a stable sort gives the same rows at any tile."""
    _check(rows, 0)
    if rows.device.type == "cpu":
        return radix_sort_rows_ref(rows)
    out = torch.empty_like(rows)
    if rows.shape[0]:
        _sort_on_card(rows, 0, NUM_PASSES, out)
        radix_sort_rows.launches += 1
    return out


radix_sort_rows.launches = 0


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
