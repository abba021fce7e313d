"""Lossless per-page columnar codecs for exchange payloads (compress tier a).

Copy of ``sparkucx_tpu/utils/pagecodec.py`` (numpy only; importing it would
pull jax in through ``sparkucx_tpu/ops/__init__.py``).  The encodings are
byte-identical to the JAX package's: the codec ids and every header layout are
wire format, and ``tests/test_torch_pagecodec.py`` holds both on the same
seeded pages.

A striped wire's chunk frames are self-addressing — (tag, block,
offset-within-block) — so every chunk can be encoded and decoded independently
of its siblings, with the codec-id/raw-len pair riding a chunk-header
extension.  The codecs here are the page-level encoders behind that path:
numpy-vectorized, no per-byte Python loops, tuned for the shapes the data
plane moves — int32 exchange rows with low-cardinality key columns (dict),
word runs from clustered keys and padding/sealed zeros (rle), and
sorted/clustered numeric columns (delta + zigzag, byte-aligned widths).

Every codec treats the page as little-endian u32 words plus a <=3-byte raw
tail, because u32 words ARE the unit of this data plane (ops/columnar.py
packs every lane as int32).  That choice is also what makes the encoders
fast enough to sit on the serve path: word-level RLE sees the period-4
patterns that byte-level RLE is blind to, and the dict encoder can afford a
full ``np.unique`` (sort-only, no inverse — the inverse comes from a direct
or hashed lookup table, never from the 20x-slower ``return_inverse`` path).

Contract:

* ``encode_page(codec_id, data) -> bytes | None`` — None means "not
  profitable / not applicable"; the caller ships the page raw
  (``CODEC_RAW``).  An encoder NEVER returns an encoding as large as the
  input, so codec-id raw on the wire always means "payload == page bytes".
* ``decode_page(codec_id, payload, out)`` — decodes exactly ``out.nbytes``
  bytes into ``out`` or raises :class:`CodecError`.  Every length is checked
  against the payload's actual size BEFORE any array is built: truncated,
  oversized, or internally inconsistent encodings raise, they never over-read
  or scatter out of bounds.  A transport turns a ``CodecError`` on the
  fetch path into a corrupt-block error, so corruption enters the reducer's
  retry path.

Codec ids are wire format; renumbering is a protocol break.
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np

#: Wire codec ids (the chunk-header extension field).
CODEC_RAW = 0  #: payload is the page verbatim (unprofitable-page fallback)
CODEC_DICT = 1  #: u32-word dictionary + u8/u16 indices (low-cardinality pages)
CODEC_RLE = 2  #: u32-word run-length (clustered keys / padding / zero runs)
CODEC_DELTA = 3  #: u32-word zigzag deltas, byte-aligned (sorted/clustered pages)

#: conf ``compress.codec`` values -> wire codec id ('off' never reaches here).
WIRE_CODECS = {"dict": CODEC_DICT, "rle": CODEC_RLE, "delta": CODEC_DELTA}

CODEC_NAMES = {CODEC_RAW: "raw", CODEC_DICT: "dict", CODEC_RLE: "rle", CODEC_DELTA: "delta"}

_RLE_HDR = struct.Struct("<I")  # nruns (u32 run lengths + u32 run values follow)
_DICT_HDR = struct.Struct("<IIB")  # nwords, nuniq, index width (1|2)
_DELTA_HDR = struct.Struct("<IIB")  # nwords, first word, bytes per delta (1|2|3)

#: dict-encode inverse strategy bounds: alphabets whose value span fits a
#: direct LUT use one; wider alphabets up to this cardinality go through a
#: collision-checked multiplicative hash table (2**_DICT_HASH_BITS slots);
#: anything bigger falls back to searchsorted (correct, just slower — such
#: pages also compress worst, u16 indices cap the ratio at 2x).
_DICT_LUT_SPAN = 1 << 22
_DICT_HASH_MAX = 1 << 10
_DICT_HASH_BITS = 22
_DICT_HASH_MULTS = (
    np.uint64(0x9E3779B97F4A7C15),
    np.uint64(0xC2B2AE3D27D4EB4F),
    np.uint64(0xFF51AFD7ED558CCD),
    np.uint64(0x2545F4914F6CDD1D),
)


class CodecError(ValueError):
    """A page failed to decode: truncated/oversized payload, inconsistent
    header fields, or out-of-range dictionary indices.  Deliberately a
    ``ValueError`` subclass — the same malformed-input contract as
    utils/codec.py — and never allowed to escape a transport as-is (the
    fetch path turns it into a corrupt-block error)."""


def _as_bytes_array(data) -> np.ndarray:
    return np.frombuffer(data, dtype=np.uint8)


# ----------------------------------------------------------------------------
# RLE — u32-word runs
# ----------------------------------------------------------------------------


def _encode_rle(arr: np.ndarray) -> Optional[bytes]:
    # Word-level runs, not byte-level: a clustered low-cardinality int32 key
    # column is a sequence of repeated WORDS, which byte RLE cannot see (the
    # byte stream has period 4, runs of length 1).  Padding/zero pages are
    # word runs too, so nothing is lost on the constant-page case.
    nwords = arr.size // 4
    if nwords == 0:
        return None
    words = arr[: 4 * nwords].view("<u4")
    tail = arr[4 * nwords :]
    change = np.flatnonzero(words[1:] != words[:-1])
    starts = np.concatenate([np.zeros(1, np.int64), change + 1])
    nruns = starts.size
    if _RLE_HDR.size + 8 * nruns + tail.size >= arr.size:
        return None
    bounds = np.concatenate([starts, np.array([nwords], np.int64)])
    lengths = np.diff(bounds).astype("<u4")
    values = words[starts]
    return (
        _RLE_HDR.pack(nruns)
        + lengths.tobytes()
        + values.astype("<u4").tobytes()
        + tail.tobytes()
    )


def _decode_rle(payload: np.ndarray, out: np.ndarray) -> None:
    if payload.size < _RLE_HDR.size:
        raise CodecError(f"rle page truncated: {payload.size} B, need header")
    (nruns,) = _RLE_HDR.unpack_from(payload)
    nwords = out.size // 4
    tail_len = out.size - 4 * nwords
    if payload.size != _RLE_HDR.size + 8 * nruns + tail_len:
        raise CodecError(
            f"rle page claims {nruns} runs ({_RLE_HDR.size + 8 * nruns + tail_len} B)"
            f" but payload is {payload.size} B"
        )
    pos = _RLE_HDR.size
    lengths = payload[pos : pos + 4 * nruns].view("<u4")
    pos += 4 * nruns
    values = payload[pos : pos + 4 * nruns].view("<u4")
    pos += 4 * nruns
    total = int(lengths.sum(dtype=np.int64))
    if total != nwords:
        raise CodecError(
            f"rle runs expand to {total} words, destination holds {nwords}"
        )
    out[: 4 * nwords].view("<u4")[:] = np.repeat(values, lengths.astype(np.int64))
    out[4 * nwords :] = payload[pos:]


# ----------------------------------------------------------------------------
# DICT — u32-word dictionary
# ----------------------------------------------------------------------------


def _dict_inverse(uniq: np.ndarray, words: np.ndarray, idx_dtype) -> np.ndarray:
    """Map every word to its index in ``uniq`` (which covers all of them).

    ``np.unique(return_inverse=True)`` pays an argsort of the whole page —
    measured 20x slower than the sort-only ``np.unique`` — so the inverse is
    rebuilt from the alphabet instead: a direct LUT over the value span when
    it fits, else a multiplicative hash table whose collision freedom is
    verified on the alphabet itself (cheap: the alphabet is small), which
    makes it injective for every word on the page by construction.  No
    per-word validation pass is needed on any path because ``uniq`` came
    from ``words``."""
    base = uniq[0]
    span = int(uniq[-1]) - int(base)
    if span <= _DICT_LUT_SPAN:
        lut = np.empty(span + 1, idx_dtype)
        lut[(uniq - base).astype(np.int64)] = np.arange(uniq.size, dtype=idx_dtype)
        return lut[words - base]
    if uniq.size <= _DICT_HASH_MAX:
        shift = np.uint64(64 - _DICT_HASH_BITS)
        u64 = uniq.astype(np.uint64)
        for mult in _DICT_HASH_MULTS:
            slots = (u64 * mult) >> shift
            if np.unique(slots).size != uniq.size:
                continue  # alphabet collision under this multiplier: next
            lut = np.empty(1 << _DICT_HASH_BITS, idx_dtype)
            lut[slots] = np.arange(uniq.size, dtype=idx_dtype)
            return lut[(words.astype(np.uint64) * mult) >> shift]
    # wide span AND (large or hash-unlucky) alphabet: binary search.  Slower,
    # but such pages are also the worst compressors (u16 indices, ratio <= 2).
    return np.searchsorted(uniq, words).astype(idx_dtype)


def _encode_dict(arr: np.ndarray) -> Optional[bytes]:
    nwords = arr.size // 4
    if nwords == 0:
        return None
    words = arr[: 4 * nwords].view("<u4")
    tail = arr[4 * nwords :]
    uniq = np.unique(words)
    if uniq.size <= 0xFF + 1:
        width, idx_dtype = 1, np.uint8
    elif uniq.size <= 0xFFFF + 1:
        width, idx_dtype = 2, np.dtype("<u2")
    else:
        return None
    size = _DICT_HDR.size + 4 * uniq.size + width * nwords + tail.size
    if size >= arr.size:
        return None
    idx = _dict_inverse(uniq, words, idx_dtype)
    return (
        _DICT_HDR.pack(nwords, uniq.size, width)
        + uniq.astype("<u4").tobytes()
        + idx.tobytes()
        + tail.tobytes()
    )


def _decode_dict(payload: np.ndarray, out: np.ndarray) -> None:
    if payload.size < _DICT_HDR.size:
        raise CodecError(f"dict page truncated: {payload.size} B, need header")
    nwords, nuniq, width = _DICT_HDR.unpack_from(payload)
    if width not in (1, 2):
        raise CodecError(f"dict page has invalid index width {width}")
    tail_len = out.size - 4 * nwords
    if tail_len < 0 or tail_len >= 4:
        raise CodecError(
            f"dict page claims {nwords} words for a {out.size} B destination"
        )
    need = _DICT_HDR.size + 4 * nuniq + width * nwords + tail_len
    if payload.size != need:
        raise CodecError(
            f"dict page needs {need} B ({nwords} words, {nuniq} entries, "
            f"width {width}) but payload is {payload.size} B"
        )
    pos = _DICT_HDR.size
    uniq = payload[pos : pos + 4 * nuniq].view("<u4")
    pos += 4 * nuniq
    idx_dtype = np.uint8 if width == 1 else np.dtype("<u2")
    idx = payload[pos : pos + width * nwords].view(idx_dtype)
    pos += width * nwords
    if nuniq == 0 and nwords:
        raise CodecError("dict page has words but an empty dictionary")
    try:
        # take(mode="raise") bounds-checks every index itself, and the out=
        # form writes straight into the destination — the separate max() scan
        # plus gather-into-temp-then-copy cost a third of decode throughput
        np.take(uniq, idx, out=out[: 4 * nwords].view("<u4"))
    except IndexError:
        raise CodecError("dict page index out of dictionary range") from None
    out[4 * nwords :] = payload[pos:]


# ----------------------------------------------------------------------------
# DELTA — u32-word zigzag deltas, byte-aligned widths
# ----------------------------------------------------------------------------
#
# The first word rides in the header raw: it is a full-magnitude value whose
# zigzag would otherwise force the page-wide delta width to 32 bits (one page
# = one width).  Deltas are modular in the u32 domain (wraparound-exact) and
# packed at 1, 2 or 3 bytes each — byte alignment decodes via dtype casts at
# GB/s where arbitrary bit widths paid two ``packbits`` passes (measured 79
# MB/s, 25x slower); the ratio lost to rounding a width like 13 bits up to 16
# is far smaller than the throughput kept.


def _encode_delta(arr: np.ndarray) -> Optional[bytes]:
    nwords = arr.size // 4
    if nwords == 0:
        return None
    words = arr[: 4 * nwords].view("<u4")
    tail = arr[4 * nwords :]
    d = words[1:] - words[:-1]  # u32 arithmetic: wraparound-exact
    di = d.view(np.int32)
    zz = ((di << 1) ^ (di >> 31)).view(np.uint32)
    top = int(zz.max()) if zz.size else 0
    nbytes = (max(1, top.bit_length()) + 7) // 8
    if nbytes > 3:
        return None
    size = _DELTA_HDR.size + nbytes * (nwords - 1) + tail.size
    if size >= arr.size:
        return None
    if nbytes == 1:
        packed = zz.astype(np.uint8)
    elif nbytes == 2:
        packed = zz.astype("<u2")
    else:
        packed = zz.astype("<u4").view(np.uint8).reshape(-1, 4)[:, :3]
    return (
        _DELTA_HDR.pack(nwords, int(words[0]), nbytes)
        + packed.tobytes()
        + tail.tobytes()
    )


def _decode_delta(payload: np.ndarray, out: np.ndarray) -> None:
    if payload.size < _DELTA_HDR.size:
        raise CodecError(f"delta page truncated: {payload.size} B, need header")
    nwords, first, nbytes = _DELTA_HDR.unpack_from(payload)
    if nbytes not in (1, 2, 3):
        raise CodecError(f"delta page has invalid delta width {nbytes}")
    if nwords == 0:
        raise CodecError("delta page claims zero words")
    tail_len = out.size - 4 * nwords
    if tail_len < 0 or tail_len >= 4:
        raise CodecError(
            f"delta page claims {nwords} words for a {out.size} B destination"
        )
    packed_len = nbytes * (nwords - 1)
    need = _DELTA_HDR.size + packed_len + tail_len
    if payload.size != need:
        raise CodecError(
            f"delta page needs {need} B ({nwords} words x {nbytes} B deltas) "
            f"but payload is {payload.size} B"
        )
    packed = payload[_DELTA_HDR.size : _DELTA_HDR.size + packed_len]
    if nbytes == 1:
        zz = packed.astype(np.uint32)
    elif nbytes == 2:
        zz = packed.view("<u2").astype(np.uint32)
    else:
        b = packed.reshape(-1, 3).astype(np.uint32)
        zz = b[:, 0] | (b[:, 1] << np.uint32(8)) | (b[:, 2] << np.uint32(16))
    d = (zz >> np.uint32(1)) ^ (np.uint32(0) - (zz & np.uint32(1)))
    words = out[: 4 * nwords].view("<u4")
    words[0] = first
    # u32 cumsum wraps mod 2**32 — the exact inverse of the modular diff
    np.cumsum(d, dtype=np.uint32, out=words[1:])
    words[1:] += np.uint32(first)
    out[4 * nwords :] = payload[_DELTA_HDR.size + packed_len :]


# ----------------------------------------------------------------------------
# Entry points
# ----------------------------------------------------------------------------

_ENCODERS = {CODEC_DICT: _encode_dict, CODEC_RLE: _encode_rle, CODEC_DELTA: _encode_delta}
_DECODERS = {CODEC_DICT: _decode_dict, CODEC_RLE: _decode_rle, CODEC_DELTA: _decode_delta}


def encode_page(codec_id: int, data) -> Optional[bytes]:
    """Encode one page under ``codec_id``.  ``data`` is any contiguous
    bytes-like; returns the encoded bytes, or None when the encoding would
    not shrink the page (ship raw).  ``CODEC_RAW`` always returns None."""
    if codec_id == CODEC_RAW:
        return None
    enc = _ENCODERS.get(codec_id)
    if enc is None:
        raise ValueError(f"unknown codec id {codec_id}")
    arr = _as_bytes_array(data)
    if arr.size == 0:
        return None
    return enc(arr)


def decode_page(codec_id: int, payload, out) -> None:
    """Decode ``payload`` (the encoded page) into ``out`` (a writable
    bytes-like of exactly the page's raw size).  Raises :class:`CodecError`
    on ANY malformation — lengths are validated before touching the data, so
    a hostile/corrupt payload can neither over-read nor write out of range."""
    dst = np.frombuffer(out, dtype=np.uint8)
    src = _as_bytes_array(payload)
    if codec_id == CODEC_RAW:
        if src.size != dst.size:
            raise CodecError(
                f"raw page is {src.size} B but destination expects {dst.size} B"
            )
        dst[:] = src
        return
    dec = _DECODERS.get(codec_id)
    if dec is None:
        raise CodecError(f"unknown codec id {codec_id}")
    dec(src, dst)
