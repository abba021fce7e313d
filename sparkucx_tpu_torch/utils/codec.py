"""Typed, non-executing record codec — the data plane's default serializer.

Port of ``sparkucx_tpu/utils/codec.py`` (a verbatim copy): the bytes a map task
encodes decode identically in either package.

The shuffle data plane delivers peer-produced bytes into the reduce-side
record pipeline (shuffle/reader.py).  Spark's default ``JavaSerializer``
deserializes attacker-controllable streams with full object construction;
this build's control plane explicitly bans that (parallel/bootstrap.py: "must
not execute peer-controlled bytes"), and the same rule applies here: the
default codec decodes a closed set of value shapes with explicit type tags
and bounds checks, and nothing else.  ``pickle`` remains available as an
explicit opt-in for trusted single-host runs (see shuffle/reader.py's
``pickle_deserializer``).

Wire format, per record (records concatenate back-to-back; each is
self-delimiting):

    N                      None
    T / F                  True / False
    i <int64 be>           int fitting 64 bits
    j <u32 len> <bytes>    arbitrary-precision int (two's complement, be)
    f <float64 be>         float
    s <u32 len> <utf8>     str
    b <u32 len> <bytes>    bytes
    t <u32 count> <items>  tuple
    l <u32 count> <items>  list
    m <u32 count> <k v>*   dict

Anything else — unknown tags, truncated frames, nesting deeper than
``MAX_DEPTH`` — raises ``ValueError``.  Decoding allocates only containers
and scalars; there is no code path to object construction or callables.
"""

from __future__ import annotations

import struct
from typing import Any, Iterable, Iterator

import numpy as np

#: Container-nesting bound: a crafted frame of a million nested tuples would
#: otherwise turn the recursive decoder into a stack-overflow primitive.
MAX_DEPTH = 100

_U32 = struct.Struct(">I")
_I64 = struct.Struct(">q")
_F64 = struct.Struct(">d")


def _encode(obj: Any, out: bytearray, depth: int = 0) -> None:
    if depth > MAX_DEPTH:
        raise ValueError(f"record nests deeper than MAX_DEPTH={MAX_DEPTH}")
    if obj is None:
        out += b"N"
    elif obj is True:
        out += b"T"
    elif obj is False:
        out += b"F"
    elif isinstance(obj, (bool, np.bool_)):  # np.bool_ is not `is True`
        out += b"T" if bool(obj) else b"F"
    elif isinstance(obj, (int, np.integer)):
        v = int(obj)
        if -(2**63) <= v < 2**63:
            out += b"i"
            out += _I64.pack(v)
        else:
            raw = v.to_bytes((v.bit_length() + 8) // 8, "big", signed=True)
            out += b"j"
            out += _U32.pack(len(raw))
            out += raw
    elif isinstance(obj, (float, np.floating)):
        out += b"f"
        out += _F64.pack(float(obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        out += b"s"
        out += _U32.pack(len(raw))
        out += raw
    elif isinstance(obj, (bytes, bytearray)):
        # zero-copy append: bytearray.__iadd__ copies straight out of the
        # source buffer — materializing an intermediate bytes() doubled the
        # allocation on the map-side hot path (PERF.md codec microbench)
        out += b"b"
        out += _U32.pack(len(obj))
        out += obj
    elif isinstance(obj, memoryview):
        # len() counts ELEMENTS, not bytes, on shaped views — use nbytes and
        # flatten to a byte view; only a non-contiguous view pays a copy
        mv = obj if obj.contiguous else memoryview(obj.tobytes())
        out += b"b"
        out += _U32.pack(mv.nbytes)
        out += mv.cast("B")
    elif isinstance(obj, tuple):
        out += b"t"
        out += _U32.pack(len(obj))
        for item in obj:
            _encode(item, out, depth + 1)
    elif isinstance(obj, list):
        out += b"l"
        out += _U32.pack(len(obj))
        for item in obj:
            _encode(item, out, depth + 1)
    elif isinstance(obj, dict):
        out += b"m"
        out += _U32.pack(len(obj))
        for k, v in obj.items():
            _encode(k, out, depth + 1)
            _encode(v, out, depth + 1)
    else:
        raise TypeError(
            f"type {type(obj).__name__} is outside the safe codec's value set "
            "(None/bool/int/float/str/bytes/tuple/list/dict); pass an explicit "
            "pickle serializer for trusted single-host runs"
        )


def encode_record(obj: Any) -> bytes:
    """Encode one record into the typed wire format."""
    out = bytearray()
    _encode(obj, out)
    return bytes(out)


def encode_records(records: Iterable[Any]) -> bytes:
    """Encode a record stream (back-to-back self-delimiting frames)."""
    out = bytearray()
    for rec in records:
        _encode(rec, out)
    return bytes(out)


def _need(payload: bytes, pos: int, n: int) -> None:
    if pos + n > len(payload):
        raise ValueError(
            f"truncated record frame: need {n} bytes at offset {pos}, "
            f"have {len(payload) - pos}"
        )


def _decode(payload: bytes, pos: int, depth: int = 0):
    if depth > MAX_DEPTH:
        raise ValueError(f"record nests deeper than MAX_DEPTH={MAX_DEPTH}")
    _need(payload, pos, 1)
    tag = payload[pos : pos + 1]
    pos += 1
    if tag == b"N":
        return None, pos
    if tag == b"T":
        return True, pos
    if tag == b"F":
        return False, pos
    if tag == b"i":
        _need(payload, pos, 8)
        return _I64.unpack_from(payload, pos)[0], pos + 8
    if tag == b"f":
        _need(payload, pos, 8)
        return _F64.unpack_from(payload, pos)[0], pos + 8
    if tag in (b"j", b"s", b"b"):
        _need(payload, pos, 4)
        (n,) = _U32.unpack_from(payload, pos)
        pos += 4
        _need(payload, pos, n)
        raw = payload[pos : pos + n]
        pos += n
        if tag == b"j":
            return int.from_bytes(raw, "big", signed=True), pos
        if tag == b"s":
            return str(raw, "utf-8"), pos
        return bytes(raw), pos
    if tag in (b"t", b"l", b"m"):
        _need(payload, pos, 4)
        (n,) = _U32.unpack_from(payload, pos)
        pos += 4
        if tag == b"m":
            d = {}
            for _ in range(n):
                k, pos = _decode(payload, pos, depth + 1)
                v, pos = _decode(payload, pos, depth + 1)
                try:
                    d[k] = v
                except TypeError:
                    # container-typed key in a crafted frame: keep the
                    # documented ValueError error contract
                    raise ValueError(
                        f"unhashable map key of type {type(k).__name__}"
                    ) from None
            return d, pos
        items = []
        for _ in range(n):
            item, pos = _decode(payload, pos, depth + 1)
            items.append(item)
        return (tuple(items) if tag == b"t" else items), pos
    raise ValueError(f"unknown record tag {bytes(tag)!r} at offset {pos - 1}")


def decode_records(payload) -> Iterator[Any]:
    """Decode a stream of records; raises ``ValueError`` on any malformation
    (unknown tag, truncation, over-deep nesting) — never executes anything.
    ``payload`` may be any bytes-like (``bytes`` or a read-only ``memoryview``
    served zero-copy by the fetch iterator, shuffle/reader.py)."""
    pos = 0
    n = len(payload)
    while pos < n:
        rec, pos = _decode(payload, pos)
        yield rec
