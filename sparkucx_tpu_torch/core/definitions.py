"""Wire-protocol message ids, frame format and the map-side commit record.

Port of ``sparkucx_tpu/core/definitions.py``, cut to what the staged-store path
needs: the message ids and base frame of ``shuffle/ucx/Definitions.scala:22-29``,
the FetchBlockReq header, and ``MapperInfo``.  ``MapperInfo.pack()`` blobs are
byte-identical to the JAX package's, so a commit written by either package
decodes in the other.  The striped-wire, replication, membership, trace and
hot-set frames arrive with the peer wire plane.

Frame format (all little-endian):  ``<u32 am_id> <u64 header_len> <u64 body_len>
<header bytes> <body bytes>`` — the (header, body) split mirrors jucx's
``sendAmNonBlocking(header, body)`` (UcxWorkerWrapper.scala:96-126).
"""

from __future__ import annotations

import enum
import struct
from dataclasses import dataclass
from typing import List, Optional, Tuple


class AmId(enum.IntEnum):
    """Definitions.scala:22-29, with the JAX package's extension ids."""

    INIT_EXECUTOR_REQ = 0
    INIT_EXECUTOR_ACK = 1
    MAPPER_INFO = 2
    FETCH_BLOCK_REQ = 3
    FETCH_BLOCK_REQ_ACK = 4
    FETCH_BLOCK_CHUNK = 5
    WIRE_HELLO = 6
    REPLICA_PUT = 7
    REPLICA_ACK = 8
    MEMBER_SUSPECT = 9
    MEMBER_REJOIN = 10
    TRACE_PULL = 11
    METRICS_PULL = 12
    SERVER_BUSY = 13
    HOT_SET_PULL = 14


_FRAME = struct.Struct("<IQQ")
FRAME_HEADER_SIZE = _FRAME.size

#: FetchBlockReq header: (shuffleId, mapId, reduceId) — 12 bytes, matching the
#: reference's header layout (UcxWorkerWrapper.scala:96-126).
_FETCH_REQ = struct.Struct("<iii")


def pack_frame(am_id: AmId, header: bytes = b"", body: bytes = b"") -> bytes:
    return _FRAME.pack(int(am_id), len(header), len(body)) + header + body


def unpack_frame_header(data: bytes) -> Tuple[AmId, int, int]:
    am_id, hlen, blen = _FRAME.unpack_from(data)
    return AmId(am_id), hlen, blen


def pack_fetch_req(shuffle_id: int, map_id: int, reduce_id: int) -> bytes:
    return _FETCH_REQ.pack(shuffle_id, map_id, reduce_id)


def unpack_fetch_req(data: bytes) -> Tuple[int, int, int]:
    return _FETCH_REQ.unpack_from(data)


@dataclass(frozen=True)
class MapperInfo:
    """Map-side commit record.

    Counterpart of the packed commit blob
    ``{1, numPartitions, mapId, (offset, len) * numPartitions}``
    (NvkvShuffleMapOutputWriter.scala:116-148).  We add shuffle_id explicitly
    instead of relying on device-space carve-up by shuffleId, and an optional
    per-partition staging-round index (multi-round spill) carried as a
    backward-compatible tail: blobs without the tail decode with all rounds 0.
    """

    shuffle_id: int
    map_id: int
    partitions: Tuple[Tuple[int, int], ...]  # (offset, length) per reduce partition
    rounds: Optional[Tuple[int, ...]] = None  # staging round per partition

    _HDR = struct.Struct("<iii")  # shuffle_id, map_id, num_partitions
    _ENT = struct.Struct("<qq")  # offset, length
    _RND = struct.Struct("<i")  # round index

    def round_of(self, reduce_id: int) -> int:
        return self.rounds[reduce_id] if self.rounds is not None else 0

    def pack(self) -> bytes:
        out = bytearray(self._HDR.pack(self.shuffle_id, self.map_id, len(self.partitions)))
        for off, ln in self.partitions:
            out += self._ENT.pack(off, ln)
        if self.rounds is not None and any(self.rounds):
            out += b"\x01"
            for r in self.rounds:
                out += self._RND.pack(r)
        return bytes(out)

    @classmethod
    def unpack(cls, data: bytes) -> "MapperInfo":
        sid, mid, n = cls._HDR.unpack_from(data)
        offs: List[Tuple[int, int]] = []
        pos = cls._HDR.size
        for _ in range(n):
            off, ln = cls._ENT.unpack_from(data, pos)
            offs.append((off, ln))
            pos += cls._ENT.size
        rounds: Optional[Tuple[int, ...]] = None
        if pos < len(data) and data[pos] == 1:
            pos += 1
            rounds = tuple(cls._RND.unpack_from(data, pos + i * cls._RND.size)[0] for i in range(n))
        return cls(sid, mid, tuple(offs), rounds)
