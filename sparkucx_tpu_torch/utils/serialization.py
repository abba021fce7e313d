"""Address/buffer codecs for control-plane payloads.

Copy of ``sparkucx_tpu/utils/serialization.py``.

Counterpart of ``utils/SerializableDirectBuffer.scala`` (88 LoC): the reference
wraps direct ByteBuffers for Java serialization (:20-48) and codes
``InetSocketAddress`` as ``{int port, utf8 host}`` (:71-88).  Python needs no
direct-buffer wrapper (bytes are picklable/sendable as-is); the address codec is
kept wire-compatible in spirit: little-endian port then utf-8 host.

The in-tree control planes deliberately use self-describing encodings instead
(JSON frames in parallel/bootstrap.py, ``b"host:port"`` transport addresses) —
this codec is the InetSocketAddress-shaped twin for engines that want the
reference's byte layout, contract-tested in tests/test_aux.py.
"""

from __future__ import annotations

import struct
from typing import Tuple

_PORT = struct.Struct("<i")


def pack_address(host: str, port: int) -> bytes:
    """SerializationUtils.serializeInetAddress analogue
    (SerializableDirectBuffer.scala:71-80)."""
    return _PORT.pack(port) + host.encode("utf-8")


def unpack_address(data: bytes) -> Tuple[str, int]:
    """SerializationUtils.deserializeInetAddress analogue (:82-88)."""
    (port,) = _PORT.unpack_from(data)
    return data[_PORT.size :].decode("utf-8"), port
