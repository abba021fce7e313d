"""CRC32C (Castagnoli) — the wire-integrity checksum (conf.wire_checksum).

Copy of ``sparkucx_tpu/utils/checksum.py`` (pure Python).

CRC32C is the checksum the storage/network world standardized on for exactly
this job (iSCSI, ext4, RDMA NICs, Hadoop block transfer) because its error
detection at short message lengths beats CRC32/IEEE and hardware computes it
for free (SSE4.2 ``crc32`` instruction, ARMv8 ``CRC32C``).  Python's stdlib
only ships the IEEE polynomial (``zlib.crc32``), so this module carries a
table-driven software implementation of the reflected Castagnoli polynomial
``0x82F63B78`` — no new dependency, byte-compatible with every hardware
implementation (google/crc32c test vectors pinned in tests/test_wire.py).

The byte-at-a-time table walk runs at CPython speed (tens of MB/s), which is
fine for what it guards: the knob defaults off, and when on it trades wire
throughput for end-to-end integrity — the same trade Hadoop's
``dfs.checksum.type=CRC32C`` makes.  Deployments that need both swap in a
hardware binding behind this function; the wire format doesn't change.
"""

from __future__ import annotations

_POLY = 0x82F63B78  # Castagnoli, reflected


def _build_table():
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ _POLY if crc & 1 else crc >> 1
        table.append(crc)
    return tuple(table)


_TABLE = _build_table()


def crc32c(data, value: int = 0) -> int:
    """CRC32C of ``data`` (bytes-like), continuing from ``value`` (a previous
    call's return) for incremental use.  Returns an unsigned 32-bit int."""
    crc = (value ^ 0xFFFFFFFF) & 0xFFFFFFFF
    table = _TABLE
    for b in bytes(data):
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF
