"""Transport-level stats aggregation.

Port of ``sparkucx_tpu/utils/stats.py`` (a verbatim copy over the port's
``OperationStats``).

The reference exposes per-op stats only (``UcxStats``,
UcxShuffleTransport.scala:36-53) and relies on Spark's shuffle metrics for
aggregates.  With no Spark UI underneath, this module provides the aggregate
view: a ``StatsAggregator`` transports feed each completed operation into, with
latency percentiles and byte totals — what the benchmark prints and what an
operator would scrape.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Optional

from sparkucx_tpu_torch.core.operation import OperationStats


@dataclass
class StatsSummary:
    ops: int = 0
    bytes: int = 0
    total_ns: int = 0
    min_ns: Optional[int] = None
    max_ns: Optional[int] = None
    p50_ns: Optional[int] = None
    p99_ns: Optional[int] = None
    #: exchange staging occupancy (ops/skew.py telemetry): rows that carried
    #: payload vs rows staged only as slot padding, summed over this kind's ops
    used_rows: int = 0
    padded_rows: int = 0

    @property
    def mean_ns(self) -> float:
        return self.total_ns / self.ops if self.ops else 0.0

    @property
    def throughput_gbps(self) -> float:
        return self.bytes / self.total_ns if self.total_ns else 0.0  # bytes/ns == GB/s

    @property
    def padding_fraction(self) -> float:
        """Fraction of staged rows that were slot padding — the imbalance the
        skew planner (conf.slot_quota_rows) exists to shrink."""
        staged = self.used_rows + self.padded_rows
        return self.padded_rows / staged if staged else 0.0


class StatsAggregator:
    """Thread-safe sink for completed OperationStats, bucketed by op kind."""

    _RESERVOIR = 4096

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # record() is called from the pipeline's submit AND drain lanes
        # concurrently — every counter mutates under _lock (lock-discipline)
        self._ops: Dict[str, int] = {}  #: guarded by self._lock
        self._bytes: Dict[str, int] = {}  #: guarded by self._lock
        self._total_ns: Dict[str, int] = {}  #: guarded by self._lock
        self._samples: Dict[str, List[int]] = {}  #: guarded by self._lock
        # padding telemetry (ops/skew.py): written from the pipeline drain
        # worker alongside the timing counters — same lock, same discipline
        self._used_rows: Dict[str, int] = {}  #: guarded by self._lock
        self._padded_rows: Dict[str, int] = {}  #: guarded by self._lock
        # free-form named counters (striped-wire per-lane bytes / syscalls /
        # stall time): kind -> counter name -> accumulated value
        self._counters: Dict[str, Dict[str, int]] = {}  #: guarded by self._lock

    def record(
        self,
        kind: str,
        stats: OperationStats,
        *,
        used_rows: int = 0,
        padded_rows: int = 0,
    ) -> None:
        elapsed = stats.elapsed_ns()
        with self._lock:
            self._ops[kind] = self._ops.get(kind, 0) + 1
            self._bytes[kind] = self._bytes.get(kind, 0) + stats.recv_size
            self._total_ns[kind] = self._total_ns.get(kind, 0) + elapsed
            self._used_rows[kind] = self._used_rows.get(kind, 0) + used_rows
            self._padded_rows[kind] = self._padded_rows.get(kind, 0) + padded_rows
            samples = self._samples.setdefault(kind, [])
            if len(samples) < self._RESERVOIR:
                samples.append(elapsed)
            else:  # cheap deterministic reservoir: overwrite round-robin
                samples[self._ops[kind] % self._RESERVOIR] = elapsed

    def record_rows(self, kind: str, used_rows: int, padded_rows: int) -> None:
        """Occupancy-only record (no timed operation behind it): per-round
        lane-occupancy counters the transports emit once per exchange."""
        with self._lock:
            self._used_rows[kind] = self._used_rows.get(kind, 0) + used_rows
            self._padded_rows[kind] = self._padded_rows.get(kind, 0) + padded_rows

    def record_counters(self, kind: str, **counters: int) -> None:
        """Accumulate named counters under a kind — the wire path's per-lane
        telemetry (rx_bytes / rx_syscalls / rx_stall_ns) lands here, where an
        operator's report() can pick it up next to the op summaries."""
        with self._lock:
            dst = self._counters.setdefault(kind, {})
            for name, value in counters.items():
                dst[name] = dst.get(name, 0) + int(value)

    def counters(self, kind: str) -> Dict[str, int]:
        with self._lock:
            return dict(self._counters.get(kind, {}))

    def summary(self, kind: str) -> StatsSummary:
        with self._lock:
            ops = self._ops.get(kind, 0)
            used = self._used_rows.get(kind, 0)
            padded = self._padded_rows.get(kind, 0)
            if not ops:
                # row-only kinds (record_rows) still surface their occupancy
                return StatsSummary(used_rows=used, padded_rows=padded)
            samples = sorted(self._samples.get(kind, []))
            return StatsSummary(
                ops=ops,
                bytes=self._bytes[kind],
                total_ns=self._total_ns[kind],
                min_ns=samples[0] if samples else None,
                max_ns=samples[-1] if samples else None,
                p50_ns=samples[len(samples) // 2] if samples else None,
                p99_ns=samples[min(len(samples) - 1, int(len(samples) * 0.99))] if samples else None,
                used_rows=used,
                padded_rows=padded,
            )

    def kinds(self) -> List[str]:
        with self._lock:
            return sorted(set(self._ops) | set(self._used_rows) | set(self._counters))

    def report(self) -> str:
        lines = []
        for kind in self.kinds():
            s = self.summary(kind)
            line = (
                f"{kind}: ops={s.ops} bytes={s.bytes} mean={s.mean_ns/1e3:.1f}us "
                f"p50={0 if s.p50_ns is None else s.p50_ns/1e3:.1f}us "
                f"p99={0 if s.p99_ns is None else s.p99_ns/1e3:.1f}us"
            )
            if s.used_rows or s.padded_rows:
                line += (
                    f" used_rows={s.used_rows} padded_rows={s.padded_rows} "
                    f"padding={s.padding_fraction:.1%}"
                )
            counters = self.counters(kind)
            if counters:
                line += "".join(f" {k}={v}" for k, v in sorted(counters.items()))
            lines.append(line)
        return "\n".join(lines)
