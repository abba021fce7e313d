"""The popularity tier's decoded-block cache.

Port of ``ServeCache`` from ``sparkucx_tpu/service/eviction.py`` (a verbatim
copy of the class).  The rest of that module, the ``EvictionManager`` with
the store's tier moves (``demote_round``, ``restage_round``), is not ported
yet (ROADMAP queue A item 5): the port's store has no tiers for it to move
rounds between, and nothing here depends on it.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple


class ServeCache:
    """Bounded serve-side decoded-block cache ABOVE the eviction tiers.

    Hot blocks — promoted by the popularity tracker — are pinned here as
    immutable ``bytes`` in a byte-budgeted LRU (``serve.cacheBytes``), so a
    fetch storm on a demoted round is served from RAM without paying the
    disk restage, and demotion/restage churn below never touches the hot
    set.  The cache stores COPIES (decoded payload snapshots), never views
    into the store's staging buffers: entries stay valid across demotion,
    restage, and round rollover, and are dropped only by LRU pressure or
    :meth:`invalidate_shuffle` when the shuffle itself is removed.

    Quota interplay is orchestrated by the store, not here: the store
    charges the owning tenant BEFORE :meth:`put` and releases the bytes of
    whatever :meth:`put`/:meth:`invalidate_shuffle` return as evicted —
    sequential lock scopes, so ``ServeCache._lock`` stays a leaf and never
    nests with ``HbmBlockStore._lock``.
    """

    def __init__(self, capacity_bytes: int) -> None:
        self.capacity_bytes = int(capacity_bytes)
        self._lock = threading.Lock()  # LEAF: no calls out while held
        #: (shuffle_id, map_id, reduce_id) -> payload; guarded by self._lock
        self._entries: "OrderedDict[Tuple[int, int, int], bytes]" = OrderedDict()
        self._used = 0  #: guarded by self._lock
        self.stats: Dict[str, int] = {
            "cache_hits": 0,
            "cache_misses": 0,
            "cache_evictions": 0,
            "cache_rejects": 0,
        }  #: guarded by self._lock

    def get(self, key: Tuple[int, int, int]) -> Optional[bytes]:
        """Cached payload for ``(shuffle, map, reduce)`` or None; a hit
        refreshes the entry's LRU position."""
        with self._lock:
            data = self._entries.get(key)
            if data is None:
                self.stats["cache_misses"] += 1
                return None
            self._entries.move_to_end(key)
            self.stats["cache_hits"] += 1
            return data

    def put(self, key: Tuple[int, int, int], data: bytes) -> List[Tuple[Tuple[int, int, int], int]]:
        """Insert (or refresh) one decoded block; evicts LRU entries to fit.
        Returns ``[(key, nbytes)]`` for every entry evicted so the caller can
        release their tenant charges.  A block larger than the whole budget
        is rejected (counted, nothing evicted for it)."""
        nbytes = len(data)
        with self._lock:
            if nbytes > self.capacity_bytes:
                self.stats["cache_rejects"] += 1
                return []
            prev = self._entries.pop(key, None)
            if prev is not None:
                self._used -= len(prev)
            evicted: List[Tuple[Tuple[int, int, int], int]] = []
            while self._used + nbytes > self.capacity_bytes and self._entries:
                old_key, old_data = self._entries.popitem(last=False)
                self._used -= len(old_data)
                self.stats["cache_evictions"] += 1
                evicted.append((old_key, len(old_data)))
            self._entries[key] = data
            self._used += nbytes
            if prev is not None:
                evicted.append((key, len(prev)))
            return evicted

    def invalidate_shuffle(self, shuffle_id: int) -> List[Tuple[Tuple[int, int, int], int]]:
        """Drop every entry of one shuffle (shuffle removal); returns the
        dropped ``[(key, nbytes)]`` so the caller releases tenant charges."""
        with self._lock:
            doomed = [k for k in self._entries if k[0] == shuffle_id]
            out: List[Tuple[Tuple[int, int, int], int]] = []
            for k in doomed:
                data = self._entries.pop(k)
                self._used -= len(data)
                out.append((k, len(data)))
            return out

    @property
    def used_bytes(self) -> int:
        with self._lock:
            return self._used

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def snapshot(self) -> Dict[str, int]:
        """Counter snapshot for MetricsRegistry export."""
        with self._lock:
            out = dict(self.stats)
            out["cache_used_bytes"] = self._used
            out["cache_entries"] = len(self._entries)
            return out
