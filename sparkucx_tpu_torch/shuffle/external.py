"""Bounded-memory combine/sort for the reduce side — the ExternalSorter role.

Port of ``sparkucx_tpu/shuffle/external.py`` (host code, copied: the port
imports nothing of the JAX package).

The reference's read pipeline hands aggregation and ordering to Spark's
spilling ExternalSorter (``UcxShuffleReader.scala:137-199``: ``aggregator
.combineValuesByKey`` then ``ExternalSorter.insertAll``), which caps memory and
spills sorted runs to disk.  An unbounded dict + ``sorted()`` over a full list
would kill the reducer on a reduce partition larger than memory; this module
bounds it:

* records insert into an in-memory map (combine) or list (no combine) under an
  approximate byte budget;
* crossing the budget spills the current contents to a temp file as ONE run,
  sorted by the merge key (the actual key when ordering is requested —
  orderable by definition then — else ``hash(key)``, which any dict key
  supports);
* iteration k-way-merges the runs + the in-memory tail with ``heapq.merge``
  and, when combining, groups merge-key-equal records and aggregates per
  actual key (same-hash-different-key collisions stay correct: groups are
  tiny and combined through a dict).

Once a run spills, output comes in merge-key order (without ``key_ordering``:
``hash(key)``, which Python randomizes per process for ``str`` and ``bytes``);
with nothing spilled, in first-seen order.  Spill files go to ``spill_dir``
(conf.spill_dir, shared with the store's disk round tier).
"""

from __future__ import annotations

import heapq
import itertools
import os
import pickle
import sys
import tempfile
from typing import Any, Callable, Iterable, Iterator, List, Optional, Tuple

import numpy as np

#: rough per-record bookkeeping overhead (dict entry / list slot, pointers)
_RECORD_OVERHEAD = 64

#: max spilled runs merged in one pass; beyond this, runs are hierarchically
#: compacted first so the merge never holds an unbounded number of open files
#: (Spark's ExternalSorter caps fan-in the same way)
DEFAULT_MERGE_FAN_IN = 64

#: deep-estimate recursion depth — matches SizeEstimator's bounded object-graph
#: walk (Spark bounds by visit count; a depth bound plays the same role for the
#: tree-shaped values shuffle records actually carry)
_ESTIMATE_MAX_DEPTH = 4

#: elements sampled per container level; beyond this the mean of the sample is
#: extrapolated over len() — Spark's SizeEstimator samples large arrays the
#: same way (ARRAY_SAMPLE_SIZE) so a million-element value costs O(sample)
_ESTIMATE_SAMPLE = 16


def _estimate(obj: Any, depth: int = _ESTIMATE_MAX_DEPTH) -> int:
    """Approximate deep retained size of ``obj`` in bytes.

    The role Spark's ``SizeEstimator`` plays for ExternalSorter's
    ``maybeSpill`` budget (UcxShuffleReader.scala:137-199 hands records to
    exactly that machinery): a shallow ``sys.getsizeof`` counts a list of 10k
    ints as ~56 B of pointer header, so nested-value workloads would blow
    through ``memory_budget`` without ever spilling.  Containers recurse to a
    bounded depth and sample ``_ESTIMATE_SAMPLE`` elements, extrapolating the
    sample mean over ``len()``, so cost per record stays O(sample * depth)
    regardless of value size: sequences are indexed at evenly spaced
    positions; dict/set (not indexable) take the first ``sample`` entries — a
    biased but O(sample) draw.  Scalars, numpy arrays, and
    ``__slots__``/``__dict__`` objects are sized directly."""
    try:
        size = sys.getsizeof(obj)
    except TypeError:  # objects with broken __sizeof__
        size = 64
    # exact-size leaves (getsizeof already counts their payload)
    if isinstance(obj, (str, bytes, bytearray, memoryview, int, float, bool, complex)) or obj is None:
        return size
    if isinstance(obj, np.ndarray):
        # getsizeof misses the buffer of array *views*; nbytes covers payload
        return size if obj.base is None else size + obj.nbytes
    if depth <= 0:
        return size
    if isinstance(obj, dict):
        n = len(obj)
        if n == 0:
            return size
        sampled = list(itertools.islice(obj.items(), _ESTIMATE_SAMPLE))
        per = sum(_estimate(k, depth - 1) + _estimate(v, depth - 1) for k, v in sampled)
        return size + per * n // len(sampled)
    if isinstance(obj, (list, tuple)):
        n = len(obj)
        if n == 0:
            return size
        k = min(n, _ESTIMATE_SAMPLE)
        per = sum(_estimate(obj[(i * n) // k], depth - 1) for i in range(k))
        return size + per * n // k
    if isinstance(obj, (set, frozenset)):
        n = len(obj)
        if n == 0:
            return size
        sampled = list(itertools.islice(obj, _ESTIMATE_SAMPLE))
        per = sum(_estimate(e, depth - 1) for e in sampled)
        return size + per * n // len(sampled)
    # plain objects: their attribute dict / slots
    d = getattr(obj, "__dict__", None)
    if d:
        return size + _estimate(d, depth - 1)
    slots = getattr(type(obj), "__slots__", None)
    if slots:
        return size + sum(
            _estimate(getattr(obj, s, None), depth - 1)
            for s in ([slots] if isinstance(slots, str) else slots)
        )
    return size


class _Run:
    """One spilled sorted run: a pickle stream of (merge_key, key, value).

    Pickle is safe HERE and only here: spill files are written and read back
    by the same process under a mkstemp path — they never carry peer bytes.
    The socket-facing record codec is the typed one (utils/codec.py)."""

    def __init__(self, items: Iterable[Tuple[Any, Any, Any]], spill_dir: Optional[str]):
        if spill_dir:
            os.makedirs(spill_dir, exist_ok=True)
        fd, self.path = tempfile.mkstemp(prefix="sparkucx_tpu_reduce_", dir=spill_dir)
        with os.fdopen(fd, "wb") as f:
            for item in items:
                pickle.dump(item, f, protocol=pickle.HIGHEST_PROTOCOL)

    def __iter__(self) -> Iterator[Tuple[Any, Any, Any]]:
        with open(self.path, "rb") as f:
            while True:
                try:
                    yield pickle.load(f)
                except EOFError:
                    return

    def close(self) -> None:
        try:
            os.unlink(self.path)
        except OSError:
            pass


class ExternalCombiner:
    """Spillable combine/sort with an approximate in-memory byte budget.

    ``aggregator(acc, v)`` folds a VALUE into an accumulator (Spark's
    mergeValue); ``merge_combiners(acc1, acc2)`` merges two per-run
    accumulators of the same key after a spill (Spark's mergeCombiners,
    ExternalSorter's exact distinction) and defaults to ``aggregator`` — only
    correct when accumulator and value have the same type (sum-like folds);
    collect-style aggregators MUST pass an explicit ``merge_combiners``.
    ``key_ordering`` yields output sorted by key.  Mirrors what Spark's
    ExternalSorter provides the reference's reader
    (UcxShuffleReader.scala:137-199).
    """

    def __init__(
        self,
        aggregator: Optional[Callable[[Any, Any], Any]] = None,
        key_ordering: bool = False,
        memory_budget: int = 64 << 20,
        spill_dir: Optional[str] = None,
        merge_combiners: Optional[Callable[[Any, Any], Any]] = None,
        merge_fan_in: int = DEFAULT_MERGE_FAN_IN,
    ) -> None:
        self.aggregator = aggregator
        self.merge_combiners = merge_combiners if merge_combiners is not None else aggregator
        self.key_ordering = key_ordering
        self.memory_budget = max(1, memory_budget)
        self.spill_dir = spill_dir
        self.merge_fan_in = max(2, merge_fan_in)
        self.spill_count = 0
        self._map: dict = {}
        self._list: List[Tuple[Any, Any]] = []
        self._approx = 0
        self._runs: List[_Run] = []

    # -- insert ------------------------------------------------------------

    def insert(self, key: Any, value: Any) -> None:
        if self.aggregator is not None:
            if key in self._map:
                old = self._map[key]
                # growing accumulators (collect-style folds) must count against
                # the budget too, or they bypass the spill entirely; size the
                # old accumulator BEFORE the fold — an in-place aggregator
                # returns the same (already grown) object
                old_size = _estimate(old)
                new = self.aggregator(old, value)
                self._map[key] = new
                self._approx += _estimate(new) - old_size
            else:
                self._map[key] = value
                self._approx += _estimate(key) + _estimate(value) + _RECORD_OVERHEAD
        else:
            self._list.append((key, value))
            self._approx += _estimate(key) + _estimate(value) + _RECORD_OVERHEAD
        if self._approx > self.memory_budget:
            self._spill()

    def insert_all(self, records: Iterable[Tuple[Any, Any]]) -> None:
        for k, v in records:
            self.insert(k, v)

    # -- spill -------------------------------------------------------------

    def _merge_key(self, key: Any) -> Any:
        return key if self.key_ordering else hash(key)

    def _memory_items(self) -> List[Tuple[Any, Any, Any]]:
        pairs = self._map.items() if self.aggregator is not None else self._list
        return [(self._merge_key(k), k, v) for k, v in pairs]

    def _spill(self) -> None:
        items = self._memory_items()
        items.sort(key=lambda t: t[0])
        self._runs.append(_Run(items, self.spill_dir))
        self.spill_count += 1
        self._map = {}
        self._list = []
        self._approx = 0

    # -- output ------------------------------------------------------------

    def __iter__(self) -> Iterator[Tuple[Any, Any]]:
        if not self._runs:
            # pure in-memory path: identical behavior to the pre-spill pipeline
            pairs = (
                iter(self._map.items()) if self.aggregator is not None else iter(self._list)
            )
            if self.key_ordering:
                pairs = iter(sorted(pairs, key=lambda kv: kv[0]))
            return pairs
        return self._merged()

    def _compact_runs(self) -> None:
        """Hierarchically merge runs until at most ``merge_fan_in`` remain, so
        the final merge never holds an unbounded number of open files.  Plain
        order-preserving concatenation of sorted streams — aggregator combine
        happens only at final iteration, so duplicates pass through intact."""
        while len(self._runs) > self.merge_fan_in:
            batch, self._runs = self._runs[: self.merge_fan_in], self._runs[self.merge_fan_in :]
            merged = heapq.merge(*(iter(r) for r in batch), key=lambda t: t[0])
            self._runs.append(_Run(merged, self.spill_dir))
            for r in batch:
                r.close()

    def _merged(self) -> Iterator[Tuple[Any, Any]]:
        self._compact_runs()
        tail = self._memory_items()
        tail.sort(key=lambda t: t[0])
        streams = [iter(r) for r in self._runs] + [iter(tail)]
        merged = heapq.merge(*streams, key=lambda t: t[0])
        if self.aggregator is None:
            for _mk, k, v in merged:
                yield (k, v)
        else:
            # combine within each merge-key group; a group holds one key in the
            # common case, a handful on hash collision — bounded either way.
            # Entries are per-run ACCUMULATORS, so they merge with
            # merge_combiners, not the value-folding aggregator.
            for _mk, group in itertools.groupby(merged, key=lambda t: t[0]):
                acc: dict = {}
                order: list = []
                for _, k, v in group:
                    if k in acc:
                        acc[k] = self.merge_combiners(acc[k], v)
                    else:
                        acc[k] = v
                        order.append(k)
                for k in order:
                    yield (k, acc[k])

    def close(self) -> None:
        for r in self._runs:
            r.close()
        self._runs = []
        self._map = {}
        self._list = []
        self._approx = 0
