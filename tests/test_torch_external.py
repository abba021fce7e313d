"""The port's spilling reduce side (sparkucx_tpu_torch/shuffle/external.py
``ExternalCombiner``, and its wiring through shuffle/reader.py and
shuffle/manager.py ``get_reader``) against the JAX package's
(sparkucx_tpu/shuffle/external.py, reader.py, manager.py).

Twins of every case of ``tests/test_external.py`` and of the combine and
ordering cases of ``tests/test_manager.py`` that need no peer plane, run
under a reduce memory budget small enough to spill.  The same records go
through both in one process, so ``hash`` agrees between them even for
``str`` keys: outputs are compared as lists (the same records in the same
order), spill counts as numbers, and each side's spill files must be gone
after ``close``.  Tolerance: exact."""

import os
import sys
import time

import numpy as np
import pytest

from sparkucx_tpu.config import TpuShuffleConf as JaxConf
from sparkucx_tpu.shuffle import external as jax_external
from sparkucx_tpu.shuffle.manager import TpuShuffleManager as JaxManager
from sparkucx_tpu.shuffle.reader import serialize_records as jax_serialize
from sparkucx_tpu_torch.config import TpuShuffleConf
from sparkucx_tpu_torch.shuffle import external
from sparkucx_tpu_torch.shuffle.external import ExternalCombiner, _estimate
from sparkucx_tpu_torch.shuffle.manager import TpuShuffleManager
from sparkucx_tpu_torch.shuffle.reader import ShuffleReadMetrics, TpuShuffleReader, serialize_records


def oracle_aggregate(records, agg):
    out = {}
    for k, v in records:
        out[k] = agg(out[k], v) if k in out else v
    return out


def _both(tmp_path, records, **kw):
    """(port output, JAX output, port spills, JAX spills) of one combine, each
    side spilling into its own directory, which ``close`` leaves empty."""
    outs = []
    for name, cls in (("torch", ExternalCombiner), ("jax", jax_external.ExternalCombiner)):
        d = tmp_path / name
        c = cls(spill_dir=str(d), **kw)
        c.insert_all(records)
        outs.append((list(c), c.spill_count, c))
    (got, tspills, tc), (want, jspills, jc) = outs
    assert got == want
    assert tspills == jspills
    for name, c in (("torch", tc), ("jax", jc)):
        c.close()
        if (tmp_path / name).exists():
            assert os.listdir(tmp_path / name) == []  # runs reclaimed
    return got, tspills


_add = lambda a, b: a + b


# -- in memory -----------------------------------------------------------------


@pytest.mark.parametrize("records, kw, want", [
    ([("a", 1), ("b", 2), ("a", 3)], dict(aggregator=_add), [("a", 4), ("b", 2)]),
    ([(3, "c"), (1, "a"), (2, "b")], dict(key_ordering=True), [(1, "a"), (2, "b"), (3, "c")]),
    ([(2, 1), (1, 1), (2, 1)], dict(aggregator=_add, key_ordering=True), [(1, 1), (2, 2)]),
], ids=["combine_no_spill", "sort_no_spill", "combine_and_sort"])
def test_in_memory_paths(tmp_path, records, kw, want):
    got, spills = _both(tmp_path, records, **kw)
    assert got == want and spills == 0


# -- spilling --------------------------------------------------------------------


def test_combine_beyond_budget(tmp_path):
    rng = np.random.default_rng(0)
    records = [(int(k), 1) for k in rng.integers(0, 100_000, size=200_000)]
    got, spills = _both(tmp_path, records, aggregator=_add, memory_budget=64 << 10)
    assert spills > 5
    assert dict(got) == oracle_aggregate(records, _add)


def test_sort_beyond_budget(tmp_path):
    rng = np.random.default_rng(1)
    keys = rng.integers(0, 1 << 30, size=100_000)
    got, spills = _both(tmp_path, [(int(k), i) for i, k in enumerate(keys)], key_ordering=True,
                        memory_budget=64 << 10)
    assert spills > 5
    assert [k for k, _ in got] == sorted(int(k) for k in keys)


def test_combine_and_sort_beyond_budget(tmp_path):
    rng = np.random.default_rng(2)
    records = [(int(k), 1) for k in rng.integers(0, 5_000, size=100_000)]
    got, spills = _both(tmp_path, records, aggregator=_add, key_ordering=True, memory_budget=32 << 10)
    assert spills > 0
    assert got == sorted(oracle_aggregate(records, _add).items())


def test_hash_collision_groups_stay_correct(tmp_path):
    # hash(1) == hash(1.0) and 1 == 1.0: one key, merged across runs
    records = [(1, 10), (1.0, 100), (2, 1), (1, 3)]
    got, spills = _both(tmp_path, records, aggregator=_add, memory_budget=1)
    assert spills >= 3
    assert dict(got) == oracle_aggregate(records, _add)


def _collect(acc, v):
    return (acc if isinstance(acc, list) else [acc]) + [v]


def _merge_lists(a, b):
    return (a if isinstance(a, list) else [a]) + (b if isinstance(b, list) else [b])


def test_collect_style_aggregator_with_merge_combiners(tmp_path):
    records = [(i % 5, i) for i in range(20_000)]
    got, spills = _both(tmp_path, records, aggregator=_collect, merge_combiners=_merge_lists,
                        key_ordering=True, memory_budget=8 << 10)
    assert spills > 0, "growing accumulators never crossed the budget"
    out = dict(got)
    for k in range(5):
        vals = out[k] if isinstance(out[k], list) else [out[k]]
        assert sorted(vals) == [i for i in range(20_000) if i % 5 == k]


def test_growing_accumulator_counts_against_budget(tmp_path):
    agg = lambda acc, v: acc + [v] if isinstance(acc, list) else [acc, v]
    got, spills = _both(tmp_path, [(0, i) for i in range(50_000)], aggregator=agg,
                        merge_combiners=lambda a, b: a + b, memory_budget=16 << 10)
    assert spills > 0
    assert sorted(got[0][1]) == list(range(50_000))


def test_in_place_aggregator_counts_growth(tmp_path):
    def agg(acc, v):
        if not isinstance(acc, list):
            acc = [acc]
        acc.append(v)
        return acc

    got, spills = _both(tmp_path, [(0, i) for i in range(50_000)], aggregator=agg,
                        merge_combiners=lambda a, b: a + b, memory_budget=16 << 10)
    assert spills > 0, "in-place accumulator growth bypassed the budget"


def test_merge_fan_in_capped(tmp_path):
    records = [(i % 100, 1) for i in range(300)]
    c = ExternalCombiner(aggregator=_add, memory_budget=1, spill_dir=str(tmp_path / "t"), merge_fan_in=4)
    c.insert_all(records)
    assert c.spill_count > 20
    out = list(c)
    assert len(c._runs) <= 4, "hierarchical compaction did not cap fan-in"
    c.close()
    assert os.listdir(tmp_path / "t") == []
    got, _ = _both(tmp_path, records, aggregator=_add, memory_budget=1, merge_fan_in=4)
    assert got == out and dict(out) == oracle_aggregate(records, _add)


def test_spill_dir_created_on_demand(tmp_path):
    missing = tmp_path / "not" / "yet" / "there"
    c = ExternalCombiner(aggregator=_add, memory_budget=1, spill_dir=str(missing))
    c.insert_all([(1, 1), (2, 2)])
    assert c.spill_count >= 1
    assert dict(c) == {1: 1, 2: 2}
    c.close()
    got, _ = _both(missing, [(1, 1), (2, 2)], aggregator=_add, memory_budget=1)
    assert dict(got) == {1: 1, 2: 2}


def test_unordered_no_aggregator_streams_all_records(tmp_path):
    records = [(i % 50, i) for i in range(10_000)]
    got, spills = _both(tmp_path, records, memory_budget=1 << 10)
    assert spills > 0
    assert sorted(v for _, v in got) == list(range(10_000))


# -- the size estimate -----------------------------------------------------------


class _Rec:
    def __init__(self):
        self.payload = [0] * 10_000


_SELF = []
_SELF.append(_SELF)

_ESTIMATE_CASES = {
    "nested_list": ([0] * 10_000, 10_000 * 24),
    "nested_dict": ({i: "x" * 100 for i in range(1_000)}, 1_000 * 100),
    "self_reference": (_SELF, 0),
    "numpy_view": (np.zeros(1 << 20, dtype=np.uint8)[: 1 << 19], (1 << 19) - 1),
    "object_with_dict_attrs": (_Rec(), 10_000 * 24),
}


@pytest.mark.parametrize("name", sorted(_ESTIMATE_CASES))
def test_estimate_counts_payload_as_the_jax_package(name):
    obj, floor = _ESTIMATE_CASES[name]
    assert _estimate(obj) == jax_external._estimate(obj)
    assert _estimate(obj) > floor


def test_scalars_and_strings_exact():
    for obj in (42, 3.14, "hello" * 100, b"x" * 1000, None, True):
        assert _estimate(obj) == sys.getsizeof(obj) == jax_external._estimate(obj)


def test_sampling_keeps_cost_bounded():
    big = [list(range(100)) for _ in range(100_000)]
    t0 = time.perf_counter()
    size = _estimate(big)
    dt = time.perf_counter() - t0
    assert size > 100_000 * 100 * 24  # payload dominates
    assert dt < 0.05, f"estimate walked the whole container ({dt:.3f}s)"
    assert size == jax_external._estimate(big)


def test_nested_values_spill_within_budget(tmp_path):
    records = [(i, list(range(i, i + 10_000))) for i in range(40)]
    got, spills = _both(tmp_path, records, key_ordering=True, memory_budget=1 << 20)
    assert spills > 0, "nested values bypassed the spill budget"
    assert got == records  # keys inserted pre-sorted; values intact


def test_module_constants_equal_the_jax_package():
    for name in ("_RECORD_OVERHEAD", "DEFAULT_MERGE_FAN_IN", "_ESTIMATE_MAX_DEPTH", "_ESTIMATE_SAMPLE"):
        assert getattr(external, name) == getattr(jax_external, name)


# -- the reader and the manager ------------------------------------------------------


N_EXEC = 4


def _managers(tmp_path, budget, n=N_EXEC, **kw):
    common = dict(staging_capacity_per_executor=1 << 20, block_alignment=128, num_executors=n,
                  max_blocks_per_request=3, reduce_memory_budget=budget, **kw)
    ours = TpuShuffleManager(TpuShuffleConf(spill_dir=str(tmp_path / "torch"), **common), devices=["cpu"] * n)
    theirs = JaxManager(JaxConf(spill_dir=str(tmp_path / "jax"), **common), num_executors=n)
    return ours, theirs


def _write(manager, serialize, sid, writes):
    """``writes``: per map task, {reduce partition: records}."""
    for m, parts in enumerate(writes):
        writer = manager.get_writer(sid, m)
        for r in sorted(parts):
            with writer.get_partition_writer(r).open_stream() as stream:
                stream.write(serialize(parts[r]))
        writer.commit_all_partitions()
    manager.run_exchange(sid)


def _by_hash(records, R):
    parts = {}
    for k, v in records:
        parts.setdefault(hash(k) % R, []).append((k, v))
    return parts


def _read_both(ours, theirs, sid, start, end, **kw):
    """(port records, port metrics) of one reader, held equal to the JAX reader's."""
    tr = ours.get_reader(sid, start, end, **kw)
    jr = theirs.get_reader(sid, start, end, **kw)
    got, want = list(tr.read()), list(jr.read())
    assert got == want
    for field in ("records_read", "remote_bytes_read", "remote_blocks_fetched", "spills"):
        assert getattr(tr.metrics, field) == getattr(jr.metrics, field), field
    return got, tr.metrics


def test_spilled_reduce_partition_equals_the_jax_reader(tmp_path):
    """Int keys through a budget that spills every reducer, aggregated
    without key ordering: the records come out in merge-key order, the JAX
    reader's, where an unbounded in-memory combine gives first-seen order."""
    ours, theirs = _managers(tmp_path, 16 << 10)
    M, R, SID = 4, 4, 0
    rng = np.random.default_rng(9)
    writes = [{r: [(int(k), int(v)) for k, v in zip(rng.integers(0, 5_000, 3_000), rng.integers(0, 100, 3_000))]
               for r in range(R)} for _ in range(M)]
    for mgr, ser in ((ours, serialize_records), (theirs, jax_serialize)):
        mgr.register_shuffle(SID, M, R)
        _write(mgr, ser, SID, writes)
    for r in range(R):
        got, metrics = _read_both(ours, theirs, SID, r, r + 1, aggregator=_add)
        assert metrics.spills > 0, f"reducer {r} never spilled"
        flat = [rec for m in range(M) for rec in writes[m][r]]
        assert dict(got) == oracle_aggregate(flat, _add)
        first_seen = list(oracle_aggregate(flat, _add))
        assert [k for k, _ in got] != first_seen  # merge-key order, not insertion order
    ours.stop()
    theirs.stop()
    assert os.listdir(tmp_path / "torch") == []


def test_collect_style_reader_needs_merge_combiners(tmp_path):
    ours, theirs = _managers(tmp_path, 4 << 10)
    M, R, SID = 3, 2, 1
    writes = [{r: [(i % 7, m * 10_000 + i) for i in range(2_000)] for r in range(R)} for m in range(M)]
    for mgr, ser in ((ours, serialize_records), (theirs, jax_serialize)):
        mgr.register_shuffle(SID, M, R)
        _write(mgr, ser, SID, writes)
    got, metrics = _read_both(ours, theirs, SID, 0, 1, aggregator=_collect, merge_combiners=_merge_lists,
                              key_ordering=True)
    assert metrics.spills > 0
    for k, vals in got:
        assert sorted(vals) == sorted(v for m in range(M) for kk, v in writes[m][0] if kk == k)
    ours.stop()
    theirs.stop()


@pytest.mark.parametrize("budget", [64 << 20, 256], ids=["in_memory", "spilling"])
def test_groupby_end_to_end(tmp_path, rng, budget):
    ours, theirs = _managers(tmp_path, budget)
    M, R, SID = 6, 8, 2
    oracle, writes = {}, []
    for m in range(M):
        records = [(f"key-{int(rng.integers(0, 50))}", int(rng.integers(0, 1000))) for _ in range(200)]
        for k, v in records:
            oracle[k] = oracle.get(k, 0) + v
        writes.append(_by_hash(records, R))
    for mgr, ser in ((ours, serialize_records), (theirs, jax_serialize)):
        mgr.register_shuffle(SID, M, R)
        _write(mgr, ser, SID, writes)
    got, spills = {}, 0
    for r in range(R):
        out, metrics = _read_both(ours, theirs, SID, r, r + 1, aggregator=_add, key_ordering=True)
        keys = [k for k, _ in out]
        assert keys == sorted(keys)  # key_ordering honored
        for k, v in out:
            assert hash(k) % R == r  # partition integrity
            got[k] = v
        assert metrics.records_read >= len(out)
        spills += metrics.spills
    assert got == oracle
    assert (spills > 0) == (budget < 1 << 20)
    ours.stop()
    theirs.stop()


def test_reader_range_spanning_partitions(tmp_path):
    ours, theirs = _managers(tmp_path, 1 << 10)
    M, R, SID = 2, 8, 3
    writes = [_by_hash([(f"k{i}", i) for i in range(64)], R) for _ in range(M)]
    for mgr, ser in ((ours, serialize_records), (theirs, jax_serialize)):
        mgr.register_shuffle(SID, M, R)
        _write(mgr, ser, SID, writes)
    start, end = ours.cluster.meta(SID).peer_ranges[0]
    assert (start, end) == tuple(theirs.cluster.meta(SID).peer_ranges[0])
    records, metrics = _read_both(ours, theirs, SID, start, end)  # streams: nothing combines or spills
    expected = [(f"k{i}", i) for i in range(64) if start <= hash(f"k{i}") % R < end] * M
    assert sorted(map(str, records)) == sorted(map(str, expected))
    assert metrics.remote_blocks_fetched > 3 and metrics.spills == 0
    ours.stop()
    theirs.stop()


def test_metrics_accounting(tmp_path):
    ours, theirs = _managers(tmp_path, 1)
    writes = [{0: [("a", 1)], 1: [("b", 2), ("c", 3)]}]
    for mgr, ser in ((ours, serialize_records), (theirs, jax_serialize)):
        mgr.register_shuffle(4, 1, 2)
        _write(mgr, ser, 4, writes)
    records, m = _read_both(ours, theirs, 4, 0, 1)
    assert records == [("a", 1)]
    assert m.remote_bytes_read > 0 and m.remote_blocks_fetched == 1 and m.records_read == 1
    assert m.fetch_wait_ns >= 0 and m.spills == 0
    # a budget of one byte spills each record on its own run
    records, m = _read_both(ours, theirs, 4, 1, 2, aggregator=_add)
    assert dict(records) == {"b": 2, "c": 3} and m.spills == 2
    assert ShuffleReadMetrics().spills == 0
    ours.stop()
    theirs.stop()


def test_terasort_style_global_sort(tmp_path, rng):
    import bisect

    ours, theirs = _managers(tmp_path, 4 << 10)
    M, R, SID = 4, 8, 30
    bounds = [int(2**32 * (i + 1) / R) for i in range(R - 1)]  # range partitioner
    all_keys, writes = [], []
    for m in range(M):
        keys = [int(k) for k in rng.integers(0, 2**32, size=500)]
        all_keys.extend(keys)
        parts = {}
        for k in keys:
            parts.setdefault(bisect.bisect_right(bounds, k), []).append((k, f"row-{k}"))
        writes.append(parts)
    for mgr, ser in ((ours, serialize_records), (theirs, jax_serialize)):
        mgr.register_shuffle(SID, M, R)
        _write(mgr, ser, SID, writes)
    merged, spills = [], 0
    for r in range(R):
        out, metrics = _read_both(ours, theirs, SID, r, r + 1, key_ordering=True)
        part = [k for k, _ in out]
        assert part == sorted(part)
        if merged and part:
            assert merged[-1] <= part[0]
        merged.extend(part)
        spills += metrics.spills
    assert merged == sorted(all_keys) and spills > 0
    ours.unregister_shuffle(SID)
    ours.stop()
    theirs.stop()


def test_reduce_beyond_budget_end_to_end(tmp_path):
    """Aggregate data several times larger than the budget through the
    manager and reader, one executor, as the JAX test does."""
    budget = 32 << 10
    ours, theirs = _managers(tmp_path, budget, n=1)
    M, R = 4, 2
    rng = np.random.default_rng(3)
    writes = [{r: [(int(k), 1) for k in rng.integers(0, 20_000, size=20_000)] for r in range(R)}
              for _ in range(M)]
    for mgr, ser in ((ours, serialize_records), (theirs, jax_serialize)):
        mgr.register_shuffle(0, M, R)
        _write(mgr, ser, 0, writes)
    out, metrics = _read_both(ours, theirs, 0, 0, 1, aggregator=_add, key_ordering=True)
    assert metrics.spills > 0, "budget never exceeded — test too small"
    assert out == sorted(oracle_aggregate([rec for w in writes for rec in w[0]], _add).items())
    assert sum(len(serialize_records(w[r])) for w in writes for r in range(R)) > 4 * budget
    ours.stop()
    theirs.stop()


def test_reader_reclaims_runs_when_a_record_fails(tmp_path):
    """A deserializer that raises mid-stream leaves no spill file behind."""
    ours, _ = _managers(tmp_path, 1)
    ours.register_shuffle(5, 1, 1)
    _write(ours, serialize_records, 5, [{0: [(i, i) for i in range(50)]}])

    def failing(payload):
        from sparkucx_tpu_torch.shuffle.reader import default_deserializer

        for i, rec in enumerate(default_deserializer(payload)):
            if i == 20:
                raise RuntimeError("bad record")
            yield rec

    reader = ours.get_reader(5, 0, 1, deserializer=failing, aggregator=_add)
    assert isinstance(reader, TpuShuffleReader)
    with pytest.raises(RuntimeError, match="bad record"):
        reader.read()
    assert os.listdir(tmp_path / "torch") == []
    ours.stop()
