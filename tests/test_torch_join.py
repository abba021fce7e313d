"""The port's hash join (sparkucx_tpu_torch/ops/relational.py) against the JAX
package's (sparkucx_tpu/ops/relational.py on the virtual CPU mesh of
tests/conftest.py) on the same seeded inputs: the join cases of
tests/test_relational.py (TestHashJoin, the filtered join of
TestFilterPushdown, TestLeftOuterJoin, TestRightFullOuterJoin,
TestSemiAntiJoin), ``plan_join_capacities``, and the join shapes of
tests/test_tpch.py (q18, q5, q3, q13, q4, q16, q22) and tests/test_tpcds.py
(q97, q80, q16).

Tolerance: none.  Every value is int32 or a key, so the outputs are equal
bit for bit, whole output buffers included: ``out_keys`` zero past each
executor's count, zeroed build lanes on semi, anti and null-extended rows,
``out_counts``, ``recv_totals`` (n, 2) and ``out_matched``.  The host
drivers' flat outputs are equal in order, not only as multisets."""

import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from sparkucx_tpu.ops import exchange as jax_exchange
from sparkucx_tpu.ops import relational as jr
from sparkucx_tpu_torch.ops import relational as tr

N = 8
CAP = 128
KEY_MAX = int(tr.KEY_MAX)


@functools.lru_cache(maxsize=None)
def _mesh(n):
    return jax_exchange.make_mesh(n)


@functools.lru_cache(maxsize=None)
def _jax_join(spec):
    return jr.build_hash_join(_mesh(spec.num_executors), spec)


def _jax_outputs(spec_kw, inputs, masks=None):
    spec = jr.JoinSpec(impl="dense", **spec_kw)
    mesh = _mesh(spec.num_executors)
    ks, rs = NamedSharding(mesh, P("ex")), NamedSharding(mesh, P("ex", None))
    bk, bv, bn, pk, pv, pn = inputs
    args = [jax.device_put(bk, ks), jax.device_put(bv, rs), jax.device_put(bn, ks),
            jax.device_put(pk, ks), jax.device_put(pv, rs), jax.device_put(pn, ks)]
    args += [jax.device_put(m, ks) for m in masks or ()]
    return [np.asarray(o) for o in _jax_join(spec)(*args)]


def _torch_outputs(spec_kw, inputs, masks=None):
    n = spec_kw["num_executors"]
    fn = tr.build_hash_join(["cpu"] * n, tr.JoinSpec(**spec_kw))
    bk, bv, bn, pk, pv, pn = inputs
    args = [torch.from_numpy(bk.astype(np.int64)), torch.from_numpy(bv), bn,
            torch.from_numpy(pk.astype(np.int64)), torch.from_numpy(pv), pn]
    args += [torch.from_numpy(m) for m in masks or ()]
    outs = fn(*args)
    return [o.numpy() if isinstance(o, torch.Tensor) else o for o in outs]


def assert_join_equal(spec_kw, inputs, masks=None):
    """Both packages' whole output buffers equal; returns the port's."""
    j = _jax_outputs(spec_kw, inputs, masks)
    t = _torch_outputs(spec_kw, inputs, masks)
    assert len(t) == len(j)
    assert t[0].dtype == np.int64 and np.array_equal(t[0], j[0].astype(np.int64)), "out_keys"
    for k, name in ((1, "out_build"), (2, "out_probe")):
        assert t[k].dtype == j[k].dtype and np.array_equal(t[k], j[k]), name
    assert np.array_equal(t[3], j[3]), "out_counts"
    assert t[4].dtype == np.int32 and np.array_equal(t[4], j[4].reshape(t[4].shape)), "recv_totals"
    if len(t) == 6:
        assert t[5].dtype == bool and np.array_equal(t[5], j[5]), "out_matched"
    return t


def assert_run_join_equal(bk, bv, pk, pv, n=N, join_type="inner", **kw):
    """``run_hash_join`` of both packages: equal arrays, in order."""
    j = jr.run_hash_join(_mesh(n), bk, bv, pk, pv, impl="dense", join_type=join_type, **kw)
    t = tr.run_hash_join(["cpu"] * n, bk, bv, pk, pv, join_type=join_type, **kw)
    assert len(t) == len(j)
    for a, b in zip(t, j):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    return t


def assert_run_aggregate_equal(n, spec_kw, keys, values, mask=None):
    j = jr.run_grouped_aggregate(_mesh(n), jr.AggregateSpec(impl="dense", **spec_kw), keys, values, mask=mask)
    t = tr.run_grouped_aggregate(["cpu"] * n, tr.AggregateSpec(**spec_kw), keys, values, mask=mask)
    for a, b in zip(t, j):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    return t


def _u32(rng, lo, hi, size):
    return rng.integers(lo, hi, size=size, dtype=np.uint64).astype(np.uint32)


def _i32(rng, lo, hi, size):
    return rng.integers(lo, hi, size=size, dtype=np.int64).astype(np.int32)


# -- TestHashJoin: build_hash_join, whole buffers, every join type -----------


def _join_kw(n=N, **kw):
    out = dict(
        num_executors=n,
        build_capacity=CAP, build_recv_capacity=4 * CAP, build_width=2,
        probe_capacity=CAP, probe_recv_capacity=4 * CAP, probe_width=1,
        out_capacity=8 * CAP,
    )
    out.update(kw)
    return out


def _case_many_to_many(rng):
    bk, pk = _u32(rng, 0, 40, N * CAP), _u32(rng, 0, 40, N * CAP)
    bv, pv = _i32(rng, 0, 1000, (N * CAP, 2)), _i32(rng, 0, 1000, (N * CAP, 1))
    return {}, (bk, bv, np.full(N, CAP, np.int32), pk, pv, np.full(N, 16, np.int32))


def _case_pk_fk(rng):
    bk = rng.permutation(N * CAP).astype(np.uint32)
    bv = bk[:, None].astype(np.int32) * np.array([1, 7], np.int32)
    pk, pv = _u32(rng, 0, N * CAP, N * CAP), _i32(rng, 0, 100, (N * CAP, 1))
    full = np.full(N, CAP, np.int32)
    return {}, (bk, bv, full, pk, pv, full)


def _case_disjoint(rng):
    bk, pk = _u32(rng, 0, 100, N * CAP), _u32(rng, 1000, 1100, N * CAP)
    full = np.full(N, CAP, np.int32)
    return {}, (bk, np.zeros((N * CAP, 2), np.int32), full, pk, np.zeros((N * CAP, 1), np.int32), full)


def _case_empty_build(rng):
    keys = _u32(rng, 0, 10, N * CAP)
    bv, pv = _i32(rng, 1, 9, (N * CAP, 2)), _i32(rng, 1, 9, (N * CAP, 1))
    return {}, (keys, bv, np.zeros(N, np.int32), keys, pv, np.full(N, CAP, np.int32))


def _case_empty_probe(rng):
    keys = _u32(rng, 0, 10, N * CAP)
    bv, pv = _i32(rng, 1, 9, (N * CAP, 2)), _i32(rng, 1, 9, (N * CAP, 1))
    return {}, (keys, bv, np.full(N, CAP, np.int32), keys, pv, np.zeros(N, np.int32))


def _case_sentinel_probe_key(rng):
    # ONE valid KEY_MAX build row + padding; a KEY_MAX probe matches exactly
    # the valid row, never the KEY_MAX-forced padding tail
    bk = np.zeros(N * CAP, np.uint32)
    bk[0] = KEY_MAX
    bv = np.zeros((N * CAP, 2), np.int32)
    bv[0] = (11, 22)
    bn = np.zeros(N, np.int32)
    bn[0] = 1
    pk = np.full(N * CAP, KEY_MAX, np.uint32)
    pv = np.arange(N * CAP, dtype=np.int32)[:, None]
    return {}, (bk, bv, bn, pk, pv, np.ones(N, np.int32))


def _case_output_overflow(rng):
    # every row one key: (N * CAP)**2 matches on its owner, out_capacity 4
    keys = np.zeros(N * CAP, np.uint32)
    ones = np.ones((N * CAP, 1), np.int32)
    full = np.full(N, CAP, np.int32)
    kw = dict(build_width=1, build_recv_capacity=8 * CAP, probe_recv_capacity=8 * CAP, out_capacity=4)
    return kw, (keys, ones, full, keys, ones, full)


def _case_exchange_overflow(rng):
    # every row hashes to one executor whose build receive buffer is too small
    keys = np.full(N * CAP, 5, np.uint32)
    ones = np.ones((N * CAP, 1), np.int32)
    full = np.full(N, CAP, np.int32)
    kw = dict(build_width=1, build_recv_capacity=CAP // 4, probe_recv_capacity=8 * CAP, out_capacity=CAP)
    return kw, (keys, ones, full, keys, ones, full)


_CASES = {
    "many_to_many": _case_many_to_many,
    "pk_fk": _case_pk_fk,
    "disjoint": _case_disjoint,
    "empty_build": _case_empty_build,
    "empty_probe": _case_empty_probe,
    "sentinel_probe_key": _case_sentinel_probe_key,
    "output_overflow": _case_output_overflow,
    "exchange_overflow": _case_exchange_overflow,
}


@pytest.mark.parametrize("join_type", tr.JOIN_TYPES)
@pytest.mark.parametrize("case", list(_CASES))
def test_hash_join_matches_jax(case, join_type, rng):
    kw, inputs = _CASES[case](rng)
    t = assert_join_equal(_join_kw(join_type=join_type, **kw), inputs)
    if case == "sentinel_probe_key" and join_type == "inner":
        assert t[3].sum() == N and (t[0][t[0] != 0] == KEY_MAX).all()
    if case == "output_overflow" and join_type == "inner":
        assert t[3].max() == (N * CAP) ** 2  # the true total, far past out_capacity
    if case == "exchange_overflow":
        assert t[4][:, 0].max() == N * CAP  # the true routed count


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_hash_join_executors_and_padding_matches_jax(n, rng):
    """Ragged fills (one executor empty) and sentinel keys among real ones."""
    cap = 48
    bn = rng.integers(0, cap + 1, size=n).astype(np.int32)
    pn = rng.integers(0, cap + 1, size=n).astype(np.int32)
    bn[0] = 0
    bk, pk = _u32(rng, 0, 30, n * cap), _u32(rng, 0, 30, n * cap)
    bk[rng.choice(n * cap, size=5, replace=False)] = KEY_MAX
    pk[rng.choice(n * cap, size=5, replace=False)] = KEY_MAX
    bv, pv = _i32(rng, -9, 9, (n * cap, 2)), _i32(rng, -9, 9, (n * cap, 3))
    for join_type in tr.JOIN_TYPES:
        assert_join_equal(
            _join_kw(n, build_capacity=cap, build_recv_capacity=n * cap, probe_capacity=cap,
                     probe_recv_capacity=n * cap, probe_width=3, out_capacity=4 * n * cap, join_type=join_type),
            (bk, bv, bn, pk, pv, pn),
        )


def test_float32_lanes_bit_equal(rng):
    bk, pk = _u32(rng, 0, 20, N * 32), _u32(rng, 0, 20, N * 32)
    bv = rng.normal(size=(N * 32, 1)).astype(np.float32)
    pv = rng.normal(size=(N * 32, 2)).astype(np.float32)
    full = np.full(N, 32, np.int32)
    kw = _join_kw(build_capacity=32, build_recv_capacity=N * 32, build_width=1, probe_capacity=32,
                  probe_recv_capacity=N * 32, probe_width=2, out_capacity=4 * N * 32, dtype=np.dtype(np.float32),
                  join_type="full_outer")
    assert_join_equal(kw, (bk, bv, full, pk, pv, full))


@pytest.mark.parametrize("join_type", tr.JOIN_TYPES)
def test_filtered_join_matches_jax(join_type, rng):
    """TestFilterPushdown.test_filtered_join_vs_masked_oracle: scattered
    masks on both sides, and the oracle on the masked rows."""
    bcap = pcap = 32
    bk, pk = _u32(rng, 0, 20, N * bcap), _u32(rng, 0, 20, N * pcap)
    bv, pv = _i32(rng, -50, 50, (N * bcap, 1)), _i32(rng, -50, 50, (N * pcap, 1))
    bm, pm = rng.random(N * bcap) < 0.5, rng.random(N * pcap) < 0.5
    kw = _join_kw(build_capacity=bcap, build_recv_capacity=N * bcap, build_width=1, probe_capacity=pcap,
                  probe_recv_capacity=N * pcap, out_capacity=4 * N * pcap, with_filters=True,
                  join_type=join_type)
    full = np.full(N, bcap, np.int32)
    t = assert_join_equal(kw, (bk, bv, full, pk, pv, full), masks=(bm, pm))
    assert t[4][:, 0].sum() == bm.sum() and t[4][:, 1].sum() == pm.sum()
    if join_type == "inner":
        oc, cap = t[3], kw["out_capacity"]
        got = sorted(
            (int(t[0][i]), int(t[1][i, 0]), int(t[2][i, 0]))
            for s in range(N) for i in range(s * cap, s * cap + int(oc[s]))
        )
        wk, wb, wp = tr.oracle_join(bk[bm], bv[bm], pk[pm], pv[pm])
        assert got == sorted(zip(wk.tolist(), wb[:, 0].tolist(), wp[:, 0].tolist()))


def test_mask_signature_mismatch_raises(rng):
    fn = tr.build_hash_join(["cpu"] * 2, tr.JoinSpec(**_join_kw(2, with_filters=True)))
    k = torch.zeros(2 * CAP, dtype=torch.int64)
    args = (k, torch.zeros((2 * CAP, 2), dtype=torch.int32), [CAP, CAP], k,
            torch.zeros((2 * CAP, 1), dtype=torch.int32), [CAP, CAP])
    with pytest.raises(ValueError, match="with_filters"):
        fn(*args)
    with pytest.raises(ValueError, match="join_type"):
        tr.JoinSpec(**_join_kw(impl="shared", join_type="cross")).validate()
    with pytest.raises(NotImplementedError):
        tr.JoinSpec(**_join_kw(impl="ragged")).validate()


def test_entry_points_default_to_cuda(monkeypatch):
    from sparkucx_tpu_torch.ops.skew import ExchangePlan

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tr.build_hash_join(None, tr.JoinSpec(**_join_kw(2)))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tr.run_hash_join(None, np.zeros(3, np.uint32), np.zeros((3, 1), np.int32),
                         np.zeros(3, np.uint32), np.zeros((3, 1), np.int32), num_executors=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tr.run_plan_grouped_aggregate(
            None, tr.AggregateSpec(2, 8, 8, ("sum",), partial=True, combine="dense", combine_groups=8),
            ExchangePlan(slot_rows=8, chunks_per_round=(1,), combine="dense"),
            np.zeros(4, np.uint32), np.zeros((4, 1), np.int32),
        )


# -- the host driver: left / right / full outer, semi, anti -----------------


def _draw(rng, nb, npr, bkeys, pkeys, bw, pw):
    return (_u32(rng, *bkeys, nb), _i32(rng, 1, 50, (nb, bw)), _u32(rng, *pkeys, npr), _i32(rng, 1, 50, (npr, pw)))


_DRIVER_CASES = {
    # TestLeftOuterJoin.test_left_outer_vs_oracle
    "left_outer": ("left_outer", (60, 200, (0, 30), (0, 60), 2, 1)),
    # TestRightFullOuterJoin.test_right_outer_vs_oracle / test_full_outer_vs_oracle
    "right_outer": ("right_outer", (80, 150, (0, 60), (0, 30), 2, 1)),
    "full_outer": ("full_outer", (70, 90, (0, 40), (20, 60), 1, 2)),
    # test_full_outer_preserves_every_row's inner leg
    "inner": ("inner", (50, 60, (0, 20), (10, 30), 1, 1)),
    # TestSemiAntiJoin.test_semi_and_anti_partition_the_probe
    "left_semi": ("left_semi", (40, 150, (0, 25), (0, 50), 1, 2)),
    "left_anti": ("left_anti", (40, 150, (0, 25), (0, 50), 1, 2)),
}


@pytest.mark.parametrize("n", [2, 8])
@pytest.mark.parametrize("case", list(_DRIVER_CASES))
def test_run_hash_join_matches_jax_and_oracle(case, n, rng):
    join_type, draw = _DRIVER_CASES[case]
    bk, bv, pk, pv = _draw(rng, *draw)
    got = assert_run_join_equal(bk, bv, pk, pv, n=n, join_type=join_type)
    want = tr.oracle_join(bk, bv, pk, pv, join_type=join_type)

    def rows(out):
        return sorted(zip(*(x.tolist() if x.ndim == 1 else list(map(tuple, x.tolist())) for x in out)))

    assert rows(got) == rows(want)
    if join_type in ("left_semi", "left_anti"):
        assert (got[1] == 0).all()
        exists = np.isin(pk, bk)
        assert len(got[0]) == (exists.sum() if join_type == "left_semi" else (~exists).sum())


@pytest.mark.parametrize(
    "case",
    ["empty_build_left_outer", "empty_probe_right_outer", "inner_default", "sentinel_full_outer", "semi_once"],
)
def test_run_hash_join_edge_cases_match_jax(case, rng):
    if case == "empty_build_left_outer":
        pk, pv = _u32(rng, 0, 9, 50), _i32(rng, 1, 9, (50, 1))
        got = assert_run_join_equal(np.zeros(0, np.uint32), np.zeros((0, 1), np.int32), pk, pv,
                                    join_type="left_outer")
        assert len(got[0]) == 50 and not got[3].any() and (got[1] == 0).all()
    elif case == "empty_probe_right_outer":
        bk, bv = _u32(rng, 0, 9, 40), _i32(rng, 1, 9, (40, 2))
        got = assert_run_join_equal(bk, bv, np.zeros(0, np.uint32), np.zeros((0, 1), np.int32),
                                    join_type="right_outer")
        assert len(got[0]) == 40 and not got[3].any() and (got[2] == 0).all()
    elif case == "inner_default":
        got = assert_run_join_equal(np.array([1, 2], np.uint32), np.array([[10], [20]], np.int32),
                                    np.array([2, 3, 2], np.uint32), np.array([[7], [8], [9]], np.int32))
        assert len(got) == 3 and sorted(got[0].tolist()) == [2, 2]
    elif case == "sentinel_full_outer":
        got = assert_run_join_equal(np.array([KEY_MAX, 3], np.uint32), np.array([[111], [333]], np.int32),
                                    np.array([3, 4], np.uint32), np.array([[30], [40]], np.int32),
                                    join_type="full_outer")
        rows = sorted(zip(got[0].tolist(), got[1][:, 0].tolist(), got[2][:, 0].tolist(), got[3].tolist()))
        assert rows == [(3, 333, 30, True), (4, 0, 40, False), (KEY_MAX, 111, 0, False)]
    else:
        got = assert_run_join_equal(np.full(90, 7, np.uint32), np.arange(90, dtype=np.int32)[:, None],
                                    np.array([7, 7, 8], np.uint32), np.array([[1], [2], [3]], np.int32),
                                    join_type="left_semi")
        assert sorted(got[2][:, 0].tolist()) == [1, 2]


@pytest.mark.parametrize("join_type", tr.JOIN_TYPES)
@pytest.mark.parametrize("n", [1, 3, 8])
def test_plan_join_capacities_match_jax(join_type, n, rng):
    bk, pk = _u32(rng, 0, 40, 300), _u32(rng, 20, 90, 500)
    bk[:7] = KEY_MAX
    got = tr.plan_join_capacities(bk, pk, n, join_type=join_type)
    assert got == jr.plan_join_capacities(bk, pk, n, join_type=join_type)
    assert tr.plan_join_capacities(bk[:0], pk[:0], n, join_type) == jr.plan_join_capacities(bk[:0], pk[:0], n, join_type)


def test_run_hash_join_over_provisioned_capacities(rng):
    bk, bv, pk, pv = _draw(rng, 70, 90, (0, 40), (20, 60), 1, 2)
    assert_run_join_equal(bk, bv, pk, pv, join_type="full_outer", build_capacity=40, probe_capacity=64)


# -- TPC-H and TPC-DS join shapes (tests/test_tpch.py, tests/test_tpcds.py) ---


def _pad_table(n, keys, values, cap):
    """Round-robin deal, the stage boundary of tests/test_tpch.py."""
    k = np.zeros(n * cap, np.uint32)
    v = np.zeros((n * cap, values.shape[1]), np.int32)
    nv = np.zeros(n, np.int32)
    for i, (ki, vi) in enumerate(zip(keys, values)):
        j = i % n
        assert nv[j] < cap
        k[j * cap + nv[j]], v[j * cap + nv[j]] = ki, vi
        nv[j] += 1
    return k, v, nv


def _prefixes(out, n, cap):
    return tr.unpack_shard_prefixes(out[:3], out[3], cap)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_q18_matches_jax(n, rng):
    """Q18: GROUP BY l_orderkey SUM(l_quantity) HAVING > T, join with orders,
    then ORDER BY o_totalprice DESC, o_orderkey LIMIT 10."""
    num_orders, lineitems, threshold = 300, 4000, 60
    l_orderkey = _u32(rng, 0, num_orders, lineitems)
    l_quantity = _i32(rng, 1, 20, (lineitems, 1))
    o_orderkey = np.arange(num_orders, dtype=np.uint32)
    o_vals = np.stack([rng.integers(0, 50, num_orders), rng.integers(100, 9000, num_orders)], axis=1).astype(np.int32)
    cap = -(-lineitems // n)
    keys, sums, _ = assert_run_aggregate_equal(
        n, dict(num_executors=n, capacity=cap, recv_capacity=lineitems, aggs=("sum",)), l_orderkey, l_quantity
    )
    qual = sums[:, 0] > threshold
    ocap = -(-num_orders // n)
    kw = dict(num_executors=n, build_capacity=ocap, build_recv_capacity=num_orders, build_width=1,
              probe_capacity=ocap, probe_recv_capacity=num_orders, probe_width=2, out_capacity=num_orders)
    out = assert_join_equal(kw, _pad_table(n, keys[qual], sums[qual], ocap) + _pad_table(n, o_orderkey, o_vals, ocap))
    jk, jb, jp = _prefixes(out, n, num_orders)
    top = np.lexsort((jk, -jp[:, 1].astype(np.int64)))[:10]
    want_sums = np.bincount(l_orderkey, weights=l_quantity[:, 0], minlength=num_orders)
    want_k = np.nonzero(want_sums > threshold)[0]
    want_top = want_k[np.lexsort((want_k, -o_vals[want_k, 1].astype(np.int64)))[:10]]
    assert np.array_equal(jk[top], want_top)
    assert np.array_equal(jb[top, 0], want_sums[want_top])


def test_q5_matches_jax(rng):
    """Q5: customer ⋈ orders on custkey, re-key, ⋈ lineitem, GROUP BY nation."""
    num_cust, num_orders, lineitems, num_nations = 120, 250, 2500, 12
    c_custkey = np.arange(num_cust, dtype=np.uint32)
    c_nation = _i32(rng, 0, num_nations, (num_cust, 1))
    o_custkey = _u32(rng, 0, num_cust, num_orders)
    o_orderkey = np.arange(num_orders, dtype=np.int32)[:, None]
    l_orderkey = _u32(rng, 0, num_orders, lineitems)
    l_revenue = _i32(rng, 1, 500, (lineitems, 1))
    ccap, ocap, lcap = -(-num_cust // N), -(-num_orders // N), -(-lineitems // N)
    out1 = assert_join_equal(
        dict(num_executors=N, build_capacity=ccap, build_recv_capacity=num_cust, build_width=1,
             probe_capacity=ocap, probe_recv_capacity=num_orders, probe_width=1, out_capacity=num_orders),
        _pad_table(N, c_custkey, c_nation, ccap) + _pad_table(N, o_custkey, o_orderkey, ocap),
    )
    _, nation_col, orderkey_col = _prefixes(out1, N, num_orders)
    out2 = assert_join_equal(
        dict(num_executors=N, build_capacity=ocap, build_recv_capacity=num_orders, build_width=1,
             probe_capacity=lcap, probe_recv_capacity=lineitems, probe_width=1, out_capacity=lineitems),
        _pad_table(N, orderkey_col[:, 0].astype(np.uint32), nation_col, ocap)
        + _pad_table(N, l_orderkey, l_revenue, lcap),
    )
    _, nation2, revenue2 = _prefixes(out2, N, lineitems)
    gk, gv, _ = assert_run_aggregate_equal(
        N, dict(num_executors=N, capacity=lcap, recv_capacity=lineitems, aggs=("sum",)),
        nation2[:, 0].astype(np.uint32), revenue2,
    )
    nation_of_line = c_nation[o_custkey, 0][l_orderkey]
    want = np.bincount(nation_of_line, weights=l_revenue[:, 0], minlength=num_nations)
    assert {int(k): int(v) for k, v in zip(gk, gv[:, 0])} == {k: int(v) for k, v in enumerate(want) if v}


def test_q3_matches_jax(rng):
    """Q3: filtered customer ⋈ orders, GROUP BY order SUM(revenue), top 5."""
    n_cust, n_orders = 40, 300
    seg_custs = np.sort(rng.choice(n_cust, size=n_cust // 2, replace=False)).astype(np.uint32)
    order_cust = rng.integers(0, n_cust, size=n_orders).astype(np.uint32)
    order_key = np.arange(n_orders, dtype=np.int32)
    revenue = (rng.permutation(n_orders) + 1).astype(np.int32)
    kw = dict(num_executors=N, build_capacity=CAP, build_recv_capacity=2 * CAP, build_width=1,
              probe_capacity=CAP, probe_recv_capacity=2 * CAP, probe_width=2, out_capacity=2 * CAP)
    out = assert_join_equal(
        kw, _pad_table(N, seg_custs, seg_custs.astype(np.int32)[:, None], CAP)
        + _pad_table(N, order_cust, np.stack([order_key, revenue], axis=1), CAP),
    )
    _, _, jp = _prefixes(out, N, 2 * CAP)
    keys, vals, _ = assert_run_aggregate_equal(
        N, dict(num_executors=N, capacity=2 * CAP, recv_capacity=4 * CAP, aggs=("sum",)),
        jp[:, 0].astype(np.uint32), jp[:, 1:2],
    )
    top = np.argsort(-vals[:, 0], kind="stable")[:5]
    in_seg = np.isin(order_cust, seg_custs)
    want = sorted(zip(revenue[in_seg], order_key[in_seg]), reverse=True)[:5]
    assert {(int(keys[i]), int(vals[i, 0])) for i in top} == {(int(k), int(r)) for r, k in want}


def test_q13_matches_jax(rng):
    """Q13: customer LEFT OUTER JOIN orders, COUNT per customer."""
    n_cust, n_orders = 80, 400
    custkeys = np.arange(n_cust, dtype=np.uint32)
    ordering = custkeys[rng.random(n_cust) < 0.75]
    order_cust = ordering[rng.integers(0, len(ordering), size=n_orders)].astype(np.uint32)
    jk, _, _, jm = assert_run_join_equal(order_cust, np.ones((n_orders, 1), np.int32), custkeys,
                                         np.zeros((n_cust, 1), np.int32), join_type="left_outer")
    c = -(-len(jk) // N)
    gk, gv, _ = assert_run_aggregate_equal(
        N, dict(num_executors=N, capacity=c, recv_capacity=4 * c, aggs=("sum",)), jk, jm.astype(np.int32)[:, None]
    )
    assert np.array_equal(gk, custkeys)
    assert np.array_equal(gv[:, 0], np.bincount(order_cust, minlength=n_cust))


def test_q4_matches_jax(rng):
    """Q4: orders SEMI JOIN late lineitems (filter pushed below the build
    exchange), GROUP BY priority COUNT(*)."""
    num_orders, lineitems = 120, 900
    o_orderkey = np.arange(num_orders, dtype=np.uint32)
    o_priority = rng.integers(0, 5, size=num_orders).astype(np.int32)
    l_orderkey = _u32(rng, 0, num_orders, lineitems)
    l_late = rng.random(lineitems) < 0.3
    bcap, pcap = -(-lineitems // N), -(-num_orders // N)
    kw = dict(num_executors=N, build_capacity=bcap, build_recv_capacity=lineitems, build_width=1,
              probe_capacity=pcap, probe_recv_capacity=num_orders, probe_width=1, out_capacity=num_orders,
              with_filters=True, join_type="left_semi")
    bk, bv, bn = tr.shard_rows_host(l_orderkey, np.zeros((lineitems, 1), np.int32), N, bcap)
    bm, _, _ = tr.shard_rows_host(l_late.astype(np.uint32), np.zeros((lineitems, 0), np.int32), N, bcap)
    pk, pv, pn = tr.shard_rows_host(o_orderkey, o_priority[:, None], N, pcap)
    out = assert_join_equal(kw, (bk, bv, bn, pk, pv, pn), masks=(bm.astype(bool), np.ones(N * pcap, bool)))
    jk, _, jp = _prefixes(out, N, num_orders)
    c = -(-max(len(jk), 1) // N)
    gk, _, gc = assert_run_aggregate_equal(
        N, dict(num_executors=N, capacity=c, recv_capacity=4 * c, aggs=()),
        jp[:, 0].astype(np.uint32), np.zeros((len(jk), 0), np.int32),
    )
    exists = np.isin(o_orderkey, np.unique(l_orderkey[l_late]))
    want_k, want_c = np.unique(o_priority[exists], return_counts=True)
    assert np.array_equal(gk, want_k.astype(np.uint32)) and np.array_equal(gc, want_c)


def test_q16_matches_jax(rng):
    """TPC-H Q16: partsupp ANTI JOIN complaints, COUNT(DISTINCT suppkey)."""
    n_parts, n_suppliers, rows = 40, 60, 800
    partkey = _u32(rng, 0, n_parts, rows)
    suppkey = rng.integers(0, n_suppliers, size=rows).astype(np.int32)
    complained = rng.choice(n_suppliers, size=12, replace=False).astype(np.uint32)
    _, jb, jp = assert_run_join_equal(complained, np.zeros((12, 1), np.int32), suppkey.astype(np.uint32),
                                      np.stack([partkey.astype(np.int32), suppkey], axis=1), join_type="left_anti")
    assert (jb == 0).all()
    gk, gv, gc = assert_run_aggregate_equal(
        N, dict(num_executors=N, capacity=max(1, -(-len(jp) // N)) + 8, recv_capacity=4 * CAP,
                aggs=("count_distinct",)),
        jp[:, 0].astype(np.uint32), jp[:, 1][:, None].astype(np.int32),
    )
    keep = ~np.isin(suppkey, complained.astype(np.int64))
    wk, wv, wc = tr.oracle_aggregate(partkey[keep], suppkey[keep][:, None], ("count_distinct",))
    assert np.array_equal(gk, wk) and np.array_equal(gv, wv) and np.array_equal(gc, wc)


def test_q22_matches_jax(rng):
    """Q22: AVG subquery with a filter, customers above it ANTI JOIN orders,
    COUNT / SUM per country code."""
    n_cust = 300
    custkey = np.arange(n_cust, dtype=np.uint32)
    country = rng.integers(10, 17, size=n_cust).astype(np.uint32)
    acctbal = rng.integers(-500, 5000, size=n_cust).astype(np.int32)
    order_cust = rng.choice(n_cust, size=n_cust // 2, replace=False).astype(np.uint32)
    pos = acctbal > 0
    _, av, _ = assert_run_aggregate_equal(
        N, dict(num_executors=N, capacity=-(-n_cust // N) + 8, recv_capacity=n_cust, aggs=("avg",),
                with_filter=True),
        np.zeros(n_cust, np.uint32), acctbal[:, None], mask=pos,
    )
    rich = acctbal.astype(np.float64) > float(av[0, 0])
    jk, _, jp = assert_run_join_equal(
        order_cust, np.zeros((len(order_cust), 1), np.int32), custkey[rich],
        np.stack([country[rich].astype(np.int32), acctbal[rich]], axis=1), join_type="left_anti",
    )
    gk, gv, gc = assert_run_aggregate_equal(
        N, dict(num_executors=N, capacity=-(-max(len(jk), 1) // N) + 8, recv_capacity=2 * CAP, aggs=("sum",)),
        jp[:, 0].astype(np.uint32), jp[:, 1][:, None],
    )
    want = rich & ~np.isin(custkey, order_cust)
    wk, wv, wc = tr.oracle_aggregate(country[want], acctbal[want][:, None], ("sum",))
    assert np.array_equal(gk, wk) and np.array_equal(gv, wv) and np.array_equal(gc, wc)


def test_tpcds_q97_full_outer_matches_jax(rng):
    store = rng.choice(200, size=60, replace=False).astype(np.uint32)
    catalog = rng.choice(200, size=80, replace=False).astype(np.uint32)
    jk, jb, jp, jm = assert_run_join_equal(store, np.ones((60, 1), np.int32), catalog,
                                           np.ones((80, 1), np.int32), join_type="full_outer")
    both = int(((jb[:, 0] == 1) & (jp[:, 0] == 1)).sum())
    assert both == np.isin(store, catalog).sum()
    assert len(jk) == both + (~np.isin(store, catalog)).sum() + (~np.isin(catalog, store)).sum()
    assert (jm == ((jb[:, 0] == 1) & (jp[:, 0] == 1))).all()


def test_tpcds_q80_right_outer_matches_jax(rng):
    n_sales = 300
    sale_id = rng.permutation(n_sales).astype(np.uint32)
    price = rng.integers(10, 400, size=(n_sales, 1)).astype(np.int32)
    returned = rng.choice(n_sales, size=70, replace=False).astype(np.uint32)
    refund = rng.integers(1, 9, size=(70, 1)).astype(np.int32)
    jk, jb, jp, jm = assert_run_join_equal(sale_id, price, returned, refund, join_type="right_outer")
    assert len(jk) == n_sales
    assert (jb[:, 0] - jp[:, 0]).sum() == price.sum() - refund.sum()


def test_tpcds_q16_anti_join_matches_jax(rng):
    num_orders, returns = 600, 150
    cs_order = _u32(rng, 0, num_orders, 1500)
    cs_price = rng.integers(1, 200, size=(1500, 1)).astype(np.int32)
    cr_order = rng.choice(num_orders, size=returns, replace=False).astype(np.uint32)
    jk, jb, jp = assert_run_join_equal(cr_order, np.zeros((returns, 1), np.int32), cs_order, cs_price,
                                       join_type="left_anti")
    assert (jb == 0).all()
    c = -(-max(len(jk), 1) // N)
    _, gv, gc = assert_run_aggregate_equal(
        N, dict(num_executors=N, capacity=c, recv_capacity=4 * c, aggs=("sum",)),
        np.zeros(len(jk), np.uint32), jp[:, 0][:, None],
    )
    keep = ~np.isin(cs_order, cr_order)
    assert gc[0] == keep.sum() and gv[0, 0] == cs_price[keep, 0].sum()
