"""The port's grouped aggregation (sparkucx_tpu_torch/ops/relational.py)
against the JAX package's (sparkucx_tpu/ops/relational.py on the virtual CPU
mesh of tests/conftest.py) on the same seeded inputs: the GROUP BY cases of
tests/test_relational.py, the fused-combine cases of tests/test_fused_combine.py
(all but the plan-driven ones) and the Q1 / Q6 shapes of tests/test_tpch.py.

Tolerances: int32 results are exact, whole output buffers included (groups,
identity tails, counts, recv totals).  float32 sums differ from JAX's by the
order of additions only: relative 1e-5 on these sizes (tens of values per
group, each rounding step 2**-24 relative).  float32 min/max are exact, and
bit-equal to JAX's where a group holds both signed zeros (in either order)
or NaNs: -0.0 lies below +0.0, and a NaN propagates with its own bits,
np.nan's and others of either sign; between NaNs of both signs min takes the
positive one and max the negative one
(``test_float_min_max_signed_zeros_and_nan_match_jax``).  No case puts two
NaNs of one sign but different bits in a group, where XLA's pick depends on
its order (tests/test_torch_combine.py pins the port's).  The seeded values
of the other cases hold neither signed zeros nor NaN.
Quantized results stay within ``QuantizeSpec.error_bound`` per partial row."""

from dataclasses import replace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from sparkucx_tpu.config import TpuShuffleConf as JaxConf
from sparkucx_tpu.ops import exchange as jax_exchange
from sparkucx_tpu.ops import relational as jr
from sparkucx_tpu_torch.config import TpuShuffleConf
from sparkucx_tpu_torch.ops import relational as tr
from sparkucx_tpu_torch.ops import ring_kernels

N = 8
CAP = 128
FLOAT_RTOL = 1e-5


def _jax_spec(**kw):
    return jr.AggregateSpec(impl="dense", **kw)


def _jax_fn_outputs(spec_kw, keys, values, nvalid, mask=None):
    n = spec_kw["num_executors"]
    mesh = jax_exchange.make_mesh(n)
    fn = jr.build_grouped_aggregate(mesh, _jax_spec(**spec_kw))
    ks, rs = NamedSharding(mesh, P("ex")), NamedSharding(mesh, P("ex", None))
    args = [jax.device_put(keys, ks), jax.device_put(values, rs), jax.device_put(nvalid, ks)]
    if mask is not None:
        args.append(jax.device_put(mask, ks))
    return [np.asarray(o) for o in fn(*args)]


def _torch_fn_outputs(spec_kw, keys, values, nvalid, mask=None):
    n = spec_kw["num_executors"]
    fn = tr.build_grouped_aggregate(["cpu"] * n, tr.AggregateSpec(**spec_kw))
    gk, gv, gc, ng, rt = fn(
        torch.from_numpy(keys.astype(np.int64)), torch.from_numpy(values), nvalid,
        None if mask is None else torch.from_numpy(mask),
    )
    return [gk.numpy(), gv.numpy(), gc.numpy(), ng, rt]


def _assert_outputs_equal(spec_kw, keys, values, nvalid, mask=None):
    j = _jax_fn_outputs(spec_kw, keys, values, nvalid, mask)
    t = _torch_fn_outputs(spec_kw, keys, values, nvalid, mask)
    assert np.array_equal(t[0], j[0].astype(np.int64)), "group keys"
    assert t[1].dtype == j[1].dtype and np.array_equal(t[1].view(np.int32), j[1].view(np.int32)), "group values"
    for a, b, name in zip(t[2:], j[2:], ("counts", "num_groups", "recv_totals")):
        assert np.array_equal(a, b.reshape(a.shape)), name
    return t


def _base(**kw):
    out = dict(num_executors=N, capacity=CAP, recv_capacity=4 * CAP, aggs=("sum", "min", "max"))
    out.update(kw)
    return out


# -- the unfused GROUP BY (test_relational.py) ------------------------------


@pytest.mark.parametrize("partial", [False, True])
def test_matches_jax_outputs(partial, rng):
    keys = rng.integers(0, 50, size=N * CAP, dtype=np.uint64).astype(np.uint32)
    values = rng.integers(-100, 100, size=(N * CAP, 3), dtype=np.int64).astype(np.int32)
    _assert_outputs_equal(_base(partial=partial), keys, values, np.full(N, CAP, np.int32))


def test_padding_rows_excluded(rng):
    nvalid = rng.integers(0, CAP + 1, size=N).astype(np.int32)
    nvalid[2] = 0
    keys = np.zeros(N * CAP, np.uint32)
    values = np.zeros((N * CAP, 3), np.int32)
    for j in range(N):
        keys[j * CAP : j * CAP + nvalid[j]] = rng.integers(0, 20, size=nvalid[j])
        values[j * CAP : j * CAP + nvalid[j]] = rng.integers(1, 10, size=(nvalid[j], 3))
    _assert_outputs_equal(_base(), keys, values, nvalid)


def test_sentinel_key_is_a_real_group(rng):
    keys = rng.integers(0, 5, size=N * CAP, dtype=np.uint64).astype(np.uint32)
    keys[rng.choice(N * CAP, size=33, replace=False)] = tr.KEY_MAX
    values = np.ones((N * CAP, 3), np.int32)
    t = _assert_outputs_equal(_base(), keys, values, np.full(N, CAP, np.int32))
    assert t[2][t[0] == int(tr.KEY_MAX)].sum() == 33


def test_count_star_no_value_columns(rng):
    keys = rng.integers(0, 10, size=N * CAP, dtype=np.uint64).astype(np.uint32)
    _assert_outputs_equal(_base(aggs=()), keys, np.zeros((N * CAP, 0), np.int32), np.full(N, CAP, np.int32))


@pytest.mark.parametrize("aggs", [("min", "max"), ("sum", "avg")])
def test_float_aggregation_within_tolerance(aggs, rng):
    keys = rng.integers(0, 16, size=N * CAP, dtype=np.uint64).astype(np.uint32)
    values = rng.normal(size=(N * CAP, 2)).astype(np.float32)
    kw = _base(aggs=aggs, dtype=np.dtype(np.float32))
    j = _jax_fn_outputs(kw, keys, values, np.full(N, CAP, np.int32))
    t = _torch_fn_outputs(kw, keys, values, np.full(N, CAP, np.int32))
    assert np.array_equal(t[0], j[0]) and np.array_equal(t[2], j[2])
    if aggs == ("min", "max"):
        assert np.array_equal(t[1], j[1])  # no reassociation in min/max
    else:
        np.testing.assert_allclose(t[1], j[1], rtol=FLOAT_RTOL, atol=1e-5)


def test_spec_validation():
    for kw, err, match in [
        (dict(aggs=("median",)), ValueError, "unknown aggregation"),
        (dict(aggs=("count_distinct",), partial=True), ValueError, "count_distinct"),
        (dict(aggs=("sum",), impl="ragged"), NotImplementedError, "NCCL"),
        (dict(aggs=("sum",), impl="dense"), ValueError, "unknown impl"),
        (dict(aggs=("sum",), quantize_mode="int8", partial=True), ValueError, "floating"),
        (dict(aggs=("sum",), combine="fused", partial=True), ValueError, "combine tier"),
        (dict(aggs=("sum",), combine="dense", combine_groups=8), ValueError, "partial"),
        (dict(aggs=("sum",), combine="dense", partial=True), ValueError, "combine_groups"),
    ]:
        with pytest.raises(err, match=match):
            tr.build_grouped_aggregate(["cpu"] * 2, tr.AggregateSpec(num_executors=2, capacity=8, recv_capacity=8, **kw))
    with pytest.raises(ValueError, match="num_executors"):
        tr.build_grouped_aggregate(["cpu"] * 3, tr.AggregateSpec(num_executors=2, capacity=8, recv_capacity=8, aggs=()))
    with pytest.raises(NotImplementedError, match="NCCL"):
        tr.build_grouped_aggregate(["cpu", "meta"], tr.AggregateSpec(num_executors=2, capacity=8, recv_capacity=8, aggs=()))


def test_hash_owners_match_jax(rng):
    import jax.numpy as jnp

    keys = rng.integers(0, 2**32, size=4096, dtype=np.uint64).astype(np.uint32)
    keys[:4] = [0, 1, 2**31, 2**32 - 1]
    valid = rng.random(4096) < 0.9
    for n in (1, 3, 4, 8):
        want = np.asarray(jr.hash_owners(jnp.asarray(keys), n, jnp.asarray(valid)))
        got = tr.hash_owners(torch.from_numpy(keys.astype(np.int64)), n, torch.from_numpy(valid))
        assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
        assert np.array_equal(tr.hash_owners_host(keys, n), jr.hash_owners_host(keys, n))


# -- host driver, filters, partials, avg, count_distinct -----------------------


def _run_both(n, spec_kw, keys, values, mask=None):
    j = jr.run_grouped_aggregate(jax_exchange.make_mesh(n), _jax_spec(num_executors=n, **spec_kw), keys, values, mask=mask)
    t = tr.run_grouped_aggregate(["cpu"] * n, tr.AggregateSpec(num_executors=n, **spec_kw), keys, values, mask=mask)
    return t, j


def _assert_exact(t, j):
    for a, b in zip(t, j):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_run_roundtrip_vs_jax_and_oracle(rng):
    keys = rng.integers(0, 50, size=3000).astype(np.uint32)
    values = rng.integers(-99, 99, size=(3000, 2)).astype(np.int32)
    t, j = _run_both(4, dict(capacity=1024, recv_capacity=1536, aggs=("sum", "max")), keys, values)
    _assert_exact(t, j)
    _assert_exact(t, tr.oracle_aggregate(keys, values, ("sum", "max")))


def test_single_hot_key_triggers_retry(rng):
    keys = np.full(2000, 42, np.uint32)
    values = rng.integers(0, 10, size=(2000, 1)).astype(np.int32)
    t, j = _run_both(4, dict(capacity=512, recv_capacity=600, aggs=("sum",)), keys, values)
    _assert_exact(t, j)
    assert t[0].tolist() == [42] and t[2][0] == 2000
    with pytest.raises(RuntimeError, match="skewed"):
        tr.run_grouped_aggregate(
            ["cpu"] * 4, tr.AggregateSpec(4, 512, 100, ("sum",)), keys, values, max_attempts=2
        )


@pytest.mark.parametrize("partial", [False, True])
def test_scattered_mask_matches_jax(partial, rng):
    keys = rng.integers(0, 12, size=N * CAP, dtype=np.uint64).astype(np.uint32)
    keys[rng.choice(N * CAP, size=17, replace=False)] = tr.KEY_MAX
    values = rng.integers(-100, 100, size=(N * CAP, 2)).astype(np.int32)
    mask = rng.random(N * CAP) < 0.4
    t = _assert_outputs_equal(
        _base(aggs=("sum", "min"), with_filter=True, partial=partial), keys, values, np.full(N, CAP, np.int32), mask
    )
    if not partial:
        assert int(t[4].sum()) == int(mask.sum())


def test_all_rows_filtered_zero_groups():
    keys = np.arange(N * CAP, dtype=np.uint32)
    t = _assert_outputs_equal(
        _base(aggs=(), recv_capacity=CAP, with_filter=True), keys, np.zeros((N * CAP, 0), np.int32),
        np.full(N, CAP, np.int32), np.zeros(N * CAP, bool),
    )
    assert t[3].sum() == 0


def test_filter_mask_mismatch_raises(rng):
    spec = tr.AggregateSpec(2, 8, 8, ("sum",), with_filter=True)
    with pytest.raises(ValueError, match="mask"):
        tr.run_grouped_aggregate(["cpu"] * 2, spec, np.zeros(4, np.uint32), np.zeros((4, 1), np.int32))
    fn = tr.build_grouped_aggregate(["cpu"] * 2, spec)
    with pytest.raises(ValueError, match="mask"):
        fn(torch.zeros(16, dtype=torch.int64), torch.zeros((16, 1), dtype=torch.int32), [8, 8])


def test_partial_fuzz_bit_equal_to_unfused_and_jax(rng):
    for _ in range(3):
        total = int(rng.integers(100, 2500))
        keys = rng.integers(0, int(rng.integers(1, 60)), size=total).astype(np.uint32)
        values = rng.integers(-1000, 1000, size=(total, 3)).astype(np.int32)
        kw = dict(capacity=-(-total // N) + 8, recv_capacity=4 * max(32, -(-total // N)), aggs=("sum", "min", "max"))
        plain, _ = _run_both(N, kw, keys, values)
        fused, jfused = _run_both(N, dict(kw, partial=True), keys, values)
        _assert_exact(fused, plain)
        _assert_exact(fused, jfused)


def test_hot_key_sends_one_partial_per_shard():
    keys = np.full(N * CAP, 99, np.uint32)
    values = np.ones((N * CAP, 1), np.int32)
    t = _assert_outputs_equal(
        _base(aggs=("sum",), recv_capacity=2 * N, partial=True), keys, values, np.full(N, CAP, np.int32)
    )
    assert int(t[4].sum()) == N


def test_float_partials_compose_exactly(rng):
    keys = rng.integers(0, 16, size=N * CAP, dtype=np.uint64).astype(np.uint32)
    values = rng.normal(size=(N * CAP, 2)).astype(np.float32)
    _assert_outputs_equal(_base(aggs=("min", "max"), dtype=np.dtype(np.float32), partial=True), keys, values,
                          np.full(N, CAP, np.int32))


def test_avg_and_avg_with_partial(rng):
    keys = rng.integers(0, 40, size=3000).astype(np.uint32)
    values = rng.integers(-500, 500, size=(3000, 2)).astype(np.int32)
    kw = dict(capacity=512, recv_capacity=1024, aggs=("avg", "sum"))
    t, j = _run_both(N, kw, keys, values)
    assert t[1].dtype == np.float64
    _assert_exact(t, j)
    _assert_exact(t, tr.oracle_aggregate(keys, values, kw["aggs"]))
    _assert_exact(_run_both(N, dict(kw, partial=True), keys, values)[0], t)


@pytest.mark.parametrize("masked", [False, True])
def test_count_distinct_matches_jax(masked, rng):
    total = 1200
    keys = rng.integers(0, 30 if not masked else 8, size=total).astype(np.uint32)
    values = rng.integers(0, 12, size=(total, 2)).astype(np.int32)
    values[:, 1] = rng.integers(-3, 3, size=total)
    mask = None
    if masked:
        keys[rng.choice(total, size=21, replace=False)] = tr.KEY_MAX
        mask = rng.random(total) < 0.6
    kw = dict(capacity=256, recv_capacity=1024, aggs=("count_distinct", "count_distinct"), with_filter=masked)
    t, j = _run_both(N, kw, keys, values, mask=mask)
    _assert_exact(t, j)
    sel = mask if masked else slice(None)
    _assert_exact(t, tr.oracle_aggregate(keys[sel], values[sel], kw["aggs"]))


def test_from_conf_matches_jax():
    for kwargs in (
        dict(capacity=64, recv_capacity=64, aggs=("sum",), partial=True),
        dict(capacity=64, recv_capacity=64, aggs=("sum",), partial=False),
        dict(capacity=64, recv_capacity=64, aggs=("count_distinct",)),
        dict(capacity=64, recv_capacity=64, aggs=("sum",), dtype=np.dtype(np.float32)),
        dict(capacity=64, recv_capacity=64, aggs=("sum",), num_executors=1),
    ):
        for conf_kw in (
            dict(num_executors=4, exchange_fused_combine=True),
            dict(num_executors=4, quantize_mode="int8"),
            dict(num_executors=4, partial_aggregation=False),
        ):
            j = jr.AggregateSpec.from_conf(JaxConf(**conf_kw), **kwargs)
            t = tr.AggregateSpec.from_conf(TpuShuffleConf(**conf_kw), **kwargs)
            assert (t.partial, t.combine, t.quantize_mode, t.num_executors) == (
                j.partial, j.combine, j.quantize_mode, j.num_executors,
            )


# -- the fused combine (test_fused_combine.py) ---------------------------------

NF = 4


def _agg(**kw):
    base = dict(capacity=256, recv_capacity=256, aggs=("sum", "min", "max", "avg"), partial=True)
    base.update(kw)
    return base


def _dense_case(rng, dtype=np.int32, total=700, domain=60):
    keys = rng.integers(0, domain, size=total).astype(np.uint32)
    vals = rng.integers(-100, 100, size=(total, 4)).astype(dtype)
    return keys, vals


@pytest.mark.parametrize("tier", ["dense", "sorted"])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("jax_lowering", ["xla", "interpret"])
def test_fused_bit_identical_to_unfused_and_jax(tier, dtype, jax_lowering, rng):
    """int32 always; float32 over integral values, where every order of
    addition gives the same bits.  The port has one route; the JAX side runs
    its scheduled permutes ('xla') and its Pallas kernel interpreted."""
    keys, vals = _dense_case(rng, dtype=dtype)
    kw = _agg(dtype=np.dtype(dtype), combine=tier, combine_groups=64 if tier == "dense" else 0)
    ref = tr.run_grouped_aggregate(["cpu"] * NF, tr.AggregateSpec(NF, **dict(kw, combine="off")), keys, vals)
    before = ring_kernels.ring_combine_grid.launches
    got = tr.run_grouped_aggregate(["cpu"] * NF, tr.AggregateSpec(NF, **kw), keys, vals)
    assert ring_kernels.ring_combine_grid.launches == before
    _assert_exact(got, ref)
    jspec = _jax_spec(num_executors=NF, combine_lowering=jax_lowering, **kw)
    j = jr.run_grouped_aggregate(jax_exchange.make_mesh(NF), jspec, keys, vals)
    _assert_exact(got, j)
    ok, _, oc = tr.oracle_aggregate(keys, vals, kw["aggs"])
    assert np.array_equal(got[0], ok) and np.array_equal(got[2], oc)


def test_fused_with_filter(rng):
    keys, vals = _dense_case(rng)
    mask = rng.random(keys.size) < 0.7
    kw = _agg(with_filter=True, combine="dense", combine_groups=64)
    ref = tr.run_grouped_aggregate(["cpu"] * NF, tr.AggregateSpec(NF, **dict(kw, combine="off")), keys, vals, mask=mask)
    got = tr.run_grouped_aggregate(["cpu"] * NF, tr.AggregateSpec(NF, **kw), keys, vals, mask=mask)
    _assert_exact(got, ref)


def test_fused_outputs_match_jax_buffers(rng):
    """The whole compiled outputs of the dense fused route, identity tails and
    recv_totals included, against JAX's."""
    keys, vals = _dense_case(rng, total=4 * 200)
    kw = dict(num_executors=NF, capacity=200, recv_capacity=64, aggs=("sum", "max"), partial=True,
              combine="dense", combine_groups=64)
    _assert_outputs_equal(kw, keys, vals[:, :2].copy(), np.array([200, 180, 0, 77], np.int32))


@pytest.mark.parametrize("tier", ["dense", "sorted"])
@pytest.mark.parametrize("mode", ["int8", "blockfloat"])
def test_quantized_fused_within_error_bound(tier, mode, rng):
    keys = rng.integers(0, 48, size=600).astype(np.uint32)
    vals = (rng.random((600, 2), np.float32) * 200 - 100).astype(np.float32)
    kw = _agg(aggs=("sum", "avg"), dtype=np.dtype(np.float32), quantize_mode=mode,
              combine=tier, combine_groups=64 if tier == "dense" else 0)
    spec = tr.AggregateSpec(NF, **kw)
    gk, gv, gc = tr.run_grouped_aggregate(["cpu"] * NF, spec, keys, vals)
    ok, ov, oc = tr.oracle_aggregate(keys, vals, spec.aggs)
    assert np.array_equal(gk, ok) and np.array_equal(gc, oc)  # keys and counts are never quantized
    bound = spec.qspec.error_bound(np.abs(vals).max()) * NF + 1e-4
    assert np.abs(gv[:, 0] - ov[:, 0]).max() <= bound * gc.max()
    uk, uv, uc = tr.run_grouped_aggregate(["cpu"] * NF, replace(spec, combine="off"), keys, vals)
    assert np.array_equal(gk, uk)
    assert np.abs(gv - uv).max() <= 2 * bound * gc.max()
    jk, jv, jc = jr.run_grouped_aggregate(jax_exchange.make_mesh(NF), _jax_spec(num_executors=NF, **kw), keys, vals)
    assert np.array_equal(gk, jk) and np.array_equal(gc, jc)
    assert np.abs(gv - jv).max() <= 2 * bound * gc.max()


def test_repeated_calls_are_identical(rng):
    spec = tr.AggregateSpec(NF, **_agg(aggs=("sum", "avg"), dtype=np.dtype(np.float32), quantize_mode="int8"))
    fn = tr.build_grouped_aggregate(["cpu"] * NF, spec)
    keys = rng.integers(0, 32, size=NF * 256).astype(np.int64)
    vals = (rng.random((NF * 256, 2), np.float32) * 50).astype(np.float32)
    args = (torch.from_numpy(keys), torch.from_numpy(vals), [256, 200, 100, 0])
    first = fn(*args)
    for _ in range(2):
        for a, b in zip(first, fn(*args)):
            assert np.array_equal(np.asarray(a), np.asarray(b))


def test_auto_tiers(rng):
    keys = rng.integers(0, 1 << 31, size=500).astype(np.uint32)
    vals = rng.integers(-100, 100, size=(500, 4)).astype(np.int32)
    kw = _agg(combine="auto")
    g = 1 << int(np.max(keys)).bit_length()
    assert tr.AggregateSpec(NF, **dict(kw, combine_groups=g)).resolve_combine().combine == "sorted"
    assert tr.AggregateSpec(NF, **dict(kw, combine_groups=64)).resolve_combine().combine == "dense"
    ref = tr.run_grouped_aggregate(["cpu"] * NF, tr.AggregateSpec(NF, **dict(kw, combine="off")), keys, vals)
    got = tr.run_grouped_aggregate(["cpu"] * NF, tr.AggregateSpec(NF, **kw), keys, vals)
    _assert_exact(got, ref)


# -- TPC-H shapes (test_tpch.py) ------------------------------------------------


@pytest.mark.parametrize("combine", ["off", "auto"])
def test_q1_pricing_summary_matches_jax(combine, rng):
    rows = 600
    flags = rng.integers(0, 6, size=rows).astype(np.uint32)
    qty = rng.integers(1, 51, size=rows).astype(np.int32)
    price = rng.integers(100, 10000, size=rows).astype(np.int32)
    disc = rng.integers(0, 10, size=rows).astype(np.int32)
    values = np.stack([qty, price, disc, qty], axis=1)
    kw = dict(capacity=CAP, recv_capacity=4 * CAP, aggs=("sum", "sum", "min", "max"), partial=True, combine=combine)
    t, j = _run_both(N, kw, flags, values)
    _assert_exact(t, j)
    assert np.array_equal(t[0], np.arange(6, dtype=np.uint32))
    for f in range(6):
        m = flags == f
        assert t[1][f].tolist() == [qty[m].sum(), price[m].sum(), disc[m].min(), qty[m].max()]
        assert t[2][f] == m.sum()


def test_q1_float_pricing_summary_within_tolerance(rng):
    """Q1's float columns (sum_disc_price, sum_charge, avg_*) through the fused
    route against JAX and a float64 oracle."""
    rows = 2000
    flags = rng.integers(0, 4, size=rows).astype(np.uint32)
    qty = rng.integers(1, 51, size=rows).astype(np.float32)
    price = (qty * rng.integers(90000, 200000, size=rows) / 100).astype(np.float32)
    disc = (rng.integers(0, 11, size=rows) / 100).astype(np.float32)
    tax = (rng.integers(0, 9, size=rows) / 100).astype(np.float32)
    values = np.stack([qty, price, price * (1 - disc), price * (1 - disc) * (1 + tax), qty, price, disc], axis=1)
    aggs = ("sum", "sum", "sum", "sum", "avg", "avg", "avg")
    kw = dict(capacity=CAP * 2, recv_capacity=CAP, aggs=aggs, dtype=np.dtype(np.float32), partial=True, combine="auto")
    t, j = _run_both(N, kw, flags, values)
    assert np.array_equal(t[0], j[0]) and np.array_equal(t[2], j[2])
    np.testing.assert_allclose(t[1], j[1], rtol=FLOAT_RTOL)
    ok, ov, oc = tr.oracle_aggregate(flags, values.astype(np.float64), aggs)
    np.testing.assert_allclose(t[1], ov, rtol=FLOAT_RTOL)


def test_q6_forecast_revenue_filtered_aggregate_matches_jax(rng):
    rows = 800
    qty = rng.integers(1, 51, size=rows).astype(np.int32)
    disc = rng.integers(0, 11, size=rows).astype(np.int32)
    price = rng.integers(100, 10000, size=rows).astype(np.int32)
    mask = (qty < 24) & (disc >= 5) & (disc <= 7)
    keys = np.zeros(rows, np.uint32)  # a global aggregate: one group
    values = (price * disc)[:, None].astype(np.int32)
    kw = dict(capacity=CAP, recv_capacity=CAP, aggs=("sum",), with_filter=True)
    t, j = _run_both(N, kw, keys, values, mask=mask)
    _assert_exact(t, j)
    assert t[1][0, 0] == int((price * disc)[mask].sum()) and t[2][0] == mask.sum()


# -- float32 min/max: signed zeros and NaN ----------------------------------

#: NaNs of other bits than np.nan's (0x7fc00000): another positive one and a
#: negative one (x86's 0/0)
_POS_NAN, _NEG_NAN = np.array([0x7FC00001, 0xFFC00000], np.uint32).view(np.float32)
_P, _N = _POS_NAN, _NEG_NAN
#: each column's values per row: both zeros in both orders and NaNs, over keys
#: [5, 5, 7, 7, 5, 5, 7, 7] (executor 0 holds rows 0-3, executor 1 rows 4-7);
#: no group meets two NaNs of one sign with different bits, between which
#: XLA picks by the order it meets them in
_SIGNED_COLUMNS = {
    "zeros": ([0.0, -0.0, 1, 1, -0.0, 0.0, 1, 1], [-0.0, 0.0, 1, 1, 0.0, -0.0, 1, 1]),
    "nan": ([0.0, -0.0, 1, np.nan, -0.0, np.nan, 1, 1], [np.nan, 0.0, -0.0, 1, 0.0, -0.0, 1, np.nan]),
    "nans of other bits": ([0.0, -0.0, 1, _N, -0.0, _N, 1, 1], [_P, 0.0, -0.0, 1, 0.0, -0.0, 1, _P]),
    "nans of both signs": ([0.0, _N, 1, _P, -0.0, _P, 1, _N], [_P, 0.0, _N, 1, _N, -0.0, _P, 1]),
}
#: the bits of min a, min b, max a, max b in groups 5 and 7, where NaN came out
_SIGNED_NAN_OUT = {
    "nan": [np.nan] * 4,
    "nans of other bits": [_N, _P, _N, _P],
    "nans of both signs": [_P, _P, _N, _N],  # min takes the positive NaN, max the negative one
}
_SIGNED_ROUTES = {
    "unfused": dict(partial=False),
    "unfused partial": dict(partial=True),
    "fused": dict(partial=True, combine="dense", combine_groups=16),
}


@pytest.mark.parametrize("route", sorted(_SIGNED_ROUTES))
@pytest.mark.parametrize("case", sorted(_SIGNED_COLUMNS))
def test_float_min_max_signed_zeros_and_nan_match_jax(route, case):
    """n=2 GROUP BY of min and max over both columns, every output buffer
    bit-equal to the JAX package's (``_assert_outputs_equal``)."""
    keys = np.array([5, 5, 7, 7, 5, 5, 7, 7], np.uint32)
    a, b = (np.asarray(c, np.float32) for c in _SIGNED_COLUMNS[case])
    values = np.stack([a, b, a, b], axis=1)
    kw = dict(num_executors=2, capacity=4, recv_capacity=16, aggs=("min", "min", "max", "max"),
              dtype=np.dtype(np.float32), **_SIGNED_ROUTES[route])
    got = _assert_outputs_equal(kw, keys, values, np.array([4, 4], np.int32))
    (five,) = np.flatnonzero((got[0] == 5) & (got[2] > 0))
    (seven,) = np.flatnonzero((got[0] == 7) & (got[2] > 0))
    if case == "zeros":  # group 5: min -0.0 and max +0.0 from either order
        assert got[1][five].view(np.uint32).tolist() == [0x80000000, 0x80000000, 0, 0]
    else:  # every column of both groups meets a NaN, and passes its bits on
        want = np.asarray(_SIGNED_NAN_OUT[case], np.float32).view(np.uint32).tolist()
        assert got[1][[five, seven]].view(np.uint32).tolist() == [want] * 2


def test_float_min_max_seeded_signed_values_match_jax(rng):
    """Seeded keys and values drawn from {-0.0, +0.0, -1, 1} and two NaNs, one
    of each sign, fused and unfused, against JAX."""
    n, cap = 2, 32
    keys = rng.integers(0, 6, size=n * cap).astype(np.uint32)
    pool = np.array([-0.0, 0.0, -1.0, 1.0, np.nan, _NEG_NAN], np.float32)
    values = pool[rng.integers(0, pool.size, size=(n * cap, 2))]
    values[rng.random(values.shape) < 0.5] = 0.0  # mostly zeros: many groups hold both
    for route in _SIGNED_ROUTES.values():
        kw = dict(num_executors=n, capacity=cap, recv_capacity=32, aggs=("min", "max"),
                  dtype=np.dtype(np.float32), **route)
        _assert_outputs_equal(kw, keys, values, np.array([cap, cap - 3], np.int32))
