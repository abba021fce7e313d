"""The port's plan-driven aggregate (``run_plan_grouped_aggregate`` in
sparkucx_tpu_torch/ops/relational.py) against the JAX package's on the
virtual CPU mesh of tests/conftest.py: the two cases of
tests/test_fused_combine.py (quota sub-rounds at all three quotas, and the
non-dense fallback), plus a masked plan and the plan's telemetry.

Tolerance: none.  int32 results are equal bit for bit, to each other and to
the unfused route of both packages."""

from dataclasses import replace

import numpy as np
import pytest

from sparkucx_tpu.ops import exchange as jax_exchange
from sparkucx_tpu.ops import relational as jr
from sparkucx_tpu.ops import skew as jax_skew
from sparkucx_tpu_torch.ops import relational as tr
from sparkucx_tpu_torch.ops import skew as torch_skew
from sparkucx_tpu_torch.utils.stats import StatsAggregator

N = 4


@pytest.fixture(scope="module")
def mesh():
    return jax_exchange.make_mesh(N)


def _spec_kw(**kw):
    base = dict(num_executors=N, capacity=256, recv_capacity=256, aggs=("sum", "min", "max", "avg"), partial=True)
    base.update(kw)
    return base


def _dense_case(rng, total=600, domain=60):
    keys = rng.integers(0, domain, size=total).astype(np.uint32)
    vals = rng.integers(-100, 100, size=(total, 4)).astype(np.int32)
    return keys, vals


def _plans(**kw):
    return jax_skew.ExchangePlan(**kw), torch_skew.ExchangePlan(**kw)


def _assert_same(a_tuple, b_tuple):
    for a, b in zip(a_tuple, b_tuple):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("quota,chunks", [(256, 1), (64, 4), (128, 2)])
def test_plan_driven_quota_subrounds_match_jax(mesh, rng, quota, chunks):
    keys, vals = _dense_case(rng)
    kw = _spec_kw(combine="dense", combine_groups=64)
    jplan, tplan = _plans(slot_rows=quota, chunks_per_round=(chunks,), combine="dense")
    want = jr.run_plan_grouped_aggregate(mesh, jr.AggregateSpec(**kw), jplan, keys, vals)
    got = tr.run_plan_grouped_aggregate(["cpu"] * N, tr.AggregateSpec(**kw), tplan, keys, vals)
    _assert_same(got, want)
    ref = tr.run_grouped_aggregate(["cpu"] * N, tr.AggregateSpec(**_spec_kw()), keys, vals)
    _assert_same(got, ref)


def test_plan_driven_non_dense_falls_back(mesh, rng):
    keys, vals = _dense_case(rng, total=300)
    jplan, tplan = _plans(slot_rows=256, chunks_per_round=(1,), combine="off")
    want = jr.run_plan_grouped_aggregate(mesh, jr.AggregateSpec(impl="dense", **_spec_kw()), jplan, keys, vals)
    got = tr.run_plan_grouped_aggregate(["cpu"] * N, tr.AggregateSpec(**_spec_kw()), tplan, keys, vals)
    _assert_same(got, want)


def test_plan_driven_with_filter_and_stats_match_jax(mesh, rng):
    keys, vals = _dense_case(rng, total=700)
    mask = rng.random(keys.size) < 0.6
    kw = _spec_kw(combine="auto", combine_groups=64, with_filter=True, aggs=("sum", "max", "min", "sum"))
    jplan, tplan = _plans(slot_rows=64, chunks_per_round=(4,), combine="dense", pipeline_depth=2)
    want = jr.run_plan_grouped_aggregate(mesh, jr.AggregateSpec(**kw), jplan, keys, vals, mask=mask)
    stats = StatsAggregator()
    got = tr.run_plan_grouped_aggregate(["cpu"] * N, tr.AggregateSpec(**kw), tplan, keys, vals, mask=mask,
                                        stats=stats)
    _assert_same(got, want)
    # one submit / drain pair a sub-round; the drain counts the accumulator
    assert stats.summary("aggregate.fused.submit").ops == 4
    assert stats.summary("aggregate.fused.drain").ops == 4
    wk, wv, wc = tr.oracle_aggregate(keys[mask], vals[mask], kw["aggs"])
    assert np.array_equal(got[0], wk) and np.array_equal(got[1], wv) and np.array_equal(got[2], wc)
    with pytest.raises(ValueError, match="with_filter"):
        tr.run_plan_grouped_aggregate(["cpu"] * N, tr.AggregateSpec(**kw), tplan, keys, vals)
    with pytest.raises(ValueError, match="chunks_per_round"):
        tr.run_plan_grouped_aggregate(
            ["cpu"] * N, tr.AggregateSpec(**kw), replace(tplan, chunks_per_round=(2, 2)), keys, vals, mask=mask
        )
