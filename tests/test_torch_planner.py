"""The port's planners (sparkucx_tpu_torch/ops/planner.py) against the JAX
package's ops/planner.py, on the same contexts and conf knobs, down to the
``canonical_plan`` strings; the port's plan executor and lowering dispatch
(transport/executor.py); and plan-driven cluster runs against the default
single-shot run, byte for byte."""

import dataclasses

import numpy as np
import pytest
import torch

from sparkucx_tpu.config import TpuShuffleConf as JaxConf
from sparkucx_tpu.obs.metrics import MetricSample
from sparkucx_tpu.ops import planner as jax_planner
from sparkucx_tpu.ops import skew as jax_skew
from sparkucx_tpu_torch.config import TpuShuffleConf
from sparkucx_tpu_torch.core.block import MemoryBlock, ShuffleBlockId
from sparkucx_tpu_torch.core.operation import OperationStatus
from sparkucx_tpu_torch.ops import planner
from sparkucx_tpu_torch.ops.exchange import ExchangeSpec, build_exchange
from sparkucx_tpu_torch.ops.planner import (
    DEFAULT_PASSES,
    AdaptivePlanner,
    PlanContext,
    PlanSignals,
    StaticPlanner,
    canonical_plan,
    lineage_hash,
    make_planner,
    optimize_plan,
    pass_coalesce_chunks,
    pass_pow2_bucket,
    pass_reorder_rounds,
)
from sparkucx_tpu_torch.ops.skew import ExchangePlan, plan_exchange
from sparkucx_tpu_torch.transport.executor import (
    HOST_RECV_MODES,
    build_plan_exchange,
    execute_plan,
    validate_host_recv_mode,
)
from sparkucx_tpu_torch.transport.tpu import TpuShuffleCluster
from sparkucx_tpu_torch.utils.stats import StatsAggregator
from sparkucx_tpu_torch.utils.trace import TRACER

N_EXEC = 4

_HOT = dict(
    padding_fraction=0.99, drain_occupancy=3.0, rx_stall_p99_ns=10**9, credit_stall_ns=10**9,
    worst_peer_health=0.0, breakers_open=3, compression_ratio=1.0,
)


def _ctx(mod, slot=100, maxes=(70, 10), used=0, n=N_EXEC, signals=None):
    return mod.PlanContext(
        num_executors=n, staging_slot_rows=slot, round_max_rows=tuple(maxes), used_rows_total=used,
        row_bytes=128, platform="cpu", signals=signals if signals is not None else mod.PlanSignals(),
    )


CONFS = [
    {},
    {"slot_quota_rows": 32},
    {"slot_quota_rows": 1 << 20},
    {"slot_quota_rows": 16, "planner_optimize": True},
    {"wire_streams": 4, "wire_compress_codec": "rle", "quantize_mode": "int8", "quantize_block_size": 64,
     "fetch_hedge_ms": 7, "pipeline_depth": 3, "exchange_impl": "pallas"},
    {"planner_mode": "adaptive"},
    {"planner_mode": "adaptive", "planner_min_quota_rows": 1024},
    {"planner_mode": "adaptive", "planner_min_quota_rows": 1 << 20},
    {"planner_mode": "adaptive", "planner_target_padding": 0.99},
    {"planner_mode": "adaptive", "slot_quota_rows": 16},
    {"planner_mode": "adaptive", "fetch_hedge_ms": 5, "fetch_hedge_max_ms": 50, "wire_compress_codec": "rle",
     "wire_streams": 4},
]
CONTEXTS = [
    dict(slot=100, maxes=(70, 10)),
    dict(slot=128, maxes=(100, 0, 5)),
    dict(slot=64, maxes=(48, 1)),
    dict(slot=3000, maxes=(300,), used=4 * 400),
    dict(slot=3000, maxes=(4000,), used=4 * 4 * 4096),
    dict(slot=64, maxes=(60,)),
    dict(slot=100, maxes=()),
]
SIGNALS = [None, _HOT, dict(worst_peer_health=0.3, rx_stall_p99_ns=int(10e6)), dict(compression_ratio=2.0),
           dict(credit_stall_ns=int(5e6), drain_occupancy=1.5)]


@pytest.mark.parametrize("conf_kw", CONFS, ids=range(len(CONFS)))
@pytest.mark.parametrize("sig", SIGNALS, ids=range(len(SIGNALS)))
def test_planners_match_jax_down_to_canonical_plan(conf_kw, sig):
    ours_planner = make_planner(TpuShuffleConf(**conf_kw))
    theirs_planner = jax_planner.make_planner(JaxConf(**conf_kw))
    assert type(ours_planner).__name__ == type(theirs_planner).__name__
    for c in CONTEXTS:
        ours = ours_planner.plan(_ctx(planner, signals=None if sig is None else PlanSignals(**sig), **c))
        theirs = theirs_planner.plan(
            _ctx(jax_planner, signals=None if sig is None else jax_planner.PlanSignals(**sig), **c)
        )
        assert canonical_plan(ours) == jax_planner.canonical_plan(theirs), c
        keep = ("slot_rows", "chunks_per_round", "single_shot", "round_order", "lowering")
        assert canonical_plan(ours, keep) == jax_planner.canonical_plan(theirs, keep)
        assert ours.ordered_subrounds() == theirs.ordered_subrounds()


def test_static_default_is_single_shot_golden():
    conf = TpuShuffleConf()
    plan = StaticPlanner(conf).plan(_ctx(planner, slot=100, maxes=(70, 10)))
    assert (plan.slot_rows, plan.chunks_per_round, plan.single_shot, plan.round_order) == (128, (1, 1), True, ())
    assert (plan.streams, plan.codec, plan.hedge_ms, plan.quantize_mode) == (1, "off", 0, "off")
    assert (plan.lowering, plan.pipeline_depth) == (conf.exchange_impl, conf.pipeline_depth)
    assert StaticPlanner(conf).plan(_ctx(planner, maxes=())).chunks_per_round == (1,)


def test_make_planner_dispatch():
    assert isinstance(make_planner(TpuShuffleConf()), StaticPlanner)
    assert isinstance(make_planner(TpuShuffleConf(planner_mode="adaptive")), AdaptivePlanner)


@pytest.mark.parametrize("seed", range(3))
def test_optimize_plan_matches_jax_and_preserves_coverage(seed):
    rng = np.random.default_rng(seed)
    for _ in range(25):
        nrounds = int(rng.integers(1, 5))
        maxes = tuple(int(m) for m in rng.integers(0, 500, size=nrounds))
        slot, quota = int(rng.integers(1, 400)), int(rng.integers(1, 400))
        ours = optimize_plan(plan_exchange(maxes, slot, quota), _ctx(planner, slot=slot, maxes=maxes))
        theirs = jax_planner.optimize_plan(
            jax_skew.plan_exchange(maxes, slot, quota), _ctx(jax_planner, slot=slot, maxes=maxes)
        )
        assert canonical_plan(ours) == jax_planner.canonical_plan(theirs)
        for r, m in enumerate(maxes):
            assert ours.chunks_per_round[r] * ours.slot_rows >= m
        assert ours.slot_rows & (ours.slot_rows - 1) == 0


@pytest.mark.parametrize(
    "pass_name,plan_kw,ctx_kw",
    [
        ("pass_pow2_bucket", dict(slot_rows=100, chunks_per_round=(2,)), dict(slot=100, maxes=(200,))),
        ("pass_coalesce_chunks", dict(slot_rows=16, chunks_per_round=(4,)), dict(slot=64, maxes=(60,))),
        ("pass_coalesce_chunks", dict(slot_rows=16, chunks_per_round=(3,)), dict(slot=64, maxes=(48,))),
        ("pass_coalesce_chunks", dict(slot_rows=16, chunks_per_round=(1,), single_shot=True), dict(slot=16, maxes=(16,))),
        ("pass_reorder_rounds", dict(slot_rows=16, chunks_per_round=(3, 1, 2)), dict(maxes=(48, 16, 32))),
        ("pass_reorder_rounds", dict(slot_rows=16, chunks_per_round=(1, 2)), dict(maxes=(16, 32))),
    ],
)
def test_passes_match_jax(pass_name, plan_kw, ctx_kw):
    ours = getattr(planner, pass_name)(ExchangePlan(**plan_kw), _ctx(planner, **ctx_kw))
    theirs = getattr(jax_planner, pass_name)(jax_skew.ExchangePlan(**plan_kw), _ctx(jax_planner, **ctx_kw))
    assert canonical_plan(ours) == jax_planner.canonical_plan(theirs)
    assert DEFAULT_PASSES == (pass_pow2_bucket, pass_coalesce_chunks, pass_reorder_rounds)


class _Registry:
    def __init__(self, samples):
        self._samples = samples

    def snapshot(self):
        return list(self._samples)


def test_plan_signals_from_registry_matches_jax():
    drain = (("kind", "exchange.pipeline.drain"),)
    submit = (("kind", "exchange.pipeline.submit"),)
    samples = [
        MetricSample("ops", "used_rows_total", 50.0, drain),
        MetricSample("ops", "padded_rows_total", 50.0, drain),
        MetricSample("ops", "total_ns_total", 2e9, drain),
        MetricSample("ops", "total_ns_total", 1e9, submit),
        MetricSample("wire", "rx_stall_p99_ns", 7e6),
        MetricSample("wire", "credit_stall_ns", 2e6),
        MetricSample("wire", "peer_health", 0.9),
        MetricSample("wire", "peer_health", 0.4),
        MetricSample("wire", "breaker_open", 1.0),
        MetricSample("compress", "raw_bytes", 100.0),
        MetricSample("compress", "encoded_bytes", 50.0),
    ]
    ours = PlanSignals.from_registry(_Registry(samples))
    theirs = jax_planner.PlanSignals.from_registry(_Registry(samples))
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.describe() == theirs.describe()
    assert ours.worst_peer_health == pytest.approx(0.4) and ours.compression_ratio == pytest.approx(2.0)
    assert PlanSignals.from_registry(_Registry([])) == PlanSignals()


def test_lineage_hash_and_canonical_plan_match_jax():
    parts = ("ab", "c", canonical_plan(ExchangePlan(slot_rows=8, chunks_per_round=(2, 1))))
    assert lineage_hash(*parts) == jax_planner.lineage_hash(*parts)
    assert lineage_hash("ab", "c") != lineage_hash("a", "bc")


# ----------------------------------------------------------------------
# the executor: host_recv_mode gate, lowering dispatch, execute_plan


def test_host_recv_mode_gate():
    assert HOST_RECV_MODES == ("array", "memmap", "device")
    with pytest.raises(ValueError, match=r"unknown host_recv_mode 'bogus' \(array\|memmap\|device\)"):
        validate_host_recv_mode("bogus")
    with pytest.raises(ValueError, match=r"host_recv_mode 'device' is not supported by the SPMD executor"):
        validate_host_recv_mode("device", allowed=("array", "memmap"), where="the SPMD executor")


@pytest.mark.parametrize("impl", ["stock", "pallas"])
def test_build_plan_exchange_matches_build_exchange(impl, rng):
    n, slot, lane = 4, 8, 8
    data = torch.from_numpy(rng.integers(-100, 100, size=(n * n * slot, lane), dtype=np.int32))
    sizes = rng.integers(0, slot + 1, size=(n, n)).astype(np.int32)
    spec = ExchangeSpec(n, n * slot, n * slot, lane)
    recv_ref, rs_ref = build_exchange(["cpu"] * n, spec)(data, sizes)
    fn = build_plan_exchange(["cpu"] * n, num_executors=n, send_rows=n * slot, lane=lane, impl=impl)
    recv, rs = fn(data, sizes)
    assert torch.equal(rs, rs_ref)
    for j in range(n):
        used = int(sizes[:, j].sum())
        assert torch.equal(recv[j * n * slot : j * n * slot + used], recv_ref[j * n * slot : j * n * slot + used])


def test_build_plan_exchange_unported_routes_raise():
    from sparkucx_tpu_torch.ops.compress import QuantizeSpec

    kw = dict(num_executors=2, send_rows=8, lane=4, impl="stock")
    # the quantized route is ported (tests/test_torch_quantized_exchange.py):
    # a QuantizeSpec reaches its builder, whose rejections it raises
    assert build_plan_exchange(["cpu"] * 2, quantize=QuantizeSpec("int8", 4), **kw).qspec.mode == "int8"
    with pytest.raises(ValueError, match="int8"):
        build_plan_exchange(["cpu"] * 2, quantize=QuantizeSpec(), **kw)
    with pytest.raises(NotImplementedError, match="multi-slice"):
        build_plan_exchange(["cpu"] * 2, num_slices=2, **kw)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_execute_plan_emits_natural_round_order(depth):
    plan = ExchangePlan(slot_rows=4, chunks_per_round=(3, 1, 2), round_order=(1, 2, 0), pipeline_depth=depth)
    submitted = []
    stats = StatsAggregator()

    def submit(rnd, chunk, nchunks):
        submitted.append((rnd, chunk))
        return (rnd, chunk)

    results = execute_plan(
        plan,
        submit=submit,
        drain_chunk=lambda rnd, chunk, nchunks, ticket: ticket,
        finish_round=lambda rnd, nchunks, parts: (rnd, parts),
        result_bytes=lambda r: 10,
        occupancy=lambda r: (len(r[1]), 1),
        stats=stats,
    )
    assert submitted == [(r, c) for r, c, _ in plan.ordered_subrounds()]
    assert [r for r, _ in results] == [0, 1, 2]
    assert results[0][1] == [(0, 0), (0, 1), (0, 2)]
    drain = stats.summary("exchange.pipeline.drain")
    assert drain.ops == 6 and (drain.used_rows, drain.padded_rows) == (6, 3) and drain.bytes == 30


# ----------------------------------------------------------------------
# the port's cluster: plan-driven runs against the default engine


def _buf(n):
    return MemoryBlock(np.zeros(n, dtype=np.uint8), size=n)


def _write_skewed(cluster, shuffle_id, M, R, seed=77):
    meta = cluster.create_shuffle(shuffle_id, M, R)
    rng = np.random.default_rng(seed)
    oracle = {}
    for m in range(M):
        t = cluster.transport(meta.map_owner[m])
        w = t.store.map_writer(shuffle_id, m)
        for r in range(R):
            size = int(rng.integers(2000, 3000)) if r == 0 else int(rng.integers(1, 300))
            payload = rng.integers(0, 256, size=size, dtype=np.uint8).tobytes()
            oracle[(m, r)] = payload
            w.write_partition(r, payload)
        t.commit_block(w.commit().pack())
    return meta, oracle


def _fetch_all(cluster, meta, shuffle_id, M, R, oracle):
    for r in range(R):
        consumer = meta.owner_of_reduce(r)
        t = cluster.transport(consumer)
        bufs = [_buf(8192) for _ in range(M)]
        reqs = t.fetch_blocks_by_block_ids(consumer, [ShuffleBlockId(shuffle_id, m, r) for m in range(M)], bufs, [None] * M)
        for m in range(M):
            res = reqs[m].wait(5)
            assert res.status == OperationStatus.SUCCESS, str(res.error)
            assert bufs[m].host_view()[: bufs[m].size].tobytes() == oracle[(m, r)]


def _conf(quota, mode="array", **kw):
    return TpuShuffleConf(
        staging_capacity_per_executor=N_EXEC * 4096, block_alignment=128, num_executors=N_EXEC,
        host_recv_mode=mode, slot_quota_rows=quota, **kw,
    )


def _exchange(conf, M=3 * N_EXEC, R=8):
    cluster = TpuShuffleCluster(conf, devices=["cpu"] * N_EXEC)
    meta, oracle = _write_skewed(cluster, 0, M, R)
    cluster.run_exchange(0)
    return cluster, meta, oracle


def _assert_prefix_equal(meta, base_meta):
    assert len(meta.recv_sizes) == len(base_meta.recv_sizes)
    for rnd in range(len(base_meta.recv_sizes)):
        np.testing.assert_array_equal(meta.recv_sizes[rnd], base_meta.recv_sizes[rnd])
        for j in range(N_EXEC):
            used = int(base_meta.recv_sizes[rnd][j].sum()) * 128
            assert bytes(meta.recv_shards[rnd][j][:used]) == bytes(base_meta.recv_shards[rnd][j][:used])


def test_cluster_rejects_unknown_mode_before_staging():
    cluster = TpuShuffleCluster(dataclasses.replace(_conf(0), host_recv_mode="bogus"), devices=["cpu"] * N_EXEC)
    _write_skewed(cluster, 0, N_EXEC, 4)
    with pytest.raises(ValueError, match="unknown host_recv_mode"):
        cluster.run_exchange(0)


@pytest.mark.parametrize(
    "kw",
    [
        dict(planner_optimize=True),
        dict(exchange_impl="pallas"),
        dict(planner_mode="adaptive", planner_min_quota_rows=8, wire_compress_codec="rle"),
        dict(quantize_mode="int8", quantize_block_size=64, slot_quota_rows=8),
        dict(slot_quota_rows=8, planner_optimize=True),
        dict(slot_quota_rows=8, exchange_impl="pallas"),
    ],
)
def test_plan_driven_runs_bit_identical_to_default(kw):
    _, base_meta, oracle = _exchange(_conf(0))
    kw = dict(kw)
    cluster, meta, _ = _exchange(_conf(kw.pop("slot_quota_rows", 0), **kw))
    _assert_prefix_equal(meta, base_meta)
    _fetch_all(cluster, meta, 0, 3 * N_EXEC, 8, oracle)


@pytest.mark.parametrize("mode", ["array", "memmap", "device"])
def test_adaptive_bit_identical_each_recv_mode(mode, tmp_path):
    _, base_meta, oracle = _exchange(_conf(0))
    kw = {"planner_mode": "adaptive", "planner_min_quota_rows": 8}
    if mode == "memmap":
        kw["spill_dir"] = str(tmp_path)
    if mode == "device":
        kw["keep_device_recv"] = True
    cluster, meta, _ = _exchange(_conf(0, mode=mode, **kw))
    if mode == "device":
        assert meta.recv_shards is None
    else:
        _assert_prefix_equal(meta, base_meta)
    _fetch_all(cluster, meta, 0, 3 * N_EXEC, 8, oracle)


def test_adaptive_actually_chunked():
    cluster, meta, _ = _exchange(_conf(0, planner_mode="adaptive", planner_min_quota_rows=8))
    for rnd in range(len(meta.recv_sizes)):
        for j in range(N_EXEC):
            assert meta.recv_shards[rnd][j].nbytes == int(meta.recv_sizes[rnd][j].sum()) * 128
    assert cluster.stats.summary("exchange.pipeline.drain").used_rows > 0


def test_plan_traced_per_shuffle():
    prev_enabled, prev_recording = TRACER.enabled, TRACER.recording
    TRACER.clear()
    TRACER.enable()
    try:
        _exchange(_conf(0, planner_mode="adaptive", planner_min_quota_rows=8))
        evs = [e for e in TRACER.events if e["name"] == "exchange.plan"]
        assert evs, "exchange.plan instant missing"
        args = evs[0]["args"]
        assert args["planner"] == "AdaptivePlanner" and args["shuffle_id"] == 0
        for key in ("slot_rows", "chunks_per_round", "single_shot", "lowering", "codec", "hedge_ms",
                    "signal_padding_fraction", "signal_worst_peer_health", "signal_compression_ratio"):
            assert key in args, key
    finally:
        TRACER.enabled, TRACER.recording = prev_enabled, prev_recording
