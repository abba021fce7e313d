"""The port's quantized exchange (sparkucx_tpu_torch/ops/ici_exchange.py
``build_quantized_exchange``, ``build_quantized_fused_exchange``, and the
``quantize`` arm of transport/executor.py ``build_plan_exchange``) against
the JAX package's builders (sparkucx_tpu/ops/ici_exchange.py on the virtual
CPU mesh of tests/conftest.py) and against the stock float32 exchange.

Twins of ``tests/test_compress.py::TestQuantizedExchange``, of
``tests/test_planner.py::TestBuildPlanExchange::test_quantized_route_matches_direct_builder``
and of ``perf/benchmark.py`` ``measure_quantized_ici``.  Tolerances: the
quantizer is bit-equal to the JAX package's (tests/test_torch_combine.py), so
every receiver's sized prefix is held BIT-EQUAL to the JAX builder's, its tail
is zero, the receive sizes are equal, and every value lies within
``QuantizeSpec.error_bound`` (of the largest magnitude, + 1e-7) of the stock
float32 exchange of the same rows.  On the CPU the wrappers run their plain
versions, so K1, K2 and K3 count no launch here."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from sparkucx_tpu.ops import compress as jax_compress
from sparkucx_tpu.ops import exchange as jax_exchange
from sparkucx_tpu.ops import ici_exchange as jax_ici
from sparkucx_tpu.transport import executor as jax_executor
from sparkucx_tpu_torch.ops import block_kernels, ring_kernels
from sparkucx_tpu_torch.ops import compress as torch_compress
from sparkucx_tpu_torch.ops import exchange as torch_exchange
from sparkucx_tpu_torch.ops import ici_exchange as torch_ici
from sparkucx_tpu_torch.perf import benchmark
from sparkucx_tpu_torch.transport import executor as torch_executor

N, SLOT, LANE = 4, 8, 8


def _jax_spec(n=N, slot=SLOT, lane=LANE):
    return jax_exchange.ExchangeSpec(num_executors=n, send_rows=n * slot, recv_rows=n * slot, lane=lane)


def _torch_spec(n=N, slot=SLOT, lane=LANE):
    return torch_exchange.ExchangeSpec(n, n * slot, n * slot, lane)


def _put(mesh):
    sharding = NamedSharding(mesh, P("ex", None))
    return lambda a: jax.device_put(a, sharding)


def _case(rng, n=N, slot=SLOT, lane=LANE, lo=0):
    data = rng.normal(scale=5.0, size=(n * n * slot, lane)).astype(np.float32)
    sizes = rng.integers(lo, slot + 1, size=(n, n)).astype(np.int32)
    return data, sizes


def _assert_prefixes_bit_equal(got: torch.Tensor, want: np.ndarray, sizes: np.ndarray, recv_rows: int):
    """Every receiver's sized prefix bit-equal to ``want``'s, and zero after it."""
    got = got.numpy()
    for j in range(sizes.shape[0]):
        used = int(sizes[:, j].sum())
        shard = got[j * recv_rows : (j + 1) * recv_rows]
        assert shard[:used].tobytes() == want[j * recv_rows : j * recv_rows + used].tobytes(), f"receiver {j}"
        assert not shard[used:].any(), f"receiver {j}: tail not zero"


def _within_bound(q, got: torch.Tensor, stock: torch.Tensor, data: np.ndarray, sizes: np.ndarray):
    """Within the bound of the stock exchange over every receiver's received
    rows (the stock exchange leaves the rows past them unspecified)."""
    bound = q.error_bound(float(np.abs(data).max())) + 1e-7
    err = benchmark.max_err_rows(got, stock, sizes, got.shape[0] // sizes.shape[0])
    assert err <= bound, f"{err} > {bound}"
    return err


@pytest.mark.parametrize("mode", ["int8", "blockfloat"])
def test_within_bound_vs_stock(mode, rng):
    q = torch_compress.QuantizeSpec(mode=mode, block_size=8)
    data, sizes = _case(rng)
    mesh = jax_exchange.make_mesh(N)
    put = _put(mesh)
    jfn = jax_ici.build_quantized_exchange(mesh, _jax_spec(), jax_compress.QuantizeSpec(mode=mode, block_size=8))
    jrecv, jrs = (np.asarray(a) for a in jfn(put(data), put(sizes)))
    spec = _torch_spec()
    fn = torch_ici.build_quantized_exchange(["cpu"] * N, spec, q)
    assert fn.qspec is q and fn.lowering == "dma"
    before = (ring_kernels.ring_exchange_grid.launches, block_kernels.block_gather.launches)
    recv, rs = fn(torch.from_numpy(data), sizes)
    assert (ring_kernels.ring_exchange_grid.launches, block_kernels.block_gather.launches) == before
    assert recv.dtype == torch.float32 and tuple(recv.shape) == (N * N * SLOT, LANE)
    np.testing.assert_array_equal(rs.numpy(), jrs.reshape(N, N))
    _assert_prefixes_bit_equal(recv, jrecv, sizes, N * SLOT)
    srecv, srs = torch_exchange.build_exchange(["cpu"] * N, spec)(torch.from_numpy(data.view(np.int32).copy()), sizes)
    assert torch.equal(rs, srs)
    _within_bound(q, recv, srecv.view(torch.float32), data, sizes)


def _fused_case(rng, n=N, slot=SLOT, lane=LANE):
    """One block per (executor, destination), packed back to back per
    executor, and the staging it lands in (the JAX test's case)."""
    send_rows = n * slot
    sizes = rng.integers(1, slot + 1, size=(n, n)).astype(np.int32)
    starts, counts, outs = (np.zeros((n, n), np.int32) for _ in range(3))
    packed = np.zeros((n * send_rows, lane), np.float32)
    staged = np.zeros((n * send_rows, lane), np.float32)
    for i in range(n):
        off = 0
        for j in range(n):
            c = int(sizes[i, j])
            rows = rng.normal(size=(c, lane)).astype(np.float32)
            packed[i * send_rows + off : i * send_rows + off + c] = rows
            staged[i * send_rows + j * slot : i * send_rows + j * slot + c] = rows
            starts[i, j], counts[i, j], outs[i, j] = j * slot, c, off
            off += c
    return sizes, starts, counts, outs, packed, staged


@pytest.mark.parametrize("mode", ["int8", "blockfloat"])
def test_fused_matches_unfused(mode, rng):
    """Scatter (K2) + quantize + ring + compaction + dequantize equals
    staging first and running the unfused quantized exchange, bit for bit,
    and the JAX fused builder over every receiver's sized prefix."""
    sizes, starts, counts, outs, packed, staged = _fused_case(rng)
    q = torch_compress.QuantizeSpec(mode=mode, block_size=8)
    spec = _torch_spec()
    recv_u, rs_u = torch_ici.build_quantized_exchange(["cpu"] * N, spec, q)(torch.from_numpy(staged), sizes)
    fused = torch_ici.build_quantized_fused_exchange(["cpu"] * N, spec, q, N, max_block_rows=SLOT)
    staging = torch.zeros((N * N * SLOT, LANE), dtype=torch.float32)
    before = block_kernels.block_scatter.launches
    recv_f, rs_f = fused(*(torch.from_numpy(a) for a in (starts, counts, outs, packed)), staging, sizes)
    assert block_kernels.block_scatter.launches == before
    assert torch.equal(rs_u, rs_f)
    assert recv_u.numpy().tobytes() == recv_f.numpy().tobytes()
    assert staging.numpy().tobytes() == staged.tobytes()  # the scatter landed in place
    mesh = jax_exchange.make_mesh(N)
    put = _put(mesh)
    jfn = jax_ici.build_quantized_fused_exchange(
        mesh, _jax_spec(), jax_compress.QuantizeSpec(mode=mode, block_size=8), N, max_block_rows=SLOT)
    jrecv, jrs = jfn(put(starts), put(counts), put(outs), put(packed),
                     put(np.zeros((N * N * SLOT, LANE), np.float32)), put(sizes))
    np.testing.assert_array_equal(rs_f.numpy(), np.asarray(jrs).reshape(N, N))
    _assert_prefixes_bit_equal(recv_f, np.asarray(jrecv), sizes, N * SLOT)


def test_fused_rejects_a_block_past_max_block_rows(rng):
    sizes, starts, counts, outs, packed, _ = _fused_case(rng)
    q = torch_compress.QuantizeSpec(mode="int8", block_size=8)
    fused = torch_ici.build_quantized_fused_exchange(["cpu"] * N, _torch_spec(), q, N, max_block_rows=1)
    with pytest.raises(ValueError, match="max_block_rows"):
        fused(*(torch.from_numpy(a) for a in (starts, counts, outs, packed)),
              torch.zeros((N * N * SLOT, LANE)), sizes)


def _hier_jax():
    from sparkucx_tpu.ops.hierarchy import make_hierarchical_mesh

    return make_hierarchical_mesh(2, 4), jax_exchange.ExchangeSpec(
        num_executors=8, send_rows=64, recv_rows=64, lane=8)


# (what the JAX builder is given, what the port's is given, the error both raise)
_REJECTIONS = {
    "flat": (
        lambda q: (*_hier_jax(), q),
        # a ring across slices: the port's counterpart of the hierarchical mesh
        lambda q: (["cpu"] * 8, torch_exchange.ExchangeSpec(8, 64, 64, 8), q,
                   dict(schedule=torch_ici.ring_schedule(8, 1, kind="dcn"))),
        "flat",
    ),
    "int8": (
        lambda q: (jax_exchange.make_mesh(N), _jax_spec(), jax_compress.QuantizeSpec()),
        lambda q: (["cpu"] * N, _torch_spec(), torch_compress.QuantizeSpec(), {}),
        "int8",
    ),
    "num_executors > 1": (
        lambda q: (jax_exchange.make_mesh(1), jax_exchange.ExchangeSpec(
            num_executors=1, send_rows=8, recv_rows=8, lane=8), q),
        lambda q: (["cpu"], torch_exchange.ExchangeSpec(1, 8, 8, 8), q, {}),
        "num_executors > 1",
    ),
}


@pytest.mark.parametrize("case", sorted(_REJECTIONS))
@pytest.mark.parametrize("fused", [False, True])
def test_builder_rejections(case, fused):
    jax_args, torch_args, match = _REJECTIONS[case]
    jq = jax_compress.QuantizeSpec(mode="int8", block_size=8)
    tq = torch_compress.QuantizeSpec(mode="int8", block_size=8)
    jbuild = jax_ici.build_quantized_fused_exchange if fused else jax_ici.build_quantized_exchange
    tbuild = torch_ici.build_quantized_fused_exchange if fused else torch_ici.build_quantized_exchange
    extra = (4,) if fused else ()
    with pytest.raises(ValueError, match=match) as jerr:
        jbuild(*jax_args(jq), *extra)
    *args, kw = torch_args(tq)
    with pytest.raises(ValueError, match=match) as terr:
        tbuild(*args, *extra, **kw)
    assert type(jerr.value) is type(terr.value)


def test_data_must_be_float32(rng):
    data, sizes = _case(rng)
    fn = torch_ici.build_quantized_exchange(["cpu"] * N, _torch_spec(), torch_compress.QuantizeSpec("int8", 8))
    with pytest.raises(ValueError, match="float32"):
        fn(torch.from_numpy(data.view(np.int32)), sizes)


def test_quantized_route_matches_direct_builder():
    """``build_plan_exchange(quantize=q)`` is the direct builder (and the
    JAX plan route, bit for bit over the sized prefixes)."""
    q = torch_compress.QuantizeSpec(mode="int8", block_size=8)
    data = np.random.default_rng(3).normal(scale=5.0, size=(N * N * SLOT, LANE)).astype(np.float32)
    sizes = np.random.default_rng(4).integers(0, SLOT + 1, size=(N, N)).astype(np.int32)
    recv_ref, rs_ref = torch_ici.build_quantized_exchange(["cpu"] * N, _torch_spec(), q)(torch.from_numpy(data), sizes)
    for impl in ("stock", "pallas"):
        fn = torch_executor.build_plan_exchange(
            ["cpu"] * N, num_executors=N, send_rows=N * SLOT, lane=LANE, impl=impl, quantize=q)
        assert fn.qspec is q
        recv, rs = fn(torch.from_numpy(data), sizes)
        assert torch.equal(rs, rs_ref)
        assert recv.numpy().tobytes() == recv_ref.numpy().tobytes()
    mesh = jax_exchange.make_mesh(N)
    put = _put(mesh)
    jfn = jax_executor.build_plan_exchange(
        mesh, num_executors=N, send_rows=N * SLOT, lane=LANE, axis_name="ex", impl="stock",
        quantize=jax_compress.QuantizeSpec(mode="int8", block_size=8))
    jrecv, _ = jfn(put(data), put(sizes))
    _assert_prefixes_bit_equal(recv_ref, np.asarray(jrecv), sizes, N * SLOT)


def test_measure_quantized_ici_keys_match_the_jax_core():
    """The core of the ``compress`` mode's quantized leg at n = 4, slot 1024,
    lane 128: the keys that describe the work equal the JAX core's (the
    same seeded payload, so the same largest error and bound)."""
    from sparkucx_tpu.perf import benchmark as jax_benchmark

    ours = benchmark.measure_quantized_ici(4, 1024, 128, iterations=1, device="cpu")
    theirs = jax_benchmark.measure_quantized_ici(4, 1024, 128, iterations=1)
    assert ours["n"] == theirs["n"] == 4
    assert set(ours["modes"]) == set(theirs["modes"]) == {"int8", "blockfloat"}
    for mode, cell in ours["modes"].items():
        want = theirs["modes"][mode]
        assert cell["wire_reduction"] == want["wire_reduction"] == 128 / 33
        assert cell["err_bound"] == want["err_bound"]
        assert cell["max_err"] == want["max_err"]
        assert cell["max_err"] <= cell["err_bound"]
    assert set(ours) == set(theirs)
    with pytest.raises(RuntimeError, match=">= 2 executors"):
        benchmark.measure_quantized_ici(1, 64, 8, iterations=1, device="cpu")


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    q = torch_compress.QuantizeSpec(mode="int8", block_size=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_ici.build_quantized_exchange(None, _torch_spec(), q)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_ici.build_quantized_fused_exchange(None, _torch_spec(), q, N)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        benchmark.measure_quantized_ici(4, 64, 8, iterations=1)
