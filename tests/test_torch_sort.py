"""The port's distributed sort (sparkucx_tpu_torch/ops/sort.py) against the JAX
package's (sparkucx_tpu/ops/sort.py) on the same seeded keys and payloads.

JAX side: the dense lowering on the virtual CPU mesh of tests/conftest.py (its
``single`` lowering at n=1, and its Pallas radix sort in interpret mode where
the case says ``radix``).  Port side: ``devices=["cpu"] * n``, which runs the
``shared`` lowering (the exchange is K1's plain version here) or, at n=1,
``single`` / ``radix`` (the K6 plain version).  Tolerance 0: output keys,
payloads (zero tails included) and per-shard counts must be equal, so the
splitters, and the float32 sample weights behind them, are bit-equal too."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from sparkucx_tpu.ops import exchange as jax_exchange
from sparkucx_tpu.ops import sort as jax_sort
from sparkucx_tpu_torch.ops import sort as torch_sort

CAP = 128
W = 4
_jax_fns = {}


def _jax_fn(n, **kw):
    key = (n, tuple(sorted(kw.items())))
    if key not in _jax_fns:
        spec = jax_sort.SortSpec(num_executors=n, **kw)
        _jax_fns[key] = jax_sort.build_distributed_sort(jax_exchange.make_mesh(n), spec)
    return _jax_fns[key]


def _run_jax(fn, keys, payload, nvalid):
    mesh = jax_exchange.make_mesh(len(nvalid))
    ko, po, cnt = fn(
        jax.device_put(keys, NamedSharding(mesh, P("ex"))),
        jax.device_put(payload, NamedSharding(mesh, P("ex", None))),
        jax.device_put(nvalid, NamedSharding(mesh, P("ex"))),
    )
    return np.asarray(ko), np.asarray(po), np.asarray(cnt)


def _run_torch(n, keys, payload, nvalid, **kw):
    fn = torch_sort.build_distributed_sort(["cpu"] * n, torch_sort.SortSpec(num_executors=n, **kw))
    ko, po, cnt = fn(torch.from_numpy(keys.astype(np.int64)), torch.from_numpy(payload), nvalid)
    assert ko.dtype == torch.int64
    return ko.numpy(), po.numpy(), cnt, fn.spec.impl


def _assert_same(n, keys, payload, nvalid, jax_impl, port_impl="auto", **kw):
    jk, jp, jc = _run_jax(_jax_fn(n, impl=jax_impl, **kw), keys, payload, nvalid)
    tk, tp, tc, impl = _run_torch(n, keys, payload, nvalid, impl=port_impl, **kw)
    assert impl == ("shared" if port_impl == "auto" and n > 1 else impl)
    assert np.array_equal(tc, jc), (tc, jc)
    assert np.array_equal(tk.astype(np.uint32), jk) and (tk < 2**32).all()
    assert tp.dtype == jp.dtype and np.array_equal(tp.view(np.int32), jp.view(np.int32))
    return tk.astype(np.uint32), tp, tc


def _case(name, n, rng, width=W, cap=CAP):
    """(keys, payload, nvalid) of one named input pattern (tests/test_sort.py's)."""
    total = n * cap
    nvalid = np.full(n, cap, np.int32)
    keys = rng.integers(0, 2**32, size=total, dtype=np.uint64).astype(np.uint32)
    payload = rng.integers(-(2**31), 2**31 - 1, size=(total, width), dtype=np.int64).astype(np.int32)
    if name == "unique":
        keys = rng.permutation(total).astype(np.uint32) * np.uint32(2654435761 % 2**32)
    elif name == "padding":
        nvalid = rng.integers(0, cap + 1, size=n).astype(np.int32)
        nvalid[n // 2] = 0  # an empty shard
        payload[:, 0] = np.arange(total)
        for j in range(n):  # padding keys deliberately NOT KEY_MAX, garbage payload
            keys[j * cap + nvalid[j] : (j + 1) * cap] = 12345
    elif name == "duplicates":
        keys = rng.integers(0, 7, size=total, dtype=np.uint64).astype(np.uint32)
        payload[:, 0] = np.arange(total)  # stability shows in the payload order
    elif name == "sentinel":
        keys = rng.integers(0, 1000, size=total, dtype=np.uint64).astype(np.uint32)
        keys[rng.choice(total, size=17, replace=False)] = jax_sort.KEY_MAX
        payload[:, 0] = np.arange(total)
    elif name == "band":
        keys = rng.integers(1000, 1100, size=total, dtype=np.uint64).astype(np.uint32)
    elif name == "sign_bit":
        keys = (rng.integers(0, 2**31, size=total, dtype=np.uint64) + 2**31 - 500).astype(np.uint32)
    return keys, payload, nvalid


CASES = ["uniform", "unique", "padding", "duplicates", "sentinel", "band", "sign_bit"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_sort_matches_jax(n, case):
    keys, payload, nvalid = _case(case, n, np.random.default_rng(100 * n + CASES.index(case)))
    jax_impl = "dense" if n > 1 else "single"
    tk, tp, tc = _assert_same(n, keys, payload, nvalid, jax_impl, capacity=CAP, recv_capacity=2 * CAP, width=W)
    valid = np.concatenate([keys[j * CAP : j * CAP + nvalid[j]] for j in range(n)])
    vpay = np.concatenate([payload[j * CAP : j * CAP + nvalid[j]] for j in range(n)])
    ok, op = jax_sort.oracle_sort(valid, vpay)
    got = torch_sort.unpack_shard_prefixes((tk, tp), tc, 2 * CAP)
    assert np.array_equal(got[0], ok) and np.array_equal(got[1], op)


@pytest.mark.parametrize("case", ["uniform", "padding", "sentinel"])
def test_terasort_width_matches_jax(case):
    """100-byte rows: one key and 24 payload lanes, at n=4 and a small N."""
    keys, payload, nvalid = _case(case, 4, np.random.default_rng(4), width=24, cap=96)
    _assert_same(4, keys, payload, nvalid, "dense", capacity=96, recv_capacity=144, width=24)


def test_float32_payload_matches_jax():
    rng = np.random.default_rng(11)
    keys, _, nvalid = _case("duplicates", 4, rng, width=3)
    payload = rng.normal(size=(4 * CAP, 3)).astype(np.float32)
    _assert_same(4, keys, payload, nvalid, "dense", capacity=CAP, recv_capacity=2 * CAP, width=3,
                 dtype=np.dtype(np.float32))


def test_imbalanced_shards_match_jax():
    """One full shard of uniform keys and seven one-row shards pinned at key
    0, at a tight 1x receive capacity: the fill-weighted samples must keep the
    big shard's rows spread out, exactly as in the JAX package."""
    n = 8
    rng = np.random.default_rng(12)
    keys = np.full(n * CAP, jax_sort.KEY_MAX, dtype=np.uint32)
    nvalid = np.ones(n, np.int32)
    nvalid[0] = CAP
    keys[:CAP] = rng.integers(0, 2**32 - 1, size=CAP, dtype=np.uint64).astype(np.uint32)
    keys[np.arange(1, n) * CAP] = 0
    payload = np.zeros((n * CAP, 1), np.int32)
    _, _, tc = _assert_same(n, keys, payload, nvalid, "dense", capacity=CAP, recv_capacity=CAP, width=1)
    assert (tc <= CAP).all()


@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_splitters_match_jax(n):
    """The splitters alone, through fills whose float32 sample weight lands
    next to an integer (nv / capacity * s), where a float64 or a true
    division would round differently from the JAX package."""
    from sparkucx_tpu.ops._compat import shard_map

    cap, s = 100, 100
    spec_kw = dict(num_executors=n, capacity=cap, recv_capacity=2 * cap, width=1, samples_per_shard=s)
    jspec = jax_sort.SortSpec(**spec_kw, impl="dense")
    mesh = jax_exchange.make_mesh(n)
    rng = np.random.default_rng(n)
    nvalid = np.array([53, 59, 100, 0, 1, 3, 77, 99][:n], np.int32)
    keys = np.sort(rng.integers(0, 2**32, size=(n, cap), dtype=np.uint64).astype(np.uint32), axis=1)
    jfn = jax.jit(shard_map(
        lambda k, v: jax_sort._global_splitters(jspec, k, v[0])[None, :],
        mesh=mesh, in_specs=(P("ex"), P("ex")), out_specs=P("ex", None), check_vma=False,
    ))
    theirs = np.asarray(jfn(keys.reshape(-1), nvalid))[0]
    tspec = torch_sort.SortSpec(**spec_kw)
    ours = torch_sort._global_splitters(tspec, torch.from_numpy(keys.astype(np.int64)), nvalid.astype(np.int64))
    assert np.array_equal(ours.numpy(), theirs.astype(np.int64))


@pytest.mark.parametrize("cap", [3, 7, 100, 1000, 1023, 4097, 12345, 6_250_001, 100_000_000])
@pytest.mark.parametrize("s", [3, 37, 64, 100])
def test_sample_weights_round_like_xla(cap, s):
    """The float32 sample weight ``nv / capacity * s`` of sort.py:122-124,
    jitted by XLA (which folds the division into a product with the
    reciprocal), against the port's, over every fill up to 3000 and random
    fills beyond."""
    import jax.numpy as jnp

    rng = np.random.default_rng(cap + s)
    nv = np.unique(np.concatenate([np.arange(min(cap, 3000) + 1), rng.integers(0, cap + 1, 3000)]))
    nv = nv.astype(np.int32)
    xla = jax.jit(lambda v: jnp.minimum(s, (v.astype(jnp.float32) / cap * s).astype(jnp.int32) + (v > 0)))
    spec = torch_sort.SortSpec(num_executors=1, capacity=cap, recv_capacity=cap, samples_per_shard=s)
    assert np.array_equal(torch_sort._sample_weights(spec, nv), np.asarray(xla(jnp.asarray(nv))))


@pytest.mark.parametrize("impl", ["single", "radix"])
def test_single_executor_padding_contract_matches_jax(impl):
    """n=1 with nv < capacity, garbage padding keys and payload, a valid
    KEY_MAX row and recv_capacity > capacity: sorted prefix, KEY_MAX key tail
    and zero payload tail, as the JAX lowering of the same name gives."""
    cap, recv, nv = 64, 96, 40
    rng = np.random.default_rng(7)
    keys = np.full(cap, 12345, np.uint32)
    keys[:nv] = rng.integers(0, 1 << 32, size=nv, dtype=np.uint64).astype(np.uint32)
    keys[3] = jax_sort.KEY_MAX
    payload = np.full((cap, 2), -7, np.int32)
    payload[:nv] = rng.integers(-100, 100, size=(nv, 2)).astype(np.int32)
    tk, tp, tc = _assert_same(1, keys, payload, np.array([nv], np.int32), impl, port_impl=impl,
                              capacity=cap, recv_capacity=recv, width=2)
    assert tc.tolist() == [nv]
    assert (tk[nv:] == jax_sort.KEY_MAX).all() and not tp[nv:].any()


def test_radix_valid_keymax_rows_sort_before_padding():
    keys = np.array([5, jax_sort.KEY_MAX, 1, jax_sort.KEY_MAX], np.uint32)
    pay = np.array([[50], [91], [10], [92]], np.int32)
    spec = torch_sort.SortSpec(num_executors=1, capacity=8, recv_capacity=8, width=1, impl="radix")
    sk, sp = torch_sort.run_distributed_sort(["cpu"], spec, keys, pay)
    assert sk.dtype == np.uint32
    assert sk.tolist() == [1, 5, int(jax_sort.KEY_MAX), int(jax_sort.KEY_MAX)]
    assert sp[:, 0].tolist() == [10, 50, 91, 92]


def test_radix_driver_matches_jax():
    rng = np.random.default_rng(13)
    keys = rng.integers(0, 2**32, size=1500, dtype=np.uint64).astype(np.uint32)
    pay = rng.integers(-99, 99, size=(1500, 4)).astype(np.int32)
    kw = dict(num_executors=1, capacity=2048, recv_capacity=2048, width=4, impl="radix")
    jk, jp = jax_sort.run_distributed_sort(jax_exchange.make_mesh(1), jax_sort.SortSpec(**kw), keys, pay)
    tk, tp = torch_sort.run_distributed_sort(["cpu"], torch_sort.SortSpec(**kw), keys, pay)
    assert np.array_equal(tk, jk) and np.array_equal(tp, jp)


def test_spec_resolution_and_validation():
    spec = torch_sort.SortSpec(num_executors=1, capacity=64, recv_capacity=64, width=1)
    assert spec.resolve_impl().impl == "single"
    assert torch_sort.SortSpec(2, 64, 128, width=1).resolve_impl().impl == "shared"
    assert torch_sort.SortSpec(1, 64, 32, width=1).resolve_impl().impl == "shared"
    for impl in ("single", "radix"):
        with pytest.raises(ValueError, match=impl):
            torch_sort.SortSpec(2, 8, 16, impl=impl).validate()
    with pytest.raises(NotImplementedError, match="NCCL"):
        torch_sort.SortSpec(2, 8, 16, impl="ragged").validate()
    with pytest.raises(ValueError, match="unknown impl"):
        torch_sort.SortSpec(2, 8, 16, impl="dense").validate()
    with pytest.raises(ValueError, match="32-bit"):
        torch_sort.SortSpec(2, 8, 8, dtype=np.dtype(np.float64)).resolve_impl().validate()
    with pytest.raises(ValueError, match="samples_per_shard"):
        torch_sort.SortSpec(8, 8, 8, samples_per_shard=2).resolve_impl().validate()
    with pytest.raises(ValueError, match="num_executors"):
        torch_sort.build_distributed_sort(["cpu"] * 3, torch_sort.SortSpec(4, 8, 8))
    with pytest.raises(NotImplementedError, match="NCCL"):
        torch_sort.build_distributed_sort(["cpu", "meta"], torch_sort.SortSpec(2, 8, 16))
    fn = torch_sort.build_distributed_sort(["cpu"], torch_sort.SortSpec(1, 8, 8, width=1))
    with pytest.raises(ValueError, match="payload"):
        fn(torch.zeros(8, dtype=torch.int64), torch.zeros((8, 1), dtype=torch.float32), [8])
    with pytest.raises(ValueError, match="num_valid"):
        fn(torch.zeros(8, dtype=torch.int64), torch.zeros((8, 1), dtype=torch.int32), [9])


def test_key_bits_roundtrip():
    keys = torch.tensor([0, 1, 2**31 - 1, 2**31, 2**32 - 1], dtype=torch.int64)
    bits = torch_sort.key_bits(keys)
    assert bits.dtype == torch.int32
    assert np.array_equal(bits.numpy().view(np.uint32), keys.numpy().astype(np.uint32))
    assert torch.equal(torch_sort.key_values(bits), keys)


def test_uint32_key_tensors_are_accepted():
    rng = np.random.default_rng(14)
    keys = rng.integers(0, 2**32, size=64, dtype=np.uint64).astype(np.uint32)
    pay = np.arange(64, dtype=np.int32)[:, None]
    fn = torch_sort.build_distributed_sort(["cpu"], torch_sort.SortSpec(1, 64, 64, width=1, impl="radix"))
    ko, po, _ = fn(torch.from_numpy(keys), torch.from_numpy(pay), [64])
    ok, op = torch_sort.oracle_sort(keys, pay)
    assert np.array_equal(ko.numpy(), ok.astype(np.int64)) and np.array_equal(po.numpy(), op)


class TestHostDrivers:
    def test_uniform_keys_roundtrip_matches_jax(self):
        rng = np.random.default_rng(1234)
        keys = rng.integers(0, 1 << 31, size=3000, dtype=np.uint32)
        payload = rng.integers(-99, 99, size=(3000, 3), dtype=np.int32)
        kw = dict(num_executors=4, capacity=1024, recv_capacity=1536, width=3)
        jk, jp = jax_sort.run_distributed_sort(jax_exchange.make_mesh(4), jax_sort.SortSpec(**kw, impl="dense"), keys, payload)
        tk, tp = torch_sort.run_distributed_sort(["cpu"] * 4, torch_sort.SortSpec(**kw), keys, payload)
        assert np.array_equal(tk, jk) and np.array_equal(tp, jp)
        ok, op = torch_sort.oracle_sort(keys, payload)
        assert np.array_equal(tk, ok) and np.array_equal(tp, op)

    def test_skewed_keys_trigger_retry_like_jax(self):
        rng = np.random.default_rng(1234)
        keys = np.where(rng.uniform(size=2000) < 0.9, np.uint32(7),
                        rng.integers(0, 1 << 31, size=2000).astype(np.uint32))
        payload = rng.integers(-99, 99, size=(2000, 1), dtype=np.int32)
        kw = dict(num_executors=4, capacity=512, recv_capacity=600, width=1)
        jk, jp = jax_sort.run_distributed_sort(jax_exchange.make_mesh(4), jax_sort.SortSpec(**kw, impl="dense"), keys, payload)
        fns = {}
        tk, tp = torch_sort._sort_one_batch(["cpu"] * 4, torch_sort.SortSpec(**kw), keys, payload, 3, fns)
        assert len(fns) > 1  # the first attempt overflowed and was retried
        assert np.array_equal(tk, jk) and np.array_equal(tp, jp)

    def test_pathological_skew_raises_like_jax(self):
        keys = np.full(2000, 7, np.uint32)
        payload = np.zeros((2000, 1), np.int32)
        kw = dict(num_executors=4, capacity=512, recv_capacity=520, width=1)
        with pytest.raises(RuntimeError, match="skewed"):
            jax_sort.run_distributed_sort(jax_exchange.make_mesh(4), jax_sort.SortSpec(**kw, impl="dense"),
                                          keys, payload, max_attempts=1)
        with pytest.raises(RuntimeError, match="skewed"):
            torch_sort.run_distributed_sort(["cpu"] * 4, torch_sort.SortSpec(**kw), keys, payload, max_attempts=1)

    def test_too_many_rows_raise(self):
        with pytest.raises(ValueError, match="capacity"):
            torch_sort.run_distributed_sort(["cpu"] * 2, torch_sort.SortSpec(2, 4, 8, width=1),
                                            np.zeros(9, np.uint32), np.zeros((9, 1), np.int32))

    @pytest.mark.parametrize("n,cap,total,width,hi", [
        (4, 200, 5 * 4 * 200 + 37, 3, 1 << 32),  # six runs, ragged tail
        (2, 64, 7 * 2 * 64 + 11, 1, 3),          # heavy duplication across runs
        (4, 256, 4 * 256, 1, 1 << 32),           # exactly one batch
        (1, 300, 1000, 24, 1 << 32),             # n=1 batches, TeraSort width
    ])
    def test_external_sort_matches_jax(self, n, cap, total, width, hi):
        rng = np.random.default_rng(total)
        keys = rng.integers(0, hi, size=total, dtype=np.uint64).astype(np.uint32)
        payload = np.arange(total * width, dtype=np.int32).reshape(total, width)
        kw = dict(num_executors=n, capacity=cap, recv_capacity=2 * cap, width=width)
        jimpl = "dense" if n > 1 else "single"
        jk, jp = jax_sort.run_external_sort(jax_exchange.make_mesh(n), jax_sort.SortSpec(**kw, impl=jimpl), keys, payload)
        tk, tp = torch_sort.run_external_sort(["cpu"] * n, torch_sort.SortSpec(**kw), keys, payload)
        assert np.array_equal(tk, jk) and np.array_equal(tp, jp)
        ok, op = torch_sort.oracle_sort(keys, payload)
        assert np.array_equal(tk, ok) and np.array_equal(tp, op)

    def test_external_sort_radix_batches(self):
        rng = np.random.default_rng(15)
        keys = rng.integers(0, 2**32, size=700, dtype=np.uint64).astype(np.uint32)
        payload = np.arange(700, dtype=np.int32)[:, None]
        spec = torch_sort.SortSpec(1, 256, 256, width=1, impl="radix")
        tk, tp = torch_sort.run_external_sort(["cpu"], spec, keys, payload)
        ok, op = torch_sort.oracle_sort(keys, payload)
        assert np.array_equal(tk, ok) and np.array_equal(tp, op)


def _runs(*lists):
    keys = [np.array(k, np.uint32) for k in lists]
    pays = [(np.arange(len(k), dtype=np.int32) + 10 * i)[:, None] for i, k in enumerate(keys)]
    return keys, pays


@pytest.mark.parametrize("lists", [
    ([1, 3, 5], [], [2, 3, 3]),   # odd run count, an empty run, equal keys across runs
    ([4, 4, 4], [4], [4, 4]),     # all keys equal: run order decides
    ([7],),                       # one run
    ([], []),                     # only empty runs
])
def test_merge_sorted_runs_matches_jax(lists):
    ours = torch_sort.merge_sorted_runs(*_runs(*lists))
    theirs = jax_sort.merge_sorted_runs(*_runs(*lists))
    for a, b in zip(ours, theirs):
        assert np.array_equal(a, b)


def test_merge_sorted_runs_rejects_bad_runs():
    with pytest.raises(ValueError, match="no runs"):
        torch_sort.merge_sorted_runs([], [])
    with pytest.raises(ValueError, match="pair up"):
        torch_sort.merge_sorted_runs([np.zeros(2, np.uint32)], [np.zeros((3, 1), np.int32)])
