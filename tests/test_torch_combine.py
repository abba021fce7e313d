"""The port's quantize half of ops/compress.py and ops/combine.py against the
JAX package's on the same seeded inputs.

Tolerances: the quantized payload is bit-equal to ``compress.quantize_rows``
(both round half to even and pack the same bytes), so dequantized values are
bit-equal too.  ``combine_window`` and ``merge_accumulators`` are exact for
int32; float32 windows without repeated keys are exact as well (each group
gets one addition per window in both packages)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkucx_tpu.ops import combine as jax_combine
from sparkucx_tpu.ops import compress as jax_compress
from sparkucx_tpu_torch.ops import combine as torch_combine
from sparkucx_tpu_torch.ops import compress as torch_compress


def _rows(rng, rows, w, scale=100.0):
    x = (rng.standard_normal((rows, w)) * scale).astype(np.float32)
    x[rng.random((rows, w)) < 0.1] = 0.0
    if rows > 3:
        x[2] = 0.0  # an all-zero row: scale 1.0
        x[3, 0] = 127.0 * 0.5  # a value that lands on a rounding tie
    return x


@pytest.mark.parametrize("mode", ["int8", "blockfloat"])
@pytest.mark.parametrize("w,block", [(1, 4), (7, 4), (16, 8), (130, 128), (5, 128)])
def test_quantize_rows_bit_equal_to_jax(mode, w, block):
    rng = np.random.default_rng(w * 31 + block + len(mode))
    x = _rows(rng, 64, w)
    jspec = jax_compress.QuantizeSpec(mode=mode, block_size=block)
    tspec = torch_compress.QuantizeSpec(mode=mode, block_size=block)
    want = np.asarray(jax_compress.quantize_rows(jspec, jnp.asarray(x)))
    got = torch_compress.quantize_rows(tspec, torch.from_numpy(x))
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert np.array_equal(got.numpy(), want)
    back_j = np.asarray(jax_compress.dequantize_rows(jspec, jnp.asarray(want), w))
    back_t = torch_compress.dequantize_rows(tspec, got, w).numpy()
    assert np.array_equal(back_t.view(np.int32), back_j.view(np.int32))
    amax = np.abs(x).max()
    assert np.abs(back_t - x).max() <= tspec.error_bound(amax) + 1e-6


def test_quantize_spec_math_and_validation():
    for block in (4, 8, 128):
        for w in (1, 3, 4, 129, 300):
            j = jax_compress.QuantizeSpec(mode="int8", block_size=block)
            t = torch_compress.QuantizeSpec(mode="int8", block_size=block)
            assert t.quantized_width(w) == j.quantized_width(w)
            assert t.padded_width(w) == j.padded_width(w) and t.num_blocks(w) == j.num_blocks(w)
            assert t.error_bound(2.0) == j.error_bound(2.0)
    with pytest.raises(ValueError, match="mode"):
        torch_compress.QuantizeSpec(mode="fp4").validate()
    with pytest.raises(ValueError, match="block_size"):
        torch_compress.QuantizeSpec(mode="int8", block_size=6).validate()
    with pytest.raises(ValueError, match="off"):
        torch_compress.quantize_rows(torch_compress.QuantizeSpec(), torch.zeros((2, 2)))
    with pytest.raises(ValueError, match="payload width"):
        torch_compress.dequantize_rows(
            torch_compress.QuantizeSpec(mode="int8", block_size=4), torch.zeros((2, 3), dtype=torch.int32), 4
        )


def test_zero_payload_dequantizes_to_zero_rows():
    spec = torch_compress.QuantizeSpec(mode="blockfloat", block_size=8)
    out = torch_compress.dequantize_rows(spec, torch.zeros((3, spec.quantized_width(10)), dtype=torch.int32), 10)
    assert torch.equal(out, torch.zeros((3, 10)))


def _window(rng, spec, rows, dup=True):
    g = spec.num_groups
    keys = rng.integers(0, g + 2, size=rows).astype(np.uint32)  # a few out of range
    if not dup:
        keys = rng.permutation(g)[:rows].astype(np.uint32)
    counts = rng.integers(0, 4, size=rows).astype(np.int32)  # count 0 = invalid
    if np.dtype(spec.dtype) == np.int32:
        vals = rng.integers(-99, 99, size=(rows, spec.width)).astype(np.int32)
        payload = vals
    else:
        vals = _rows(rng, rows, spec.width, scale=10.0)
        payload = vals
        if spec.qspec is not None:
            q = jax_compress.QuantizeSpec(mode=spec.quantize_mode, block_size=spec.quantize_block)
            payload = np.asarray(jax_compress.quantize_rows(q, jnp.asarray(vals))).view(np.float32)
    dtype = np.dtype(spec.dtype)
    return np.concatenate(
        [keys.view(np.int32).view(dtype)[:, None], payload.view(dtype), counts.view(dtype)[:, None]], axis=1
    )


_CASES = [
    (8, ("sum", "min", "max"), np.int32, "off", True),
    (1, ("sum", "avg"), np.int32, "off", True),
    (64, ("max", "sum"), np.int32, "off", True),
    (16, ("sum", "min", "max", "avg"), np.float32, "off", False),
    (32, ("sum", "avg"), np.float32, "int8", False),
    (32, ("sum", "max"), np.float32, "blockfloat", False),
]


@pytest.mark.parametrize("groups,aggs,dtype,qmode,dup", _CASES)
def test_combine_window_and_merge_match_jax(groups, aggs, dtype, qmode, dup):
    rng = np.random.default_rng(groups * 7 + len(aggs))
    kw = dict(num_groups=groups, aggs=aggs, dtype=dtype, quantize_mode=qmode, quantize_block=8)
    jspec = jax_combine.CombineSpec(**kw)
    tspec = torch_combine.CombineSpec(**kw)
    jspec.validate()
    tspec.validate()
    assert (tspec.width, tspec.payload_width, tspec.row_width, tspec.acc_bytes) == (
        jspec.width, jspec.payload_width, jspec.row_width, jspec.acc_bytes,
    )
    jv, jc = jax_combine.acc_init(jspec)
    tv, tc = torch_combine.acc_init(tspec)
    assert np.array_equal(tv.numpy(), np.asarray(jv)) and np.array_equal(tc.numpy(), np.asarray(jc))
    for _ in range(3):  # three windows folded in order
        win = _window(rng, tspec, min(groups, 12) if not dup else 40, dup=dup)
        jv, jc = jax_combine.combine_window(jspec, jnp.asarray(win), jv, jc)
        tv, tc = torch_combine.combine_window(tspec, torch.from_numpy(win), tv, tc)
        assert np.array_equal(tc.numpy(), np.asarray(jc))
        assert np.array_equal(tv.numpy().view(np.int32), np.asarray(jv).view(np.int32))
    bv, bc = torch_combine.acc_init(tspec)
    bv, bc = torch_combine.combine_window(tspec, torch.from_numpy(_window(rng, tspec, 10, dup=dup)), bv, bc)
    mj = jax_combine.merge_accumulators(jspec, (jv, jc), (jnp.asarray(bv.numpy()), jnp.asarray(bc.numpy())))
    mt = torch_combine.merge_accumulators(tspec, (tv, tc), (bv, bc))
    for a, b in zip(mt, mj):
        assert np.array_equal(a.numpy().view(np.int32), np.asarray(b).view(np.int32))


def test_merge_with_identity_is_identity():
    spec = torch_combine.CombineSpec(num_groups=8, aggs=("sum", "max", "min"), dtype=np.int32)
    rng = np.random.default_rng(5)
    av, ac = torch_combine.acc_init(spec)
    av, ac = torch_combine.combine_window(spec, torch.from_numpy(_window(rng, spec, 20)), av, ac)
    mv, mc = torch_combine.merge_accumulators(spec, (av, ac), torch_combine.acc_init(spec))
    assert torch.equal(mv, av) and torch.equal(mc, ac)


def test_combine_spec_validation_matches_jax():
    for kw, match in [
        (dict(num_groups=0, aggs=("sum",)), "num_groups"),
        (dict(num_groups=4, aggs=("count_distinct",)), "count_distinct"),
        (dict(num_groups=4, aggs=("sum",), quantize_mode="int8"), "float dtype"),
    ]:
        for mod in (jax_combine, torch_combine):
            with pytest.raises(ValueError, match=match):
                mod.CombineSpec(**kw).validate()
    q = torch_combine.CombineSpec(num_groups=4, aggs=("sum",), dtype=np.float32, quantize_mode="int8")
    q.validate()
    assert q.payload_width > q.width
    assert set(torch_combine.COMBINE_AGGS) == set(jax_combine.COMBINE_AGGS)
    for agg in ("sum", "min", "max", "avg"):
        for dt in (np.int32, np.float32):
            assert torch_combine.agg_identity(agg, dt) == jax_combine.agg_identity(agg, dt)


#: NaNs of other bits than np.nan's (0x7fc00000): another positive one and a
#: negative one (x86's 0/0); min and max pass on the bits of the NaN they meet
_POS_NAN, _NEG_NAN, _NEG_NAN_1 = np.array([0x7FC00001, 0xFFC00000, 0xFFC00001], np.uint32).view(np.float32)

#: float32 min/max inputs: both zeros in both orders, and NaNs.  No group
#: meets two NaNs of one sign with different bits: XLA's pick between those
#: depends on the order it meets them in
#: (``test_nans_of_one_sign_fold_to_one_pick_in_any_order``).
_SIGNED = {
    "zero first": [0.0, -0.0, 2.0],
    "negative zero first": [-0.0, 0.0, 2.0],
    "nan": [1.0, np.nan, -0.0],
    "nan last": [-0.0, 0.0, np.nan],
    "positive nan of other bits": [-0.0, _POS_NAN, 0.0],
    "negative nan": [1.0, _NEG_NAN, -0.0],
    "nans of both signs": [_NEG_NAN, 0.0, _POS_NAN],
}


def _signed_window(spec, values, counts=(1, 2, 1)):
    """One window: every row of ``values`` in group 1, then the same values
    reversed in group 2 (both arrival orders in one fold), a row in group 3."""
    vals = np.asarray(values, np.float32)
    rows = np.concatenate([vals, vals[::-1], vals[:1]])
    keys = np.array([1] * vals.size + [2] * vals.size + [3], np.uint32)
    cnt = np.array(list(counts) * 2 + [1], np.int32)
    payload = np.repeat(rows[:, None], spec.width, axis=1)
    return np.concatenate([keys.view(np.float32)[:, None], payload, cnt.view(np.float32)[:, None]], axis=1)


def _bits(x):
    return np.asarray(x).view(np.uint32)


@pytest.mark.parametrize("case", sorted(_SIGNED))
def test_float_min_max_signed_zeros_and_nan_bit_equal_to_jax(case):
    """-0.0 below +0.0 in either order, a NaN's own bits passed on (between
    NaNs of both signs, min takes the positive one and max the negative one),
    in ``combine_window`` (one window, then a second one folded over it) and
    in ``merge_accumulators`` (both argument orders)."""
    kw = dict(num_groups=4, aggs=("min", "max", "sum"), dtype=np.float32)
    jspec, tspec = jax_combine.CombineSpec(**kw), torch_combine.CombineSpec(**kw)
    values = _SIGNED[case]
    first = _signed_window(tspec, values)
    second = _signed_window(tspec, [-0.0, 0.0, 0.0] if "nan" not in case else [0.0, 1.0, -0.0])
    jv, jc = jax_combine.acc_init(jspec)
    tv, tc = torch_combine.acc_init(tspec)
    for win in (first, second):
        jv, jc = jax_combine.combine_window(jspec, jnp.asarray(win), jv, jc)
        tv, tc = torch_combine.combine_window(tspec, torch.from_numpy(win), tv, tc)
        assert np.array_equal(_bits(tv.numpy()), _bits(jv))
        assert np.array_equal(tc.numpy(), np.asarray(jc))
    nans = [v for v in np.asarray(values, np.float32) if np.isnan(v)]
    other = np.full((4, 3), 0.0, np.float32)
    other[1] = -0.0
    other[2, :2] = nans[0] if nans else np.nan  # the NaN the group met, or np.nan
    ov, oc = torch.from_numpy(other), torch.ones((4, 1), dtype=torch.int32)
    for a, b in (((tv, tc), (ov, oc)), ((ov, oc), (tv, tc))):
        mt = torch_combine.merge_accumulators(tspec, a, b)
        mj = jax_combine.merge_accumulators(jspec, *(tuple(jnp.asarray(x.numpy()) for x in p) for p in (a, b)))
        for x, y in zip(mt, mj):
            assert np.array_equal(_bits(x.numpy()), _bits(y))
    if "nan" in case:  # the NaN's own bits came out of group 1's min and max
        want = {"nans of both signs": [_POS_NAN, _NEG_NAN]}.get(case, nans[:1] * 2)
        assert _bits(tv.numpy()[1, :2]).tolist() == _bits(np.asarray(want, np.float32)).tolist()


@pytest.mark.parametrize("agg", ["min", "max"])
def test_nans_of_one_sign_fold_to_one_pick_in_any_order(agg):
    """Two NaNs of one sign but different bits: XLA picks by the order it
    meets them in; the port picks the same one in every order (the NaN whose
    ``order_image`` is least for min, greatest for max), in ``combine_window``,
    ``merge_accumulators`` and ``extreme``."""
    spec = torch_combine.CombineSpec(num_groups=2, aggs=(agg,), dtype=np.float32)
    for pair, want in (((np.nan, _POS_NAN), {"min": np.nan, "max": _POS_NAN}),
                       ((_NEG_NAN, _NEG_NAN_1), {"min": _NEG_NAN_1, "max": _NEG_NAN})):
        got = set()
        for order in (pair, pair[::-1]):
            win = _signed_window(spec, [order[0], 1.0, order[1]])
            acc = torch_combine.combine_window(spec, torch.from_numpy(win), *torch_combine.acc_init(spec))
            got.add(int(_bits(acc[0].numpy())[1, 0]))
            a, b = (torch.tensor([[v]], dtype=torch.float32) for v in order)
            got.add(int(_bits(torch_combine.extreme(agg, a, b).numpy())[0, 0]))
            merged = torch_combine.merge_accumulators(spec, (a, torch.ones((1, 1), dtype=torch.int32)),
                                                      (b, torch.ones((1, 1), dtype=torch.int32)))
            got.add(int(_bits(merged[0].numpy())[0, 0]))
        assert got == {int(_bits(np.float32(want[agg])))}


def test_order_image_orders_as_the_floats_do():
    x = np.array([-np.inf, -3.5, -1e-38, -0.0, 0.0, 1e-45, 2.0, np.inf], np.float32)
    image = torch_combine.order_image(torch.from_numpy(x)).numpy()
    assert (np.diff(image.astype(np.int64)) > 0).all()
    back = torch_combine.order_image(torch.from_numpy(image).view(torch.float32)).numpy()
    assert np.array_equal(back, x.view(np.int32))


@pytest.mark.parametrize("agg", ["min", "max"])
def test_fold_key_puts_every_nan_past_the_numbers(agg):
    """``fold_key`` orders the numbers as ``order_image`` does, puts every NaN
    below -inf (min) or above +inf (max), positive NaNs below negative ones,
    and maps one key to one bit pattern."""
    numbers = np.array([-np.inf, -3.5, -0.0, 0.0, 1e-45, np.inf], np.float32)
    nans = np.array([0x7F800001, 0x7FC00000, 0x7FFFFFFF, 0xFFFFFFFF, 0xFFC00000, 0xFF800001], np.uint32)
    x = np.concatenate([numbers, nans.view(np.float32)])
    key = torch_combine.fold_key(agg, torch.from_numpy(x)).numpy().astype(np.int64)
    num, nan = key[: numbers.size], key[numbers.size :]
    assert (np.diff(num) > 0).all()
    assert (nan < num.min()).all() if agg == "min" else (nan > num.max()).all()
    assert (nan[:3] < nan[3:, None]).all()  # positive NaNs below negative ones
    assert np.unique(key).size == key.size
    back = torch_combine._from_key(agg, torch.from_numpy(key.astype(np.int32)))
    assert np.array_equal(_bits(back.numpy()), _bits(x))
