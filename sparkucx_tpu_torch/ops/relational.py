"""Device-resident grouped aggregation (GROUP BY) with compute-in-exchange.

Port of the aggregation half of ``sparkucx_tpu/ops/relational.py``.  Spark
SQL's HashAggregateExec around a ShuffleExchange runs on the device:

    hash(key) -> owner  ->  exchange  ->  local segment reduce

For executors that share one device.  Keys cross the port as int64 tensors
holding uint32 values (as in ops/sort.py) and travel inside a row as their
32-bit pattern, bitcast into the value dtype; rows past ``num_valid`` are
padding.  Every function works on all executors at once: executor i's rows
are ``[i * capacity, (i + 1) * capacity)`` of one stacked tensor.

Two routes, same outputs:

* **unfused** (``combine='off'``): the columnar shuffle (ops/columnar.py,
  K1) moves the raw or partial rows, a segment reduce merges them;
* **compute-in-exchange** (``combine`` 'dense' | 'sorted' | 'auto', with
  ``partial=True``): each executor reduces its rows to partial rows, places
  them in per-destination slots, and the scheduled ring
  (ops/ici_exchange.py) folds every landed window into a dense O(groups)
  accumulator — K4 on the card — instead of staging O(rows) received rows.
  'sorted' is the high-cardinality fallback: a bounded sorted accumulator
  merged window by window.

Segment reductions are deterministic on the card and use no atomics for
sums: float sums go through ``torch.segment_reduce`` over the sorted segments
(a float ``index_add_``'s atomics change the order from run to run), integer
sums and counts are differences of one running sum at the segment ends (an
``index_add_`` into a few groups piles its atomics onto a few addresses);
min/max use ``scatter_reduce_``, exact in any order.  Integer results equal the JAX package's bit for bit; float32 sums
differ from it by the order of additions only.

Hash joins, ``expand_matches``, the plan-driven aggregate and the transitive
closure are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from sparkucx_tpu_torch.ops.columnar import (
    _CROSS_DEVICE,
    ColumnarSpec,
    build_columnar_shuffle,
    shard_rows_host,
    unpack_shard_prefixes,
)
from sparkucx_tpu_torch.ops.combine import CombineSpec, agg_identity, torch_dtype
from sparkucx_tpu_torch.ops.compress import QuantizeSpec, dequantize_rows, quantize_rows
from sparkucx_tpu_torch.ops.exchange import same_device
from sparkucx_tpu_torch.ops.ici_exchange import (
    DEFAULT_CHUNKS_PER_DEST,
    combine_axis_grid,
    resolve_ici_lowering,
    ring_schedule,
    schedule_chunks,
)
from sparkucx_tpu_torch.ops.ring_kernels import ring_windows
from sparkucx_tpu_torch.ops.sort import KEY_MAX, key_bits, key_values
from sparkucx_tpu_torch.utils.devices import resolve_devices

_KEY_MAX = int(KEY_MAX)
#: Multiplicative hash constant (Knuth); uint32 wraparound is the mixing step.
_HASH_MULT = 2654435761

#: 'avg' is a sum on device divided by the count on the host; 'count_distinct'
#: counts distinct values of its column per group, on device.
VALID_AGGS = ("sum", "min", "max", "avg", "count_distinct")

def _hash_low32(keys: torch.Tensor) -> torch.Tensor:
    """``(keys * _HASH_MULT) mod 2**32`` for int64 keys in [0, 2**32), in
    int64 without overflow: the multiplier is split into 16-bit halves."""
    lo, hi = _HASH_MULT & 0xFFFF, _HASH_MULT >> 16
    return (keys * lo + (((keys * hi) & 0xFFFF) << 16)) & 0xFFFFFFFF


def hash_owners(keys: torch.Tensor, num_executors: int, valid: torch.Tensor) -> torch.Tensor:
    """Destination executor per row: the multiplicative hash of the uint32
    key, mod n (Spark SQL's HashPartitioning).  Padding rows map to
    ``num_executors``, the columnar shuffle's never-sent owner.  int32."""
    owner = (_hash_low32(keys.to(torch.int64)) >> 16) % num_executors
    return torch.where(valid, owner, num_executors).to(torch.int32)


def hash_owners_host(keys: np.ndarray, num_executors: int) -> np.ndarray:
    """Host twin of :func:`hash_owners` (numpy uint32 wraparound)."""
    mixed = (keys.astype(np.uint32) * np.uint32(_HASH_MULT)) >> np.uint32(16)
    return (mixed % np.uint32(num_executors)).astype(np.int32)


def padded_keys(keys: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Padding rows get the KEY_MAX sentinel, so they sort last."""
    return torch.where(valid, keys.to(torch.int64), _KEY_MAX)


def _key_lane(keys: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(R,) int64 uint32 keys -> (R, 1) lane of their bits in ``dtype``."""
    return key_bits(keys.to(torch.int64).contiguous()).view(dtype)[:, None]


def exchange_keyed_rows(devices: Sequence, spec: ColumnarSpec, keys, values, valid):
    """Hash-partition (key | values) rows through one columnar exchange.

    Returns ``(recv_keys int64, recv_values, recv_valid, recv_total)`` —
    every executor's received rows tight at the front of its
    ``recv_capacity`` rows; ``recv_total`` (numpy (n,)) is the TRUE row count
    routed to each executor, above ``recv_capacity`` when it truncated."""
    dtype = torch_dtype(spec.dtype)
    rows = torch.cat([_key_lane(keys, dtype), values.to(dtype)], dim=1)
    owners = hash_owners(keys, spec.num_executors, valid)
    recv, counts = build_columnar_shuffle(devices, spec)(rows, owners)
    total = counts.numpy().sum(axis=1)
    rc = spec.recv_capacity
    fill = torch.from_numpy(np.minimum(total, rc)).to(recv.device)
    recv_valid = (torch.arange(rc, device=recv.device)[None, :] < fill[:, None]).reshape(-1)
    return key_values(recv[:, 0]), recv[:, 1:], recv_valid, total


# ----------------------------------------------------------------------------
# Grouped aggregation (GROUP BY)
# ----------------------------------------------------------------------------


@dataclass(frozen=True)
class AggregateSpec:
    """Static description of one grouped aggregation (the JAX package's
    fields without ``axis_name``).

    ``capacity``: per-executor input rows; ``recv_capacity``: per-executor
    rows after the hash exchange (and groups in the output); ``aggs``: one of
    ``VALID_AGGS`` per value column.  A per-group COUNT is always produced.
    ``impl``: 'auto' or 'shared' (every executor on one device); 'ragged'
    (NCCL across devices) is not ported yet.  ``with_filter`` takes a per-row
    mask (WHERE pushdown); ``partial`` reduces each executor's rows before the
    exchange; ``quantize_mode`` block-quantizes the partial float columns
    across the exchange (ops/compress.py); ``combine`` picks the
    compute-in-exchange tier ('off' | 'auto' | 'dense' | 'sorted'),
    ``combine_groups`` the dense key domain, ``combine_lowering`` the JAX
    package's lowering name, which ops/ici_exchange.resolve_ici_lowering
    checks (the ring has one route: its kernels)."""

    num_executors: int
    capacity: int
    recv_capacity: int
    aggs: Tuple[str, ...]
    dtype: np.dtype = np.dtype(np.int32)
    impl: str = "auto"
    with_filter: bool = False
    partial: bool = False
    quantize_mode: str = "off"
    quantize_block_size: int = 128
    combine: str = "off"
    combine_groups: int = 0
    combine_lowering: str = "auto"

    @property
    def width(self) -> int:
        return len(self.aggs)

    @property
    def qspec(self) -> QuantizeSpec:
        return QuantizeSpec(mode=self.quantize_mode, block_size=self.quantize_block_size)

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @classmethod
    def from_conf(cls, conf, **kwargs) -> "AggregateSpec":
        """A spec with the cluster defaults of a ``TpuShuffleConf``:
        ``partial`` from ``partialAggregation``, ``num_executors``, the
        quantize mode and block, and ``combine='auto'`` under
        ``exchange.fusedCombine``.  Explicit kwargs win; plans the conf knobs
        cannot apply to keep the stock path silently (count_distinct,
        non-partial plans, integer dtypes for quantize, one executor)."""
        if "count_distinct" in kwargs.get("aggs", ()):
            kwargs.setdefault("partial", False)
        kwargs.setdefault("partial", bool(conf.partial_aggregation))
        kwargs.setdefault("num_executors", conf.num_executors)
        explicit_quantize = "quantize_mode" in kwargs
        kwargs.setdefault("quantize_mode", conf.quantize_mode)
        kwargs.setdefault("quantize_block_size", conf.quantize_block_size)
        explicit_combine = "combine" in kwargs
        kwargs.setdefault("combine", "auto" if getattr(conf, "exchange_fused_combine", False) else "off")
        spec = cls(**kwargs)
        if (
            not explicit_quantize
            and spec.quantize_mode != "off"
            and not (spec.partial and np.issubdtype(np.dtype(spec.dtype), np.floating))
        ):
            spec = replace(spec, quantize_mode="off")
        if (
            not explicit_combine
            and spec.combine != "off"
            and (not spec.partial or spec.num_executors < 2)
        ):
            spec = replace(spec, combine="off")
        return spec

    def resolve_combine(self) -> "AggregateSpec":
        """``combine='auto'`` -> 'dense' when the per-group accumulator
        undercuts the slot grid the exchange would otherwise drain, else
        'sorted'.  ``combine_groups`` must hold the pow2-bucketed key domain."""
        if self.combine != "auto":
            return self
        acc_bytes = self.combine_groups * (self.width * 4 + 4)
        staging_bytes = self.num_executors * self.capacity * (self.width + 2) * 4
        dense = self.combine_groups > 0 and acc_bytes < staging_bytes
        return replace(self, combine="dense" if dense else "sorted")

    @property
    def combine_cspec(self) -> CombineSpec:
        """The ``ops/combine.CombineSpec`` of the dense tier."""
        return CombineSpec(
            num_groups=max(1, self.combine_groups),
            aggs=self.aggs,
            dtype=self.dtype,
            quantize_mode=self.quantize_mode,
            quantize_block=self.quantize_block_size,
        )

    def resolve_impl(self) -> "AggregateSpec":
        return replace(self, impl="shared") if self.impl == "auto" else self

    def validate(self) -> None:
        if self.impl == "ragged":
            raise NotImplementedError(f"impl='ragged': {_CROSS_DEVICE}")
        if self.impl != "shared":
            raise ValueError(f"unknown impl {self.impl!r}")
        if np.dtype(self.dtype).itemsize != 4:
            raise ValueError("value dtype must be 32-bit (keys bitcast through it)")
        for a in self.aggs:
            if a not in VALID_AGGS:
                raise ValueError(f"unknown aggregation {a!r} (valid: {VALID_AGGS})")
        if self.partial and "count_distinct" in self.aggs:
            raise ValueError(
                "count_distinct cannot use partial aggregation (per-shard "
                "distinct counts do not compose by sum); use partial=False"
            )
        if self.quantize_mode != "off":
            self.qspec.validate()
            if not self.partial:
                raise ValueError(
                    "quantization rides the partial-aggregate exchange; set partial=True"
                )
            if not np.issubdtype(np.dtype(self.dtype), np.floating):
                raise ValueError("quantization needs a floating value dtype")
        if self.combine not in ("off", "auto", "dense", "sorted"):
            raise ValueError(f"unknown combine tier {self.combine!r} (off|auto|dense|sorted)")
        if self.combine != "off":
            if not self.partial:
                raise ValueError(
                    "the fused combine folds PARTIAL aggregate rows across the "
                    "exchange; set partial=True"
                )
            if self.combine == "dense" and self.combine_groups <= 0:
                raise ValueError("combine='dense' needs combine_groups > 0")


def _agg_identity(agg: str, dtype):
    """Fold identity of a column (numpy scalar); count_distinct counts from 0."""
    return agg_identity("sum" if agg == "count_distinct" else agg, dtype)


class _Segments:
    """Every executor's valid rows sorted by (executor, key), stably, and
    numbered into groups: the numbering ``_segment_reduce`` and
    ``_distinct_count_col`` share.  ``out_cap`` groups per executor are kept;
    later groups are dropped (their count still shows in ``num_groups``)."""

    def __init__(self, n: int, out_cap: int, keys: torch.Tensor, valid: torch.Tensor):
        rows = keys.shape[0]
        cap = rows // n
        device = keys.device
        self.shard = torch.arange(rows, device=device) // cap
        self.pk = padded_keys(keys, valid)
        # executor, then validity (valid rows first), then key
        self.composite = (self.shard << 33) | ((~valid).to(torch.int64) << 32) | self.pk
        order = torch.sort(self.composite, stable=True).indices
        svalid = valid[order]
        self.rows = order[svalid]  # input index of each valid row, in sorted order
        sc = self.composite[self.rows]
        self.starts = torch.ones_like(sc, dtype=torch.bool)
        if sc.numel() > 1:
            self.starts[1:] = sc[1:] != sc[:-1]
        self.seg = torch.cumsum(self.starts.to(torch.int64), 0) - 1
        start_shard = self.shard[self.rows[self.starts]]
        groups = torch.bincount(start_shard, minlength=n)
        self.num_groups = groups.cpu().numpy().astype(np.int32)
        first = torch.cumsum(groups, 0) - groups
        local = torch.arange(start_shard.numel(), device=device) - first[start_shard]
        self.seg_out = start_shard * out_cap + local  # output row of each group
        self.seg_keep = local < out_cap
        self.lengths = torch.diff(
            torch.nonzero(self.starts).reshape(-1),
            append=torch.tensor([self.rows.numel()], device=device),
        )


def _segment_sum_int(segs: _Segments, col: torch.Tensor) -> torch.Tensor:
    """Integer sums of ``col`` (in ``segs.rows`` order) per segment: the
    differences of one int64 running sum at the segment ends, cast back to
    ``col``'s dtype, so int32 wraps as a sum in int32 does."""
    run = torch.cumsum(col.to(torch.int64), 0)[torch.cumsum(segs.lengths, 0) - 1]
    return torch.diff(run, prepend=run.new_zeros(1)).to(col.dtype)


def _reduce_col(segs: _Segments, agg: str, col: torch.Tensor, ident) -> torch.Tensor:
    """One column reduced per segment, deterministic on any device."""
    num_seg = segs.lengths.numel()
    if not num_seg:
        return col.new_empty((0,))
    if agg in ("sum", "avg"):
        if col.is_floating_point():
            return torch.segment_reduce(col, "sum", lengths=segs.lengths)
        return _segment_sum_int(segs, col)
    reduce = "amin" if agg == "min" else "amax"
    return col.new_full((num_seg,), ident.item()).scatter_reduce_(0, segs.seg, col, reduce, include_self=True)


def _segment_reduce(aggs: Tuple[str, ...], n: int, out_cap: int, keys, vals, valid, counts=None):
    """Stable (executor, key) sort + segment reduce — the GROUP BY shared by
    the map-side partial phase, the final phase and the fused compaction.

    ``keys`` (n * cap,) int64, ``vals`` (n * cap, width), ``valid`` bool;
    ``counts`` pre-aggregated row counts of partial rows (None counts rows).
    Returns ``(group_keys (n * out_cap,) int64, group_vals (n * out_cap,
    width), group_count (n * out_cap,) int32, num_groups (n,) numpy int32)``:
    executor j's groups in ascending key order at the front of its
    ``out_cap`` rows, fold identities after them."""
    segs = _Segments(n, out_cap, keys, valid)
    device = keys.device
    dtype = vals.dtype
    out = segs.seg_out[segs.seg_keep]
    group_keys = torch.zeros(n * out_cap, dtype=torch.int64, device=device)
    group_keys[out] = keys.to(torch.int64)[segs.rows[segs.starts]][segs.seg_keep]
    if counts is None:
        per_seg = segs.lengths.to(torch.int32)
    else:
        per_seg = _segment_sum_int(segs, counts[segs.rows].to(torch.int32))
    group_count = torch.zeros(n * out_cap, dtype=torch.int32, device=device)
    group_count[out] = per_seg[segs.seg_keep]
    np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
    cols = []
    for c, agg in enumerate(aggs):
        ident = torch.tensor(_agg_identity(agg, np_dtype), dtype=dtype)
        col_out = torch.full((n * out_cap,), ident.item(), dtype=dtype, device=device)
        if agg == "count_distinct":
            red = _distinct_count_col(segs, vals[:, c], valid).to(dtype)
        else:
            red = _reduce_col(segs, agg, vals[segs.rows, c], ident)
        col_out[out] = red[segs.seg_keep]
        cols.append(col_out)
    group_vals = torch.stack(cols, dim=1) if cols else torch.zeros((n * out_cap, 0), dtype=dtype, device=device)
    return group_keys, group_vals, group_count, segs.num_groups


def _distinct_count_col(segs: _Segments, col: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """COUNT(DISTINCT col) per segment of ``segs``: rows sorted by (executor,
    validity, key) and, inside a key, by value, then (key, value) pair
    starts counted per group."""
    by_value = torch.sort(col, stable=True).indices
    order = by_value[torch.sort(segs.composite[by_value], stable=True).indices]
    rows = order[valid[order]]
    sk, sv = segs.composite[rows], col[rows]
    pair_start = torch.ones_like(sk, dtype=torch.bool)
    if sk.numel() > 1:
        pair_start[1:] = (sk[1:] != sk[:-1]) | (sv[1:] != sv[:-1])
    # the same (executor, key) order as segs.rows, so the segments line up
    return _segment_sum_int(segs, pair_start.to(torch.int32))


def _partial_rows(spec: AggregateSpec, qspec, keys, values, valid):
    """Map-side partial aggregation (HashAggregateExec(partial) below the
    Exchange): one row per executor and local distinct key, carrying (key |
    agg columns | count).  The count lane travels as int32 BITS through the
    value dtype (a float32 cast would round counts above 2**24).  Shared by
    the unfused and the fused route, so their wire formats cannot drift."""
    n, cap = spec.num_executors, spec.capacity
    lk, lv, lc, lng = _segment_reduce(spec.aggs, n, cap, keys, values, valid)
    if qspec is not None:
        lv = quantize_rows(qspec, lv).view(spec.torch_dtype)
    packed = torch.cat([lv, lc.view(spec.torch_dtype)[:, None]], dim=1)
    fill = torch.from_numpy(lng.astype(np.int64)).to(keys.device)
    pvalid = (torch.arange(cap, device=keys.device)[None, :] < fill[:, None]).reshape(-1)
    return lk, packed, pvalid


def _input_valid(spec: AggregateSpec, num_valid: np.ndarray, device, mask) -> torch.Tensor:
    nv = torch.from_numpy(num_valid.astype(np.int64)).to(device)
    valid = (torch.arange(spec.capacity, device=device)[None, :] < nv[:, None]).reshape(-1)
    return valid if mask is None else valid & mask.to(device=device, dtype=torch.bool)


def _aggregate_body(spec: AggregateSpec, devices, keys, values, num_valid, mask=None):
    """The unfused route: (partial reduce,) columnar exchange, final reduce."""
    valid = _input_valid(spec, num_valid, keys.device, mask)
    counts = None
    qspec = spec.qspec if (spec.partial and spec.quantize_mode != "off") else None
    if spec.partial:
        keys, values, valid = _partial_rows(spec, qspec, keys, values, valid)
    payload_width = qspec.quantized_width(spec.width) if qspec is not None else spec.width
    cspec = ColumnarSpec(
        spec.num_executors, spec.capacity, spec.recv_capacity,
        payload_width + (2 if spec.partial else 1), np.dtype(spec.dtype),
    )
    rkeys, rvals, rvalid, rtotal = exchange_keyed_rows(devices, cspec, keys, values, valid)
    if spec.partial:
        counts = rvals[:, -1].view(torch.int32)
        rvals = rvals[:, :-1]
        if qspec is not None:
            rvals = dequantize_rows(qspec, rvals.view(torch.int32), spec.width).to(spec.torch_dtype)
    # sum/min/max/avg compose with themselves, counts compose by sum
    gk, gv, gc, ng = _segment_reduce(spec.aggs, spec.num_executors, spec.recv_capacity, rkeys, rvals, rvalid, counts)
    return gk, gv, gc, ng, rtotal.astype(np.int32)


def _sorted_combine_walk(spec: AggregateSpec, sched, slot_rows: int, flat: torch.Tensor):
    """High-cardinality tier (``combine='sorted'``): walk the ring schedule and
    merge each receiver's landed window into a BOUNDED sorted accumulator of
    ``recv_capacity`` groups with :func:`_segment_reduce` — the accumulator
    rows are partial rows themselves, so one segment reduce over
    [accumulator | window] is the merge.  Canonical window order; every
    receiver's window of one index merges in one call."""
    n, oc = spec.num_executors, spec.recv_capacity
    qspec = spec.qspec if spec.quantize_mode != "off" else None
    device = flat.device
    table = ring_windows(n, slot_rows, slot_rows // sched.chunks, sched.raw_steps())
    per = table.shape[0] // n
    ns = n * slot_rows
    ak = torch.zeros(n * oc, dtype=torch.int64, device=device)
    av = torch.zeros((n * oc, spec.width), dtype=spec.torch_dtype, device=device)
    ac = torch.zeros(n * oc, dtype=torch.int32, device=device)
    ang = np.zeros(n, np.int32)
    for index in range(per):
        wins = table[index::per]  # window `index` of every receiver
        r = int(wins[0, 4])
        window = torch.cat([flat[i * ns + s : i * ns + s + r] for _, i, s, _, _ in wins.tolist()])
        wkeys = key_values(window[:, 0])
        wc = window[:, -1].view(torch.int32)
        wp = window[:, 1:-1]
        if qspec is not None:
            wp = dequantize_rows(qspec, wp.view(torch.int32), spec.width).to(spec.torch_dtype)
        fill = torch.from_numpy(ang.astype(np.int64)).to(device)
        acc_valid = torch.arange(oc, device=device)[None, :] < fill[:, None]
        mk = torch.cat([ak.view(n, oc), wkeys.view(n, r)], dim=1).reshape(-1)
        w = spec.width
        mv = torch.cat([av.view(n, oc, w), wp.reshape(n, r, w)], dim=1).reshape(n * (oc + r), w)
        mc = torch.cat([ac.view(n, oc), wc.reshape(n, r)], dim=1).reshape(-1)
        mvalid = torch.cat([acc_valid, (wc > 0).reshape(n, r)], dim=1).reshape(-1)
        ak, av, ac, ang = _segment_reduce(spec.aggs, n, oc, mk, mv, mvalid, counts=mc)
    return ak, av, ac, ang


def _fused_aggregate_body(spec: AggregateSpec, sched, keys, values, num_valid, mask=None):
    """The COMPUTE-IN-EXCHANGE route (``spec.combine != 'off'``): local
    partial reduce, partial rows placed into per-destination slots of every
    executor's staging, then every window folded into the accumulator as it
    lands (K4 on the card) instead of staging O(rows) received
    rows.  The dense tier compacts the ``(combine_groups,)`` accumulator with
    the same :func:`_segment_reduce` the unfused final phase uses — single-row
    segments are identity folds — so the output contract is the unfused
    route's."""
    n, cap = spec.num_executors, spec.capacity
    device = keys.device
    valid = _input_valid(spec, num_valid, device, mask)
    qspec = spec.qspec if spec.quantize_mode != "off" else None
    keys, values, valid = _partial_rows(spec, qspec, keys, values, valid)

    # slot placement: executor s's partial rows for owner o land at rows
    # s * n * cap + o * cap + (rank among s's rows for o); count == 0 rows
    # (the zero fill) are the padding the fold skips
    rows = torch.cat([_key_lane(keys, spec.torch_dtype), values], dim=1)
    owners = hash_owners(keys, n, valid).to(torch.int64)
    shard = torch.arange(n * cap, device=device) // cap
    bucket = shard * (n + 1) + owners
    sizes = torch.bincount(bucket, minlength=n * (n + 1)).view(n, n + 1)[:, :n]
    order = torch.sort(bucket, stable=True).indices
    sowner, sshard = owners[order], shard[order]
    start = torch.cumsum(sizes, dim=1) - sizes
    keep = sowner < n
    pos = torch.arange(n * cap, device=device) - sshard * cap - start[sshard, sowner.clamp(max=n - 1)]
    dest = (sshard * (n * cap) + sowner * cap + pos)[keep]
    staging = torch.zeros((n * n * cap, rows.shape[1]), dtype=rows.dtype, device=device)
    staging.index_copy_(0, dest, rows[order[keep]])
    del rows, order, keep, dest

    # recv_totals keeps the unfused contract: TRUE partial rows per receiver
    rtotal = sizes.sum(dim=0).cpu().numpy().astype(np.int32)
    if spec.combine == "dense":
        accv, accc = combine_axis_grid(n, cap, sched, staging, spec.combine_cspec)
        del staging
        g = spec.combine_groups
        gkeys = torch.arange(g, device=device).repeat(n)
        count = accc[:, 0]
        gk, gv, gc, ng = _segment_reduce(spec.aggs, n, spec.recv_capacity, gkeys, accv, count > 0, counts=count)
    else:
        gk, gv, gc, ng = _sorted_combine_walk(spec, sched, cap, staging)
    return gk, gv, gc, ng, rtotal


def build_grouped_aggregate(devices: Optional[Sequence], spec: AggregateSpec):
    """The distributed GROUP BY for executors on ``devices`` (one entry per
    executor; ``None`` puts every executor on ``cuda``).

    Returns ``fn(keys, values, num_valid, mask=None) -> (group_keys,
    group_values, group_counts, num_groups, recv_totals)``:

    * ``keys``: (n * capacity,) int64 (or uint32) tensor of uint32 values;
    * ``values``: (n * capacity, len(aggs)) tensor of ``dtype``;
    * ``num_valid``: (n,) valid rows per executor;
    * ``mask``: (n * capacity,) bool, required with ``spec.with_filter``
      (False rows are dropped before the exchange), else not allowed;
    * ``group_keys``: (n * recv_capacity,) int64 — executor j's first
      ``num_groups[j]`` entries are its distinct keys, ascending; every key
      lives on one executor;
    * ``group_values``: per group and column; 'avg' columns carry the SUM
      (the host driver divides), 'count_distinct' the distinct count;
    * ``group_counts``: (n * recv_capacity,) int32 rows per group;
    * ``num_groups``, ``recv_totals``: (n,) numpy int32 — the TRUE rows
      (partial rows with ``spec.partial``) hashed to each executor; above
      ``recv_capacity`` the exchange truncated and the caller must retry.

    With ``spec.combine != 'off'`` and more than one executor the exchange is
    the compute-in-exchange route; the outputs are the same, bit for bit for
    integer dtypes."""
    devices = resolve_devices(devices, spec.num_executors)
    spec = spec.resolve_impl()
    if spec.combine == "auto":
        spec = spec.resolve_combine()
    spec.validate()
    if not same_device(devices):
        raise NotImplementedError(_CROSS_DEVICE)
    n, cap, device = spec.num_executors, spec.capacity, devices[0]

    if spec.combine != "off" and n > 1:
        # the ring of every executor sharing one device never leaves it
        resolve_ici_lowering(spec.combine_lowering, device.type)
        sched = ring_schedule(n, schedule_chunks(cap, DEFAULT_CHUNKS_PER_DEST), kind="ici")

        def body(keys, values, nv, mask):
            return _fused_aggregate_body(spec, sched, keys, values, nv, mask)
    else:

        def body(keys, values, nv, mask):
            return _aggregate_body(spec, devices, keys, values, nv, mask)

    def aggregate(keys: torch.Tensor, values: torch.Tensor, num_valid, mask: Optional[torch.Tensor] = None):
        if spec.with_filter != (mask is not None):
            raise ValueError("spec.with_filter=True needs a mask (and a mask needs with_filter=True)")
        if tuple(keys.shape) != (n * cap,) or tuple(values.shape) != (n * cap, spec.width):
            raise ValueError(
                f"keys {tuple(keys.shape)} / values {tuple(values.shape)} != "
                f"({n * cap},) / ({n * cap}, {spec.width})"
            )
        if values.dtype != spec.torch_dtype:
            raise ValueError(f"values dtype {values.dtype} != spec dtype {spec.torch_dtype}")
        if keys.device != device or values.device != device:
            raise ValueError(f"keys and values must be on {device}")
        nv = torch.as_tensor(num_valid).cpu().numpy().astype(np.int64).reshape(n)
        if (nv < 0).any() or (nv > cap).any():
            raise ValueError(f"num_valid must lie in [0, {cap}]")
        return body(keys.to(torch.int64), values.contiguous(), nv, mask)

    aggregate.spec = spec
    return aggregate


def run_grouped_aggregate(
    devices: Optional[Sequence],
    spec: AggregateSpec,
    keys: np.ndarray,
    values: np.ndarray,
    max_attempts: int = 3,
    mask: Optional[np.ndarray] = None,
):
    """Host driver: shard, run the GROUP BY, retry with doubled
    ``recv_capacity`` when hash skew overflows an executor.

    ``keys``: (T,) uint32; ``values``: (T, len(aggs)); ``mask`` (T,) bool
    with a ``with_filter`` spec.  With ``combine='auto'`` the dense key
    domain is measured from the keys (pow2 of max + 1) and the tier resolved.
    Returns (group keys ascending uint32, aggregated columns, counts) as
    numpy arrays; 'avg' columns make the value array float64, divided exactly
    by the counts."""
    n = spec.num_executors
    devices = resolve_devices(devices, n)
    total = keys.shape[0]
    cap = spec.capacity
    if total > n * cap:
        raise ValueError(f"{total} rows exceed {n} x {cap} capacity")
    if spec.with_filter != (mask is not None):
        raise ValueError(
            "spec.with_filter=True needs a mask argument (and a mask needs "
            "with_filter=True): the signatures differ"
        )
    if spec.combine == "auto":
        if keys.size:
            g = 1 << int(np.max(keys)).bit_length()  # pow2 ceil of max + 1
            spec = replace(spec, combine_groups=int(g)).resolve_combine()
        else:
            spec = replace(spec, combine="sorted")

    pk, pv, nv = shard_rows_host(keys, values, n, cap, value_dtype=spec.dtype)
    device = devices[0]
    gk = torch.from_numpy(pk.astype(np.int64)).to(device)
    gv = torch.from_numpy(pv).to(device)
    del pk, pv
    gm = None
    if mask is not None:
        pm, _, _ = shard_rows_host(mask.astype(np.uint32), np.zeros((total, 0), np.int32), n, cap)
        gm = torch.from_numpy(pm.astype(bool)).to(device)

    attempt_spec = spec
    for _ in range(max_attempts):
        fn = build_grouped_aggregate(devices, attempt_spec)
        out_k, out_v, out_c, num_groups, recv_totals = fn(gk, gv, nv, gm)
        rc = attempt_spec.recv_capacity
        if (recv_totals <= rc).all():
            keys_h, vals_h, cnts_h = unpack_shard_prefixes(
                (out_k.cpu().numpy(), out_v.cpu().numpy(), out_c.cpu().numpy()), num_groups, rc
            )
            order = np.argsort(keys_h, kind="stable")
            keys_h, vals_h, cnts_h = keys_h[order].astype(np.uint32), vals_h[order], cnts_h[order]
            if "avg" in spec.aggs:
                vals_h = vals_h.astype(np.float64)
                for c, agg in enumerate(spec.aggs):
                    if agg == "avg":
                        vals_h[:, c] /= np.maximum(cnts_h, 1)
            return keys_h, vals_h, cnts_h
        attempt_spec = replace(attempt_spec, recv_capacity=2 * rc)
    raise RuntimeError(
        f"aggregation overflowed recv_capacity {attempt_spec.recv_capacity // 2} "
        f"after {max_attempts} doublings — hash(key) distribution too skewed"
    )


# ----------------------------------------------------------------------------
# CPU oracle
# ----------------------------------------------------------------------------


def oracle_aggregate(keys: np.ndarray, values: np.ndarray, aggs: Sequence[str]):
    """numpy reference: (distinct keys ascending, aggregated columns, counts),
    the JAX package's oracle unchanged.  'avg' columns are exact float64
    sum/count (and flip the value array to float64)."""
    uniq, inv, counts = np.unique(keys, return_inverse=True, return_counts=True)
    cols = []
    for c, agg in enumerate(aggs):
        if agg in ("sum", "avg"):
            s = np.bincount(inv, weights=values[:, c].astype(np.float64), minlength=len(uniq))
            cols.append((s / counts) if agg == "avg" else s.astype(values.dtype))
        elif agg == "count_distinct":
            nd = np.zeros(len(uniq), np.int64)
            for g in range(len(uniq)):
                nd[g] = len(np.unique(values[inv == g, c]))
            cols.append(nd.astype(values.dtype))
        else:
            red = np.minimum if agg == "min" else np.maximum
            ident = (
                np.finfo(values.dtype).max
                if np.issubdtype(values.dtype, np.floating)
                else np.iinfo(values.dtype).max
            )
            if agg == "max":
                ident = -ident if np.issubdtype(values.dtype, np.floating) else np.iinfo(values.dtype).min
            acc = np.full(len(uniq), ident, values.dtype)
            red.at(acc, inv, values[:, c])
            cols.append(acc)
    out = np.stack(cols, axis=1) if cols else np.zeros((len(uniq), 0), values.dtype)
    return uniq, out, counts.astype(np.int32)
