"""Device-resident relational operators: GROUP BY with compute-in-exchange,
and the hash join.

Port of ``sparkucx_tpu/ops/relational.py``.  Spark SQL's HashAggregateExec
around a ShuffleExchange and its ShuffledHashJoinExec run on the device:

    hash(key) -> owner  ->  exchange  ->  local segment reduce (GROUP BY)
                                          or sort-merge expansion (JOIN)

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

The hash join (all six join types of ``JOIN_TYPES``) hash-partitions both
sides through the columnar shuffle (K1, one launch a receiver and side),
sorts each executor's build rows and expands the matches of its probe rows
with batched ``searchsorted`` / ``cumsum`` over all executors at once
(:func:`expand_matches`, shared with ops/tc.py).  The plan-driven aggregate
(:func:`run_plan_grouped_aggregate`) runs the fused route's exchange in the
quota sub-rounds of an ``ExchangePlan`` through the plan executor, K4 a
sub-round.
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
    take_rows,
    unpack_shard_prefixes,
)
from sparkucx_tpu_torch.ops.combine import CombineSpec, agg_identity, fold_extreme_, torch_dtype
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
from sparkucx_tpu_torch.utils.devices import resolve_devices, upload

_KEY_MAX = int(KEY_MAX)
#: Multiplicative hash constant (Knuth); uint32 wraparound is the mixing step.
_HASH_MULT = 2654435761

#: 'avg' is a sum on device divided by the count on the host; 'count_distinct'
#: counts distinct values of its column per group, on device.
VALID_AGGS = ("sum", "min", "max", "avg", "count_distinct")

def mul_low32(x: torch.Tensor, mult: int = _HASH_MULT) -> torch.Tensor:
    """``(x * mult) mod 2**32`` for int64 ``x`` in [0, 2**32) and a 32-bit
    ``mult``: uint32 wraparound in int64 without overflow, the multiplier
    split into 16-bit halves."""
    lo, hi = mult & 0xFFFF, mult >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & 0xFFFFFFFF


def prefix_valid(capacity: int, counts, device) -> torch.Tensor:
    """(n * capacity,) bool: the first ``counts[i]`` rows of executor i's
    ``capacity`` rows.  ``counts``: (n,) numpy array or tensor."""
    if isinstance(counts, torch.Tensor):
        fill = counts.to(device=device, dtype=torch.int64)
    else:
        fill = upload(np.asarray(counts, dtype=np.int64), device)
    return (torch.arange(capacity, device=device)[None, :] < fill[:, None]).reshape(-1)


def hash_owners(keys: torch.Tensor, num_executors: int, valid: torch.Tensor) -> torch.Tensor:
    """Destination executor per row: the multiplicative hash of the uint32
    key, mod n (Spark SQL's HashPartitioning).  Padding rows map to
    ``num_executors``, the columnar shuffle's never-sent owner.  int32."""
    owner = (mul_low32(keys.to(torch.int64)) >> 16) % num_executors
    return torch.where(valid, owner, num_executors).to(torch.int32)


def hash_owners_host(keys: np.ndarray, num_executors: int) -> np.ndarray:
    """Host twin of :func:`hash_owners` (numpy uint32 wraparound)."""
    mixed = (keys.astype(np.uint32) * np.uint32(_HASH_MULT)) >> np.uint32(16)
    return (mixed % np.uint32(num_executors)).astype(np.int32)


def padded_keys(keys: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Padding rows get the KEY_MAX sentinel, so they sort last."""
    return torch.where(valid, keys.to(torch.int64), _KEY_MAX)


def key_lane(keys: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(R,) int64 uint32 keys -> (R, 1) lane of their bits in ``dtype``."""
    return key_bits(keys.to(torch.int64).contiguous()).view(dtype)[:, None]


def exchange_keyed_rows(devices: Sequence, spec: ColumnarSpec, keys, values, valid):
    """Hash-partition (key | values) rows through one columnar exchange.

    Returns ``(recv_keys int64, recv_values, recv_valid, recv_total)`` —
    every executor's received rows tight at the front of its
    ``recv_capacity`` rows; ``recv_total`` (numpy (n,)) is the TRUE row count
    routed to each executor, above ``recv_capacity`` when it truncated."""
    dtype = torch_dtype(spec.dtype)
    rows = torch.cat([key_lane(keys, dtype), values.to(dtype)], dim=1)
    owners = hash_owners(keys, spec.num_executors, valid)
    recv, counts = build_columnar_shuffle(devices, spec)(rows, owners)
    total = counts.numpy().sum(axis=1)
    recv_valid = prefix_valid(spec.recv_capacity, np.minimum(total, spec.recv_capacity), recv.device)
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
    return fold_extreme_(agg, col.new_full((num_seg,), ident.item()), segs.seg, col)


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
    return lk, packed, prefix_valid(cap, lng, keys.device)


def _input_valid(capacity: int, num_valid: np.ndarray, device, mask) -> torch.Tensor:
    valid = prefix_valid(capacity, num_valid, device)
    return valid if mask is None else valid & mask.to(device=device, dtype=torch.bool)


def _aggregate_body(spec: AggregateSpec, devices, keys, values, num_valid, mask=None):
    """The unfused route: (partial reduce,) columnar exchange, final reduce."""
    valid = _input_valid(spec.capacity, num_valid, keys.device, mask)
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
        acc_valid = prefix_valid(oc, ang, device).view(n, oc)
        mk = torch.cat([ak.view(n, oc), wkeys.view(n, r)], dim=1).reshape(-1)
        w = spec.width
        mv = torch.cat([av.view(n, oc, w), wp.reshape(n, r, w)], dim=1).reshape(n * (oc + r), w)
        mc = torch.cat([ac.view(n, oc), wc.reshape(n, r)], dim=1).reshape(-1)
        mvalid = torch.cat([acc_valid, (wc > 0).reshape(n, r)], dim=1).reshape(-1)
        ak, av, ac, ang = _segment_reduce(spec.aggs, n, oc, mk, mv, mvalid, counts=mc)
    return ak, av, ac, ang


def _seal_slots(spec: AggregateSpec, keys, values, num_valid, mask=None):
    """Local partial reduce, then every executor's partial rows placed in its
    slot layout: executor s's rows for owner o land at rows ``s * n * cap +
    o * cap + (rank among s's rows for o)``; count == 0 rows (the zero fill)
    are the padding the fold skips.  Returns ``(staging (n * n * cap, lane),
    sizes (n, n) int64 tensor)``, ``sizes[s, o]`` = rows s sends o."""
    n, cap = spec.num_executors, spec.capacity
    device = keys.device
    valid = _input_valid(cap, num_valid, device, mask)
    qspec = spec.qspec if spec.quantize_mode != "off" else None
    keys, values, valid = _partial_rows(spec, qspec, keys, values, valid)
    rows = torch.cat([key_lane(keys, spec.torch_dtype), values], dim=1)
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
    return staging, sizes


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
    staging, sizes = _seal_slots(spec, keys, values, num_valid, mask)
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


def _groups_to_host(spec: AggregateSpec, out_k, out_v, out_c, num_groups, out_cap: int):
    """The host finish of a GROUP BY: every executor's groups, keys ascending
    (uint32), with 'avg' columns divided exactly by the counts (float64)."""
    keys_h, vals_h, cnts_h = unpack_shard_prefixes(
        (out_k.cpu().numpy(), out_v.cpu().numpy(), out_c.cpu().numpy()), num_groups, out_cap
    )
    order = np.argsort(keys_h, kind="stable")
    keys_h, vals_h, cnts_h = keys_h[order].astype(np.uint32), vals_h[order], cnts_h[order]
    if "avg" in spec.aggs:
        vals_h = vals_h.astype(np.float64)
        for c, agg in enumerate(spec.aggs):
            if agg == "avg":
                vals_h[:, c] /= np.maximum(cnts_h, 1)
    return keys_h, vals_h, cnts_h


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
            return _groups_to_host(spec, out_k, out_v, out_c, num_groups, rc)
        attempt_spec = replace(attempt_spec, recv_capacity=2 * rc)
    raise RuntimeError(
        f"aggregation overflowed recv_capacity {attempt_spec.recv_capacity // 2} "
        f"after {max_attempts} doublings — hash(key) distribution too skewed"
    )


def run_plan_grouped_aggregate(
    devices: Optional[Sequence],
    spec: AggregateSpec,
    plan,
    keys: np.ndarray,
    values: np.ndarray,
    mask: Optional[np.ndarray] = None,
    stats=None,
):
    """One partial grouped aggregation through an ``ExchangePlan`` and the plan
    executor: the compute-in-exchange route in quota sub-rounds
    (``plan.chunks_per_round``), the engine raw shuffles run through.

    * stage A (once): the partial reduce and the slot seal
      (:func:`_seal_slots`, ``slot = capacity`` rows a destination);
    * stage B (a sub-round each, through ``transport/executor.execute_plan``):
      the quota window sliced out of the sealed slots on the device
      (``skew.slice_subround``), the fused-combine exchange of
      ``build_plan_exchange(..., combine=cspec)`` (K4 on the card) into an
      identity accumulator, merged into the running one in ``finish_round``
      (running accumulator first, so float merges are deterministic);
    * stage C (once): the dense compaction through :func:`_segment_reduce`.

    Integer results equal :func:`run_grouped_aggregate`'s with any quota.
    Only the dense tier composes with sub-rounds; plans with ``combine !=
    'dense'`` fall back to :func:`run_grouped_aggregate`.  Returns what it
    returns."""
    from sparkucx_tpu_torch.ops.combine import acc_init, merge_accumulators
    from sparkucx_tpu_torch.ops.skew import chunk_size_rows, slice_subround
    from sparkucx_tpu_torch.transport.executor import build_plan_exchange, execute_plan

    if plan.combine != "dense":
        return run_grouped_aggregate(devices, spec, keys, values, mask=mask)
    n = spec.num_executors
    devices = resolve_devices(devices, n)
    if spec.combine == "auto":
        spec = spec.resolve_combine()
    spec = replace(spec.resolve_impl(), combine="dense")
    spec.validate()
    if not same_device(devices):
        raise NotImplementedError(_CROSS_DEVICE)
    if len(plan.chunks_per_round) != 1:
        raise ValueError(
            "one aggregation is one staging round — plan the quota as "
            f"chunks_per_round=(k,), got {plan.chunks_per_round}"
        )
    cap = spec.capacity
    cspec = spec.combine_cspec
    lane = cspec.row_width
    if spec.width + 2 != lane and spec.quantize_mode == "off":
        raise ValueError(f"row lane mismatch: {spec.width + 2} != {lane}")
    q = int(plan.slot_rows)
    g = cspec.num_groups
    total = keys.shape[0]
    if total > n * cap:
        raise ValueError(f"{total} rows exceed {n} x {cap} capacity")
    if spec.with_filter != (mask is not None):
        raise ValueError("spec.with_filter and mask must agree (see run_grouped_aggregate)")
    device = devices[0]

    # ---- stage A: partial reduce + slot sealing (once) ----
    pk, pv, nv = shard_rows_host(keys, values, n, cap, value_dtype=spec.dtype)
    gm = None
    if mask is not None:
        pm, _, _ = shard_rows_host(mask.astype(np.uint32), np.zeros((total, 0), np.int32), n, cap)
        gm = upload(pm.astype(bool), device)
    payload, sizes = _seal_slots(spec, upload(pk.astype(np.int64), device), upload(pv, device), nv, gm)
    size_rows = sizes.cpu().numpy()
    del pk, pv

    # ---- stage B: the plan's sub-rounds through the plan executor ----
    exchange = build_plan_exchange(
        devices, num_executors=n, send_rows=n * q, lane=lane, impl=plan.lowering, combine=cspec
    )
    av0, ac0 = acc_init(cspec, device)
    av0, ac0 = av0.repeat(n, 1), ac0.repeat(n, 1)  # every receiver's identity

    def submit(rnd, chunk, nchunks):
        # every executor's n slots are n * n slots of the stacked staging
        sub = slice_subround(payload, n * n, chunk, q)
        return exchange(sub, chunk_size_rows(size_rows, chunk, q), av0, ac0)

    def finish_round(rnd, nchunks, parts):
        accv, accc, recv = parts[0]
        for bv, bc, brecv in parts[1:]:
            accv, accc = merge_accumulators(cspec, (accv, accc), (bv, bc))
            recv = recv + brecv
        return accv, accc, recv

    results = execute_plan(
        plan,
        submit=submit,
        drain_chunk=lambda rnd, chunk, nchunks, ticket: ticket,
        finish_round=finish_round,
        # the drain counts the O(groups) accumulator, not O(rows) received rows
        result_bytes=lambda r: int(r[0].numel() * r[0].element_size() + r[1].numel() * 4),
        occupancy=lambda r: (int(r[2].sum()), n * cap),
        stats=stats,
        name="aggregate.fused",
    )
    accv, accc, _ = results[0]
    del payload

    # ---- stage C: compaction (once) + host finish ----
    count = accc[:, 0]
    gkeys = torch.arange(g, device=device).repeat(n)
    out_k, out_v, out_c, num_groups = _segment_reduce(
        spec.aggs, n, spec.recv_capacity, gkeys, accv, count > 0, counts=count
    )
    if (num_groups > spec.recv_capacity).any():
        raise RuntimeError(
            f"dense compaction overflowed recv_capacity {spec.recv_capacity}; re-plan with headroom"
        )
    return _groups_to_host(spec, out_k, out_v, out_c, num_groups, spec.recv_capacity)


# ----------------------------------------------------------------------------
# Hash join
# ----------------------------------------------------------------------------

#: join_type -> rows emitted per probe row with m build matches.  ONE table
#: serves the device expansion (xp=torch in expand_matches) and the host
#: capacity planner (xp=np in plan_join_capacities), so the two cannot drift.
#: ``clip`` takes the same arguments in both libraries.
_JOIN_EMIT = {
    "inner": lambda m, xp: m,
    "left_outer": lambda m, xp: xp.clip(m, 1, None),
    "left_semi": lambda m, xp: xp.clip(m, None, 1),
    "left_anti": lambda m, xp: 1 - xp.clip(m, None, 1),
}

#: right/full outer: a probe-driven base expansion plus an appended pass over
#: the unmatched BUILD rows (a build-side match-flag scan).
_OUTER_BASE = {"right_outer": "inner", "full_outer": "left_outer"}

#: join types whose output gains ``out_matched`` (False = null-extended row:
#: zeroed build lanes for an unmatched probe row, zeroed probe lanes for an
#: unmatched build row).
OUTER_JOIN_TYPES = ("left_outer", "right_outer", "full_outer")

JOIN_TYPES = tuple(_JOIN_EMIT) + tuple(_OUTER_BASE)

_INT32_MAX = int(np.iinfo(np.int32).max)


def _join_emit(join_type: str):
    fn = _JOIN_EMIT.get(join_type)
    if fn is None:
        raise ValueError(f"unknown join_type {join_type!r} (valid: {tuple(_JOIN_EMIT)})")
    return fn


def row_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Running sums along each row of an (n, k) tensor, int64, as ONE scan of
    the flattened rows minus each row's base: a scan along the last
    dimension of a few long rows runs on a few blocks of the card, more than
    ten times slower on an NVIDIA H100 80GB HBM3 at 700 W (``chip_smoke.py``
    phase 18 times both; PERF.md)."""
    if x.shape[1] == 0:
        return torch.zeros(x.shape, dtype=torch.int64, device=x.device)
    flat = torch.cumsum(x.reshape(-1), 0, dtype=torch.int64).view(x.shape)
    base = torch.zeros((x.shape[0], 1), dtype=torch.int64, device=x.device)
    base[1:, 0] = flat[:-1, -1]
    return flat - base


def gather_rows(rows: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``rows`` (n * cap, W) and executor-local row numbers ``index`` (n, k)
    -> (n * k, W): each executor's rows picked from its own ``cap`` rows."""
    n, cap = index.shape[0], rows.shape[0] // index.shape[0]
    flat = index + torch.arange(n, device=index.device)[:, None] * cap
    return take_rows(rows, flat.reshape(-1))


def expand_matches(
    out_capacity: int,
    sbk: torch.Tensor,
    btotal: torch.Tensor,
    probe_keys: torch.Tensor,
    probe_valid: torch.Tensor,
    probe_cap: int,
    build_cap: int,
    join_type: str = "inner",
):
    """Sort-merge match expansion shared by the hash join and the transitive
    closure, for all n executors at once: given each executor's sorted
    (padded) build keys ``sbk`` (n, build_cap) with ``btotal`` (n,) valid rows
    and its probe keys (n, probe_cap), emit per output row p its probe row
    ``j[p]`` and build row ``li[p]`` (executor-local row numbers).

    Returns ``(j, li, ok, unmatched, total)``, the first four (n,
    out_capacity): ``ok`` masks rows past the true emission count;
    ``unmatched`` marks null-extended rows.  ``total`` (n,) int64 is the true
    count, saturated at int32 max where a float32 shadow sum passes 2**31 - 1
    (the JAX package's guard; below it, the int32 running sum's last value)
    so a caller's ``total > out_capacity`` check cannot pass silently.

    Per probe row with m build matches, ``join_type`` emits: 'inner' m rows;
    'left_outer' max(m, 1), the extra row null-extended (``unmatched``);
    'left_semi' min(m, 1) (``li`` the first match in sorted build order);
    'left_anti' 1 if m == 0 else 0 (every emitted row ``unmatched``).  ``hi``
    is clamped at ``btotal``, so a valid 0xFFFFFFFF probe key never matches
    build padding."""
    n = sbk.shape[0]
    lo = torch.searchsorted(sbk, probe_keys)
    hi = torch.minimum(torch.searchsorted(sbk, probe_keys, right=True), btotal.to(torch.int64)[:, None])
    zero = torch.zeros((), dtype=torch.int64, device=sbk.device)
    matched = torch.where(probe_valid, (hi - lo).clamp(min=0), zero)
    cnt = torch.where(probe_valid, _join_emit(join_type)(matched, torch), zero)
    cum = row_cumsum(cnt)
    offs = cum - cnt
    wrapped = ((cum[:, -1] + 2**31) % 2**32) - 2**31  # the int32 running sum's last value
    saturated = cnt.to(torch.float32).sum(dim=1) > float(np.float32(_INT32_MAX))
    total = torch.where(saturated, _INT32_MAX, wrapped)
    pos = torch.arange(out_capacity, device=sbk.device).expand(n, out_capacity).contiguous()
    j = torch.searchsorted(cum, pos, right=True).clamp(0, probe_cap - 1)
    li = (lo.gather(1, j) + (pos - offs.gather(1, j))).clamp(0, build_cap - 1)
    ok = pos < total[:, None]
    # all-False for inner and semi: their emitted rows always have a match
    unmatched = ok & (matched.gather(1, j) == 0)
    return j, li, ok, unmatched, total


@dataclass(frozen=True)
class JoinSpec:
    """Static description of one equi-join (the JAX package's fields without
    ``axis_name``).

    ``build_*`` is the hash-table side, ``probe_*`` the streamed side; in SQL
    the probe side is the LEFT operand (``SELECT ... FROM probe [LEFT OUTER]
    JOIN build ON key``).  ``join_type`` is one of ``JOIN_TYPES``: 'inner';
    'left_outer' (every probe row kept, unmatched ones null-extended);
    'left_semi' / 'left_anti' (EXISTS / NOT EXISTS: each qualifying probe row
    once, build lanes zeroed); 'right_outer' (inner plus every unmatched build
    row, probe lanes zeroed); 'full_outer' (both sides kept).
    ``out_capacity``: output rows per executor.  ``impl``: 'auto' or 'shared'
    (every executor on one device); 'ragged' is not ported yet.
    ``with_filters`` takes per-row build and probe masks (WHERE pushdown)."""

    num_executors: int
    build_capacity: int
    build_recv_capacity: int
    build_width: int
    probe_capacity: int
    probe_recv_capacity: int
    probe_width: int
    out_capacity: int
    dtype: np.dtype = np.dtype(np.int32)
    impl: str = "auto"
    with_filters: bool = False
    join_type: str = "inner"

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    def resolve_impl(self) -> "JoinSpec":
        return replace(self, impl="shared") if self.impl == "auto" else self

    def validate(self) -> None:
        if self.impl == "ragged":
            raise NotImplementedError(f"impl='ragged': {_CROSS_DEVICE}")
        if self.impl != "shared":
            raise ValueError(f"unknown impl {self.impl!r}")
        if np.dtype(self.dtype).itemsize != 4:
            raise ValueError("value dtype must be 32-bit (keys bitcast through it)")
        if self.join_type not in JOIN_TYPES:
            raise ValueError(f"unknown join_type {self.join_type!r} (valid: {JOIN_TYPES})")


def sort_build(n: int, keys: torch.Tensor, valid: torch.Tensor, vals: torch.Tensor):
    """Each executor's received build rows sorted by key, stably, padding
    (forced to KEY_MAX) last: ``(sorted keys (n, cap), rows (n * cap, W) in
    that order, the order (n, cap))``."""
    skeys, order = torch.sort(padded_keys(keys, valid).view(n, -1), dim=1, stable=True)
    return skeys, gather_rows(vals, order), order


def _join_body(spec: JoinSpec, devices, bkeys, bvals, bnum, pkeys, pvals, pnum, bmask=None, pmask=None):
    n = spec.num_executors
    device = bkeys.device
    brc, prc, oc = spec.build_recv_capacity, spec.probe_recv_capacity, spec.out_capacity

    def cspec(cap, recv_cap, width):
        return ColumnarSpec(n, cap, recv_cap, width + 1, np.dtype(spec.dtype))

    bvalid = _input_valid(spec.build_capacity, bnum, device, bmask)
    pvalid = _input_valid(spec.probe_capacity, pnum, device, pmask)

    # hash-partition both sides: equal keys co-locate
    rbk, rbv, rbvalid, rbtotal = exchange_keyed_rows(
        devices, cspec(spec.build_capacity, brc, spec.build_width), bkeys, bvals, bvalid
    )
    rpk, rpv, rpvalid, rptotal = exchange_keyed_rows(
        devices, cspec(spec.probe_capacity, prc, spec.probe_width), pkeys, pvals, pvalid
    )
    btotal = upload(np.minimum(rbtotal, brc).astype(np.int64), device)

    # sort the build side; the padding occupies exactly the tail [btotal, cap)
    sbk, sbv, _ = sort_build(n, rbk, rbvalid, rbv)
    base_type = _OUTER_BASE.get(spec.join_type, spec.join_type)
    j, li, ok, unmatched, total = expand_matches(
        oc, sbk, btotal, rpk.view(n, prc), rpvalid.view(n, prc), prc, brc, join_type=base_type
    )
    zero = torch.zeros((), dtype=spec.torch_dtype, device=device)
    out_keys = torch.where(ok, rpk.view(n, prc).gather(1, j), 0).reshape(-1)
    matched = (ok & ~unmatched).reshape(-1)
    if spec.join_type in ("left_semi", "left_anti"):
        # SQL semi/anti joins emit probe columns only
        out_build = torch.zeros((n * oc, spec.build_width), dtype=spec.torch_dtype, device=device)
    else:
        out_build = torch.where(matched[:, None], gather_rows(sbv, li), zero)
    out_probe = torch.where(ok.reshape(-1)[:, None], gather_rows(rpv, j), zero)
    if spec.join_type in _OUTER_BASE:
        # build-side match flags: each valid build row searched in the sorted
        # probe keys (the right bound clamped at the probe total, as in
        # expand_matches), the matchless ones appended after the base rows
        ptotal = upload(np.minimum(rptotal, prc).astype(np.int64), device)
        spk = torch.sort(padded_keys(rpk, rpvalid).view(n, prc), dim=1).values
        lob = torch.searchsorted(spk, sbk)
        hib = torch.minimum(torch.searchsorted(spk, sbk, right=True), ptotal[:, None])
        in_build = torch.arange(brc, device=device)[None, :] < btotal[:, None]
        build_unmatched = in_build & ((hib - lob).clamp(min=0) == 0)
        unmatched_rows = build_unmatched.to(torch.int64)
        dest = total[:, None] + row_cumsum(unmatched_rows) - unmatched_rows
        keep = build_unmatched & (dest < oc)  # past out_capacity: dropped
        flat = (dest + torch.arange(n, device=device)[:, None] * oc)[keep]
        out_keys[flat] = sbk[keep]
        out_build[flat] = sbv[keep.reshape(-1)]
        # out_probe and out_matched stay zero / False on the appended rows
        ub = build_unmatched.sum(dim=1)
        total = torch.where(total > _INT32_MAX - ub, _INT32_MAX, total + ub)
    recv_totals = np.stack([rbtotal, rptotal], axis=1).astype(np.int32)
    outs = (out_keys, out_build, out_probe, total.to(torch.int32), recv_totals)
    if spec.join_type in OUTER_JOIN_TYPES:
        outs += (matched,)
    return outs


def build_hash_join(devices: Optional[Sequence], spec: JoinSpec):
    """The distributed equi-join (``spec.join_type``) for executors on
    ``devices`` (one entry per executor; ``None`` puts every executor on
    ``cuda``).

    Returns ``fn(build_keys, build_values, build_num, probe_keys,
    probe_values, probe_num, build_mask=None, probe_mask=None) ->
    (out_keys, out_build, out_probe, out_counts, recv_totals)``, and a sixth
    ``out_matched`` (n * out_capacity,) bool for an outer join type (False
    marks a null-extended row):

    * keys (n * capacity,) int64 (or uint32) tensors of uint32 values, values
      (n * capacity, width) of ``dtype``, nums (n,) valid rows per executor;
      the masks, (n * capacity,) bool, are required with
      ``spec.with_filters`` (False rows never enter an exchange), else not
      allowed;
    * ``out_keys``: (n * out_capacity,) int64 join key per output row, zero
      past an executor's count; ``out_build`` / ``out_probe``: the matched
      value rows, aligned, zero where null-extended or past the count;
    * ``out_counts``: (n,) int32 tensor on the device — rows each executor
      emitted; above ``out_capacity`` the output was truncated;
    * ``recv_totals``: (n, 2) numpy int32 — TRUE (build, probe) rows hashed
      to each executor; above a side's recv capacity that exchange truncated.
    """
    devices = resolve_devices(devices, spec.num_executors)
    spec = spec.resolve_impl()
    spec.validate()
    if not same_device(devices):
        raise NotImplementedError(_CROSS_DEVICE)
    n, device = spec.num_executors, devices[0]

    def check(name, keys, values, num, cap, width):
        if tuple(keys.shape) != (n * cap,) or tuple(values.shape) != (n * cap, width):
            raise ValueError(
                f"{name} keys {tuple(keys.shape)} / values {tuple(values.shape)} != ({n * cap},) / ({n * cap}, {width})"
            )
        if values.dtype != spec.torch_dtype:
            raise ValueError(f"{name} values dtype {values.dtype} != spec dtype {spec.torch_dtype}")
        if keys.device != device or values.device != device:
            raise ValueError(f"{name} keys and values must be on {device}")
        nv = torch.as_tensor(num).cpu().numpy().astype(np.int64).reshape(n)
        if (nv < 0).any() or (nv > cap).any():
            raise ValueError(f"{name} num must lie in [0, {cap}]")
        return keys.to(torch.int64), values.contiguous(), nv

    def join(bkeys, bvals, bnum, pkeys, pvals, pnum, bmask=None, pmask=None):
        if (bmask is None) != (pmask is None) or spec.with_filters != (bmask is not None):
            raise ValueError("spec.with_filters=True needs both masks (and masks need with_filters=True)")
        b = check("build", bkeys, bvals, bnum, spec.build_capacity, spec.build_width)
        p = check("probe", pkeys, pvals, pnum, spec.probe_capacity, spec.probe_width)
        return _join_body(spec, devices, *b, *p, bmask, pmask)

    join.spec = spec
    return join


def plan_join_capacities(
    build_keys: np.ndarray, probe_keys: np.ndarray, num_executors: int, join_type: str = "inner"
) -> Tuple[int, int, int]:
    """Exact per-executor (build_recv, probe_recv, out) capacities of a hash
    join of these keys, from the host twin of the placement hash.  Key k's
    rows land on its owner and emit ``pcount(k) * f(bcount(k))`` rows there,
    f per the join type; right/full outer also emit each probe-matchless
    build row once on its key's owner."""
    n = num_executors
    brecv = max(1, int(np.bincount(hash_owners_host(build_keys, n), minlength=n).max()))
    precv = max(1, int(np.bincount(hash_owners_host(probe_keys, n), minlength=n).max()))
    uk_b, cb = np.unique(build_keys, return_counts=True)
    uk_p, cp = np.unique(probe_keys, return_counts=True)
    present = np.isin(uk_p, uk_b)
    bcount = np.zeros(len(uk_p), np.int64)
    bcount[present] = cb[np.searchsorted(uk_b, uk_p[present])]
    base_type = _OUTER_BASE.get(join_type, join_type)
    per_key = cp * _join_emit(base_type)(bcount, np)
    per_shard = np.zeros(n, np.int64)
    if len(uk_p):
        np.add.at(per_shard, hash_owners_host(uk_p, n), per_key)
    if join_type in _OUTER_BASE:
        only_build = ~np.isin(uk_b, uk_p)
        if only_build.any():
            np.add.at(per_shard, hash_owners_host(uk_b[only_build], n), cb[only_build])
    return brecv, precv, max(1, int(per_shard.max()))


def prepare_hash_join(
    devices: Optional[Sequence],
    build_keys: np.ndarray,
    build_vals: np.ndarray,
    probe_keys: np.ndarray,
    probe_vals: np.ndarray,
    impl: str = "auto",
    build_capacity: Optional[int] = None,
    probe_capacity: Optional[int] = None,
    join_type: str = "inner",
    num_executors: Optional[int] = None,
):
    """The set-up of :func:`run_hash_join`: plan the receive and output
    capacities exactly (:func:`plan_join_capacities`), build the join and
    shard both sides onto the executors' device.  Returns ``(fn, args,
    (build_recv, probe_recv, out_capacity))``; ``fn(*args)`` runs the join
    on the device tensors alone (what a timing of the join calls)."""
    if build_vals.dtype != probe_vals.dtype:
        raise ValueError(
            f"build/probe value dtypes must match (keys bitcast through them): "
            f"{build_vals.dtype} != {probe_vals.dtype}"
        )
    devices = resolve_devices(devices, num_executors)
    n, device = len(devices), devices[0]
    bcap = build_capacity or max(1, -(-len(build_keys) // n))
    pcap = probe_capacity or max(1, -(-len(probe_keys) // n))
    brecv, precv, out_cap = plan_join_capacities(build_keys, probe_keys, n, join_type=join_type)
    spec = JoinSpec(
        num_executors=n,
        build_capacity=bcap, build_recv_capacity=brecv, build_width=build_vals.shape[1],
        probe_capacity=pcap, probe_recv_capacity=precv, probe_width=probe_vals.shape[1],
        out_capacity=out_cap, dtype=build_vals.dtype, impl=impl, join_type=join_type,
    )
    fn = build_hash_join(devices, spec)
    bk, bv, bn = shard_rows_host(build_keys, build_vals, n, bcap, value_dtype=spec.dtype)
    pk, pv, pn = shard_rows_host(probe_keys, probe_vals, n, pcap, value_dtype=spec.dtype)
    args = (
        upload(bk.astype(np.int64), device), upload(bv, device), bn,
        upload(pk.astype(np.int64), device), upload(pv, device), pn,
    )
    return fn, args, (brecv, precv, out_cap)


def run_hash_join(
    devices: Optional[Sequence],
    build_keys: np.ndarray,
    build_vals: np.ndarray,
    probe_keys: np.ndarray,
    probe_vals: np.ndarray,
    impl: str = "auto",
    build_capacity: Optional[int] = None,
    probe_capacity: Optional[int] = None,
    join_type: str = "inner",
    num_executors: Optional[int] = None,
):
    """Host driver of the equi-join: set it up (:func:`prepare_hash_join`),
    run it and check the device placement against the host plan.
    ``devices``: one entry per executor, or ``None`` with ``num_executors``
    executors on ``cuda``.  Returns flat (keys uint32, build_rows,
    probe_rows) in executor-concatenated order (compare as a multiset, as
    ``oracle_join``'s), with a fourth ``matched`` bool array for an outer
    ``join_type``; 'left_semi' / 'left_anti' zero the build lanes.
    ``build_capacity`` / ``probe_capacity`` override the tight per-executor
    input capacities."""
    fn, args, (brecv, precv, out_cap) = prepare_hash_join(
        devices, build_keys, build_vals, probe_keys, probe_vals, impl=impl, build_capacity=build_capacity,
        probe_capacity=probe_capacity, join_type=join_type, num_executors=num_executors,
    )
    outs = fn(*args)
    rt = outs[4]
    if not ((rt[:, 0] <= brecv).all() and (rt[:, 1] <= precv).all()):
        raise RuntimeError(
            f"device hash placement diverged from the host plan (build "
            f"{rt[:, 0].max()}/{brecv}, probe {rt[:, 1].max()}/{precv})"
        )
    oc = outs[3].cpu().numpy()
    if not (oc <= out_cap).all():
        raise RuntimeError(f"join output overflowed the exact host plan ({oc.max()} > {out_cap})")
    host = [outs[0].cpu().numpy().astype(np.uint32), outs[1].cpu().numpy(), outs[2].cpu().numpy()]
    if join_type in OUTER_JOIN_TYPES:
        host.append(outs[5].cpu().numpy())
    return tuple(unpack_shard_prefixes(host, oc, out_cap))


# ----------------------------------------------------------------------------
# CPU oracles
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


def oracle_join(
    build_keys: np.ndarray,
    build_vals: np.ndarray,
    probe_keys: np.ndarray,
    probe_vals: np.ndarray,
    join_type: str = "inner",
):
    """numpy reference equi-join, the JAX package's oracle unchanged: rows
    (key, build_row, probe_row), with a fourth ``matched`` array for an outer
    ``join_type`` (null-extended rows zero the missing side); 'left_semi'
    emits each matched probe row once and 'left_anti' each matchless one,
    both with zeroed build lanes."""
    from collections import defaultdict

    base_type = _OUTER_BASE.get(join_type, join_type)
    left_outer = base_type == "left_outer"
    by_key = defaultdict(list)
    for k, row in zip(build_keys, build_vals):
        by_key[int(k)].append(row)
    zero_build = np.zeros(build_vals.shape[1], build_vals.dtype)
    keys, brows, prows, matched = [], [], [], []
    for k, prow in zip(probe_keys, probe_vals):
        hits = by_key.get(int(k), ())
        if base_type == "left_semi":
            hits = [zero_build] if hits else []
        elif base_type == "left_anti":
            if not hits:
                keys.append(int(k))
                brows.append(zero_build)
                prows.append(prow)
                matched.append(False)
            continue
        for brow in hits:
            keys.append(int(k))
            brows.append(brow)
            prows.append(prow)
            matched.append(True)
        if left_outer and not hits:
            keys.append(int(k))
            brows.append(zero_build)
            prows.append(prow)
            matched.append(False)
    if join_type in _OUTER_BASE:
        probe_keyset = {int(k) for k in probe_keys}
        zero_probe = np.zeros(probe_vals.shape[1], probe_vals.dtype)
        for k, brow in zip(build_keys, build_vals):
            if int(k) not in probe_keyset:
                keys.append(int(k))
                brows.append(brow)
                prows.append(zero_probe)
                matched.append(False)
    outer = join_type in OUTER_JOIN_TYPES
    if not keys:
        out = (
            np.zeros(0, np.uint32),
            np.zeros((0, build_vals.shape[1]), build_vals.dtype),
            np.zeros((0, probe_vals.shape[1]), probe_vals.dtype),
        )
        return out + (np.zeros(0, bool),) if outer else out
    out = (np.array(keys, np.uint32), np.stack(brows), np.stack(prows))
    return out + (np.array(matched),) if outer else out
