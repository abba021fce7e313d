"""Device-resident transitive closure — the ``SparkTC`` workload.

Port of ``sparkucx_tpu/ops/tc.py``.  SparkTC computes the transitive closure
of a random edge set by iterating ``tc = (tc union tc.join(edges)).distinct()``
to a fixpoint, the driver re-counting after every round (the reference's
integration gate is ``run_groupby_test && run_tc_test``).  Each round runs on
the device for all executors at once:

    hash-exchange tc by dst            ->  sort-merge expansion against the
    (edges exchanged by src and sorted     pre-sorted edges (new paths a->c
    once, ``build_tc_prep``)               from a->b and b->c)
    ->  union with tc  ->  hash-exchange pairs by mix(a, b)  ->  lexicographic
    sort and DISTINCT

Every exchange is the columnar shuffle of ops/relational.py (K1, one launch a
receiver), the expansion is its ``expand_matches``; the sorts, searches and
running sums are torch ops.  The Python loop only compares the global pair
count between rounds, Spark's driver role (``while (nextCount !=
oldCount)``).

Vertex ids are uint32 below 0xFFFFFFFF (the KEY_MAX padding sentinel) and
cross the port as int64 tensors.  Every step reports true totals, so a
capacity overflow is detected, never silently truncated.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from sparkucx_tpu_torch.ops.columnar import _CROSS_DEVICE, ColumnarSpec
from sparkucx_tpu_torch.ops.exchange import same_device
from sparkucx_tpu_torch.ops.relational import (
    exchange_keyed_rows,
    expand_matches,
    gather_rows,
    key_lane,
    mul_low32,
    padded_keys,
    prefix_valid,
    row_cumsum,
    sort_build,
)
from sparkucx_tpu_torch.ops.sort import KEY_MAX, key_values
from sparkucx_tpu_torch.utils.devices import resolve_devices, upload

_KEY_MAX = int(KEY_MAX)
_MIX_A = 2654435761  # Knuth multiplicative
_MIX_B = 40503  # 16-bit Fibonacci constant, odd


def _pair_mix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mix a pair of uint32s (int64 tensors) into one uint32 partitioning key
    (only duplicate pairs MUST collide; quality just balances executors).
    uint32 arithmetic in int64: every product is reduced mod 2**32."""
    h = mul_low32(a.to(torch.int64), _MIX_A)
    h = h ^ ((h >> 15) | ((b.to(torch.int64) * _MIX_B) & 0xFFFFFFFF))
    return mul_low32(h, _MIX_A)


@dataclass(frozen=True)
class TcSpec:
    """Static description of one TC iteration (the JAX package's fields
    without ``axis_name``).

    ``edge_capacity``: input edges per executor.  ``tc_capacity``: closure
    rows per executor — its slice of the final closure with headroom.
    ``join_capacity``: new paths per executor and round.  ``recv_*`` default
    to the matching capacity; raise them for skewed graphs.  ``impl``:
    'auto' or 'shared' (every executor on one device); 'ragged' is not
    ported yet."""

    num_executors: int
    edge_capacity: int
    tc_capacity: int
    join_capacity: int
    edge_recv_capacity: Optional[int] = None
    tc_recv_capacity: Optional[int] = None
    impl: str = "auto"

    @property
    def edge_recv(self) -> int:
        return self.edge_recv_capacity or self.edge_capacity

    @property
    def tc_recv(self) -> int:
        return self.tc_recv_capacity or self.tc_capacity

    def resolve_impl(self) -> "TcSpec":
        return replace(self, impl="shared") if self.impl == "auto" else self

    def validate(self) -> None:
        if self.impl == "ragged":
            raise NotImplementedError(f"impl='ragged': {_CROSS_DEVICE}")
        if self.impl != "shared":
            raise ValueError(f"unknown impl {self.impl!r}")


def _lex_dedup(n: int, a: torch.Tensor, b: torch.Tensor, valid: torch.Tensor, out_rows: int):
    """Each executor's pairs sorted lexicographically ((a, b), padding last)
    and one of each kept — the device DISTINCT.  ``a``, ``b``, ``valid``:
    (n * rows,).  Returns ``(a', b')`` (n * out_rows,) int64 with the distinct
    pairs as a tight ascending prefix per executor, KEY_MAX after, and
    ``count`` (n,) int64 (the true count, above ``out_rows`` when it
    truncated)."""
    a = padded_keys(a, valid).view(n, -1)
    b = padded_keys(b, valid).view(n, -1)
    # two stable passes = lexicographic (b minor, a major); a single int64
    # key (a << 32) | b would turn negative for a >= 2**31
    order = torch.sort(b, dim=1, stable=True).indices
    order = order.gather(1, torch.sort(a.gather(1, order), dim=1, stable=True).indices)
    sa, sb, svalid = a.gather(1, order), b.gather(1, order), valid.view(n, -1).gather(1, order)
    first = svalid.clone()
    first[:, 1:] &= (sa[:, 1:] != sa[:, :-1]) | (sb[:, 1:] != sb[:, :-1])
    seg = row_cumsum(first) - 1
    count = first.sum(dim=1)
    keep = svalid & (seg < out_rows)  # past out_rows: dropped
    flat = (seg + torch.arange(n, device=a.device)[:, None] * out_rows)[keep]
    out_a = torch.full((n * out_rows,), _KEY_MAX, dtype=torch.int64, device=a.device)
    out_b = out_a.clone()
    out_a[flat] = sa[keep]
    out_b[flat] = sb[keep]
    return out_a, out_b, count


def _cspec(spec: TcSpec, cap: int, recv: int, width: int) -> ColumnarSpec:
    return ColumnarSpec(spec.num_executors, cap, recv, width + 1, np.dtype(np.int32))


def _tc_prep_body(spec: TcSpec, devices, e_src, e_dst, e_num):
    """One-time build-side prep: the immutable edge set hash-exchanged by src
    and sorted per executor; every round reuses it."""
    n, er = spec.num_executors, spec.edge_recv
    e_valid = prefix_valid(spec.edge_capacity, e_num, e_src.device)
    rek, rev, revalid, re_total = exchange_keyed_rows(
        devices, _cspec(spec, spec.edge_capacity, er, 1), e_src, key_lane(e_dst, torch.int32), e_valid
    )
    sbk, sbc, _ = sort_build(n, rek, revalid, rev)
    btotal = np.minimum(re_total, er).astype(np.int32)
    return sbk.reshape(-1), key_values(sbc[:, 0]), btotal, re_total.astype(np.int32)


def _tc_step_body(spec: TcSpec, devices, tc_a, tc_b, tc_num, sbk, sbc, btotal):
    n, device = spec.num_executors, tc_a.device
    tcap, trc, er, jcap = spec.tc_capacity, spec.tc_recv, spec.edge_recv, spec.join_capacity
    tc_valid = prefix_valid(tcap, tc_num, device)

    # 1. co-locate paths a->b (keyed by b) with the pre-sorted edges b->c
    rtk, rtv, rtvalid, rt_total = exchange_keyed_rows(
        devices, _cspec(spec, tcap, trc, 1), tc_b, key_lane(tc_a, torch.int32), tc_valid
    )

    # 2. sort-merge expansion (shared with the hash join): probe = tc rows,
    #    build = edges; each match emits the new path (a, c)
    j, li, new_ok, _, new_total = expand_matches(
        jcap, sbk.view(n, er), btotal, rtk.view(n, trc), rtvalid.view(n, trc), trc, er
    )
    new_a = torch.where(new_ok, key_values(gather_rows(rtv, j)[:, 0]).view(n, jcap), _KEY_MAX)
    new_c = torch.where(new_ok, sbc.view(n, er).gather(1, li), _KEY_MAX)

    # 3. union tc ++ new paths, re-partitioned by pair hash so duplicates collide
    u_a = torch.cat([padded_keys(tc_a, tc_valid).view(n, tcap), new_a], dim=1).reshape(-1)
    u_b = torch.cat([padded_keys(tc_b, tc_valid).view(n, tcap), new_c], dim=1).reshape(-1)
    u_valid = torch.cat([tc_valid.view(n, tcap), new_ok], dim=1).reshape(-1)
    u_cap = tcap + jcap
    _, ruv, ruvalid, ru_total = exchange_keyed_rows(
        devices,
        _cspec(spec, u_cap, u_cap, 2),
        _pair_mix(u_a, u_b),
        torch.cat([key_lane(u_a, torch.int32), key_lane(u_b, torch.int32)], dim=1),
        u_valid,
    )

    # 4. DISTINCT -> the next round's tc
    out_a, out_b, count = _lex_dedup(n, key_values(ruv[:, 0]), key_values(ruv[:, 1]), ruvalid, tcap)
    host_totals = upload(np.stack([rt_total, ru_total], axis=1).astype(np.int64), device)
    overflow = torch.stack([host_totals[:, 0], new_total, host_totals[:, 1], count], dim=1).to(torch.int32)
    global_count = count.sum().expand(n).to(torch.int32)  # every executor's copy, as a psum leaves it
    return out_a, out_b, count.to(torch.int32), global_count, overflow


def _resolve(devices, spec: TcSpec):
    devices = resolve_devices(devices, spec.num_executors)
    spec = spec.resolve_impl()
    spec.validate()
    if not same_device(devices):
        raise NotImplementedError(_CROSS_DEVICE)
    return devices, spec


def _pairs_in(n: int, cap: int, device, *tensors):
    for t in tensors:
        if tuple(t.shape) != (n * cap,):
            raise ValueError(f"shape {tuple(t.shape)} != ({n * cap},)")
        if t.device != device:
            raise ValueError(f"inputs must be on {device}")
    return [t.to(torch.int64) for t in tensors]


def build_tc_prep(devices: Optional[Sequence], spec: TcSpec):
    """The one-time edge prep for executors on ``devices`` (``None``: every
    executor on ``cuda``): ``fn(e_src, e_dst, e_num) -> (sorted_keys,
    sorted_dsts, btotals, recv_totals)`` — the edge set hash-partitioned by
    src and sorted per executor (int64 tensors (n * edge_recv,)), the valid
    rows per executor and the true rows each received (numpy (n,) int32;
    above ``edge_recv`` the exchange truncated).  Feed the first three to
    every ``build_tc_step`` call."""
    devices, spec = _resolve(devices, spec)
    n, device = spec.num_executors, devices[0]

    def prep(e_src, e_dst, e_num):
        e_src, e_dst = _pairs_in(n, spec.edge_capacity, device, e_src, e_dst)
        return _tc_prep_body(spec, devices, e_src, e_dst, e_num)

    prep.spec = spec
    return prep


def build_tc_step(devices: Optional[Sequence], spec: TcSpec):
    """One TC iteration for executors on ``devices`` (``None``: every executor
    on ``cuda``).

    Returns ``fn(tc_a, tc_b, tc_num, sorted_keys, sorted_dsts, btotals) ->
    (tc_a', tc_b', tc_num', global_count, overflow)``:

    * ``tc_a`` / ``tc_b``: (n * tc_capacity,) int64 tensors of uint32 values —
      closure pairs a->b as a tight prefix per executor; ``tc_num``: (n,)
      valid pairs per executor (numpy or tensor);
    * ``sorted_keys`` / ``sorted_dsts`` / ``btotals``: ``build_tc_prep``'s;
    * outputs, all tensors on the device: the next closure (same layout,
      hash-partitioned by pair), distinct pairs per executor (n,) int32 and
      in all (n,) (each executor's copy), and ``overflow`` (n, 4) int32 — per executor (tc rows
      received, new paths expanded, union rows received, distinct pairs).
      Any of them above tc_recv / join_capacity / tc_capacity +
      join_capacity / tc_capacity means truncation: re-run with headroom.

    Iterate with ``run_transitive_closure``."""
    devices, spec = _resolve(devices, spec)
    n, device = spec.num_executors, devices[0]

    def step(tc_a, tc_b, tc_num, sbk, sbc, btotal):
        tc_a, tc_b = _pairs_in(n, spec.tc_capacity, device, tc_a, tc_b)
        sbk, sbc = _pairs_in(n, spec.edge_recv, device, sbk, sbc)
        if not isinstance(btotal, torch.Tensor):
            btotal = upload(np.asarray(btotal, dtype=np.int64), device)
        return _tc_step_body(spec, devices, tc_a, tc_b, tc_num, sbk, sbc, btotal)

    step.spec = spec
    return step


def shard_pairs(pairs: np.ndarray, n: int, cap: int, device):
    """Deal (P, 2) uint32 pairs round-robin over n executors as tight padded
    prefixes: (a, b) int64 tensors (n * cap,) with KEY_MAX padding, and the
    pairs per executor (numpy (n,) int32)."""
    a = np.full(n * cap, _KEY_MAX, np.int64)
    b = np.full(n * cap, _KEY_MAX, np.int64)
    num = np.zeros(n, np.int32)
    for s in range(n):
        mine = pairs[s::n]
        if len(mine) > cap:
            raise ValueError(f"shard {s} holds {len(mine)} pairs > capacity {cap}")
        a[s * cap : s * cap + len(mine)] = mine[:, 0]
        b[s * cap : s * cap + len(mine)] = mine[:, 1]
        num[s] = len(mine)
    return upload(a, device), upload(b, device), num


_OVERFLOW_NAMES = ("tc_recv", "join_capacity", "union recv", "tc_capacity")


def check_overflow(spec: TcSpec, overflow: np.ndarray, rnd: int) -> None:
    """Raise when a step's ``overflow`` (n, 4) passes a capacity."""
    caps = (spec.tc_recv, spec.join_capacity, spec.tc_capacity + spec.join_capacity, spec.tc_capacity)
    for col, (cap, name) in enumerate(zip(caps, _OVERFLOW_NAMES)):
        if (overflow[:, col] > cap).any():
            raise RuntimeError(
                f"round {rnd}: {name} overflow (max {int(overflow[:, col].max())} > {cap}) "
                f"— re-run with more headroom"
            )


def run_transitive_closure(
    devices: Optional[Sequence], spec: TcSpec, edges: np.ndarray, max_rounds: int = 64
) -> Tuple[np.ndarray, int]:
    """The SparkTC driver loop: seed tc = edges, iterate the step until the
    global pair count stops growing (or ``max_rounds``).

    ``edges``: (E, 2) uint32 host array; ``devices``: one entry per executor,
    ``None`` for ``spec.num_executors`` on ``cuda``.  Returns (closure pairs
    (C, 2) uint32 ascending-unique, rounds executed).  Raises on any capacity
    overflow and when no fixpoint is reached within ``max_rounds`` (a
    partial closure is never returned)."""
    devices, spec = _resolve(devices, spec)
    n, device = spec.num_executors, devices[0]
    prep = build_tc_prep(devices, spec)
    step = build_tc_step(devices, spec)

    edges = np.unique(edges.astype(np.uint32), axis=0)
    if (edges >= 0xFFFFFFFF).any():
        raise ValueError("vertex ids must be < 0xFFFFFFFF (padding sentinel)")
    tc_a, tc_b, tc_num = shard_pairs(edges, n, spec.tc_capacity, device)
    e_src, e_dst, e_num = shard_pairs(edges, n, spec.edge_capacity, device)
    sbk, sbc, btotals, e_recv_totals = prep(e_src, e_dst, e_num)
    if (e_recv_totals > spec.edge_recv).any():
        raise RuntimeError(
            f"edge_recv overflow (max {int(e_recv_totals.max())} > {spec.edge_recv}) — re-run with more headroom"
        )

    count = int(tc_num.sum())
    converged = False
    rounds = 0
    for rounds in range(1, max_rounds + 1):
        tc_a, tc_b, tc_num, global_count, overflow = step(tc_a, tc_b, tc_num, sbk, sbc, btotals)
        check_overflow(spec, overflow.cpu().numpy(), rounds)
        new_count = int(global_count.cpu()[0])
        if new_count == count:
            converged = True
            break
        count = new_count
    if not converged:
        raise RuntimeError(
            f"no fixpoint after {max_rounds} rounds ({count} pairs and growing) — "
            f"raise max_rounds (rounds needed ~ graph diameter)"
        )
    return collect_pairs(spec, tc_a, tc_b, tc_num), rounds


def collect_pairs(spec: TcSpec, tc_a: torch.Tensor, tc_b: torch.Tensor, tc_num) -> np.ndarray:
    """Every executor's valid pairs as one (C, 2) uint32 array, ascending."""
    n, cap = spec.num_executors, spec.tc_capacity
    a = tc_a.cpu().numpy().reshape(n, cap)
    b = tc_b.cpu().numpy().reshape(n, cap)
    num = torch.as_tensor(tc_num).cpu().numpy()
    pairs = np.concatenate([np.stack([a[s, : num[s]], b[s, : num[s]]], axis=1) for s in range(n)])
    pairs = pairs.astype(np.uint32)
    return pairs[np.lexsort((pairs[:, 1], pairs[:, 0]))]


def oracle_tc(edges: np.ndarray) -> np.ndarray:
    """CPU reference closure (the JAX package's): iterated composition until
    the fixpoint, as ascending-unique (C, 2) uint32 pairs."""
    tc = {tuple(e) for e in np.unique(edges.astype(np.uint32), axis=0)}
    by_src = {}
    for s, d in tc:
        by_src.setdefault(s, set()).add(d)
    while True:
        new = {(a, c) for a, b in tc for c in by_src.get(b, ())} - tc
        if not new:
            break
        tc |= new
    return np.array(sorted(tc), np.uint32).reshape(-1, 2)
