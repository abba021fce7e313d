"""Distributed sample sort — the device-resident TeraSort core.

Port of ``sparkucx_tpu/ops/sort.py``.  TeraSort is Spark's ``sortByKey``: a
range-partitioning shuffle (sampled splitters decide which executor owns each
key range) and a sort of each range.  Here the whole job runs on the device:

    local sort -> sample splitters -> range-partition owners ->
    columnar exchange (ops/columnar.py) -> local sort of the received range

After it, executor j holds the j-th global key range, sorted; the valid
prefixes of the output shards, in executor order, are the sorted dataset.

Rows are (key, payload lanes...) of 32-bit words; a 100-byte TeraSort row is
one uint32 key and 24 payload lanes.  Keys cross the port's boundary as
int64 tensors holding uint32 values (PyTorch's uint32 lacks comparisons,
shifts and ``searchsorted``), and as uint32 numpy arrays in the host drivers.
A key travels inside a row as its 32-bit pattern, bitcast into the payload
dtype, so the permutation moves key and payload together once.

Lowerings (``SortSpec.impl``):

* ``single`` — one executor: ``torch.sort(stable=True)`` of the keys and one
  ``index_select`` of the payload (the JAX package leaves this to XLA's
  argsort outside any kernel);
* ``radix`` — one executor: key and payload fused into rows and sorted by
  the K6 LSD radix kernel (ops/radix.py);
* ``shared`` — n executors on one device: the sample sort, whose exchange is
  K1 (one ``block_gather`` per receiver);
* ``ragged`` — executors on different devices (the NCCL collective): not
  ported yet.

Skew: splitters come from ``samples_per_shard`` evenly spaced samples per
shard, so a range exceeds ``recv_capacity`` only under adversarial skew; the
returned per-shard totals signal it (``counts > recv_capacity``) and the host
drivers retry with doubled headroom.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Sequence

import numpy as np
import torch

from sparkucx_tpu_torch.ops.columnar import (
    ColumnarSpec,
    exchange_sorted_rows,
    shard_rows_host,
    size_matrix_from_owners,
    unpack_shard_prefixes,
)
from sparkucx_tpu_torch.ops.exchange import same_device
from sparkucx_tpu_torch.ops.radix import radix_sort_rows
from sparkucx_tpu_torch.utils.devices import resolve_devices

KEY_MAX = np.uint32(0xFFFFFFFF)  # padding sentinel; sorts last
_KEY_MAX = int(KEY_MAX)


@dataclass(frozen=True)
class SortSpec:
    """Static description of one distributed sort.

    ``capacity``: per-executor input rows (pad short shards; padding is
    excluded via ``num_valid``).  ``recv_capacity``: per-executor output rows
    — headroom over the balanced ``total/n`` guards against sampling error
    (1.5-2x is ample for uniform keys, e.g. TeraSort's).  ``width``: payload
    lanes of ``dtype`` per row (>= 0); keys are uint32.  The JAX
    ``axis_name`` field has no counterpart here.
    """

    num_executors: int
    capacity: int
    recv_capacity: int
    width: int = 24  # 96-byte payload -> 100-byte rows like TeraSort
    dtype: np.dtype = np.dtype(np.int32)
    samples_per_shard: int = 64
    impl: str = "auto"

    def resolve_impl(self) -> "SortSpec":
        """'auto' -> 'single' with one executor and ``recv_capacity >=
        capacity`` (one local sort, no splitters, no exchange), else 'shared'."""
        if self.impl != "auto":
            return self
        if self.num_executors == 1 and self.recv_capacity >= self.capacity:
            return replace(self, impl="single")
        return replace(self, impl="shared")

    def validate(self) -> None:
        if self.impl == "ragged":
            raise NotImplementedError(
                "impl='ragged' sorts across devices through the NCCL exchange, which is not "
                "ported yet (ROADMAP queue A item 4, executors in separate processes)"
            )
        if self.impl not in ("shared", "single", "radix"):
            raise ValueError(f"unknown impl {self.impl!r}")
        if self.impl in ("single", "radix") and (
            self.num_executors != 1 or self.recv_capacity < self.capacity
        ):
            raise ValueError(
                f"impl={self.impl!r} needs num_executors=1 and recv_capacity >= capacity"
            )
        if np.dtype(self.dtype).itemsize != 4:
            raise ValueError("payload dtype must be 32-bit (keys bitcast through it)")
        if self.samples_per_shard < self.num_executors:
            raise ValueError("samples_per_shard must be >= num_executors")

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch.from_numpy(np.empty(0, self.dtype)).dtype


def key_bits(keys: torch.Tensor) -> torch.Tensor:
    """Contiguous int64 keys in [0, 2**32) -> int32 view of their 32-bit
    patterns: the low word of each int64 (both the card and the host are
    little-endian), so no arithmetic pass over the keys."""
    return keys.view(torch.int32)[0::2]


def key_values(bits: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`key_bits`: 32-bit patterns -> int64 uint32 values."""
    return bits.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def _sample_weights(spec: SortSpec, nv: np.ndarray) -> np.ndarray:
    """Sample slots each shard fills, proportional to its fill (``num_valid /
    capacity``) so a near-empty shard does not drag the splitters toward its
    few keys.  float32 as in the JAX package, rounded as XLA computes
    ``nv / capacity * s`` there: the division by a constant becomes a product
    with its float32 reciprocal, folded with ``s`` into one constant."""
    s = spec.samples_per_shard
    scale = np.float32(1) / np.float32(spec.capacity) * np.float32(s)
    frac = (nv.astype(np.float32) * scale).astype(np.int32)
    return np.minimum(s, frac + (nv > 0)).astype(np.int64)


def _global_splitters(spec: SortSpec, sorted_keys: torch.Tensor, nv: np.ndarray) -> torch.Tensor:
    """Sample each shard's sorted valid prefix, pool the samples, and pick
    n - 1 range boundaries (the analogue of Spark's RangePartitioner sketch).

    ``sorted_keys``: (n, capacity) int64, each row sorted; ``nv``: (n,)
    valid rows per shard.  Returns (n - 1,) int64 splitters."""
    n, s, cap = spec.num_executors, spec.samples_per_shard, spec.capacity
    used = _sample_weights(spec, nv)
    # evenly spaced positions over the valid prefix: (i * nv) // used, in the
    # JAX package's overflow-safe decomposition
    i = np.arange(s, dtype=np.int64)[None, :]
    u = np.maximum(used, 1)[:, None]
    nvc = nv.astype(np.int64)[:, None]
    pos = np.clip(i * (nvc // u) + (i * (nvc % u)) // u, 0, cap - 1)
    device = sorted_keys.device
    local = torch.gather(sorted_keys, 1, torch.from_numpy(pos).to(device))
    local = torch.where(torch.from_numpy(i < used[:, None]).to(device), local, _KEY_MAX)
    allsamp = torch.sort(local.reshape(-1)).values
    total_used = int(used.sum())
    k = np.arange(1, n, dtype=np.int64)
    cut = np.clip(k * (total_used // n) + (k * (total_used % n)) // n, 0, n * s - 1)
    return allsamp[torch.from_numpy(cut).to(device)]


def _fill_padding(shards: torch.Tensor, nv: np.ndarray, value) -> torch.Tensor:
    """In place: ``shards[i, nv[i]:] = value`` for every shard row i."""
    for i, v in enumerate(nv.tolist()):
        shards[i, v:] = value
    return shards


def _masked_keys(keys: torch.Tensor, nv: np.ndarray, capacity: int) -> torch.Tensor:
    """(n * capacity,) keys -> a new (n, capacity) tensor with KEY_MAX past
    each shard's valid prefix (re-forced in case the caller's padding was not
    KEY_MAX)."""
    return _fill_padding(keys.reshape(len(nv), capacity).clone(), nv, _KEY_MAX)


def _fuse(keys: torch.Tensor, payload: torch.Tensor) -> torch.Tensor:
    """(R,) int64 keys and (R, W) 32-bit payload -> (R, W + 1) int32 rows with
    the key's bits in word 0."""
    rows = torch.empty((keys.shape[0], payload.shape[1] + 1), dtype=torch.int32, device=keys.device)
    rows[:, 0] = key_bits(keys)
    rows[:, 1:] = payload.view(torch.int32)
    return rows


def _sort_body(spec: SortSpec, keys, payload, nv: np.ndarray):
    """n executors on one device: the sample sort, exchange through K1."""
    n, cap, rc = spec.num_executors, spec.capacity, spec.recv_capacity
    device = keys.device
    # 1. local sort of every shard (padding KEY_MAX rows sort last, stably)
    masked = _masked_keys(keys, nv, cap)
    skeys, order = torch.sort(masked, dim=1, stable=True)
    del masked
    order = order + torch.arange(n, device=device)[:, None] * cap
    spay = payload.index_select(0, order.reshape(-1))
    del order
    # 2. splitters -> destination executor per sorted row (padding -> n);
    #    the first nv sorted rows of a shard are exactly its valid rows
    splitters = _global_splitters(spec, skeys, nv)
    owners = _fill_padding(torch.searchsorted(splitters, skeys, right=True), nv, n)
    # 3. one exchange moves key and payload together; keys are sorted, so
    #    owners never decrease and each shard's rows are destination-contiguous
    rows = _fuse(skeys.reshape(-1), spay)
    del skeys, spay
    sizes = size_matrix_from_owners(n, owners)[0]
    del owners
    cspec = ColumnarSpec(n, cap, rc, spec.width + 1, np.dtype(np.int32), impl="shared")
    recv, recv_sizes = exchange_sorted_rows(cspec, rows, sizes)
    del rows
    total = recv_sizes.sum(axis=1)
    # 4. final local sort of every received range
    rkeys = _fill_padding(key_values(recv[:, 0]).view(n, rc), total, _KEY_MAX)
    out_keys, rorder = torch.sort(rkeys, dim=1, stable=True)
    rorder = rorder + torch.arange(n, device=device)[:, None] * rc
    out_pay = recv[:, 1:].index_select(0, rorder.reshape(-1))
    return out_keys.reshape(-1), out_pay.view(spec.torch_dtype), total.astype(np.int32)


def _pad_recv(spec: SortSpec, out_keys, out_pay):
    pad = spec.recv_capacity - spec.capacity
    if not pad:
        return out_keys, out_pay
    return (
        torch.cat([out_keys, out_keys.new_full((pad,), _KEY_MAX)]),
        torch.cat([out_pay, out_pay.new_zeros((pad, spec.width))]),
    )


def _sort_body_single(spec: SortSpec, keys, payload, nv: np.ndarray):
    """One executor: one stable sort of the keys and one payload gather.  The
    payload past ``num_valid`` is zeroed, the collective lowering's contract:
    the caller's padding payload must not leak through the permutation."""
    out_keys, order = torch.sort(_masked_keys(keys, nv, spec.capacity).reshape(-1), stable=True)
    out_pay = payload.index_select(0, order)
    out_pay[int(nv[0]):] = 0
    return (*_pad_recv(spec, out_keys, out_pay), nv.astype(np.int32))


def _sort_body_radix(spec: SortSpec, keys, payload, nv: np.ndarray):
    """One executor through K6: key and payload fused into one row tensor,
    sorted by ``radix_sort_rows`` (each row moves once); the fused input is
    dropped and the payload returned is a view of the sorted rows."""
    rows = _fuse(keys, payload)
    rows[int(nv[0]):, 0] = -1  # KEY_MAX's bits: padding sorts last
    rows = radix_sort_rows(rows)
    out_keys = key_values(rows[:, 0])
    # invalid rows (forced KEY_MAX, input tail) sort stably to the back:
    # positions >= nv are exactly them
    out_pay = rows[:, 1:]
    out_pay[int(nv[0]):] = 0
    return (*_pad_recv(spec, out_keys, out_pay.view(spec.torch_dtype)), nv.astype(np.int32))


_BODIES = {"shared": _sort_body, "single": _sort_body_single, "radix": _sort_body_radix}


def build_distributed_sort(devices: Optional[Sequence], spec: SortSpec):
    """The distributed sort for executors on ``devices`` (one entry per
    executor; ``None`` puts every executor on ``cuda``, which must exist).

    Returns ``fn(keys, payload, num_valid) -> (keys_out, payload_out, counts)``:

    * ``keys``: (n * capacity,) int64 (or uint32) tensor of uint32 values on
      the executors' device; shard i is rows ``[i * capacity, ...)``;
    * ``payload``: (n * capacity, width) tensor of ``dtype``, same row order;
    * ``num_valid``: (n,) valid rows per shard (the rest is padding);
    * ``keys_out``: (n * recv_capacity,) int64 — shard j = j-th global key
      range, ascending; KEY_MAX after its valid prefix;
    * ``payload_out``: rows permuted identically, zero after each valid
      prefix.  The sort is **stable**: equal keys keep their global input
      order;
    * ``counts``: (n,) int32 numpy — valid rows per output shard.  A value >
      ``recv_capacity`` means splitter skew overflowed the headroom.
    """
    devices = resolve_devices(devices, spec.num_executors)
    spec = spec.resolve_impl()
    spec.validate()
    if not same_device(devices):
        raise NotImplementedError(
            "executors on different devices need the NCCL exchange, which is not ported "
            "yet (ROADMAP queue A item 4, executors in separate processes)"
        )
    n, cap, body = spec.num_executors, spec.capacity, _BODIES[spec.impl]
    device = devices[0]

    def sort(keys: torch.Tensor, payload: torch.Tensor, num_valid):
        if tuple(keys.shape) != (n * cap,) or tuple(payload.shape) != (n * cap, spec.width):
            raise ValueError(
                f"keys {tuple(keys.shape)} / payload {tuple(payload.shape)} != "
                f"({n * cap},) / ({n * cap}, {spec.width})"
            )
        if payload.dtype != spec.torch_dtype:
            raise ValueError(f"payload dtype {payload.dtype} != spec dtype {spec.torch_dtype}")
        if keys.device != device or payload.device != device:
            raise ValueError(f"keys and payload must be on {device}")
        nv = torch.as_tensor(num_valid).cpu().numpy().astype(np.int64).reshape(n)
        if (nv < 0).any() or (nv > cap).any():
            raise ValueError(f"num_valid must lie in [0, {cap}]")
        return body(spec, keys.to(torch.int64).contiguous(), payload.contiguous(), nv)

    sort.spec = spec
    return sort


def oracle_sort(keys: np.ndarray, payload: np.ndarray):
    """CPU reference: globally sorted (keys, payload) for oracle checks."""
    order = np.argsort(keys, kind="stable")
    return keys[order], payload[order]


def _sort_one_batch(devices, spec: SortSpec, keys: np.ndarray, payload: np.ndarray, max_attempts: int, fns: dict):
    """One <= ``n * capacity``-row chunk through the sort: shard on the host,
    upload, run, retry with doubled ``recv_capacity`` on splitter-skew
    overflow, unpack the valid prefixes.  ``fns`` caches sorts by spec."""
    n = spec.num_executors
    pk, pv, nv = shard_rows_host(
        keys, payload, n, spec.capacity, key_fill=int(KEY_MAX), value_dtype=spec.dtype
    )
    gk = torch.from_numpy(pk.astype(np.int64)).to(devices[0])
    gv = torch.from_numpy(pv).to(devices[0])
    del pk, pv
    attempt_spec = spec
    for _ in range(max_attempts):
        rc = attempt_spec.recv_capacity
        fn = fns.get(attempt_spec)
        if fn is None:
            fn = fns[attempt_spec] = build_distributed_sort(devices, attempt_spec)
        out_keys, out_pay, counts = fn(gk, gv, nv)
        if (counts <= rc).all():
            sk, sp = unpack_shard_prefixes((out_keys.cpu().numpy(), out_pay.cpu().numpy()), counts, rc)
            return sk.astype(np.uint32), sp
        attempt_spec = replace(attempt_spec, recv_capacity=2 * rc)
    raise RuntimeError(
        f"sort overflowed recv_capacity {attempt_spec.recv_capacity // 2} after "
        f"{max_attempts} doublings — key distribution too skewed for range "
        f"partitioning (most keys identical?)"
    )


def run_distributed_sort(devices, spec: SortSpec, keys: np.ndarray, payload: np.ndarray, max_attempts: int = 3):
    """Host driver: shard, run the sort, and retry with doubled
    ``recv_capacity`` when splitter skew overflows a shard (the TeraSort job
    surface).  ``keys``: (T,) uint32; ``payload``: (T, width).  Returns
    (sorted keys, payload rows in the same order) as numpy arrays; raises
    after ``max_attempts`` doublings (most keys identical)."""
    n = spec.num_executors
    devices = resolve_devices(devices, n)
    if keys.shape[0] > n * spec.capacity:
        raise ValueError(f"{keys.shape[0]} rows exceed {n} x {spec.capacity} capacity")
    return _sort_one_batch(devices, spec, keys, payload, max_attempts, {})


def merge_sorted_runs(run_keys, run_payloads):
    """Stable host merge of sorted (keys, payload) runs into one sorted pair —
    the JAX package's numpy merge, unchanged.

    Pairwise ``searchsorted`` merges over (key, global-row-index) only, then
    each run's payload is placed once at its final positions.  Runs must be
    in row order (run i holds earlier input rows than run i+1); equal keys
    from the later run land after the earlier run's."""
    run_keys = [np.asarray(k) for k in run_keys]
    run_payloads = list(run_payloads)
    if not run_keys:
        raise ValueError("no runs to merge")
    if len(run_keys) != len(run_payloads) or any(
        len(k) != len(p) for k, p in zip(run_keys, run_payloads)
    ):
        raise ValueError(
            "run_keys and run_payloads must pair up row-for-row "
            f"({[len(k) for k in run_keys]} keys vs "
            f"{[len(p) for p in run_payloads]} payload rows)"
        )
    offsets = np.cumsum([0] + [len(k) for k in run_keys[:-1]])
    run_idx = [
        np.arange(len(k), dtype=np.int64) + off for k, off in zip(run_keys, offsets)
    ]
    while len(run_keys) > 1:
        nk, ni = [], []
        for i in range(0, len(run_keys) - 1, 2):
            k1, x1 = run_keys[i], run_idx[i]
            k2, x2 = run_keys[i + 1], run_idx[i + 1]
            # output position of each k2 element: its searchsorted-right rank
            # among k1 plus the k2 elements already placed before it
            pos2 = np.searchsorted(k1, k2, side="right") + np.arange(len(k2))
            total = len(k1) + len(k2)
            mk = np.empty(total, k1.dtype)
            mx = np.empty(total, np.int64)
            mask = np.ones(total, bool)
            mask[pos2] = False
            mk[pos2] = k2
            mx[pos2] = x2
            mk[mask] = k1
            mx[mask] = x1
            nk.append(mk)
            ni.append(mx)
        if len(run_keys) % 2:
            nk.append(run_keys[-1])
            ni.append(run_idx[-1])
        run_keys, run_idx = nk, ni
    perm = run_idx[0]
    if len(run_payloads) == 1:
        return run_keys[0], run_payloads[0][perm]
    total = len(perm)
    inv = np.empty(total, np.int64)
    inv[perm] = np.arange(total, dtype=np.int64)  # dest position per global row
    out = np.empty((total, run_payloads[0].shape[1]), run_payloads[0].dtype)
    for off, p in zip(offsets, run_payloads):
        out[inv[off : off + len(p)]] = p
    return run_keys[0], out


def run_external_sort(
    devices,
    spec: SortSpec,
    keys: np.ndarray,
    payload: np.ndarray,
    max_attempts: int = 3,
    fns: Optional[dict] = None,
):
    """Out-of-core TeraSort driver: datasets past one batch of ``num_executors
    * capacity`` rows are sorted in device batches (one sort reused across
    batches), then the sorted runs are merged on the host.  Same contract as
    :func:`run_distributed_sort` (stable, oracle-exact), same skew retry per
    batch.  Pass a dict as ``fns`` to keep the built sorts across calls."""
    n = spec.num_executors
    devices = resolve_devices(devices, n)
    batch = n * spec.capacity
    if fns is None:
        fns = {}
    if keys.shape[0] <= batch:
        return _sort_one_batch(devices, spec, keys, payload, max_attempts, fns)
    run_keys, run_payloads = [], []
    for start in range(0, keys.shape[0], batch):
        sk, sp = _sort_one_batch(
            devices, spec, keys[start : start + batch], payload[start : start + batch],
            max_attempts, fns,
        )
        run_keys.append(sk)
        run_payloads.append(sp)
    return merge_sorted_runs(run_keys, run_payloads)
