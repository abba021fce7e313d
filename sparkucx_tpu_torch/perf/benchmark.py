"""Transport benchmark CLI of the port — the main-path modes of
``sparkucx_tpu/perf/benchmark.py``.

    python -m sparkucx_tpu_torch.perf.benchmark <mode> [flags of the JAX CLI] [--device cpu|cuda]

Every executor of a mode shares one device (``--executors N`` is N logical
executors on it), and the run is on the card unless ``--device cpu`` is
given; without a card it fails.  Each mode keeps the JAX mode's measurement
core (``measure_*``, same name and signature plus ``device=``), its geometry
and the lines it prints; on the card ``torch.cuda.synchronize`` stands where
the JAX mode blocks on its arrays.  The kernels each mode drives (counted by
their wrappers' ``launches``):

* ``superstep`` — ``-o`` chained exchanges (ops/exchange.py
  ``build_exchange``) of ``-s`` bytes per peer slot of 512-byte rows over
  ``--executors`` executors: K1 once per receiver.  ``--slices > 1`` (the
  two-phase route) is not ported.
* ``gather`` — K1 packing ``-n`` blocks of ``-s`` bytes scattered at 2x
  stride through a source buffer, ``-o`` launches a sync.
* ``write`` — one map task staging ``-n`` partitions of ``-s`` bytes into a
  fresh shuffle (store/hbm_store.py) through the ``host`` byte path (seal =
  one upload) and/or the ``device`` path (seal = K2 once).
* ``pipeline`` — ``-n`` rounds of ``-s`` bytes through upload -> exchange ->
  download at each of ``--depths`` (transport/pipeline.py): K1 n a round.
* ``skew`` — the quota-capped plan (ops/skew.py) against the single-shot
  plan on a Zipf-skewed size matrix, bit-identical: K1 n a sub-round.
* ``adaptive`` — ops/planner.py ``AdaptivePlanner`` against every static
  arm over a skew x entropy x fault matrix (the serve legs modeled from the
  measured ``encode_chunk`` of ops/compress.py): K1 n a sub-round.
* ``sort`` — TeraSort rows of 100 B through ops/sort.py: K6 once a sort
  (``--sort-impl radix``, one executor), K1 n a sort (``shared``, n > 1);
  ``--batches B`` drives ``run_external_sort``.
* ``columnar`` — ops/columnar.py repartitioning ``-n`` rows of ``-s`` bytes
  by a random owner vector: K1 n a shuffle.
* ``groupby`` — GROUP BY of 100-byte rows (ops/relational.py
  ``build_grouped_aggregate``, ``--partial`` below the exchange): K1 n a
  query.
* ``join`` — a PK-FK hash join of every ``--join-type`` (ops/relational.py
  ``build_hash_join``): K1 2n a join.
* ``combine`` — the fused-combine exchange (ops/ici_exchange.py
  ``build_combine_exchange``, K4 once a call) against the scheduled
  exchange (K3 once, then K1 n) followed by the plain fold.
* ``ici`` — the scheduled ring (K3, then K1 compaction) against the stock
  exchange at widths 2, 4 and 8, and the fused send side (K5).
* ``measure_quantized_ici`` — the quantized leg of the ``compress`` mode
  (quantize, K3, K1 a receiver, dequantize) against the float32 stock
  exchange; the mode itself waits on its codec legs (``UNPORTED``).

Lowering names map as ``ops/ici_exchange.py`` ``resolve_ici_lowering`` maps
them: ``--impl auto|dma|tiled`` and ``--sort-impl auto|radix|single`` take the
kernel route; the JAX package's portable lowerings (``xla``, ``interpret``,
``dense``) are accepted on CPU executors, where the wrappers run their plain
versions, and refused on the card.  The other modes of the JAX CLI exit 2
naming the ROADMAP queue A item that holds their modules (``UNPORTED``).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from sparkucx_tpu_torch.config import TpuShuffleConf, parse_size
from sparkucx_tpu_torch.utils.devices import resolve_devices, upload
from sparkucx_tpu_torch.utils.stats import StatsAggregator

#: the JAX CLI's modes
MODES = (
    "server", "client", "superstep", "pipeline", "gather", "sort", "columnar", "groupby", "join", "write",
    "skew", "adaptive", "wire", "ici", "combine", "failover", "elastic", "compress", "tenants", "obs",
    "gray", "fanin", "queries",
)

#: modes whose modules are not ported yet -> (ROADMAP queue A item, what it ports)
UNPORTED = {
    **{m: (7, "the wire and serving plane") for m in ("server", "client", "wire", "failover", "tenants", "gray",
                                                       "fanin", "obs")},
    "compress": (7, "the wire and serving plane its codec legs run on"),
    "elastic": (6, "the multi-process bootstrap and elastic path"),
    "queries": (8, "the query runner"),
}

#: executors on different devices, or slices of them: not ported yet
CROSS_DEVICE_ITEM = "ROADMAP queue A item 4, executors in separate processes"

ROW = 512
LANE = ROW // 4


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _executors(device, n: int):
    """``n`` executors sharing ``device``; raises without a card unless the
    CPU is asked for."""
    return resolve_devices([device] * n, None)


def _generator(device: torch.device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def _random_int32(shape, lo: int, hi: int, seed: int, device: torch.device) -> torch.Tensor:
    """Seeded int32 rows in ``[lo, hi)``, made on ``device``: payload bytes
    that only flow through a mode (the JAX mode draws them from numpy; no
    number it reports depends on them)."""
    return torch.randint(lo, hi, shape, generator=_generator(device, seed), device=device, dtype=torch.int32)


def _random_bytes_rows(rows: int, g: torch.Generator, device: torch.device) -> torch.Tensor:
    """``rows`` 512-byte rows of seeded random bytes as ``(rows, 128)`` int32."""
    raw = torch.randint(0, 256, (rows * ROW,), generator=g, device=device, dtype=torch.uint8)
    return raw.view(torch.int32).reshape(rows, LANE)


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    """``t`` on the host, page-locked when it came from the card (so an upload
    of it can be queued without waiting)."""
    if t.device.type != "cuda":
        return t
    return t.cpu().pin_memory()


def _same_rows(a: torch.Tensor, b: torch.Tensor, sizes: np.ndarray, recv_rows: int) -> bool:
    """Every receiver's received rows (the prefix ``sizes`` gives) equal."""
    for j in range(sizes.shape[0]):
        used = int(sizes[:, j].sum())
        lo = j * recv_rows
        if not torch.equal(a[lo : lo + used], b[lo : lo + used]):
            return False
    return True


def max_err_rows(a: torch.Tensor, b: torch.Tensor, sizes: np.ndarray, recv_rows: int) -> float:
    """The largest |a - b| over every receiver's received rows (the prefix
    ``sizes`` gives): the stock exchange leaves the rows past it unspecified."""
    err = 0.0
    for j in range(sizes.shape[0]):
        used = int(sizes[:, j].sum())
        lo = j * recv_rows
        if used:
            err = max(err, float((a[lo : lo + used] - b[lo : lo + used]).abs().max()))
    return err


def _shard_bytes(recv: torch.Tensor, receiver: int, recv_rows: int, rows: int) -> np.ndarray:
    """One receiver's first ``rows`` received rows as flat host bytes."""
    lo = receiver * recv_rows
    return recv[lo : lo + rows].cpu().numpy().reshape(-1).view(np.uint8)


def resolve_gather_impl(impl, device_type: str) -> str:
    """The gather mode's ``--impl`` -> the route: ``'dma'`` (K1).  ``auto``,
    ``dma`` and ``tiled`` name the kernel; ``xla`` and ``interpret`` are
    aliases of it on CPU executors (the wrapper runs its plain version there)
    and an error on the card, which has one route."""
    impl = impl or "auto"
    if impl not in ("auto", "dma", "tiled", "xla", "interpret"):
        raise ValueError(f"unknown gather impl {impl!r} (auto|dma|tiled|xla)")
    if device_type == "cuda" and impl in ("xla", "interpret"):
        raise ValueError(f"gather impl {impl!r}: on the card the gather runs its kernel ('auto', 'dma' or 'tiled')")
    return "dma"


def resolve_sort_impl(sort_impl: str, device_type: str) -> str:
    """The sort mode's ``--sort-impl`` -> a ``SortSpec`` impl.  ``dense``
    (the JAX package's portable lowering) is an alias of ``auto`` on CPU
    executors and an error on the card; ``ragged`` sorts across devices."""
    if sort_impl == "ragged":
        raise NotImplementedError(f"--sort-impl ragged sorts across devices: not ported yet ({CROSS_DEVICE_ITEM})")
    if sort_impl == "dense":
        if device_type == "cuda":
            raise ValueError("--sort-impl dense is the portable lowering: on the card use auto, radix or single")
        return "auto"
    return sort_impl


# ----------------------------------------------------------------------------
# superstep
# ----------------------------------------------------------------------------


def run_superstep(args) -> None:
    from sparkucx_tpu_torch.ops.exchange import ExchangeSpec, build_exchange

    if args.slices > 1:
        raise NotImplementedError(
            f"--slices {args.slices}: the two-phase multi-slice exchange is not ported yet ({CROSS_DEVICE_ITEM})"
        )
    size = parse_size(args.block_size)
    n = args.executors
    devices = _executors(args.device, n)
    dev = devices[0]
    rows_per_peer = max(1, size // ROW)
    send_rows = n * rows_per_peer
    fn = build_exchange(devices, ExchangeSpec(num_executors=n, send_rows=send_rows, recv_rows=send_rows, lane=LANE))
    data = _random_int32((n * send_rows, LANE), -100, 100, 0, dev)
    sizes = np.full((n, n), rows_per_peer, dtype=np.int32)
    out, _ = fn(data, sizes)
    _sync(dev)
    del data
    moved = n * n * rows_per_peer * ROW
    for it in range(args.iterations):
        t0 = time.perf_counter()
        cur = out
        for _ in range(args.outstanding):
            cur, _ = fn(cur, sizes)
        _sync(dev)
        dt = time.perf_counter() - t0
        out = cur
        total = moved * args.outstanding
        # executors sharing one device exchange through K1 (the 'shared' route)
        print(
            f"iter {it}: {total} bytes in {dt*1e3:.1f} ms = {total * 8 / dt / 1e6:.0f} Mb/s "
            f"({total / dt / 1e9:.2f} GB/s) [impl=shared]",
            flush=True,
        )


# ----------------------------------------------------------------------------
# pipeline
# ----------------------------------------------------------------------------


def measure_pipeline(
    executors: int, round_bytes: int, rounds: int, iterations: int,
    depths=(1, 2, 3), report=None, device="cuda",
) -> dict:
    """Measurement core of the ``pipeline`` mode — multi-round (spilled)
    shuffle throughput with host staging in the loop, at several pipeline
    depths: every round pays upload -> exchange -> download, and depth d
    keeps d rounds in flight (transport/pipeline.py; the drain waits on the
    round's event on a worker thread).  Returns ``{depth: best GB/s of
    payload moved}``; ``report(depth, it, seconds, bytes)`` per iteration."""
    from sparkucx_tpu_torch.ops.exchange import ExchangeSpec, bucket_send_rows, build_exchange
    from sparkucx_tpu_torch.transport.pipeline import RoundPipeline
    from sparkucx_tpu_torch.transport.tpu import _copy_to_host, _record_event

    n = executors
    devices = _executors(device, n)
    dev = devices[0]
    rows_per_peer = max(1, round_bytes // (ROW * n))
    send_rows = bucket_send_rows(n * rows_per_peer, n)
    fn = build_exchange(devices, ExchangeSpec(num_executors=n, send_rows=send_rows, recv_rows=send_rows, lane=LANE))
    # the rounds live on the host, page-locked: each upload is queued, not waited for
    host_rounds = [_host_copy(_random_int32((n * send_rows, LANE), -100, 100, r, dev)) for r in range(rounds)]
    sizes = np.full((n, n), rows_per_peer, dtype=np.int32)
    moved_per_round = n * n * rows_per_peer * ROW
    results = {}
    for depth in depths:

        def submit(rnd):
            data = host_rounds[rnd].to(dev, non_blocking=True)  # upload
            recv, _ = fn(data, sizes)                            # exchange
            shards = [_copy_to_host(recv[j * send_rows : (j + 1) * send_rows]) for j in range(n)]
            return shards, _record_event(dev)                   # download queued

        def drain(rnd, ticket):
            shards, event = ticket
            if event is not None:
                event.synchronize()
            for a in shards:
                a.numpy()  # observe completion: the host copy is readable
            return None

        pipe = RoundPipeline(depth, submit, drain, name=f"bench.pipeline.d{depth}")
        pipe.run(rounds)  # warmup: first uploads and downloads
        best = 0.0
        for it in range(iterations):
            t0 = time.perf_counter()
            pipe.run(rounds)
            dt = time.perf_counter() - t0
            tot = moved_per_round * rounds
            best = max(best, tot / dt / 1e9)
            if report is not None:
                report(depth, it, dt, tot)
        results[depth] = best
    return results


def run_pipeline(args) -> None:
    size = parse_size(args.block_size)
    depths = tuple(int(d) for d in args.depths.split(","))

    def report(depth, it, dt, tot):
        print(
            f"depth {depth} iter {it}: {args.num_blocks} rounds x {size} B in "
            f"{dt*1e3:.1f} ms = {tot / dt / 1e9:.2f} GB/s",
            flush=True,
        )

    results = measure_pipeline(
        args.executors, size, args.num_blocks, args.iterations, depths=depths, report=report, device=args.device,
    )
    base = results.get(1)
    for depth, gbps in sorted(results.items()):
        speedup = f" ({gbps / base:.2f}x vs serial)" if base and depth != 1 else ""
        print(f"pipeline depth {depth}: {gbps:.2f} GB/s{speedup}", flush=True)


# ----------------------------------------------------------------------------
# gather
# ----------------------------------------------------------------------------


def measure_gather(
    num_blocks: int, block_bytes: int, iterations: int, outstanding: int,
    impl: str | None = None, report=None, device="cuda",
) -> float:
    """Measurement core of the ``gather`` mode — the device-side ragged block
    gather (K1, the reply-packing hot path): ``num_blocks`` blocks of
    ``block_bytes`` scattered at 2x stride through a source buffer, packed
    into one buffer ``outstanding`` times a sync.  Returns best GB/s;
    ``report(it, seconds, bytes, impl)`` per iteration."""
    from sparkucx_tpu_torch.ops.block_kernels import block_gather, pack_plan, plan_tensors

    dev = _executors(device, 1)[0]
    route = resolve_gather_impl(impl, dev.type)
    rows_each = max(1, block_bytes // ROW)
    b = num_blocks
    src = _random_int32((2 * b * rows_each, LANE), -100, 100, 0, dev)
    plan = [(2 * i * rows_each * ROW, rows_each * ROW) for i in range(b)]
    starts, counts, outs, total = pack_plan(plan, ROW)
    s, c, o = plan_tensors(starts, counts, outs, dev)
    out = block_gather(s, c, o, src, total)
    # block i sits at rows [2i, 2i + 1) x rows_each of the source
    assert torch.equal(out.view(b, rows_each, LANE), src.view(b, 2, rows_each, LANE)[:, 0]), (
        "gather packed the wrong rows"
    )
    del out
    moved = total * ROW
    best = 0.0
    for it in range(iterations):
        t0 = time.perf_counter()
        for _ in range(outstanding):
            block_gather(s, c, o, src, total)
        _sync(dev)
        dt = time.perf_counter() - t0
        tot = moved * outstanding
        best = max(best, tot / dt / 1e9)
        if report is not None:
            report(it, dt, tot, route)
    return best


def run_gather(args) -> None:
    size = parse_size(args.block_size)
    rows_each = max(1, size // ROW)

    def report(it, dt, tot, impl):
        print(
            f"iter {it}: {args.num_blocks} blocks x {rows_each * ROW} B packed "
            f"{args.outstanding}x: {tot} bytes in {dt*1e3:.1f} ms = "
            f"{tot / dt / 1e9:.2f} GB/s [impl={impl}]",
            flush=True,
        )

    measure_gather(
        args.num_blocks, size, args.iterations, args.outstanding,
        impl=None if args.impl == "auto" else args.impl, report=report, device=args.device,
    )


# ----------------------------------------------------------------------------
# write
# ----------------------------------------------------------------------------


def measure_write(
    num_blocks: int, block_bytes: int, iterations: int, impls=("host", "device"), report=None, device="cuda",
) -> dict:
    """Measurement core of the ``write`` mode — map-output staging throughput,
    host byte path against device staging path.

    ``host``: ``MapWriter.write_partition`` copies bytes into host staging and
    ``seal`` uploads the whole buffer.  ``device``: ``write_partition_device``
    keeps the blocks on the device and ``seal`` places them with the block
    scatter (K2, one launch).  One map task writes ``num_blocks`` partitions of
    ``block_bytes`` into a fresh shuffle per iteration; the clock covers write
    -> seal -> payload ready.  Iteration 0 is a warm-up whose sealed payload is
    checked against the written blocks.  Returns ``{impl: best GB/s}``;
    ``report(impl, it, seconds, bytes)`` per iteration."""
    from sparkucx_tpu_torch.store.hbm_store import HbmBlockStore

    dev = _executors(device, 1)[0]
    rows_each = max(1, block_bytes // ROW)
    total = num_blocks * rows_each * ROW
    conf = TpuShuffleConf(
        device_staging=True, staging_capacity_per_executor=max(2 * total, 1 << 20), spill_to_disk=False,
    )
    for impl in impls:
        if impl not in ("host", "device"):
            raise ValueError(f"unknown write impl {impl!r} (host|device)")
    g = _generator(dev, 0)
    dev_blocks = [_random_bytes_rows(rows_each, g, dev) for _ in range(num_blocks)]
    host_blocks = [b.cpu().numpy().tobytes() for b in dev_blocks] if "host" in impls else []
    _sync(dev)
    results = {}
    for impl in impls:
        store = HbmBlockStore(conf, device=dev)
        best = 0.0
        for it in range(iterations + 1):  # iteration 0 = warm-up
            sid = it
            store.create_shuffle(sid, 1, num_blocks)
            t0 = time.perf_counter()
            w = store.map_writer(sid, 0)
            for r in range(num_blocks):
                if impl == "host":
                    w.write_partition(r, host_blocks[r])
                else:
                    w.write_partition_device(r, dev_blocks[r])
            w.commit()
            payload = store.seal(sid)[-1][0]
            _sync(dev)
            dt = time.perf_counter() - t0
            if it == 0:
                assert payload.device == dev and all(
                    torch.equal(payload[r * rows_each : (r + 1) * rows_each], blk) for r, blk in enumerate(dev_blocks)
                ), f"the {impl} seal placed the blocks wrong"
            del payload
            store.remove_shuffle(sid)
            if it == 0:
                continue
            best = max(best, total / dt / 1e9)
            if report is not None:
                report(impl, it - 1, dt, total)
        store.close()
        results[impl] = best
    return results


def run_write(args) -> None:
    size = parse_size(args.block_size)
    impls = ("host", "device") if args.impl == "auto" else tuple(s.strip() for s in args.impl.split(",") if s.strip())

    def report(impl, it, dt, tot):
        print(
            f"iter {it}: staged {args.num_blocks} x {size} B via {impl} path in "
            f"{dt*1e3:.1f} ms = {tot / dt / 1e9:.2f} GB/s",
            flush=True,
        )

    results = measure_write(args.num_blocks, size, args.iterations, impls=impls, report=report, device=args.device)
    host = results.get("host")
    for impl in impls:
        gbps = results[impl]
        speedup = f" ({gbps / host:.2f}x vs host)" if host and impl == "device" else ""
        print(f"write {impl}: {gbps:.2f} GB/s{speedup}", flush=True)


# ----------------------------------------------------------------------------
# skew
# ----------------------------------------------------------------------------


def zipf_size_matrix(executors: int, max_peer_rows: int, alpha: float) -> np.ndarray:
    """A deterministic Zipf-skewed exchange size matrix: ``sizes[i, j]`` rows
    from sender i to destination j follow ``(rank + 1) ** -alpha`` scaled so
    each sender's hottest lane is ``max_peer_rows`` (min 1 row), with the rank
    order permuted per sender (seeded) so the hot destination varies — the
    JAX package's matrix, value for value."""
    n = executors
    rng = np.random.default_rng(0)
    weights = (np.arange(1, n + 1, dtype=np.float64)) ** (-alpha)
    base = np.maximum(1, np.round(max_peer_rows * weights / weights[0])).astype(np.int64)
    sizes = np.empty((n, n), dtype=np.int32)
    for i in range(n):
        sizes[i] = base[rng.permutation(n)]
    return sizes


def measure_skew(
    executors: int, max_peer_rows: int, iterations: int,
    zipf_alpha: float = 1.2, quota_rows: int = 0, report=None, device="cuda",
) -> dict:
    """Measurement core of the ``skew`` mode — the quota-capped plan
    (ops/skew.py) against the max-sized single-shot plan on a Zipf-skewed
    shuffle.

    The max plan stages every peer slot at the hottest lane's pow2 bucket: one
    exchange, most of it padding.  The quota plan caps the slot at
    ``quota_rows`` (0 = the pow2 ceiling of the mean lane size) and chunks
    hot lanes across sub-round exchanges.  Each shot uploads its staged rows
    from pageable host memory, as the JAX mode's ``device_put`` does, and
    exchanges them (K1 n a sub-round).  Both produce
    bit-identical receive bytes (asserted); the result carries effective GB/s
    (useful bytes / wall time), staged rows, dense wire bytes and padding
    fraction per plan.  ``report(plan, it, seconds, bytes)`` per
    iteration."""
    from sparkucx_tpu_torch.ops.exchange import ExchangeSpec, bucket_send_rows, build_exchange
    from sparkucx_tpu_torch.ops.skew import (
        chunk_size_rows, plan_exchange, quota_slot_rows, reassemble_round, slice_subround,
    )

    n = executors
    devices = _executors(device, n)
    dev = devices[0]
    sizes = zipf_size_matrix(n, max_peer_rows, zipf_alpha)
    slot = bucket_send_rows(int(sizes.max()) * n, n) // n  # the max plan's slot
    if quota_rows <= 0:
        quota_rows = int(quota_slot_rows(slot, int(np.ceil(sizes.mean()))))
    plan = plan_exchange([int(sizes.max())], slot, quota_rows)
    q = plan.slot_rows

    # slot-layout staging payload per sender on the host, hot lanes filled to
    # their size, the rest of every slot zero
    used_mask = torch.arange(slot)[None, :] < torch.from_numpy(sizes.astype(np.int64))[:, :, None]
    payloads = []
    for i in range(n):
        p = _random_int32((n, slot, LANE), -100, 100, 1 + i, dev)
        p *= used_mask[i].to(dev)[:, :, None]
        payloads.append(p.reshape(n * slot, LANE).cpu())
    used_rows = int(sizes.sum())
    useful_bytes = used_rows * ROW

    def run_max():
        fn = build_exchange(devices, ExchangeSpec(num_executors=n, send_rows=n * slot, recv_rows=n * slot, lane=LANE))
        data_host = torch.cat(payloads)

        def shot():
            recv, rs = fn(data_host.to(dev), sizes)
            _sync(dev)
            return recv, rs

        recv, rs = shot()  # warm-up + the reference output
        rs = rs.numpy()
        shards = [_shard_bytes(recv, j, n * slot, int(rs[j].sum())) for j in range(n)]
        del recv
        best = 0.0
        for it in range(iterations):
            t0 = time.perf_counter()
            shot()
            dt = time.perf_counter() - t0
            best = max(best, useful_bytes / dt / 1e9)
            if report is not None:
                report("max", it, dt, useful_bytes)
        return shards, best, n * n * slot

    def run_quota():
        fn = build_exchange(devices, ExchangeSpec(num_executors=n, send_rows=n * q, recv_rows=n * q, lane=LANE))
        nchunks = plan.chunks_per_round[0]
        sub_size_mats = [np.stack([chunk_size_rows(sizes[i], c, q) for i in range(n)]) for c in range(nchunks)]

        def shot():
            outs = []
            for c in range(nchunks):
                data = torch.cat([slice_subround(p, n, c, q) for p in payloads])
                recv, _ = fn(data.to(dev), sub_size_mats[c])
                outs.append(recv)
            _sync(dev)
            return outs

        outs = shot()  # warm-up + the compared output
        shards = []
        for j in range(n):
            # consumer j reassembles from column j (rows j received per sender)
            sub_sizes = [m[:, j] for m in sub_size_mats]
            sub_shards = [_shard_bytes(o, j, n * q, n * q) for o in outs]
            shards.append(reassemble_round(sub_shards, sub_sizes, ROW))
        del outs
        best = 0.0
        for it in range(iterations):
            t0 = time.perf_counter()
            shot()
            dt = time.perf_counter() - t0
            best = max(best, useful_bytes / dt / 1e9)
            if report is not None:
                report("quota", it, dt, useful_bytes)
        return shards, best, plan.staged_rows(n)

    max_shards, max_gbps, max_staged = run_max()
    quota_shards, quota_gbps, quota_staged = run_quota()
    for j in range(n):
        assert np.array_equal(quota_shards[j], max_shards[j]), f"quota plan diverged from single-shot on consumer {j}"
    return {
        "executors": n,
        "zipf_alpha": zipf_alpha,
        "max_peer_rows": int(sizes.max()),
        "quota_slot": q,
        "subrounds": plan.num_subrounds,
        "used_rows": used_rows,
        "bit_identical": True,
        "max": {
            "gbps": max_gbps,
            "staged_rows": max_staged,
            "wire_bytes": max_staged * ROW,
            "padding_fraction": 1.0 - used_rows / max_staged,
        },
        "quota": {
            "gbps": quota_gbps,
            "staged_rows": quota_staged,
            "wire_bytes": quota_staged * ROW,
            "padding_fraction": 1.0 - used_rows / quota_staged,
        },
    }


def run_skew(args) -> None:
    size = parse_size(args.block_size)
    max_peer_rows = max(1, size // ROW)

    def report(plan, it, dt, tot):
        print(f"{plan} iter {it}: {tot} useful bytes in {dt*1e3:.1f} ms = {tot / dt / 1e9:.2f} GB/s", flush=True)

    r = measure_skew(
        args.executors, max_peer_rows, args.iterations, zipf_alpha=args.zipf_alpha, quota_rows=args.quota,
        report=report, device=args.device,
    )
    print(
        f"zipf(alpha={r['zipf_alpha']}) over {r['executors']} executors: "
        f"hottest lane {r['max_peer_rows']} rows, quota slot {r['quota_slot']} "
        f"rows, {r['subrounds']} sub-rounds",
        flush=True,
    )
    for plan in ("max", "quota"):
        p = r[plan]
        print(
            f"{plan:5} plan: {p['gbps']:.2f} GB/s effective, "
            f"{p['staged_rows']} staged rows, {p['wire_bytes']} wire bytes "
            f"(dense), padding {p['padding_fraction']:.1%}",
            flush=True,
        )
    staged_cut = r["max"]["staged_rows"] / max(r["quota"]["staged_rows"], 1)
    print(f"quota plan stages {staged_cut:.2f}x fewer rows; outputs bit-identical", flush=True)


# ----------------------------------------------------------------------------
# adaptive
# ----------------------------------------------------------------------------


def measure_adaptive(
    executors: int = 8, max_peer_rows: int = 2048, iterations: int = 2,
    link_gbps: float = 1.0, stall_ms: float = 40.0, report=None, device="cuda",
) -> dict:
    """Measurement core of the ``adaptive`` mode — the telemetry-fed
    ``AdaptivePlanner`` (ops/planner.py) against every static configuration on
    a skew x payload-entropy x fault cell matrix, as the JAX mode runs it.

    Per cell the EXCHANGE leg is measured (``measure_skew``'s machinery:
    upload and exchange per sub-round, best-of-N wall time, bit-equality of
    every chunked schedule's reassembled shards against the single-shot
    reference), while the SERVE legs are modeled from measured inputs: codec
    cost = measured ``encode_chunk`` time + shipped bytes / ``link_gbps``
    (encoded bytes measured per cell payload), and the fault cell charges a
    gray straggler of ``5 x stall_ms`` to any config that does not hedge,
    against ``hedge_ms + one peer-shard refetch`` for one that does.

    Static candidates: quota arms {single-shot, slot/4, slot/2} that stage
    fewer rows than single-shot, x codec {off, rle}, hedging off.  The
    adaptive arm builds real ``PlanSignals`` per cell and runs whatever plan
    ``AdaptivePlanner`` returns.  Reported per cell: every arm's effective
    GB/s, the static oracle (best arm), the adaptive arm's distance from it,
    the plan fields it chose, and (this port's addition) the staged rows of
    every exchange schedule the cell ran (``staged_rows``, keyed by
    quota)."""
    from sparkucx_tpu_torch.ops.compress import CompressSpec, encode_chunk
    from sparkucx_tpu_torch.ops.exchange import ExchangeSpec, bucket_send_rows, build_exchange
    from sparkucx_tpu_torch.ops.planner import AdaptivePlanner, PlanContext, PlanSignals
    from sparkucx_tpu_torch.ops.skew import chunk_size_rows, plan_exchange, reassemble_round, slice_subround

    n = executors
    devices = _executors(device, n)
    dev = devices[0]
    fns: dict = {}

    def exchange_fn(rows):
        fn = fns.get(rows)
        if fn is None:
            fn = fns[rows] = build_exchange(
                devices, ExchangeSpec(num_executors=n, send_rows=rows, recv_rows=rows, lane=LANE)
            )
        return fn

    def prepare_arm(payloads, sizes, slot, quota):
        """One quota arm's exchange leg, warmed up, with its reassembled
        shards for the bit-equality gate and the replayable ``shot`` (timed
        later, interleaved across arms).  quota == 0 is the single-shot arm."""
        plan = plan_exchange([int(sizes.max())], slot, quota)
        q, nchunks = plan.slot_rows, plan.chunks_per_round[0]
        fn = exchange_fn(n * q)
        sub_size_mats = [np.stack([chunk_size_rows(sizes[i], c, q) for i in range(n)]) for c in range(nchunks)]
        sub_payloads = [torch.cat([slice_subround(p, n, c, q) for p in payloads]) for c in range(nchunks)]

        def shot():
            outs = []
            for c in range(nchunks):
                recv, _ = fn(sub_payloads[c].to(dev), sub_size_mats[c])
                outs.append(recv)
            _sync(dev)
            return outs

        outs = shot()  # warm-up + the compared output
        shards = []
        for j in range(n):
            sub_shards = [_shard_bytes(o, j, n * q, n * q) for o in outs]
            shards.append(bytes(reassemble_round(sub_shards, [m[:, j] for m in sub_size_mats], ROW)))
        return {"shot": shot, "shards": shards, "staged": plan.staged_rows(n), "best": float("inf")}

    rle = CompressSpec(codec="rle", min_chunk_bytes=0)
    straggler_s = 5.0 * stall_ms / 1e3  # gray tail: well past the p99 signal

    def serve_time(raw_bytes, enc_bytes, enc_s, codec, hedge_ms, fault):
        ship = enc_bytes if codec != "off" else raw_bytes
        t = ship / (link_gbps * 1e9) + (enc_s if codec != "off" else 0.0)
        if fault == "degraded":
            if hedge_ms <= 0:
                t += straggler_s
            else:
                t += min(straggler_s, hedge_ms / 1e3) + (raw_bytes / n / (link_gbps * 1e9))
        return t

    cells = []
    rng = np.random.default_rng(3)
    base = 512  # pow2 floor of the requested hottest lane, min 512
    while base * 2 <= max_peer_rows:
        base *= 2
    for alpha in (0.0, 1.8):
        # balanced cells stage padding-free at a pow2 hottest lane; skewed
        # cells put the hottest lane just past the pow2 boundary
        hot = base if alpha == 0.0 else base * 5 // 4
        sizes = zipf_size_matrix(n, hot, alpha)
        slot = bucket_send_rows(int(sizes.max()) * n, n) // n
        used_rows = int(sizes.sum())
        useful = used_rows * ROW
        # static quota candidates keep only footprints distinct from single-shot
        single_staged = plan_exchange([int(sizes.max())], slot, 0).staged_rows(n)
        quotas = sorted(
            q
            for q in {0, max(256, slot // 4), max(256, slot // 2)}
            if q == 0 or plan_exchange([int(sizes.max())], slot, q).staged_rows(n) < single_staged
        )
        for entropy in ("low", "high"):
            # slot-layout payloads: zeros (RLE-collapsible) or full-range
            # random rows (incompressible), drawn from the JAX mode's seed
            payloads = []
            for i in range(n):
                p = np.zeros((n * slot, LANE), dtype=np.int32)
                if entropy == "high":
                    for j in range(n):
                        p[j * slot : j * slot + sizes[i, j]] = rng.integers(
                            -(2**30), 2**30, size=(int(sizes[i, j]), LANE), dtype=np.int32
                        )
                payloads.append(torch.from_numpy(p))
            # arms cached by realized schedule (slot, chunks)
            arm_cache: dict = {}

            def arm(quota):
                p = plan_exchange([int(sizes.max())], slot, quota)
                key = (p.slot_rows, p.chunks_per_round[0])
                if key not in arm_cache:
                    arm_cache[key] = prepare_arm(payloads, sizes, slot, quota)
                return arm_cache[key]

            conf = TpuShuffleConf(
                planner_mode="adaptive", wire_compress_codec="rle", fetch_hedge_ms=1,
                fetch_hedge_max_ms=int(stall_ms * 4),
            )

            def plan_ctx(signals):
                return PlanContext(
                    num_executors=n, staging_slot_rows=slot, round_max_rows=(int(sizes.max()),),
                    used_rows_total=used_rows, row_bytes=ROW, platform=dev.type, signals=signals,
                )

            # the adaptive quota is geometry-only, known before any fault cell
            neutral = AdaptivePlanner(conf).plan(plan_ctx(PlanSignals()))
            ad_q = 0 if neutral.single_shot else neutral.slot_rows
            ref = arm(0)["shards"]  # single-shot reference shards
            for q in sorted(set(quotas) | {ad_q}):
                shards = arm(q)["shards"]
                for j in range(n):
                    assert shards[j] == ref[j], f"quota {q} diverged from single-shot on consumer {j}"
            # interleaved best-of timing: a slow spell hits all arms alike
            for _ in range(max(2, iterations)):
                for a in arm_cache.values():
                    t0 = time.perf_counter()
                    a["shot"]()
                    a["best"] = min(a["best"], time.perf_counter() - t0)
            # measured codec leg on the reference shards: encoded bytes + encode seconds
            enc_bytes, t0 = 0, time.perf_counter()
            for shard in ref:
                _, enc = encode_chunk(rle, shard)
                enc_bytes += len(enc) if enc is not None else len(shard)
            enc_s = time.perf_counter() - t0
            staged = {q: arm(q)["staged"] for q in sorted(set(quotas) | {ad_q})}
            for fault in ("none", "degraded"):
                statics = {}
                for q in quotas:
                    ex_s = arm(q)["best"]
                    for codec in ("off", "rle"):
                        name = f"{'single' if q == 0 else f'q{q}'}/{codec}"
                        t = ex_s + serve_time(useful, enc_bytes, enc_s, codec, 0, fault)
                        statics[name] = useful / t / 1e9
                signals = PlanSignals(
                    rx_stall_p99_ns=int(stall_ms * 1e6) if fault == "degraded" else 0,
                    worst_peer_health=0.3 if fault == "degraded" else 1.0,
                    compression_ratio=useful / max(enc_bytes, 1),
                )
                plan = AdaptivePlanner(conf).plan(plan_ctx(signals))
                assert (0 if plan.single_shot else plan.slot_rows) == ad_q
                ad_ex_s = arm(ad_q)["best"]
                hedge = plan.hedge_ms if fault == "degraded" else 0
                ad_t = ad_ex_s + serve_time(useful, enc_bytes, enc_s, plan.codec, hedge, fault)
                ad_gbps = useful / ad_t / 1e9
                oracle_name, oracle_gbps = max(statics.items(), key=lambda kv: kv[1])
                cell = {
                    "alpha": alpha,
                    "entropy": entropy,
                    "fault": fault,
                    "static_gbps": {k: round(v, 4) for k, v in statics.items()},
                    "oracle": oracle_name,
                    "oracle_gbps": round(oracle_gbps, 4),
                    "adaptive_gbps": round(ad_gbps, 4),
                    "distance_from_oracle": round(1.0 - ad_gbps / oracle_gbps, 4),
                    "adaptive_choice": {
                        "quota": ad_q,
                        "codec": plan.codec,
                        "hedge_ms": plan.hedge_ms,
                        "subrounds": plan.num_subrounds,
                    },
                    "staged_rows": staged,
                    "bit_identical": True,
                }
                cells.append(cell)
                if report is not None:
                    report(cell)
            del arm_cache, payloads
    # aggregate: each static config held fixed across the matrix against the
    # adaptive planner re-planning per cell
    static_names = sorted({k for c in cells for k in c["static_gbps"]})
    agg_static = {name: sum(c["static_gbps"].get(name, 0.0) for c in cells) / len(cells) for name in static_names}
    agg_adaptive = sum(c["adaptive_gbps"] for c in cells) / len(cells)
    best_static = max(agg_static.items(), key=lambda kv: kv[1])
    return {
        "executors": n,
        "max_peer_rows": max_peer_rows,
        "link_gbps_model": link_gbps,
        "stall_ms_model": stall_ms,
        "cells": cells,
        "aggregate_static_gbps": {k: round(v, 4) for k, v in agg_static.items()},
        "aggregate_adaptive_gbps": round(agg_adaptive, 4),
        "best_static": best_static[0],
        "best_static_gbps": round(best_static[1], 4),
        "adaptive_beats_every_static": agg_adaptive >= best_static[1],
        "worst_cell_distance": round(max(c["distance_from_oracle"] for c in cells), 4),
    }


def run_adaptive(args) -> None:
    size = parse_size(args.block_size)
    max_peer_rows = max(512, size // ROW)

    def report(cell):
        print(
            f"cell alpha={cell['alpha']} entropy={cell['entropy']} "
            f"fault={cell['fault']}: adaptive {cell['adaptive_gbps']:.3f} GB/s "
            f"(chose quota={cell['adaptive_choice']['quota']} "
            f"codec={cell['adaptive_choice']['codec']} "
            f"hedge={cell['adaptive_choice']['hedge_ms']}ms) vs oracle "
            f"{cell['oracle']} {cell['oracle_gbps']:.3f} GB/s "
            f"(distance {cell['distance_from_oracle']:+.1%})",
            flush=True,
        )

    r = measure_adaptive(args.executors, max_peer_rows, args.iterations, report=report, device=args.device)
    print(
        f"aggregate over {len(r['cells'])} cells: adaptive "
        f"{r['aggregate_adaptive_gbps']:.3f} GB/s vs best static "
        f"{r['best_static']} {r['best_static_gbps']:.3f} GB/s "
        f"(beats every static: {r['adaptive_beats_every_static']}); "
        f"worst cell distance {r['worst_cell_distance']:+.1%}; "
        f"outputs bit-identical",
        flush=True,
    )


# ----------------------------------------------------------------------------
# ici
# ----------------------------------------------------------------------------


def measure_ici(
    executors_list=(2, 4, 8), slot_rows: int = 1024, lane: int = 128,
    chunks_per_dest: int = 0, iterations: int = 5, report=None, stats=None, device="cuda",
) -> dict:
    """Measurement core of the ``ici`` mode: the scheduled ring exchange
    (ops/ici_exchange.py ``build_ici_exchange``: K3, then K1 compaction) head
    to head with the stock exchange (ops/exchange.py ``build_exchange``: K1
    per receiver) at each width of ``executors_list``, executors sharing
    ``device`` (so the widths are not clamped by a device count).  Per width,
    both are fed the same seeded slot-layout payload with ragged per-peer
    sizes, held bit-identical (every receiver's rows and the receive sizes),
    then timed over ``iterations`` of four chained exchanges each.  At the
    widest width the fused send side (``build_fused_ici_exchange``: K5, then
    K1) is held against scatter-then-stock, with K5's launch count.

    Bandwidth is aggregate GB/s (bytes sent to other executors / wall
    seconds) and, as the JAX mode prints it, per link = aggregate / 2n, the
    share of one of a bidirectional ring's 2n directed links; executors
    sharing one card have no links, so there it is only aggregate / 2n.
    ``report(impl, n, it, seconds, bytes)`` per iteration; per-width link
    occupancy and slot padding land in ``stats`` under ``ici_n{n}``."""
    from sparkucx_tpu_torch.ops.block_kernels import block_scatter
    from sparkucx_tpu_torch.ops.exchange import ExchangeSpec, build_exchange
    from sparkucx_tpu_torch.ops.ici_exchange import (
        DEFAULT_CHUNKS_PER_DEST,
        build_fused_ici_exchange,
        build_ici_exchange,
        step_occupancy,
    )
    from sparkucx_tpu_torch.ops.ring_kernels import fused_scatter_ring_grid, ring_exchange_grid

    dev = resolve_devices([device], None)[0]
    if chunks_per_dest <= 0:
        chunks_per_dest = DEFAULT_CHUNKS_PER_DEST
    widths = sorted({int(n) for n in executors_list if n >= 2})
    if not widths:
        raise ValueError(f"ici mode needs widths >= 2, got {executors_list}")
    row_bytes = lane * 4
    slot = max(chunks_per_dest, slot_rows)
    per_n: dict = {}
    for n in widths:
        send_rows = n * slot
        spec = ExchangeSpec(n, send_rows, send_rows, lane)
        stock = build_exchange([dev] * n, spec)
        pallas = build_ici_exchange([dev] * n, spec, chunks_per_dest=chunks_per_dest)
        sched = pallas.schedule
        rng = np.random.default_rng(7)
        sizes = rng.integers(1, slot + 1, size=(n, n)).astype(np.int32)
        data = torch.from_numpy(rng.integers(-100, 100, size=(n * send_rows, lane), dtype=np.int32)).to(dev)
        recv_s, rs_s = stock(data, sizes)
        recv_p, rs_p = pallas(data, sizes)
        _sync(dev)
        assert torch.equal(rs_s, rs_p), f"recv_sizes diverged at n={n}"
        assert _same_rows(recv_s, recv_p, sizes, send_rows), f"scheduled exchange diverged from stock at n={n}"
        del recv_s, recv_p
        # every executor ships (n-1) remote slots per exchange
        remote_bytes = n * (n - 1) * slot * row_bytes

        def time_impl(name, fn):
            best = 0.0
            for it in range(iterations):
                _sync(dev)
                t0 = time.perf_counter()
                cur = data
                for _ in range(4):  # chained: each receive buffer feeds the next exchange
                    cur, _ = fn(cur, sizes)
                _sync(dev)
                dt = time.perf_counter() - t0
                best = max(best, 4 * remote_bytes / dt / 1e9)
                if report is not None:
                    report(name, n, it, dt, 4 * remote_bytes)
            return best

        stock_gbps = time_impl("stock", stock)
        pallas_gbps = time_impl("pallas", pallas)
        occ = step_occupancy(sched)
        if stats is not None:
            stats.record_counters(
                f"ici_n{n}",
                supersteps=sched.num_steps,
                busy_link_slots=sum(b for b, _ in occ),
                idle_link_slots=sum(i for _, i in occ),
                superstep_span_ns=int(remote_bytes / max(pallas_gbps, 1e-9) / sched.num_steps),
            )
            used = int(sizes.sum())
            stats.record_rows(f"ici_n{n}", used, n * n * slot - used)
        per_n[n] = {
            "stock_gbps": stock_gbps,
            "pallas_gbps": pallas_gbps,
            "pallas_per_link_gbps": pallas_gbps / (2 * n),
            "stock_per_link_gbps": stock_gbps / (2 * n),
            "supersteps": sched.num_steps,
            "chunks": sched.chunks,
            "lowering": pallas.lowering,
            "bit_identical": True,
        }
        del data

    # the fused send side at the widest width: one block per destination,
    # packed back to back per sender, against the staged layout built on the
    # host and exchanged by the stock path
    n = widths[-1]
    send_rows = n * slot
    spec = ExchangeSpec(n, send_rows, send_rows, lane)
    rng = np.random.default_rng(11)
    sizes = rng.integers(1, slot + 1, size=(n, n)).astype(np.int32)
    starts, counts, outs = (np.zeros((n, n), dtype=np.int32) for _ in range(3))
    packed = np.zeros((n * send_rows, lane), dtype=np.int32)
    staged = np.zeros((n * send_rows, lane), dtype=np.int32)
    for i in range(n):
        off = 0
        for j in range(n):
            c = int(sizes[i, j])
            rows = rng.integers(-100, 100, size=(c, lane), dtype=np.int32)
            packed[i * send_rows + off : i * send_rows + off + c] = rows
            staged[i * send_rows + j * slot : i * send_rows + j * slot + c] = rows
            starts[i, j], counts[i, j], outs[i, j] = j * slot, c, off
            off += c
    fused = build_fused_ici_exchange([dev] * n, spec, n, chunks_per_dest=chunks_per_dest, max_block_rows=slot)
    recv_ref, rs_ref = build_exchange([dev] * n, spec)(torch.from_numpy(staged).to(dev), sizes)
    put = lambda a: torch.from_numpy(a).to(dev)
    staging = torch.zeros((n * send_rows, lane), dtype=torch.int32, device=dev)
    counters = (fused_scatter_ring_grid, block_scatter, ring_exchange_grid)
    before = [k.launches for k in counters]
    recv_f, rs_f = fused(put(starts), put(counts), put(outs), put(packed), staging, sizes)
    _sync(dev)
    k5, k2, k3 = (k.launches - b for k, b in zip(counters, before))
    assert torch.equal(rs_ref, rs_f), "fused recv_sizes diverged"
    assert _same_rows(recv_ref, recv_f, sizes, send_rows), "fused scatter+exchange diverged from scatter-then-exchange"
    if dev.type == "cuda":
        assert (k5, k2, k3) == (1, 0, 0), f"fused send side launched K5 {k5}, K2 {k2}, K3 {k3} times"
    return {
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "slot_rows": slot,
        "chunks_per_dest": chunks_per_dest,
        "per_n": per_n,
        "fused": {
            "executors": n,
            "bit_identical": True,
            # one call covers scatter AND exchange; the reference needs a
            # separate staging call before its exchange
            "launches": 1,
            "reference_launches": 2,
            # K5 launches of that call: 1 on the card, 0 on the CPU (plain version)
            "k5_launches": k5,
        },
    }


def measure_quantized_ici(
    num_executors: int = 4,
    slot_rows: int = 1024,
    lane: int = 128,
    iterations: int = 5,
    modes=("int8", "blockfloat"),
    report=None,
    device="cuda",
) -> dict:
    """Tier-(b) core of the ``compress`` mode (the mode itself waits on its
    codec legs): the quantized exchange (ops/ici_exchange.py
    ``build_quantized_exchange``: quantize, K3, K1 a receiver, dequantize)
    against the stock float32 exchange (``build_exchange``, the float rows
    through the int32 lane: K1 a receiver), executors sharing ``device``.
    Both take the same seeded payload; each mode's result is held within the
    spec's per-block error bound of the stock one, with equal receive sizes,
    then both are timed over chained iterations.  Effective GB/s counts the
    LOGICAL float32 bytes sent to other executors; ``wire_reduction`` is the
    quantized payload's saving in bytes."""
    from sparkucx_tpu_torch.ops.compress import QuantizeSpec
    from sparkucx_tpu_torch.ops.exchange import ExchangeSpec, build_exchange
    from sparkucx_tpu_torch.ops.ici_exchange import build_quantized_exchange

    n = int(num_executors)
    if n < 2:
        raise RuntimeError(f"quantized ici leg needs >= 2 executors (have {n})")
    devices = _executors(device, n)
    dev = devices[0]
    slot = slot_rows
    send_rows = n * slot
    spec = ExchangeSpec(n, send_rows, send_rows, lane)
    stock = build_exchange(devices, spec)

    rng = np.random.default_rng(11)
    sizes = rng.integers(1, slot + 1, size=(n, n)).astype(np.int32)
    data_f32 = rng.standard_normal((n * send_rows, lane), dtype=np.float32)
    data = torch.from_numpy(data_f32).to(dev)
    remote_bytes = n * (n - 1) * slot * lane * 4

    def time_impl(label, fn, make_data):
        best = 0.0
        for it in range(iterations):
            cur = make_data()
            _sync(dev)
            t0 = time.perf_counter()
            for _ in range(4):  # chained: each receive buffer feeds the next exchange
                cur, _ = fn(cur, sizes)
            _sync(dev)
            dt = time.perf_counter() - t0
            best = max(best, 4 * remote_bytes / dt / 1e9)
            if report is not None:
                report(label, n, it, dt, 4 * remote_bytes)
        return best

    # oracle: the exact float32 rows every mode must approximate
    ref, ref_sizes = stock(data.view(torch.int32), sizes)
    ref = ref.view(torch.float32)
    stock_gbps = time_impl("f32", stock, lambda: data.view(torch.int32).clone())
    amax = float(data.abs().max())
    out: dict = {"n": n, "f32_gbps": stock_gbps, "modes": {}}
    for mode in modes:
        q = QuantizeSpec(mode=mode, block_size=128)
        qfn = build_quantized_exchange(devices, spec, q)
        got, got_sizes = qfn(data, sizes)
        assert torch.equal(got_sizes, ref_sizes), f"quantized exchange sizes diverged ({mode})"
        bound = q.error_bound(amax)
        err = max_err_rows(got, ref, sizes, send_rows)
        assert err <= bound + 1e-7, f"dequant error {err} above bound {bound} ({mode})"
        del got
        mode_gbps = time_impl(mode, qfn, lambda: data.clone())
        out["modes"][mode] = {
            "gbps": mode_gbps,
            "speedup_vs_f32": mode_gbps / max(stock_gbps, 1e-9),
            "wire_reduction": lane / q.quantized_width(lane),
            "max_err": err,
            "err_bound": bound,
        }
    return out


def run_ici(args) -> None:
    size = parse_size(args.block_size)
    slot_rows = max(1, size // ROW)
    stats = StatsAggregator()

    def report(impl, n, it, dt, tot):
        print(
            f"n={n} {impl:6} iter {it}: {tot} remote bytes in {dt*1e3:.1f} ms "
            f"= {tot / dt / 1e9:.2f} GB/s",
            flush=True,
        )

    widths = (2, 4, 8) if args.executors <= 1 else (args.executors,)
    r = measure_ici(
        widths, slot_rows, LANE, chunks_per_dest=args.chunks,
        iterations=args.iterations, report=report, stats=stats, device=args.device,
    )
    print(f"device {r['device']}; slot {r['slot_rows']} rows, {r['chunks_per_dest']} chunks/dest requested", flush=True)
    for n, p in sorted(r["per_n"].items()):
        print(
            f"n={n}: stock {p['stock_gbps']:.2f} GB/s, pallas "
            f"{p['pallas_gbps']:.2f} GB/s ({p['pallas_per_link_gbps']:.3f} "
            f"GB/s/link over {2*n} links), {p['supersteps']} supersteps x "
            f"{p['chunks']} chunks [{p['lowering']}]; bit-identical",
            flush=True,
        )
    f = r["fused"]
    print(
        f"fused send side (n={f['executors']}): scatter+exchange in "
        f"{f['launches']} launch vs {f['reference_launches']} "
        f"(separate staging launch eliminated; K5 launches {f['k5_launches']}); bit-identical",
        flush=True,
    )
    print(stats.report(), flush=True)


# ----------------------------------------------------------------------------
# combine
# ----------------------------------------------------------------------------


def measure_combine(
    executors: int = 8, slot_rows: int = 1024, num_groups: int = 128,
    iterations: int = 5, chunks_per_dest: int = 0, report=None, device="cuda",
) -> dict:
    """Measurement core of the ``combine`` mode — the receive-side fused
    combine (ops/ici_exchange.py ``build_combine_exchange``: K4 once a call)
    against the unfused reference: the same scheduled exchange (K3, then K1
    compaction) followed by a separate plain fold (ops/combine.py
    ``combine_window``) over every receiver's landed O(rows) rows.

    Both are fed the same seeded partial-aggregate rows (``[key |
    sum/min/max/avg lanes | count]``, keys in ``[0, num_groups)``, the JAX
    mode's draws) with ragged per-peer sizes; the fused accumulator is
    asserted bit-identical to the reference fold off the clock (int32 folds
    are order-exact), then both are timed over chained iterations.  ``drain``
    compares the landed grid the reference drains (O(rows)) with the
    accumulator (O(groups)); ``launches`` counts one fused call against the
    reference's exchange and fold.  ``report(impl, it, seconds, bytes)`` per
    iteration."""
    from sparkucx_tpu_torch.ops.combine import CombineSpec, acc_init, combine_window
    from sparkucx_tpu_torch.ops.exchange import ExchangeSpec
    from sparkucx_tpu_torch.ops.ici_exchange import (
        DEFAULT_CHUNKS_PER_DEST,
        build_combine_exchange,
        build_ici_exchange,
    )

    if chunks_per_dest <= 0:
        chunks_per_dest = DEFAULT_CHUNKS_PER_DEST
    n = executors
    if n < 2:
        raise RuntimeError(f"combine mode needs >= 2 executors (have {n})")
    devices = _executors(device, n)
    dev = devices[0]
    cspec = CombineSpec(num_groups=num_groups, aggs=("sum", "min", "max", "avg"))
    lane = cspec.row_width
    slot = max(chunks_per_dest, slot_rows)
    send_rows = n * slot
    spec = ExchangeSpec(num_executors=n, send_rows=send_rows, recv_rows=send_rows, lane=lane)
    fused = build_combine_exchange(devices, spec, cspec, chunks_per_dest=chunks_per_dest)
    ref_ex = build_ici_exchange(devices, spec, chunks_per_dest=chunks_per_dest)

    def fold(recv):
        """The reference's fold: a separate pass over every receiver's landed
        rows (int32 folds are order-insensitive, so one whole-shard window
        reproduces the fused order bit for bit)."""
        accs = [combine_window(cspec, recv[j * send_rows : (j + 1) * send_rows], *acc_init(cspec, dev))
                for j in range(n)]
        return torch.cat([v for v, _ in accs]), torch.cat([c for _, c in accs])

    # seeded partial rows: every staged row is a real partial (count >= 1) up
    # to its ragged per-peer size; padding rows stay all-zero (count 0)
    rng = np.random.default_rng(23)
    sizes = rng.integers(1, slot + 1, size=(n, n)).astype(np.int32)
    data_host = np.zeros((n * send_rows, lane), dtype=np.int32)
    for i in range(n):
        for j in range(n):
            c = int(sizes[i, j])
            base = i * send_rows + j * slot
            data_host[base : base + c, 0] = rng.integers(0, num_groups, size=c)
            data_host[base : base + c, 1:-1] = rng.integers(-100, 100, size=(c, cspec.width))
            data_host[base : base + c, -1] = rng.integers(1, 5, size=c)
    data = upload(data_host, dev)
    av0, ac0 = acc_init(cspec, dev)
    av_init, ac_init = av0.repeat(n, 1), ac0.repeat(n, 1)

    # warm-up + off-clock bit-equality: fused fold against exchange-then-fold
    recv, rs_ref = ref_ex(data, sizes)
    rv_ref, rc_ref = fold(recv)
    del recv
    fv, fc, rs_f = fused(data, sizes, av_init, ac_init)
    _sync(dev)
    assert torch.equal(rs_ref, rs_f), "fused recv_sizes diverged from the scheduled exchange"
    assert torch.equal(rv_ref.view(torch.int32), fv.view(torch.int32)), (
        "fused accumulator values diverged from exchange-then-fold"
    )
    assert torch.equal(rc_ref, fc), "fused accumulator counts diverged from exchange-then-fold"
    del rv_ref, rc_ref, fv, fc

    remote_bytes = n * (n - 1) * slot * lane * 4

    def time_fused():
        best = 0.0
        for it in range(iterations):
            av, ac = av_init, ac_init
            _sync(dev)
            t0 = time.perf_counter()
            for _ in range(4):  # chained: the accumulator carries over
                av, ac, _ = fused(data, sizes, av, ac)
            _sync(dev)
            dt = time.perf_counter() - t0
            best = max(best, 4 * remote_bytes / dt / 1e9)
            if report is not None:
                report("fused", it, dt, 4 * remote_bytes)
        return best

    def time_reference():
        best = 0.0
        for it in range(iterations):
            cur = data
            _sync(dev)
            t0 = time.perf_counter()
            for _ in range(4):  # chained: the exchange, then the fold
                cur, _ = ref_ex(cur, sizes)
                fold(cur)
            _sync(dev)
            dt = time.perf_counter() - t0
            best = max(best, 4 * remote_bytes / dt / 1e9)
            if report is not None:
                report("unfused", it, dt, 4 * remote_bytes)
        return best

    fused_gbps = time_fused()
    ref_gbps = time_reference()
    sched = fused.schedule
    ref_drain = n * slot * lane * 4  # the landed grid, per executor — O(rows)
    return {
        "executors": n,
        "slot_rows": slot,
        "groups": num_groups,
        "lane": lane,
        "lowering": fused.lowering,
        "supersteps": sched.num_steps,
        "chunks": sched.chunks,
        "fused_gbps": fused_gbps,
        "unfused_gbps": ref_gbps,
        "bit_identical": True,
        "drain": {
            "reference_bytes": ref_drain,
            "fused_bytes": cspec.acc_bytes,
            "ratio": ref_drain / cspec.acc_bytes,
        },
        # one call folds every window as it lands (K4, one launch per group
        # of 64 receivers); the reference needs the exchange (K3, K1) and a
        # separate fold, with one window per schedule item in the JAX walk
        "launches": 1,
        "reference_launches": 2,
        "reference_dispatches": len(sched.items()) + 1,
    }


def run_combine(args) -> None:
    size = parse_size(args.block_size)
    n = args.executors if args.executors > 1 else 8

    def report(impl, it, dt, tot):
        print(f"{impl:7} iter {it}: {tot} remote bytes in {dt*1e3:.1f} ms = {tot / dt / 1e9:.2f} GB/s", flush=True)

    r = measure_combine(
        n, max(1, size // ROW), max(2, args.keys), iterations=args.iterations, chunks_per_dest=args.chunks,
        report=report, device=args.device,
    )
    d = r["drain"]
    print(
        f"n={r['executors']}: fused {r['fused_gbps']:.2f} GB/s vs unfused "
        f"{r['unfused_gbps']:.2f} GB/s, {r['supersteps']} supersteps x "
        f"{r['chunks']} chunks [{r['lowering']}]; bit-identical",
        flush=True,
    )
    print(
        f"drain per device: {d['reference_bytes']} B landed grid (O(rows)) -> "
        f"{d['fused_bytes']} B accumulator (O(groups)), {d['ratio']:.1f}x less",
        flush=True,
    )
    print(
        f"launches: exchange+fold in {r['launches']} vs "
        f"{r['reference_launches']} (separate fold launch eliminated; "
        f"{r['reference_dispatches']} scheduled dispatches collapse under the DMA lowering)",
        flush=True,
    )


# ----------------------------------------------------------------------------
# sort
# ----------------------------------------------------------------------------


def measure_sort(
    executors: int, total_rows: int, iterations: int, report=None,
    outstanding: int = 8, sort_impl: str = "auto", device="cuda",
) -> float:
    """Measurement core of the ``sort`` mode — the device-resident TeraSort
    step (100 B rows: uint32 key + 24 int32 lanes): K6 once a sort
    (``radix``, one executor), K1 n a sort (``shared``).  Returns best M
    rows/s; ``report(it, seconds, rows, impl)`` per iteration, each over
    ``outstanding`` sorts a sync."""
    from sparkucx_tpu_torch.ops.sort import SortSpec, build_distributed_sort

    n = executors
    devices = _executors(device, n)
    dev = devices[0]
    impl = resolve_sort_impl(sort_impl, dev.type)
    cap = -(-total_rows // n)
    # one executor owns the whole key range, so n=1 needs no skew headroom
    spec = SortSpec(num_executors=n, capacity=cap, recv_capacity=2 * cap if n > 1 else cap, width=24, impl=impl)
    fn = build_distributed_sort(devices, spec)
    rng = np.random.default_rng(0)
    keys = upload(rng.integers(0, 1 << 32, size=n * cap, dtype=np.uint32).astype(np.int64), dev)
    payload = torch.zeros((n * cap, 24), dtype=torch.int32, device=dev)
    nv = np.full(n, cap, np.int32)
    out = fn(keys, payload, nv)
    assert int(out[2].sum()) == n * cap, "sort dropped rows"
    k0 = out[0][: spec.recv_capacity]
    assert bool((k0[1:] >= k0[:-1]).all()), "sort left shard 0 out of order"
    del out, k0
    best = 0.0
    for it in range(iterations):
        t0 = time.perf_counter()
        for _ in range(outstanding):
            fn(keys, payload, nv)
        _sync(dev)
        dt = time.perf_counter() - t0
        rows = outstanding * n * cap
        best = max(best, rows / dt / 1e6)
        if report is not None:
            report(it, dt, rows, fn.spec.impl)
    return best


def run_sort(args) -> None:
    def report(it, dt, rows, impl):
        print(
            f"iter {it}: sorted {rows} x 100 B rows in {dt*1e3:.1f} ms = "
            f"{rows / dt / 1e6:.2f} M rows/s ({rows * 100 / dt / 1e9:.2f} GB/s) "
            f"[impl={impl}]",
            flush=True,
        )

    if args.sort_impl in ("radix", "single") and args.executors != 1:
        raise SystemExit(
            f"--sort-impl {args.sort_impl} needs --executors 1 (it is an n=1 local-sort lowering)"
        )
    if args.batches > 1:
        run_sort_external(args)
        return
    measure_sort(
        args.executors, args.num_blocks, args.iterations, report=report, outstanding=args.outstanding,
        sort_impl=args.sort_impl, device=args.device,
    )


def run_sort_external(args) -> None:
    """The --batches > 1 arm of the sort mode: out-of-core TeraSort through
    ``run_external_sort`` (device batches + stable host run merge), timed end
    to end per iteration — one number covering the device sorts, the
    transfers and the host merge."""
    from sparkucx_tpu_torch.ops.sort import SortSpec, oracle_sort, run_external_sort

    n = args.executors
    devices = _executors(args.device, n)
    impl = resolve_sort_impl(args.sort_impl, devices[0].type)
    total = args.num_blocks
    cap = -(-total // (args.batches * n))
    spec = SortSpec(num_executors=n, capacity=cap, recv_capacity=2 * cap if n > 1 else cap, width=24, impl=impl)
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 1 << 32, size=total, dtype=np.uint32)
    payload = np.zeros((total, 24), np.int32)
    actual_batches = -(-total // (n * cap))  # the batches run_external_sort makes
    fns = {}  # built sorts shared across iterations
    sk, _ = run_external_sort(devices, spec, keys, payload, fns=fns)  # warm-up
    ok, _ = oracle_sort(keys, payload)
    assert np.array_equal(sk, ok), "external sort diverged from oracle"
    for it in range(args.iterations):
        t0 = time.perf_counter()
        run_external_sort(devices, spec, keys, payload, fns=fns)
        dt = time.perf_counter() - t0
        print(
            f"iter {it}: external-sorted {total} x 100 B rows "
            f"({actual_batches} device batches) in {dt:.2f} s = "
            f"{total / dt / 1e6:.2f} M rows/s",
            flush=True,
        )


# ----------------------------------------------------------------------------
# columnar
# ----------------------------------------------------------------------------


def measure_columnar(
    executors: int, total_rows: int, width: int, iterations: int,
    outstanding: int = 8, report=None, device="cuda",
) -> float:
    """Measurement core of the ``columnar`` mode — the device-resident columnar
    shuffle (ops/columnar.py): rows already on the device are repartitioned
    by a random owner vector (K1 n a shuffle).  Returns best GB/s of rows
    moved; ``report(it, seconds, bytes, impl)`` per iteration."""
    from sparkucx_tpu_torch.ops.columnar import ColumnarSpec, build_columnar_shuffle

    n = executors
    devices = _executors(device, n)
    dev = devices[0]
    cap = -(-total_rows // n)
    # for n > 1 the receive side gets 2x balanced headroom (random owners
    # stay well inside it)
    spec = ColumnarSpec(num_executors=n, capacity=cap, recv_capacity=cap if n == 1 else 2 * cap, width=width)
    fn = build_columnar_shuffle(devices, spec)
    g = _generator(dev, 0)
    rows = torch.randn((n * cap, width), generator=g, device=dev, dtype=torch.float32)
    owners = torch.randint(0, n, (n * cap,), generator=g, device=dev, dtype=torch.int32)
    recv, counts = fn(rows, owners)
    assert int(counts.sum()) == n * cap, "columnar shuffle dropped rows"
    del recv
    moved = n * cap * width * 4
    best = 0.0
    for it in range(iterations):
        t0 = time.perf_counter()
        for _ in range(outstanding):
            fn(rows, owners)
        _sync(dev)
        dt = time.perf_counter() - t0
        tot = moved * outstanding
        best = max(best, tot / dt / 1e9)
        if report is not None:
            report(it, dt, tot, fn.spec.impl)
    return best


def run_columnar(args) -> None:
    width = max(1, parse_size(args.block_size) // 4)  # -s = row bytes

    def report(it, dt, tot, impl):
        print(
            f"iter {it}: {tot} bytes of {width * 4} B rows in {dt*1e3:.1f} ms = "
            f"{tot / dt / 1e9:.2f} GB/s [impl={impl}]",
            flush=True,
        )

    measure_columnar(
        args.executors, args.num_blocks, width, args.iterations, outstanding=args.outstanding, report=report,
        device=args.device,
    )


# ----------------------------------------------------------------------------
# groupby
# ----------------------------------------------------------------------------


def measure_groupby(
    executors: int, total_rows: int, iterations: int,
    outstanding: int = 8, num_keys: int = 100, report=None,
    partial: bool = False, wire_rows=None, device="cuda",
) -> float:
    """Measurement core of the ``groupby`` mode — the device-resident GROUP BY
    (100 B rows: uint32 key + 24 summed int32 lanes; GroupByTest's shape):
    the unfused route, K1 n a query.  Returns best M input rows/s;
    ``report(it, seconds, rows, impl)`` per iteration.  ``partial`` reduces
    each executor's rows below the exchange; ``wire_rows``, if a list,
    receives the true exchanged row count."""
    from sparkucx_tpu_torch.ops.relational import AggregateSpec, build_grouped_aggregate, hash_owners_host

    n = executors
    devices = _executors(device, n)
    dev = devices[0]
    cap = -(-total_rows // n)
    rng = np.random.default_rng(0)
    host_keys = rng.integers(0, num_keys, size=n * cap).astype(np.uint32)
    # receive buffers sized from the actual hash placement, so the overflow
    # assert below guards host/device placement agreement; with partial
    # aggregation each sender sends one row per local distinct key
    if partial:
        per_owner = np.zeros(n, np.int64)
        for s in range(n):
            uk = np.unique(host_keys[s * cap : (s + 1) * cap])
            np.add.at(per_owner, hash_owners_host(uk, n), 1)
        recv = int(per_owner.max())
    else:
        recv = int(np.bincount(hash_owners_host(host_keys, n), minlength=n).max())
    spec = AggregateSpec(num_executors=n, capacity=cap, recv_capacity=recv, aggs=("sum",) * 24, partial=partial)
    fn = build_grouped_aggregate(devices, spec)
    keys = upload(host_keys.astype(np.int64), dev)
    # zeros: the aggregation cost is value-independent (the keys steer it)
    values = torch.zeros((n * cap, 24), dtype=torch.int32, device=dev)
    nv = np.full(n, cap, np.int32)
    out = fn(keys, values, nv)
    recv_totals = np.asarray(out[4])
    assert (recv_totals <= spec.recv_capacity).all(), (
        f"hash skew overflowed recv_capacity ({recv_totals.max()} > "
        f"{spec.recv_capacity}): use more --keys or fewer executors"
    )
    if wire_rows is not None:
        wire_rows.append(int(recv_totals.sum()))
    rows_aggregated = int(out[2].sum())
    assert rows_aggregated == n * cap, f"groupby dropped rows ({rows_aggregated} != {n * cap})"
    got_groups = int(np.asarray(out[3]).sum())
    want_groups = len(np.unique(host_keys))
    assert got_groups == want_groups, f"groupby produced {got_groups} groups, expected {want_groups}"
    del out
    best = 0.0
    for it in range(iterations):
        t0 = time.perf_counter()
        for _ in range(outstanding):
            fn(keys, values, nv)
        _sync(dev)
        dt = time.perf_counter() - t0
        rows = outstanding * n * cap
        best = max(best, rows / dt / 1e6)
        if report is not None:
            report(it, dt, rows, fn.spec.impl)
    return best


def run_groupby(args) -> None:
    def report(it, dt, rows, impl):
        print(
            f"iter {it}: grouped {rows} x 100 B rows in {dt*1e3:.1f} ms = "
            f"{rows / dt / 1e6:.2f} M rows/s ({rows * 100 / dt / 1e9:.2f} GB/s) "
            f"[impl={impl}]",
            flush=True,
        )

    wire = []
    measure_groupby(
        args.executors, args.num_blocks, args.iterations, outstanding=args.outstanding, num_keys=args.keys,
        report=report, partial=args.partial, wire_rows=wire, device=args.device,
    )
    mode = "partial (map-side agg below the exchange)" if args.partial else "raw rows"
    print(
        f"exchange traffic [{mode}]: {wire[0]} rows on the wire for "
        f"{args.num_blocks} input rows ({args.num_blocks / max(wire[0], 1):.0f}x reduction)"
        if args.partial
        else f"exchange traffic [{mode}]: {wire[0]} rows on the wire",
        flush=True,
    )


# ----------------------------------------------------------------------------
# join
# ----------------------------------------------------------------------------


def measure_join(
    executors: int, probe_rows: int, build_rows: int, iterations: int,
    outstanding: int = 8, report=None, join_type: str = "inner", device="cuda",
) -> float:
    """Measurement core of the ``join`` mode — the device-resident PK-FK hash
    join (TPC-H's plan shape; K1 2n a join): ``build_rows`` dimension rows
    with globally unique keys (8 int32 lanes), ``probe_rows`` fact rows (16
    lanes) each referencing a key in [0, 2*build_rows) — half the probes hit,
    so every ``join_type`` has work on its matched and unmatched branches.
    The expected output count comes from numpy set logic and is asserted.
    Returns best M probe rows/s; ``report(it, seconds, rows, impl)``."""
    from sparkucx_tpu_torch.ops.relational import JoinSpec, build_hash_join, plan_join_capacities

    n = executors
    devices = _executors(device, n)
    dev = devices[0]
    build_rows = build_rows or probe_rows // 4  # the CLI's documented default
    pcap = -(-probe_rows // n)
    bcap = -(-max(build_rows, n) // n)
    rng = np.random.default_rng(0)
    nb = n * bcap
    bkeys_h = rng.permutation(nb).astype(np.uint32)  # unique PKs, shuffled
    # FK keyspace = [0, 2*nb): about half the probe rows match a PK
    pkeys_h = rng.integers(0, 2 * nb, size=n * pcap, dtype=np.uint64).astype(np.uint32)
    brecv, precv, out_cap = plan_join_capacities(bkeys_h, pkeys_h, n, join_type=join_type)
    probe_hits = int(np.isin(pkeys_h, bkeys_h).sum())
    build_missed = int((~np.isin(bkeys_h, pkeys_h)).sum())
    expect = {
        "inner": probe_hits,
        "left_outer": n * pcap,                       # misses null-extend
        "left_semi": probe_hits,                      # unique PKs: 1 emit/hit
        "left_anti": n * pcap - probe_hits,
        "right_outer": probe_hits + build_missed,
        "full_outer": n * pcap + build_missed,
    }[join_type]
    spec = JoinSpec(
        num_executors=n,
        build_capacity=bcap, build_recv_capacity=brecv, build_width=8,
        probe_capacity=pcap, probe_recv_capacity=precv, probe_width=16,
        out_capacity=out_cap, join_type=join_type,
    )
    fn = build_hash_join(devices, spec)
    bkeys = upload(bkeys_h.astype(np.int64), dev)
    bvals = torch.zeros((nb, 8), dtype=torch.int32, device=dev)
    bnum = np.full(n, bcap, np.int32)
    pkeys = upload(pkeys_h.astype(np.int64), dev)
    pvals = torch.zeros((n * pcap, 16), dtype=torch.int32, device=dev)
    pnum = np.full(n, pcap, np.int32)
    out = fn(bkeys, bvals, bnum, pkeys, pvals, pnum)
    recv_totals = np.asarray(out[4])  # (n, 2) true (build, probe) per executor
    assert (recv_totals[:, 0] <= spec.build_recv_capacity).all() and (
        recv_totals[:, 1] <= spec.probe_recv_capacity
    ).all(), (
        f"hash skew overflowed a receive buffer (max build "
        f"{recv_totals[:, 0].max()}/{spec.build_recv_capacity}, probe "
        f"{recv_totals[:, 1].max()}/{spec.probe_recv_capacity})"
    )
    counts = out[3].cpu().numpy()
    assert (counts <= spec.out_capacity).all(), f"join output overflowed out_capacity ({counts.max()} > {spec.out_capacity})"
    matches = int(counts.sum())
    assert matches == expect, f"{join_type} join emitted {matches} rows, expected {expect}"
    del out
    best = 0.0
    for it in range(iterations):
        t0 = time.perf_counter()
        for _ in range(outstanding):
            fn(bkeys, bvals, bnum, pkeys, pvals, pnum)
        _sync(dev)
        dt = time.perf_counter() - t0
        rows = outstanding * n * pcap
        best = max(best, rows / dt / 1e6)
        if report is not None:
            report(it, dt, rows, fn.spec.impl)
    return best


def run_join(args) -> None:
    def report(it, dt, rows, impl):
        print(
            f"iter {it}: joined {rows} probe rows in {dt*1e3:.1f} ms = {rows / dt / 1e6:.2f} M rows/s [impl={impl}]",
            flush=True,
        )

    measure_join(
        args.executors, args.num_blocks, args.build_rows, args.iterations, outstanding=args.outstanding,
        report=report, join_type=args.join_type, device=args.device,
    )


# ----------------------------------------------------------------------------
# CLI
# ----------------------------------------------------------------------------


def _parse_args(argv):
    """Every flag of the JAX CLI, under the same names and defaults, plus
    ``--device``."""
    p = argparse.ArgumentParser(prog="sparkucx-tpu-torch-perf", description=__doc__.split("\n")[0])
    p.add_argument("mode", choices=MODES)
    p.add_argument("-a", "--address", default="127.0.0.1:13337", help="server host:port")
    p.add_argument("-f", "--file", default=None, help="file to serve blocks from (server)")
    p.add_argument("-n", "--num-blocks", type=int, default=8)
    p.add_argument("-s", "--block-size", default="4m")
    p.add_argument("-i", "--iterations", type=int, default=5)
    p.add_argument("-o", "--outstanding", type=int, default=8)
    p.add_argument("-r", "--reports", type=int, default=1, help="batches per bandwidth print")
    p.add_argument("-t", "--threads", type=int, default=1)
    p.add_argument("--executors", type=int, default=1, help="executors sharing the device")
    p.add_argument(
        "--slices", type=int, default=1,
        help=f"factor the superstep executors into this many slices (not ported: {CROSS_DEVICE_ITEM})",
    )
    p.add_argument(
        "--impl", default="auto",
        help="block-gather lowering: auto|dma|tiled (the kernel), xla (CPU only) (gather mode), or a "
        "comma list of staging paths to compare: host,device (write mode)",
    )
    p.add_argument(
        "--keys", type=int, default=100,
        help="distinct group keys (groupby mode; GroupByTest's numKVPairs keyspace), groups (combine mode)",
    )
    p.add_argument("--build-rows", type=int, default=0, help="dimension-side rows (join mode); 0 means -n // 4")
    p.add_argument(
        "--partial", action="store_true",
        help="map-side partial aggregation below the exchange (groupby mode; conf "
        "spark.shuffle.tpu.partialAggregation)",
    )
    p.add_argument(
        "--join-type", default="inner",
        choices=["inner", "left_outer", "left_semi", "left_anti", "right_outer", "full_outer"],
        help="join arm to benchmark (join mode); half the probe keys miss so every arm's matched AND "
        "unmatched branches do real work",
    )
    p.add_argument(
        "--sort-impl", default="auto",
        choices=["auto", "single", "radix", "ragged", "dense"],
        help="sort lowering (sort mode); 'radix' = the LSD radix sort kernel (n=1 only); 'dense' is a CPU "
        f"alias; 'ragged' is not ported ({CROSS_DEVICE_ITEM})",
    )
    p.add_argument("--batches", type=int, default=1, help="device batches of the out-of-core sort, run_external_sort (sort mode)")
    p.add_argument("--depths", default="1,2,3", help="comma-separated pipeline depths to compare (pipeline mode)")
    p.add_argument("--streams", default="1,2,4", help="comma-separated wire.streams values to compare (wire mode)")
    p.add_argument("--chunk-bytes", default="4m", help="chunk frame size for striped lanes (wire mode; wire.chunkBytes)")
    p.add_argument(
        "--zipf-alpha", type=float, default=1.2, help="Zipf exponent for the per-peer size distribution (skew mode)",
    )
    p.add_argument(
        "--quota", type=int, default=0,
        help="slot quota in rows (skew mode); 0 picks the pow2 ceiling of the mean lane size",
    )
    p.add_argument(
        "--chunks", type=int, default=0,
        help="FAST chunks per destination (ici, combine modes); 0 picks ops/ici_exchange.py DEFAULT_CHUNKS_PER_DEST",
    )
    p.add_argument("--apps", type=int, default=8, help="concurrent synthetic applications (tenants mode)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"), help="where the executors run")
    return p.parse_args(argv)


_RUNNERS = {
    "superstep": run_superstep,
    "pipeline": run_pipeline,
    "gather": run_gather,
    "write": run_write,
    "skew": run_skew,
    "adaptive": run_adaptive,
    "ici": run_ici,
    "combine": run_combine,
    "sort": run_sort,
    "columnar": run_columnar,
    "groupby": run_groupby,
    "join": run_join,
}


def main(argv=None) -> int:
    args = _parse_args(argv if argv is not None else sys.argv[1:])
    if args.mode in UNPORTED:
        item, what = UNPORTED[args.mode]
        print(
            f"mode {args.mode!r} is not ported yet: its modules wait on ROADMAP queue A item {item} ({what}), "
            f"the mode itself on item 9; this CLI runs {', '.join(sorted(_RUNNERS))}",
            file=sys.stderr,
        )
        return 2
    _RUNNERS[args.mode](args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
