"""Drive sparkucx_tpu_torch's main path on one CUDA card and check it.

    python3 chip_smoke.py

Builds the Hopper kernels from ``sparkucx_tpu_torch/csrc`` (nvcc, sm_90a, one
process per source, all started together), then runs twenty-three phases; any
failure propagates and the exit code is non-zero:

1. environment: card, power limit, versions, kernel build time;
2. each kernel against its plain PyTorch version, bit-exact: K1 and K2 on
   ragged plans (empty blocks, count=0 pads at the packed end, 1-row blocks,
   one block covering the whole source, a source above 2**31 bytes, a row
   width off the 16-byte path); K1 also at rows of 4, 12, 36, 100 and 512
   bytes, into ``out`` row slices off 16 bytes (compared whole: rows past
   the packed total untouched), 40,000 one-row blocks, B = 0, and one block
   of more than 2 GiB; K6 (the radix sort, and its one-digit pass
   on every digit) on N = 0, 1, 2, one whole tile and one row past it, a
   partial last tile, all-equal keys, keys 0xFFFFFFFF, keys >= 2**31, three
   keys over 1M rows with payload = row id (stability), float32 rows, widths
   1, 2 and 25, and a 2.2 GB buffer past 2**31 bytes;
3. the shuffle main path at full width on the device route — GroupByTest's
   big gate (200 mappers x 200 reducers, 25,000-byte values; numKVPairs cut
   from 5000 to 1000, about 5 GB of shuffle): blocks made on the card from a
   seeded generator, ``write_partition_device`` -> commit -> ``run_exchange``
   (seal = block scatter, exchange = block gather) -> ``fetch_blocks_device``
   for every reducer, checked against the written blocks, with the kernels'
   launch counts set to 0 before and read after;
4. the host route through the ShuffleManager SPI (GroupByTest 100 x 100,
   1000-byte values, 100 reducers) against a dict oracle;
5. a 4-executor cluster sharing the card against ``oracle_exchange``;
6. each kernel's time at its main path's shapes beside its plain version, one
   PyTorch library call on the same work, and its memory-bandwidth bound (K6:
   the whole sort of the TeraSort rows, split by step: the counts, each of
   the four pair passes, the row permutation);
7. the TeraSort main path: 100,000,000 rows of 100 B (10 GB, the reference's
   "TeraSort 10GB") made on the card, sorted by ``build_distributed_sort``
   with ``impl='radix'`` (K6's launch count set to 0 before and read after:
   one sort, one launch count), held bit for bit against
   ``torch.sort(stable=True)`` + ``index_select``, then ``radix`` and
   ``single`` timed on the same data, each with a profiler summary;
8. the host drivers: ``run_distributed_sort`` (n=1, radix, 1M rows) and
   ``run_external_sort`` (three batches) against ``oracle_sort``;
9. the sample sort with four executors sharing the card, exchange through K1
   (one launch per receiver): the host driver on 25M rows (2.5 GB, cut from
   10 GB because it holds the dataset several times in host memory) against
   the library sort, then K1 held against its plain version on that run's
   own exchange (its fused 100-byte rows and every receiver's plan); then
   ``build_distributed_sort`` on the uncut 10 GB made on the card, checked
   and timed, with its peak device memory;
10. K3 (ring exchange) and K4 (ring combine) against their plain versions,
    bit-equal: n in {2, 3, 4, 8}, and 64, 65 and 130 (one, two and three
    launches of 64 receivers), chunks in {1, 2, 4}, a staging view off the
    16-byte alignment, G = 1, 8, 64, 2**14 and 2**20 (K4's accumulator in
    device memory), duplicate keys, keys >= 2**31, int8 and blockfloat
    payloads, all-padding windows, float min, max and sum over both signed
    zeros and NaNs of three bit patterns on both tiers, grids past 2**31 bytes, K4 twice and
    compared bit for bit;
11. TPC-H Q1 at SF=10 (59,986,052 lineitem rows made from ``--seed``) on
    four executors sharing the card through ``run_grouped_aggregate`` with
    ``exchange.fusedCombine=true`` (K4 launches set to 0 before and read
    after) and the unfused route (K1, its count likewise): float32 against
    a float64 oracle and each other, an int32 twin bit-exact; both routes
    timed on device tensors with peak memory and a ``torch.profiler``
    summary; K4 and K1 held against their plain versions on the runs' own
    inputs and timed;
12. TPC-H Q18 stage 1 at SF=1 (GROUP BY l_orderkey over 6,001,215 rows, G =
    2**23): fused (K4), unfused (K1) and numpy bit-exact; K4 and K1 held
    against their plain versions on the runs' own inputs, K4 once more
    under ``torch.cuda.set_sync_debug_mode("error")``; then the same GROUP
    BY through ``run_plan_grouped_aggregate`` in four quota sub-rounds (K4
    set to 0 before and read after: once a sub-round), equal to the fused
    route bit for bit, K4 held against its plain version on every recorded
    sub-round and timed on the first;
13. GroupByTest at phase 3's widths on four executors sharing the card under
    ``exchange.impl=pallas`` (K2 seal, K3, then K1 compaction; every count
    set to 0 just before ``run_exchange`` and read just after) against
    ``stock`` and ``oracle_exchange``; K2, K3 and K1 held against their
    plain versions on the run's own inputs and timed (K3 through its
    wrapper and as its launch alone, beside one contiguous copy of the same
    bytes);
14. K5 (the fused send side: K2's scatter then K3's copies in one
    cooperative launch) against its plain version, bit-equal: n in {2, 3,
    4, 8} x chunks in {1, 2, 4}, ragged and empty blocks straddling chunk
    windows, count-0 pads, stale staging rows no block covers, 16-byte and
    4-byte words, a 2.29 GiB grid, two runs bit-equal;
15. phase 13's recorded seal inputs through ``build_fused_ici_exchange`` on
    a fresh staging (K5 then K1; counts set to 0 just before, K5 once, K2
    and K3 never): receive shards bit-equal to phase 13's K2 -> K3 -> K1;
    K5 against its plain version at that shape, timed beside the two-launch
    route, the plain version, the library pair and the bound;
16. phase 13's GroupByTest under ``slot_quota_rows`` = a quarter of the
    slot, ``pipeline_depth=2``, stock and pallas, ``host_recv_mode=
    'device'``: K2, K3 and K1 counted per sub-round, spliced shards equal to
    phase 13's, every fetch equal to its written blocks, the timed run
    repeated twice with the caching allocator's counts; then the
    ``memmap`` receive mode, chunked, through the ShuffleManager SPI;
17. ``measure_ici((2, 4, 8), 8192, 128)`` (``python -m
    sparkucx_tpu_torch.perf.benchmark ici``) on the card;
18. TPC-H Q18 whole at SF=10 (lineitem 59,986,052, orders 15,000,000,
    customer 1,500,000 rows from ``--seed``) on four executors sharing the
    card: GROUP BY l_orderkey SUM(l_quantity) fused (K4; every group's sum
    equal to the numpy oracle's, K4 held against its plain version on the
    recorded exchange and timed), HAVING > 300, ``run_hash_join`` with
    orders, ``run_hash_join`` with customer (K1 set to 0 before each join
    and read after: 2n), ORDER BY o_totalprice DESC, o_orderdate LIMIT
    100; every row of both joins and the 100 result rows equal to the
    numpy oracle's bit for bit; K1 held against its plain version on both
    joins' recorded exchanges and timed
    at the orders exchange's receivers; both joins timed on device tensors
    with peak memory and a profile;
19. SparkTC on four executors sharing the card: SparkTC.scala's graph (200
    edges over 100 vertices) against ``oracle_tc``, and a graph of 8,192
    edges over 4,096 vertices against a scipy reachability oracle, through
    ``run_transitive_closure`` (K1 counted: n for the prep, 2n a round),
    then every round timed, the last profiled and its exchanges' K1 held
    against its plain version;
20. the benchmark CLI (``python -m sparkucx_tpu_torch.perf.benchmark``): its
    eleven main-path modes (superstep, gather, write, pipeline, skew,
    adaptive, sort, columnar, groupby, join, combine) through ``main`` at
    the arguments of ``CLI_MODES``, each at the scale of a PERF.md section
    4 configuration, every kernel's launch count set to 0 just before each
    run and read just after against ``mode_launches``; then each mode again
    at one iteration of one call with every call of K1, K2, K3, K4 and K6
    held bit for bit against its plain version on the same inputs; one call
    of the GROUP BY, join and combine modes timed and profiled on its own
    inputs;
21. the quantized exchange (ops/ici_exchange.py) on four executors sharing
    the card, ``int8`` and ``blockfloat`` at block 128: 4 x 4 x 2**19 rows
    of 512-byte float32 rows (4 GiB) through ``build_quantized_exchange``
    (quantize, K3 on the 132-byte int32 payload, K1 a receiver,
    dequantize; K3 counted once and K1 four times) within ``error_bound``
    of the stock float32 exchange, ``quantize_rows`` on the card bit-equal
    to the CPU on a 1,048,576-row sample, every K3 and K1 call held bit for
    bit against its plain version; quantize, K3, K1, dequantize, the route
    and the float32 stock and K3 routes timed with their bounds and peak
    memory, one profile; then ``build_quantized_fused_exchange`` on phase
    13's plan geometry with float payloads (K2 four times, K3 once, K1 four
    times, K5 never) bit-equal to ``build_quantized_exchange`` on the
    staging K2 filled, every K2, K3 and K1 call held; then
    ``measure_quantized_ici(4, 2**19, 128)``;
22. the six walkthroughs of ``sparkucx_tpu_torch/examples`` through their
    ``main`` on the card, each checking its own oracle, with their kernels'
    launch counts; then phase 4's host route through the ShuffleManager SPI
    at 100 mappers x 100 reducers x 1,000 records of 1,000 bytes, grouped
    by key under a 256 KiB ``reduceMemoryBudget``: every reducer's groups
    equal a dict oracle and every reducer spilled;
23. the Spark-facing shuffle daemon and the peer wire on the card, at
    GroupByTest's big gate (200 x 200 blocks, 25,000-byte values,
    numKVPairs 1000, ~5 GB; numKVPairs 250 for the daemon), with every call
    of K1, K2, K3, K4 and K6 in the phase held bit for bit against its plain
    version and each part's launches checked: a ``ShuffleDaemon`` with one,
    then four executors sharing the card, under ``hostRecvMode`` ``array``
    and ``device``, written by four ``DaemonClient`` connections over
    loopback TCP (committed lengths held against the written ones),
    RunExchange (K1 once a receiver), then every reducer's 200 blocks in one
    FetchBlock batch, every byte held against the written ones (under
    ``device`` K1 once a batch, none under ``array``), and the batches
    resolved to host views alone; a daemon write measured over one and four
    connections and with a 0.1 ms thread switch interval; the raw
    ``jvm/fixtures/*.bin`` frames against a daemon on the card (K1 once a
    fetch frame); then two ``PeerTransport``s: executor 0's store stages the
    same map output on the card (``write_partition_device``, sealed by K2
    once), executor 1 fetches every block at ``wire.streams`` 1 and 4 (K1
    once a batch), then with ``wire.checksum`` on over one reducer's first
    40 blocks, then 40 reducers at streams 1 and 4 with a 0.1 ms switch
    interval; then ``benchmark wire`` at 8 x 32 MiB and a ``server`` process
    on an ephemeral port with a ``client`` (host bytes, no kernel); K1 timed
    at the daemon's and the peer server's serve-batch shapes once the hold
    is lifted.

The last line is ``{"ok": true, "device": {...}}``; the line before it holds
the kernel table as JSON.  Exits non-zero without a result when CUDA is not
available.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

#: H100 SXM device-memory bandwidth (NVIDIA data sheet), bytes/s
HBM_BYTES_PER_S = 3.35e12
ROW = 512
LANE = ROW // 4
SEED = 20261016
#: TeraSort 10GB: rows of 100 B
TERASORT_ROWS = 100_000_000


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Median device milliseconds of ``fn`` between CUDA events, after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_rounds(fns: dict, reps: int) -> dict:
    """Device milliseconds of each of ``fns`` between CUDA events, after one
    warm-up each, in ``reps`` rounds that run every function once: a slow
    spell of the card falls on all of them alike.  Returns each name's times
    in round order."""
    for fn in fns.values():
        fn()
    times = {name: [] for name in fns}
    for _ in range(reps):
        for name, fn in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end))
    return times


def device_ms(fn, reps: int = 20) -> float:
    """Device milliseconds of one ``fn``, ``reps`` of them back to back behind
    a sleeping kernel: the host has queued them all before the card reaches
    the first, so no host latency shows (on an idle stream it does)."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(1e8))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def wall(fn):
    """(result, seconds) of ``fn`` on the host clock, ending synchronized."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def alloc_counters() -> dict:
    """The caching allocator's device allocations, frees and out-of-memory
    retries (each frees the cache and synchronizes) so far."""
    st = torch.cuda.memory_stats()
    return {k: st.get(k, 0) for k in ("num_device_alloc", "num_device_free", "num_alloc_retries")}


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    if torch.equal(a, b):
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


# -- phase 2 ---------------------------------------------------------------


def _ragged_plan(rng, num_blocks, src_rows, max_rows, lo=0):
    counts = rng.integers(0, max_rows, size=num_blocks).astype(np.int64)
    counts[rng.random(num_blocks) < 0.2] = 0
    counts[rng.random(num_blocks) < 0.2] = 1
    starts = np.array([rng.integers(lo, src_rows - c + 1) for c in counts], dtype=np.int64)
    return starts, counts


def check_kernels(device, big_rows: int = (3 << 30) // ROW) -> None:
    """Phase 2; ``big_rows`` sizes the source whose byte offsets pass 2**31."""
    from sparkucx_tpu_torch.ops.block_kernels import (
        block_gather, block_gather_ref, block_scatter, block_scatter_ref, plan_tensors,
    )

    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)

    def rand_rows(rows, lane=LANE):
        return torch.randint(-(2**31), 2**31 - 1, (rows, lane), dtype=torch.int32,
                             generator=gen, device=device)

    def gather_case(name, src, starts, counts, pads=0, offset=None):
        """K1 against its plain version; with ``offset``, into a row slice
        that many rows into a larger buffer, compared whole (the rows past
        the packed total and around the slice left as they were)."""
        total = int(counts.sum())
        outs = np.cumsum(counts) - counts
        starts = np.concatenate([starts, np.zeros(pads, np.int64)])
        counts = np.concatenate([counts, np.zeros(pads, np.int64)])
        outs = np.concatenate([outs, np.full(pads, total, np.int64)])
        s, c, o = plan_tensors(starts, counts, outs, device)
        lane = src.shape[1]
        if offset is None:
            got = block_gather(s, c, o, src, total)
            want = block_gather_ref(s, c, o, src, total)
            torch.cuda.synchronize()
            assert torch.equal(got[:total], want[:total]), f"block_gather {name}: mismatch"
        else:
            buf = rand_rows(total + offset + 3, lane)
            want = buf.clone()
            block_gather_ref(s, c, o, src, total + 2, out=want[offset : offset + total + 2])
            block_gather(s, c, o, src, total + 2, out=buf[offset : offset + total + 2])
            torch.cuda.synchronize()
            assert torch.equal(buf, want), f"block_gather {name}: mismatch"
            got = buf
        del got, want
        log(f"  block_gather  {name:<36} row={lane * 4:>3} B blocks={len(counts):>6} rows={total:>9}  equal")

    def scatter_case(name, dst, starts, counts, pads=0):
        total = int(counts.sum())
        outs = np.cumsum(counts) - counts
        starts = np.concatenate([starts, np.zeros(pads, np.int64)])
        counts = np.concatenate([counts, np.zeros(pads, np.int64)])
        outs = np.concatenate([outs, np.full(pads, total, np.int64)])
        src = rand_rows(max(total, 1), dst.shape[1])
        s, c, o = plan_tensors(starts, counts, outs, device)
        want = block_scatter_ref(s, c, o, src, dst.clone())
        got = block_scatter(s, c, o, src, dst)
        torch.cuda.synchronize()
        # the whole destination: placed blocks AND untouched rows
        assert torch.equal(got, want), f"block_scatter {name}: mismatch"
        log(f"  block_scatter {name:<28} blocks={len(counts):>6} rows={total:>9}  equal")

    src = rand_rows(1 << 16)
    starts, counts = _ragged_plan(rng, 2000, 1 << 16, 64)
    gather_case("ragged+empty+1-row+pads", src, starts, counts, pads=5)
    gather_case("one block = whole source", src, np.array([0]), np.array([1 << 16]))
    gather_case("only pads", src, np.zeros(0, np.int64), np.zeros(0, np.int64), pads=3, offset=1)
    odd = rand_rows(4096, 33)  # 132-byte rows
    starts, counts = _ragged_plan(rng, 300, 4096, 40)
    gather_case("132-byte rows", odd, starts, counts, pads=2)
    # K1 copies byte spans: every row width of the paths, into row slices off 16 bytes
    for lane in (1, 3, 9, 25, 128):
        rows = rand_rows(50_000, lane)
        starts, counts = _ragged_plan(rng, 1000, 50_000, 48)
        gather_case("ragged+pads", rows, starts, counts, pads=3)
        for offset in (1, 3):
            gather_case(f"ragged, out a slice {offset} row(s) in", rows, starts, counts, pads=2, offset=offset)
        if lane in (3, 128):
            starts = rng.permutation(50_000)[:40_000].astype(np.int64)
            gather_case("40000 one-row blocks", rows, starts, np.ones(starts.size, np.int64), offset=1)
        del rows
    gather_case("B = 0", src, np.zeros(0, np.int64), np.zeros(0, np.int64), offset=1)
    high = min((1 << 31) // ROW - 1000, big_rows // 2)  # blocks straddle and pass 2**31 B
    big = rand_rows(big_rows)
    starts, counts = _ragged_plan(rng, 500, big_rows, 2000, lo=high)
    gather_case(f"{big_rows * ROW / 2**30:.1f} GiB source, high rows", big, starts, counts, pads=1)
    one = (big_rows * 3) // 4  # one block of more than 2 GiB, from row 1000 on
    gather_case(f"one block of {one * ROW / 2**30:.2f} GiB", big, np.array([1000]), np.array([one]), pads=1)

    # scatter: disjoint destination windows
    def windows(rows, n, max_rows, lo=0):
        slot = (rows - lo) // n
        starts = lo + np.arange(n, dtype=np.int64) * slot + rng.integers(0, slot // 2, size=n)
        counts = rng.integers(0, min(max_rows, slot // 2), size=n)
        counts[rng.random(n) < 0.2] = 1
        return starts, counts

    dst = rand_rows(1 << 16)
    scatter_case("ragged+empty+1-row+pads", dst, *windows(1 << 16, 2000, 64), pads=5)
    scatter_case("one block = whole dst", dst, np.array([0]), np.array([1 << 16]))
    odd = rand_rows(4096, 33)
    scatter_case("132-byte rows", odd, *windows(4096, 300, 40), pads=2)
    scatter_case(f"{big_rows * ROW / 2**30:.1f} GiB dst, high rows", big,
                 *windows(big_rows, 500, 2000, lo=high), pads=1)
    del big, src, dst, odd
    torch.cuda.empty_cache()


# -- phase 3 ---------------------------------------------------------------


def groupby_blocks(device, mappers, reducers, kv_pairs, value_bytes, seed):
    """GroupByTest's map output made on the card: per mapper ``kv_pairs``
    random keys hash-partitioned over the reducers, each record a 4-byte key
    plus ``value_bytes`` random bytes.  Returns (lengths (M, R) in bytes,
    per-mapper list of per-reducer (rows, lane) int32 blocks)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    keys = torch.randint(0, 2**31 - 1, (mappers, kv_pairs), generator=gen, device=device)
    counts = torch.zeros((mappers, reducers), dtype=torch.int64, device=device)
    counts.scatter_add_(1, keys % reducers, torch.ones_like(keys))
    lengths = counts.cpu().numpy() * (value_bytes + 4)
    rows = -(-lengths // ROW)
    blocks = []
    for m in range(mappers):
        buf = torch.randint(-(2**31), 2**31 - 1, (int(rows[m].sum()), LANE), dtype=torch.int32,
                            generator=gen, device=device)
        blocks.append(list(torch.split(buf, rows[m].tolist())))
    return lengths, blocks


def main_path(device, mappers=200, reducers=200, kv_pairs=1000, value_bytes=25000):
    """Phase 3; returns (stats, state kept for phase 6)."""
    from sparkucx_tpu_torch.config import TpuShuffleConf
    from sparkucx_tpu_torch.core.block import ShuffleBlockId
    from sparkucx_tpu_torch.ops.block_kernels import block_gather, block_scatter
    from sparkucx_tpu_torch.transport.tpu import TpuShuffleCluster

    lengths, blocks = groupby_blocks(device, mappers, reducers, kv_pairs, value_bytes, SEED)
    total_rows = int((-(-lengths // ROW)).sum())
    payload_bytes = int(lengths.sum())
    conf = TpuShuffleConf(
        block_alignment=ROW,
        staging_capacity_per_executor=total_rows * ROW,  # one staging round
        device_staging=True,
        keep_device_recv=True,
        host_recv_mode="device",
    )
    cluster = TpuShuffleCluster(conf, devices=[device])
    transport = cluster.transport(0)
    sid = 0
    log(f"  GroupByTest {mappers} x {reducers}, {kv_pairs} pairs/mapper, {value_bytes} B values: "
        f"{payload_bytes / 1e9:.3f} GB payload, {total_rows} rows of {ROW} B")

    block_gather.launches = 0
    block_scatter.launches = 0

    def write():
        cluster.create_shuffle(sid, mappers, reducers)
        for m in range(mappers):
            w = transport.store.map_writer(sid, m)
            for r in range(reducers):
                w.write_partition_device(r, blocks[m][r], length=int(lengths[m, r]))
            transport.commit_block(w.commit().pack())

    def fetch():
        return [
            transport.fetch_blocks_device([ShuffleBlockId(sid, m, r) for m in range(mappers)])
            for r in range(reducers)
        ]

    _, t_write = wall(write)
    _, t_exchange = wall(lambda: cluster.run_exchange(sid))
    fetched, t_fetch = wall(fetch)
    launches = {"block_gather": block_gather.launches, "block_scatter": block_scatter.launches}
    phase_ms = cluster.device_times_ms(sid)

    for r, (packed, entries) in enumerate(fetched):
        want = torch.cat([blocks[m][r] for m in range(mappers)])
        assert torch.equal(packed, want), f"reducer {r}: fetched blocks differ from the written ones"
        assert entries[:, 1].tolist() == [int(lengths[m, r]) for m in range(mappers)]
    del fetched
    gb = payload_bytes / 1e9
    stats = {
        "payload_gb": gb,
        "write_s": t_write,
        "run_exchange_s": t_exchange,
        "seal_ms": phase_ms["seal"],
        "exchange_ms": phase_ms["exchange"],
        "fetch_s": t_fetch,
        "end_to_end_s": t_write + t_exchange + t_fetch,
        "launches": launches,
    }
    for key, secs in (("seal", phase_ms["seal"] / 1e3), ("exchange", phase_ms["exchange"] / 1e3),
                      ("fetch", t_fetch), ("end_to_end", stats["end_to_end_s"])):
        log(f"  {key:<11} {secs * 1e3:10.2f} ms  {gb / secs:8.2f} GB/s")
    log(f"  (write {t_write * 1e3:.2f} ms, run_exchange wall {t_exchange * 1e3:.2f} ms)")
    log(f"  launches on the main path: {launches}")
    state = {"lengths": lengths, "blocks": blocks, "cluster": cluster, "sid": sid}
    return stats, state


# -- phase 4 ---------------------------------------------------------------


def host_route(device, mappers=100, reducers=100, kv_pairs=100, value_bytes=1000, seed=SEED + 1,
               keyspace=2**31 - 1, grouped=False, **conf_kw) -> dict:
    """GroupByTest through the ShuffleManager SPI against a dict oracle, its
    keys drawn from ``keyspace``; ``conf_kw`` sets the receive mode, the plan
    and the reduce side's budget (phase 4: ``array``, one shot; phase 16:
    ``memmap``, chunked; phase 22: a ``reduce_memory_budget`` that makes
    every reducer spill).  Each reducer reads its records as written or,
    with ``grouped``, its values grouped by key (``get_reader(aggregator=...,
    merge_combiners=...)``).  The exchange and the reads each run with every
    kernel call held against its plain version (:func:`held_run`).  Returns
    the manager's cluster stats report, the staging rounds, the launches of
    the exchange and of the reads, and each reducer's spills."""
    from sparkucx_tpu_torch.config import TpuShuffleConf
    from sparkucx_tpu_torch.shuffle.manager import TpuShuffleManager
    from sparkucx_tpu_torch.utils.codec import encode_records

    rng = np.random.default_rng(seed)
    oracle = {r: [] for r in range(reducers)}
    t0 = time.perf_counter()
    conf = TpuShuffleConf(**{"host_recv_mode": "array", **conf_kw})
    with TpuShuffleManager(conf, devices=[device]) as mgr:
        mgr.register_shuffle(1, mappers, reducers)
        for m in range(mappers):
            keys = rng.integers(0, keyspace, size=kv_pairs)
            values = rng.integers(0, 256, size=(kv_pairs, value_bytes), dtype=np.uint8)
            parts = {r: [] for r in range(reducers)}
            for k, v in zip(keys.tolist(), values):
                parts[k % reducers].append((k, v.tobytes()))
            writer = mgr.get_writer(1, m)
            for r in range(reducers):
                stream = writer.get_partition_writer(r).open_stream()
                if parts[r]:
                    stream.write(encode_records(parts[r]))
                stream.close()
                oracle[r].extend(parts[r])
            writer.commit_all_partitions()
        written = time.perf_counter() - t0
        _, exchange_s, exchange = held_run(lambda: mgr.run_exchange(1))
        rounds = len(mgr.cluster.meta(1).recv_sizes)

        def read_all():
            spills = []
            for r in range(reducers):
                if grouped:
                    reader = mgr.get_reader(1, r, r + 1, aggregator=_collect, merge_combiners=_merge_lists)
                    got = {k: sorted(v if isinstance(v, list) else [v]) for k, v in reader.read()}
                    want = {}
                    for k, v in oracle[r]:
                        want.setdefault(k, []).append(v)
                    assert got == {k: sorted(v) for k, v in want.items()}, f"reducer {r}: groups differ from the oracle"
                else:
                    reader = mgr.get_reader(1, r, r + 1)
                    assert sorted(reader.read()) == sorted(oracle[r]), f"reducer {r}: records differ from the oracle"
                assert reader.metrics.records_read == len(oracle[r]), f"reducer {r}: records_read"
                spills.append(reader.metrics.spills)
            return spills

        spills, read_s, reads = held_run(read_all)
        report = mgr.cluster.stats.report()
    log(f"  GroupByTest {mappers} x {reducers}, {kv_pairs} records of {value_bytes} B a mapper "
        f"({mappers * kv_pairs * value_bytes / 1e6:.0f} MB; {conf.host_recv_mode}, slot_quota_rows "
        f"{conf.slot_quota_rows}, reduceMemoryBudget {conf.reduce_memory_budget} B): every reducer's "
        f"{'groups' if grouped else 'records'} equal the oracle; write {written:.2f} s, run_exchange {exchange_s:.2f} s "
        f"({rounds} staging rounds, launches {exchange}, every call held), read {read_s:.2f} s (launches {reads}); "
        f"spills a reducer {min(spills)}-{max(spills)} ({sum(spills)} in all)")
    return {"report": report, "rounds": rounds, "exchange_launches": exchange, "read_launches": reads,
            "spills": spills, "write_s": written, "exchange_s": exchange_s, "read_s": read_s}


def _collect(acc, v):
    return (acc if isinstance(acc, list) else [acc]) + [v]


def _merge_lists(a, b):
    return (a if isinstance(a, list) else [a]) + (b if isinstance(b, list) else [b])


# -- phase 5 ---------------------------------------------------------------


def shared_device_exchange(device, n=4, mappers=8, reducers=8):
    from sparkucx_tpu_torch.config import TpuShuffleConf
    from sparkucx_tpu_torch.core.block import MemoryBlock, ShuffleBlockId
    from sparkucx_tpu_torch.ops.exchange import oracle_exchange
    from sparkucx_tpu_torch.transport.tpu import TpuShuffleCluster

    rng = np.random.default_rng(SEED + 2)
    conf = TpuShuffleConf(staging_capacity_per_executor=4 << 20, keep_device_recv=True)
    cluster = TpuShuffleCluster(conf, devices=[device] * n)
    meta = cluster.create_shuffle(2, mappers, reducers)
    payloads = {}
    for m in range(mappers):
        t = cluster.transport(meta.map_owner[m])
        w = t.store.map_writer(2, m)
        for r in range(reducers):
            payloads[(m, r)] = rng.integers(0, 256, size=int(rng.integers(0, 20000)),
                                            dtype=np.uint8).tobytes()
            w.write_partition(r, payloads[(m, r)])
        t.commit_block(w.commit().pack())
    cluster.run_exchange(2)

    def pad(b):
        return b + b"\x00" * (-len(b) % ROW)

    chunks = [
        [
            b"".join(pad(payloads[(m, r)]) for m in range(mappers) if meta.map_owner[m] == i
                     for r in range(*meta.peer_ranges[j]))
            for j in range(n)
        ]
        for i in range(n)
    ]
    expected = oracle_exchange(chunks)
    for j in range(n):
        rows = int(meta.recv_sizes[0][j].sum())
        got = meta.recv_device[0][j][:rows].cpu().numpy().tobytes()
        assert got == expected[j], f"executor {j}: received bytes differ from oracle_exchange"
        for r in range(*meta.peer_ranges[j]):
            bufs = [MemoryBlock(np.zeros(20000, np.uint8), size=20000) for _ in range(mappers)]
            reqs = cluster.transport(j).fetch_blocks_by_block_ids(
                j, [ShuffleBlockId(2, m, r) for m in range(mappers)], bufs, [None] * mappers)
            for m, (req, buf) in enumerate(zip(reqs, bufs)):
                assert req.wait(1).error is None
                assert buf.host_view()[: buf.size].tobytes() == payloads[(m, r)]
    log(f"  {n} executors on one card: every receive shard equals oracle_exchange")


# -- phase 6 ---------------------------------------------------------------


def kernel_timings(device, state, launches):
    """Each kernel at the main path's shapes: the seal's scatter (every block
    into the staging) and the n=1 exchange's gather (the staging's used
    prefix), plus the fetch's gather (one reducer's blocks)."""
    from sparkucx_tpu_torch.ops import block_kernels
    from sparkucx_tpu_torch.ops.block_kernels import (
        block_gather, block_gather_args, block_gather_ref, block_scatter, block_scatter_ref, plan_tensors,
    )

    cluster, sid = state["cluster"], state["sid"]
    lengths, blocks = state["lengths"], state["blocks"]
    meta = cluster.meta(sid)
    mappers, reducers = lengths.shape
    rows = -(-lengths // ROW)
    # the seal's plan, rebuilt from the commit table: blocks in append order
    starts, counts, order = [], [], []
    for m in range(mappers):
        for r in range(reducers):
            if rows[m, r]:
                starts.append(meta.mapper_infos[m].partitions[r][0] // ROW)
                counts.append(int(rows[m, r]))
                order.append(blocks[m][r])
    starts, counts = np.asarray(starts), np.asarray(counts)
    outs = np.cumsum(counts) - counts
    total = int(counts.sum())
    slot_rows = meta.region_bytes // ROW
    packed = torch.cat(order)
    s, c, o = plan_tensors(starts, counts, outs, device)
    staging = torch.empty((slot_rows, LANE), dtype=torch.int32, device=device)
    plain_staging = torch.empty_like(staging)
    plan_bytes = 3 * 4 * len(counts)

    table = []

    # K2 at the seal
    block_scatter(s, c, o, packed, staging)
    block_scatter_ref(s, c, o, packed, plain_staging)
    torch.cuda.synchronize()
    err = max_abs_err(staging, plain_staging)
    assert err == 0, "block_scatter at the seal shape differs from its plain version"
    idx = (torch.repeat_interleave(torch.from_numpy(starts - outs).to(device),
                                   torch.from_numpy(counts).to(device))
           + torch.arange(total, device=device))
    k_ms = time_ms(lambda: block_scatter(s, c, o, packed, staging), 10)
    p_ms = time_ms(lambda: block_scatter_ref(s, c, o, packed, plain_staging), 3)
    l_ms = time_ms(lambda: plain_staging.index_copy_(0, idx, packed), 10)
    moved = 2 * total * ROW + plan_bytes
    table.append({
        "name": "block_scatter", "route": "cuda", "source": "sparkucx_tpu_torch/csrc/block_copy.cu",
        "replaces": "sparkucx_tpu/ops/pallas_kernels.py:337",
        "launches": launches["block_scatter"], "max_abs_err": err,
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes", "library_ms": l_ms,
        "shape": f"{len(counts)} blocks, {total} rows of {ROW} B into {slot_rows} staging rows",
    })
    del idx, plain_staging

    # K1 at the n=1 exchange: the staging's used prefix as one segment
    g = plan_tensors([0], [total], [0], device)
    got = block_gather(*g, staging, total)
    want = block_gather_ref(*g, staging, total)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    assert err == 0, "block_gather at the exchange shape differs from its plain version"
    del got, want
    idx = torch.arange(total, device=device)
    k_ms = time_ms(lambda: block_gather(*g, staging, total), 10)
    p_ms = time_ms(lambda: block_gather_ref(*g, staging, total), 10)
    l_ms = time_ms(lambda: staging.index_select(0, idx), 10)
    out = torch.empty((total, LANE), dtype=torch.int32, device=device)
    lib, args = block_kernels._library(), block_gather_args(*g, staging, out)
    launch_ms = time_ms(lambda: lib.block_gather_launch(*args), 10)
    del out
    moved = 2 * total * ROW + 12
    table.append({
        "name": "block_gather", "route": "cuda", "source": "sparkucx_tpu_torch/csrc/block_copy.cu",
        "replaces": "sparkucx_tpu/ops/pallas_kernels.py:158",
        "launches": launches["block_gather"], "max_abs_err": err,
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes", "library_ms": l_ms,
        "shape": f"1 block of {total} rows of {ROW} B (the n=1 exchange); the launch alone {launch_ms:.4f} ms",
    })
    del idx

    # K1 at one reducer's device fetch (informational line)
    recv = meta.recv_device[0][0]  # n = 1: the received shard keeps the staging layout
    r = 0
    f_starts = np.asarray([meta.mapper_infos[m].partitions[r][0] // ROW for m in range(mappers)])
    f_counts = rows[:, r]
    f_outs = np.cumsum(f_counts) - f_counts
    f_total = int(f_counts.sum())
    f = plan_tensors(f_starts, f_counts, f_outs, device)
    assert torch.equal(block_gather(*f, recv, f_total), block_gather_ref(*f, recv, f_total))
    fk = time_ms(lambda: block_gather(*f, recv, f_total), 20)
    fp = time_ms(lambda: block_gather_ref(*f, recv, f_total), 5)
    f_idx = plan_index(device, (f_starts, f_counts, f_outs), f_total)
    fl = time_ms(lambda: recv.index_select(0, f_idx), 20)
    fb = (2 * f_total * ROW + 12 * mappers) / HBM_BYTES_PER_S * 1e3
    log(f"  block_gather at one reducer's fetch ({mappers} blocks, {f_total} rows): "
        f"{fk:.4f} ms, plain {fp:.4f} ms, library {fl:.4f} ms, bound {fb:.4f} ms")

    return table


def log_table(table) -> None:
    for k in table:
        log(f"  {k['name']:<14} {k['ms']:9.4f} ms  plain {k['plain_ms']:10.4f} ms  "
            f"library {k['library_ms']:9.4f} ms  bound {k['bound_ms']:8.4f} ms  "
            f"launches {k['launches']}  [{k['shape']}]")


# -- K6: the radix sort ----------------------------------------------------


def radix_sort_plain(rows: torch.Tensor) -> torch.Tensor:
    """The whole sort through K6's plain version, pass by pass."""
    from sparkucx_tpu_torch.ops.radix import radix_sort_rows_ref

    return radix_sort_rows_ref(rows)


def library_sort_rows(rows: torch.Tensor) -> torch.Tensor:
    """One PyTorch sort of the uint32 keys in word 0, then one row gather."""
    from sparkucx_tpu_torch.ops.sort import key_values

    return rows.index_select(0, torch.sort(key_values(rows[:, 0]), stable=True).indices)


def terasort_data(device, n: int, seed: int = SEED + 6):
    """TeraSort input made on the card: (n,) int64 uniform uint32 keys and
    (n, 24) int32 payload (100-byte rows), from a seeded generator."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    keys = torch.randint(0, 2**32, (n,), dtype=torch.int64, generator=gen, device=device)
    payload = torch.randint(-(2**31), 2**31 - 1, (n, 24), dtype=torch.int32, generator=gen, device=device)
    return keys, payload


def check_radix(device, big_rows: int = 22_000_000, stable_rows: int = 1_000_000) -> None:
    """Phase 2, K6: the sort and its one-digit pass against their plain
    versions, bit-equal, on the edge cases; ``big_rows`` rows of 100 B make a
    buffer past 2**31 bytes."""
    from sparkucx_tpu_torch.ops.radix import BITS, NUM_PASSES, TILE_ROWS, radix_pass, radix_pass_ref, radix_sort_rows

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 5)

    def rand_rows(n, width):
        return torch.randint(-(2**31), 2**31 - 1, (n, width), dtype=torch.int32, generator=gen, device=device)

    def case(name, rows, passes=False):
        got = radix_sort_rows(rows)
        want = radix_sort_plain(rows)
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), f"radix sort {name}: mismatch"
        if passes:
            for p in range(NUM_PASSES):
                assert torch.equal(radix_pass(rows, p * BITS), radix_pass_ref(rows, p * BITS)), (
                    f"radix pass {p} {name}: mismatch")
        tiles = -(-rows.shape[0] // TILE_ROWS)
        log(f"  radix_sort_rows {name:<32} rows={rows.shape[0]:>9} words={rows.shape[1]:>2} tiles={tiles:>5}  equal")
        return got

    for n in (0, 1, 2):
        case(f"N={n}", rand_rows(n, 25), passes=True)
    case("one whole tile, every pass", rand_rows(TILE_ROWS, 25), passes=True)
    case("one row past a tile, every pass", rand_rows(TILE_ROWS + 1, 25), passes=True)
    # the last tile holds 1001 rows: its warps' key rounds end part-way
    case("N off the tile, every pass", rand_rows(3 * TILE_ROWS + 1001, 25), passes=True)
    for value in (7, -1):  # -1 is the key 0xFFFFFFFF
        rows = rand_rows(50_000, 25)
        rows[:, 0] = value
        case(f"all keys {value & 0xFFFFFFFF:#x}", rows, passes=True)
    rows = rand_rows(200_000, 25)
    rows[:, 0] |= -(2**31)  # every key >= 2**31
    rows[::2, 0] &= 2**31 - 1  # half of them below
    case("sign-bit keys (unsigned order)", rows)
    # stability: three distinct keys, payload = row id
    rows = torch.stack([torch.randint(0, 3, (stable_rows,), dtype=torch.int32, generator=gen, device=device),
                        torch.arange(stable_rows, dtype=torch.int32, device=device)], dim=1)
    got = case("three keys, payload = row id", rows)
    assert torch.equal(got, library_sort_rows(rows)), "radix sort is not stable"
    case("float32 rows", rand_rows(100_000, 25).view(torch.float32))
    for width in (1, 2, 25):
        case(f"width {width}", rand_rows(70_001, width))
    big = rand_rows(big_rows, 25)
    case(f"{big_rows * 100 / 2**30:.2f} GiB buffer (past 2**31 B)", big)
    del big
    torch.cuda.empty_cache()


def radix_timings(device, n: int):
    """K6 at the TeraSort shape: the whole sort beside the plain version, the
    library sort and the bound, and split by step (zeroing the counts and
    look-back state, the counts, each pass, the permutation): each step's
    time is the difference of two runs of the steps up to it."""
    from sparkucx_tpu_torch.ops import radix
    from sparkucx_tpu_torch.ops.radix import NUM_PASSES, radix_pass, radix_sort_rows
    from sparkucx_tpu_torch.ops.sort import key_bits

    keys, payload = terasort_data(device, n)
    rows = torch.cat([key_bits(keys)[:, None], payload], dim=1)
    del keys, payload
    row_bytes = rows.shape[1] * 4
    got = radix_sort_rows(rows)
    want = radix_sort_plain(rows)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    assert err == 0, "radix sort at the TeraSort shape differs from its plain version"
    del want
    lib = library_sort_rows(rows)
    assert torch.equal(got, lib), "radix sort at the TeraSort shape differs from the library sort"
    del lib
    torch.cuda.empty_cache()
    k_ms = time_ms(lambda: radix_sort_rows(rows), 5)

    out = torch.empty_like(rows)
    with torch.cuda.device(device):
        sort = radix._Sort(rows, 0, NUM_PASSES)
    steps = [("zero state", sort.reset), ("counts", sort.count)]
    steps += [(f"pass {p}", lambda p=p: sort.sweep(p)) for p in range(NUM_PASSES)]
    steps += [("permutation", lambda: sort.permute(out))]

    def first(k):
        for _, step in steps[:k]:
            step()

    cum = [time_ms(lambda k=k: first(k), 5) for k in range(1, len(steps) + 1)]
    split = {name: cum[i] - (cum[i - 1] if i else 0.0) for i, (name, _) in enumerate(steps)}
    torch.cuda.synchronize()
    assert torch.equal(out, got), "the sort run step by step differs from radix_sort_rows"
    del out, got, sort
    torch.cuda.empty_cache()
    pass_ms = time_ms(lambda: radix_pass(rows, 0), 5)
    p_ms = time_ms(lambda: radix_sort_plain(rows), 2)
    torch.cuda.empty_cache()
    l_ms = time_ms(lambda: library_sort_rows(rows), 5)
    # the function's bytes: every row read once and written once
    bound_ms = 2 * n * row_bytes / HBM_BYTES_PER_S * 1e3
    # this design's bytes: key sectors read and keys written; pairs through the
    # passes (the first reads keys only, the last writes row numbers only); the
    # row numbers, each row's sectors (4-byte aligned) read and the row written
    sectors = -(-(row_bytes + 28) // 32) if row_bytes % 32 else row_bytes // 32
    design = (36 * n + 12 * n + 16 * n * (NUM_PASSES - 2) + 12 * n
              + 4 * n + 32 * sectors * n + row_bytes * n)
    # the first design's: NUM_PASSES passes, each reading the key word and
    # reading and writing every whole row
    first_ms = NUM_PASSES * (2 * n * row_bytes + 4 * n) / HBM_BYTES_PER_S * 1e3
    log("  radix_sort_rows by step: " + ", ".join(f"{k} {v:.4f} ms" for k, v in split.items())
        + f" (sum {cum[-1]:.4f} ms)")
    log(f"  radix_sort_rows: {k_ms:.4f} ms = {n / k_ms / 1e3:.1f} M rows/s ({n * row_bytes / k_ms / 1e6:.1f} GB/s of "
        f"rows sorted); bound 2 x N x {row_bytes} B / BW = {bound_ms:.4f} ms ({bound_ms / k_ms:.1%}); this design's "
        f"bytes {design / 1e9:.2f} GB = {design / HBM_BYTES_PER_S * 1e3:.4f} ms; the first design's four whole-row "
        f"passes {first_ms:.4f} ms; radix_pass (counts, one pass, permutation) {pass_ms:.4f} ms")
    del rows
    torch.cuda.empty_cache()
    return {
        "name": "radix_sort_rows", "route": "cuda", "source": "sparkucx_tpu_torch/csrc/radix_sort.cu",
        "replaces": "sparkucx_tpu/ops/radix.py:254",
        "launches": None, "max_abs_err": err,
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": l_ms,
        "shape": f"whole sort of {n} rows of {row_bytes} B: counts, {NUM_PASSES} pair passes, one permutation",
        "steps_ms": split, "design_bytes_ms": design / HBM_BYTES_PER_S * 1e3, "first_design_bound_ms": first_ms,
    }


# -- phase 7 ---------------------------------------------------------------


def profile_call(name: str, fn, top: int = 6):
    """One call of ``fn`` under torch.profiler: the device time by kernel
    (its largest ``top``), the device's busy share of the call's wall time
    and the host time of the three costliest CUDA runtime calls (a
    ``cudaMalloc`` blocks the host while the device idles).  Returns the
    busy share, or None when the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = [  # device-side events only: an aten op also reports its kernels' time
        (evt.self_device_time_total, evt.count, evt.key)
        for evt in prof.key_averages()
        if evt.device_type == torch.autograd.DeviceType.CUDA and evt.self_device_time_total > 0
    ]
    if not rows:
        log(f"  profile {name}: the trace holds no device time")
        return None
    rows.sort(reverse=True)
    busy_us = sum(r[0] for r in rows)
    log(f"  profile {name}: device busy {busy_us / 1e3:.3f} ms of {wall_us / 1e3:.3f} ms wall "
        f"({busy_us / wall_us:.1%}); by kernel:")
    for dev_us, count, key in rows[:top]:
        log(f"    {dev_us / 1e3:9.3f} ms  x{count:<3} {key[:90]}")
    runtime = sorted(((evt.cpu_time_total, evt.count, evt.key) for evt in prof.key_averages()
                      if evt.device_type == torch.autograd.DeviceType.CPU and evt.key.startswith("cuda")),
                     reverse=True)
    log("    host, CUDA runtime calls: " + ", ".join(f"{key} {us / 1e3:.3f} ms x{count}" for us, count, key in runtime[:3]))
    return busy_us / wall_us


def terasort(device, n: int = 100_000_000, reps: int = 3):
    """TeraSort at the reference's 10 GB through the sort's entry point,
    impl='radix', checked bit for bit against the library sort; then 'radix'
    and 'single' timed on the same data.  Returns (stats, K6 launches)."""
    from sparkucx_tpu_torch.ops.radix import radix_sort_rows
    from sparkucx_tpu_torch.ops.sort import SortSpec, build_distributed_sort

    keys, payload = terasort_data(device, n)
    gb = n * 100 / 1e9
    log(f"  {n} rows of 100 B (1 uint32 key + 24 int32 payload lanes) = {gb:.3f} GB, uniform keys")
    radix = build_distributed_sort([device], SortSpec(1, n, n, impl="radix"))
    single = build_distributed_sort([device], SortSpec(1, n, n))
    assert single.spec.impl == "single"
    torch.cuda.reset_peak_memory_stats()

    radix_sort_rows.launches = 0
    (ko, po, counts), secs = wall(lambda: radix(keys, payload, [n]))
    launches = radix_sort_rows.launches
    assert launches == 1, f"one radix sort launched K6 {launches} times"
    assert counts.tolist() == [n]
    want_k, order = torch.sort(keys, stable=True)
    assert torch.equal(ko, want_k), "TeraSort keys differ from the library sort"
    del ko, want_k
    want_p = payload.index_select(0, order)
    del order
    assert torch.equal(po, want_p), "TeraSort payload differs from the library sort"
    del po, want_p
    peak = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()
    log(f"  impl='radix' through build_distributed_sort: {secs * 1e3:.2f} ms (first call), "
        f"K6 launches {launches}, equal to torch.sort(stable) + index_select; peak {peak:.1f} GB")

    stats = {"rows": n, "gb": gb, "first_call_ms": secs * 1e3, "k6_launches": launches}
    for name, fn in (("radix", radix), ("single", single)):
        ms = time_ms(lambda: fn(keys, payload, [n]), reps)
        torch.cuda.empty_cache()
        stats[f"{name}_ms"] = ms
        log(f"  impl={name!r:<8} {ms:10.4f} ms  {n / ms / 1e3:10.1f} M rows/s  {gb / ms * 1e3:8.2f} GB/s")
        stats[f"{name}_busy"] = profile_call(name, lambda: fn(keys, payload, [n]))
        torch.cuda.empty_cache()
    del keys, payload
    torch.cuda.empty_cache()
    return stats, launches


# -- phase 8 ---------------------------------------------------------------


def host_drivers(device, n: int = 1_000_000, batch: int = 400_000) -> None:
    from sparkucx_tpu_torch.ops.sort import SortSpec, oracle_sort, run_distributed_sort, run_external_sort

    rng = np.random.default_rng(SEED + 7)
    keys = rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    payload = rng.integers(-(2**31), 2**31 - 1, size=(n, 24), dtype=np.int64).astype(np.int32)
    ok, op = oracle_sort(keys, payload)
    t0 = time.perf_counter()
    sk, sp = run_distributed_sort([device], SortSpec(1, n, n, impl="radix"), keys, payload)
    assert np.array_equal(sk, ok) and np.array_equal(sp, op), "run_distributed_sort differs from oracle_sort"
    log(f"  run_distributed_sort n=1 radix, {n} rows: equal to oracle_sort ({time.perf_counter() - t0:.2f} s)")
    t0 = time.perf_counter()
    sk, sp = run_external_sort([device], SortSpec(1, batch, batch, impl="radix"), keys, payload)
    assert np.array_equal(sk, ok) and np.array_equal(sp, op), "run_external_sort differs from oracle_sort"
    log(f"  run_external_sort, {-(-n // batch)} batches of {batch}: equal to oracle_sort "
        f"({time.perf_counter() - t0:.2f} s)")


# -- phase 9 ---------------------------------------------------------------


def recording(module, name: str, seen: dict):
    """Replace ``module.name`` with a wrapper that keeps its last call's
    arguments in ``seen["args"]`` and every call's in ``seen["calls"]``;
    returns a function restoring the original."""
    real = getattr(module, name)

    def wrapper(*args, **kwargs):
        seen["args"] = args
        seen.setdefault("calls", []).append(args)
        return real(*args, **kwargs)

    setattr(module, name, wrapper)
    return lambda: setattr(module, name, real)


def hold_k1(device, label: str, src: torch.Tensor, plans, out_rows: int) -> None:
    """K1 bit-equal to its plain version on every receiver's plan
    ``((starts, counts, outs), rows filled)`` over one source."""
    from sparkucx_tpu_torch.ops.block_kernels import block_gather, block_gather_ref, plan_tensors

    for j, (plan, filled) in enumerate(plans):
        p = plan_tensors(*plan, device)
        got = block_gather(*p, src, out_rows)
        want = block_gather_ref(*p, src, out_rows)
        torch.cuda.synchronize()
        assert torch.equal(got[:filled].view(torch.int32), want[:filled].view(torch.int32)), (
            f"block_gather at {label}, receiver {j}: mismatch")
        del got, want


def check_k1_calls(device, label: str, calls, reps: int = 10) -> dict:
    """K1 against its plain version on every recorded ``block_gather(starts,
    counts, outs, src, out_rows)`` call of one path, consecutive calls on one
    source (an exchange's receivers) together; :func:`check_k1` times the
    first source's.  Returns its reading."""
    groups = []  # [src, out_rows, plans], one per source, in call order
    for s_, c_, o_, src, out_rows in calls:
        plan = tuple(t.cpu().numpy() for t in (s_, c_, o_))
        filled = min(int(plan[1].sum()), out_rows)
        if groups and groups[-1][0] is src:
            groups[-1][2].append((plan, filled))
        else:
            groups.append([src, out_rows, [(plan, filled)]])
    src, out_rows, plans = groups[0]
    first = check_k1(device, f"{label} (the first of {len(groups)} sources)", src, plans, out_rows, reps)
    for src, out_rows, plans in groups[1:]:
        hold_k1(device, label, src, plans, out_rows)
    log(f"  block_gather at {label}: all {len(calls)} recorded calls, over {len(groups)} sources, "
        "equal to block_gather_ref")
    return first


def check_k3_calls(device, label: str, calls, reps: int = 7) -> dict:
    """K3 bit-equal to its plain version on every recorded
    ``ring_exchange_grid(n, slot, window, steps, data)`` call of one path;
    the first timed through the wrapper and as its launch alone (on the
    cached window table, into a grid allocated once), beside its plain
    version, the library transpose and one contiguous copy, in rounds
    (:func:`time_rounds`), and the bound.  Returns the reading,
    with the largest difference from the plain version over every recorded
    call and the launch alone's grid (``max_abs_err``)."""
    from sparkucx_tpu_torch.ops import ring_kernels
    from sparkucx_tpu_torch.ops.ring_kernels import ring_exchange_args, ring_exchange_grid, ring_exchange_grid_ref

    err = 0
    for k, args in enumerate(calls):
        got = ring_exchange_grid(*args)
        want = ring_exchange_grid_ref(*args)
        torch.cuda.synchronize()
        e = max_abs_err(got, want)
        assert e == 0, f"ring_exchange_grid at {label}, call {k}: differs from its plain version by {e}"
        err = max(err, e)
        del got, want
    n, slot, w, steps, data = calls[0]
    lane = data.shape[1]
    grid = torch.zeros_like(data)
    lib = ring_kernels._library()
    groups = ring_exchange_args(n, slot, w, steps, data, grid)  # one launch a group of receivers

    def launch():
        for args in groups:
            ring_kernels._check(lib, "ring_exchange_launch", lib.ring_exchange_launch(*args))

    launch()
    want = ring_exchange_grid_ref(*calls[0])
    torch.cuda.synchronize()
    e = max_abs_err(grid, want)
    assert e == 0, f"ring_exchange_launch alone at {label}: differs from the plain version by {e}"
    err = max(err, e)
    del want
    # in rounds, so that a slow spell of the card (after a large free) falls on each alike;
    # "copy" is the card's own rate for the same bytes, one contiguous device-to-device copy
    t = time_rounds({
        "wrapper": lambda: ring_exchange_grid(*calls[0]),
        "launch": launch,
        "plain": lambda: ring_exchange_grid_ref(*calls[0]),
        "library": lambda: data.view(n, n, slot, lane).transpose(0, 1).contiguous(),
        "copy": lambda: grid.copy_(data),
    }, reps)
    del grid
    k_ms, launch_ms, p_ms, l_ms, copy_ms = (statistics.median(t[k]) for k in ("wrapper", "launch", "plain", "library", "copy"))
    # host milliseconds a call spends before its launch, and allocating its grid
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        ring_exchange_grid(*calls[0])
    host_ms = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        torch.empty_like(data)
    alloc_ms = (time.perf_counter() - t0) / reps * 1e3
    b_ms = 2 * data.numel() * 4 / HBM_BYTES_PER_S * 1e3
    log(f"  ring_exchange_grid at {label}: all {len(calls)} recorded calls equal to ring_exchange_grid_ref; "
        f"n={n}, {data.shape[0]} rows of {lane * 4} B, {len(steps)} steps, windows of {w} rows: {k_ms:.4f} ms "
        f"(the launch alone {launch_ms:.4f} ms), plain {p_ms:.4f} ms, "
        f"library {l_ms:.4f} ms, bound {b_ms:.4f} ms, one contiguous copy of the same bytes {copy_ms:.4f} ms; "
        f"host time a call {host_ms:.4f} ms, of which allocating the grid {alloc_ms:.4f} ms; by round, wrapper "
        f"{' '.join(f'{x:.4f}' for x in t['wrapper'])}, launch {' '.join(f'{x:.4f}' for x in t['launch'])}, "
        f"plain {' '.join(f'{x:.4f}' for x in t['plain'])}")
    return {"ms": k_ms, "launch_ms": launch_ms, "max_abs_err": err, "plain_ms": p_ms, "library_ms": l_ms,
            "bound_ms": b_ms, "contiguous_copy_ms": copy_ms, "host_ms": host_ms, "alloc_ms": alloc_ms,
            "rows": int(data.shape[0]), "row_bytes": lane * 4, "executors": n, "steps": len(steps), "window_rows": w}


def plan_index(device, plan, rows: int) -> torch.Tensor:
    """The source row of each of the first ``rows`` packed rows of a K1 plan:
    the index one ``index_select`` (K1's library yardstick) takes."""
    starts, counts, outs = (np.asarray(a, np.int64) for a in plan)
    live = counts > 0
    base = torch.from_numpy(starts[live] - outs[live]).to(device)
    idx = torch.repeat_interleave(base, torch.from_numpy(counts[live]).to(device))
    return (idx + torch.arange(idx.numel(), device=device))[:rows]


def check_k1(device, label: str, src: torch.Tensor, plans, out_rows: int, reps: int = 10) -> dict:
    """K1 against its plain version on one path's own source rows and
    per-receiver plans ``[((starts, counts, outs), rows filled), ...]``:
    the filled rows bit-equal for every receiver; the receiver that fills
    the most rows timed through the wrapper and as its launch alone (on a
    plan and output made once), beside the plain version, one
    ``index_select`` into the same output (the library call) and the byte
    bound (each filled row read once and written once, plus the plan), in
    rounds (:func:`time_rounds`); on the device also beside one contiguous
    copy of as many bytes.  Returns the reading."""
    from sparkucx_tpu_torch.ops import block_kernels
    from sparkucx_tpu_torch.ops.block_kernels import block_gather, block_gather_args, block_gather_ref, plan_tensors

    hold_k1(device, label, src, plans, out_rows)
    j = max(range(len(plans)), key=lambda i: plans[i][1])
    plan, filled = plans[j]
    p, segments = plan_tensors(*plan, device), len(plan[1])
    out = torch.empty((out_rows, src.shape[1]), dtype=src.dtype, device=device)
    idx = plan_index(device, plan, filled)
    lib = block_kernels._library()
    args = block_gather_args(*p, src, out)

    def launch():
        rc = lib.block_gather_launch(*args)
        assert rc == 0, lib.block_copy_error_string(rc).decode()

    t = time_rounds({
        "wrapper": lambda: block_gather(*p, src, out_rows, out=out),
        "launch": launch,
        "plain": lambda: block_gather_ref(*p, src, out_rows, out=out),
        "library": lambda: torch.index_select(src, 0, idx, out=out[:filled]),
    }, reps)
    k_ms, launch_ms, p_ms, l_ms = (statistics.median(t[k]) for k in ("wrapper", "launch", "plain", "library"))
    dev_ms = device_ms(launch)
    m = min(filled, src.shape[0])
    copy_ms = device_ms(lambda: out[:m].copy_(src[:m]))
    row_bytes = src.shape[1] * src.element_size()
    b_ms = (2 * filled * row_bytes + 12 * segments) / HBM_BYTES_PER_S * 1e3
    log(f"  block_gather at {label}: every receiver ({len(plans)}, {segments} segments each) equal to "
        f"block_gather_ref; receiver {j} ({filled} rows of {row_bytes} B): {k_ms:.4f} ms (the launch alone "
        f"{launch_ms:.4f} ms, on the device {dev_ms:.4f} ms against {copy_ms:.4f} ms for one contiguous copy of "
        f"as many bytes), plain {p_ms:.4f} ms, library {l_ms:.4f} ms, bound {b_ms:.4g} ms; by round, wrapper {' '.join(f'{x:.4f}' for x in t['wrapper'])}, launch "
        f"{' '.join(f'{x:.4f}' for x in t['launch'])}")
    del out, idx
    return {"ms": k_ms, "launch_ms": launch_ms, "device_ms": dev_ms, "copy_ms": copy_ms, "plain_ms": p_ms,
            "library_ms": l_ms, "bound_ms": b_ms, "rows": filled, "row_bytes": row_bytes}


def columnar_plans(args):
    """One recorded ``exchange_sorted_rows(spec, rows, sizes)`` call of
    ops/columnar.py -> (rows, every receiver's K1 plan and rows filled, its
    receive capacity)."""
    from sparkucx_tpu_torch.ops.columnar import receive_plan

    cspec, rows, sizes = args
    rc = cspec.recv_capacity
    return rows, [(receive_plan(sizes, j, cspec.capacity, rc), min(int(sizes[:, j].sum()), rc))
                  for j in range(sizes.shape[0])], rc


def check_k1_columnar(device, label: str, args) -> dict:
    """:func:`check_k1` on one recorded ``exchange_sorted_rows`` call
    (ops/columnar.py): its rows, and every receiver's plan."""
    return check_k1(device, label, *columnar_plans(args))


def shared_device_sort(device, n_rows: int = 25_000_000, n: int = 4) -> int:
    """The sample sort with four executors on the card through the host
    driver: exchange through K1.  Then K1 against its plain version on that
    run's own exchange: the fused rows and every receiver's plan.  Returns
    K1's launches in the run."""
    from sparkucx_tpu_torch.ops import sort as sort_mod
    from sparkucx_tpu_torch.ops.block_kernels import block_gather
    from sparkucx_tpu_torch.ops.sort import SortSpec, run_distributed_sort

    keys, payload = terasort_data(device, n_rows, seed=SEED + 8)
    want_k, order = torch.sort(keys, stable=True)
    want_k = want_k.cpu().numpy().astype(np.uint32)
    want_p = payload.index_select(0, order).cpu().numpy()
    del order
    keys_h, payload_h = keys.cpu().numpy().astype(np.uint32), payload.cpu().numpy()
    del keys, payload
    torch.cuda.empty_cache()
    cap = -(-n_rows // n)
    spec = SortSpec(n, cap, 2 * cap, impl="auto")

    # keep the exchange's inputs (the sort's last call) for the K1 check below
    seen = {}
    restore = recording(sort_mod, "exchange_sorted_rows", seen)
    try:
        torch.cuda.reset_peak_memory_stats()
        before = block_gather.launches
        t0 = time.perf_counter()
        sk, sp = run_distributed_sort([device] * n, spec, keys_h, payload_h)
        secs = time.perf_counter() - t0
        launches = block_gather.launches - before
    finally:
        restore()
    peak = torch.cuda.max_memory_allocated() / 1e9
    assert np.array_equal(sk, want_k) and np.array_equal(sp, want_p), (
        "the 4-executor sort differs from the library sort")
    assert launches == n, f"K1 ran {launches} times, expected one per receiver ({n})"
    log(f"  {n} executors sharing the card, impl='shared', {n_rows} rows of 100 B "
        f"({n_rows * 100 / 1e9:.1f} GB, cut from 10 GB: the host driver holds the dataset several "
        f"times in host memory): equal to torch.sort(stable) + index_select; K1 launches {launches}; "
        f"host driver {secs:.2f} s incl. upload and download; peak device memory {peak:.2f} GB "
        f"(the exchange's fused rows kept for the check below included)")
    del sk, sp, want_k, want_p, keys_h, payload_h

    # K1 at this path's shapes: 100-byte rows (the 4-byte path), n segments
    # per receiver of about n_rows / n**2 rows each
    check_k1_columnar(device, f"the n={n} sort's exchange", seen.pop("args"))
    del seen
    torch.cuda.empty_cache()
    return launches


def shared_device_sort_uncut(device, n_rows: int = TERASORT_ROWS, n: int = 4, reps: int = 3) -> dict:
    """The n=4 sample sort on the whole 10 GB, made on the card and sorted by
    ``build_distributed_sort`` on device tensors (no host copies), checked
    shard by shard against the library sort and timed."""
    from sparkucx_tpu_torch.ops.block_kernels import block_gather
    from sparkucx_tpu_torch.ops.sort import SortSpec, build_distributed_sort

    keys, payload = terasort_data(device, n_rows, seed=SEED + 9)
    cap = n_rows // n
    fn = build_distributed_sort([device] * n, SortSpec(n, cap, 2 * cap))
    assert fn.spec.impl == "shared"
    nv = [cap] * n
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = block_gather.launches
    (ko, po, counts), secs = wall(lambda: fn(keys, payload, nv))
    launches = block_gather.launches - before
    peak = torch.cuda.max_memory_allocated() / 1e9
    assert launches == n, f"K1 ran {launches} times, expected {n}"
    assert int(counts.sum()) == n_rows and (counts <= 2 * cap).all(), f"shard counts {counts}"
    want_k, order = torch.sort(keys, stable=True)
    want_p = payload.index_select(0, order)
    del order
    off = 0
    for j, c in enumerate(counts.tolist()):
        assert torch.equal(ko[j * 2 * cap : j * 2 * cap + c], want_k[off : off + c]), f"shard {j} keys differ"
        assert torch.equal(po[j * 2 * cap : j * 2 * cap + c], want_p[off : off + c]), f"shard {j} payload differs"
        off += c
    del ko, po, want_k, want_p
    torch.cuda.empty_cache()
    ms = time_ms(lambda: fn(keys, payload, nv), reps)
    gb = n_rows * 100 / 1e9
    log(f"  build_distributed_sort n={n} on the card, {n_rows} rows of 100 B ({gb:.1f} GB, uncut): "
        f"equal to torch.sort(stable) + index_select; K1 launches {launches}; first call {secs * 1e3:.2f} ms; "
        f"peak device memory {peak:.2f} GB; {ms:.4f} ms, {n_rows / ms / 1e3:.1f} M rows/s, "
        f"{gb / ms * 1e3:.2f} GB/s")
    busy = profile_call("shared n=4", lambda: fn(keys, payload, nv))
    del keys, payload
    torch.cuda.empty_cache()
    return {"rows": n_rows, "executors": n, "ms": ms, "first_call_ms": secs * 1e3,
            "peak_gb": peak, "k1_launches": launches, "busy": busy}


# -- phase 10: K3 and K4 --------------------------------------------------------


def ring_rows(device, n, slot, lane, gen):
    return torch.randint(-(2**31), 2**31 - 1, (n * n * slot, lane), dtype=torch.int32,
                         generator=gen, device=device)


#: NaNs of three bit patterns: np.nan, another positive one, a negative one
#: (x86's 0/0); min and max pass on the bits of the NaN they pick
NANS = np.array([0x7FC00000, 0x7FC00001, 0xFFC00000], np.uint32).view(np.float32)


def combine_staging(device, n, slot, cspec, gen, fill=0.5, distinct=False, signed=False):
    """Slot staging of ``[key | payload | count]`` rows made on the card: each
    sender region holds a valid prefix of up to ``fill * slot`` rows (its
    length random), all-zero rows after it.  Keys lie below G — distinct
    inside a region when asked — and about one in 64 is a key >= 2**31,
    outside every domain, which no group may take.  ``signed``: float values
    drawn from {-0.0, +0.0, -1.5, 2.5} and ``NANS``, four in five a zero of
    either sign, so that groups meet both zeros in both orders, and NaN."""
    from sparkucx_tpu_torch.ops.compress import quantize_rows

    total, g = n * n * slot, cspec.num_groups
    idx = torch.arange(total, device=device)
    region, pos = idx // slot, idx % slot
    limit = min(int(fill * slot), g if distinct else slot)
    fills = torch.randint(0, limit + 1, (n * n,), generator=gen, device=device)
    valid = pos < fills[region]
    if distinct:  # an odd multiplier permutes [0, G) for G a power of two
        keys = (pos * 2654435761 + region * 40503) % g
    else:
        keys = torch.randint(0, g, (total,), generator=gen, device=device)
    high = torch.randint(0, 64, (total,), generator=gen, device=device) == 0
    keys = torch.where(high, 2**31 + region, keys)
    counts = torch.randint(1, 5, (total,), generator=gen, device=device, dtype=torch.int32)
    if cspec.torch_dtype == torch.int32:
        payload = torch.randint(-1000, 1000, (total, cspec.width), generator=gen, device=device,
                                dtype=torch.int32)
    else:
        vals = torch.randn((total, cspec.width), generator=gen, device=device) * 100
        if signed:
            pool = torch.cat([torch.tensor([-0.0, 0.0, -1.5, 2.5]), torch.from_numpy(NANS)]).to(device)
            pick = torch.randint(0, pool.numel(), (total, cspec.width), generator=gen, device=device)
            zero = torch.rand((total, cspec.width), generator=gen, device=device) < 0.8
            vals = pool[torch.where(zero, pick % 2, pick)]
        payload = vals if cspec.qspec is None else quantize_rows(cspec.qspec, vals).view(torch.float32)
        payload = payload.view(torch.int32)
    bits = ((keys + 2**31) % 2**32 - 2**31).to(torch.int32)  # the uint32 key's pattern
    rows = torch.cat([bits[:, None], payload, counts[:, None]], dim=1)
    rows[~valid] = 0
    return rows.view(cspec.torch_dtype)


def check_ring_kernels(device, big=True) -> None:
    """Phase 10: K3 and K4 against their plain versions, bit-equal."""
    from sparkucx_tpu_torch.ops.combine import CombineSpec
    from sparkucx_tpu_torch.ops.ici_exchange import ring_schedule
    from sparkucx_tpu_torch.ops.ring_kernels import (
        MAX_EXECUTORS, ring_combine_grid, ring_combine_grid_ref, ring_combine_tier, ring_exchange_grid,
        ring_exchange_grid_ref,
    )

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 20)

    def k3_case(name, n, chunks, slot, lane):
        data = ring_rows(device, n, slot, lane, gen)
        steps = ring_schedule(n, chunks).raw_steps()
        got = ring_exchange_grid(n, slot, slot // chunks, steps, data)
        want = ring_exchange_grid_ref(n, slot, slot // chunks, steps, data)
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"ring_exchange_grid {name}: mismatch"
        log(f"  ring_exchange_grid {name:<34} n={n} chunks={chunks} slot={slot:>7} "
            f"row={lane * 4:>3} B  equal")

    for n in (2, 3, 4, 8):
        for chunks in (1, 2, 4):
            k3_case("", n, chunks, 1000 * chunks, 9)
        k3_case("16-byte words", n, 2, 512, 128)
    for n in (MAX_EXECUTORS, MAX_EXECUTORS + 1, 2 * MAX_EXECUTORS + 2):  # one, two and three receiver groups
        k3_case(f"{-(-n // MAX_EXECUTORS)} receiver group(s)", n, 2, 4, 9)
    k3_case("2 receiver groups, 16-byte words", MAX_EXECUTORS + 1, 2, 8, 128)
    # a staging view 4 bytes past a 16-byte boundary: the 4-byte word path
    n, slot, lane = 4, 4096, 128
    flat = ring_rows(device, 1, 1, n * n * slot * lane + 1, gen).view(-1)
    data = flat[1 : 1 + n * n * slot * lane].view(n * n * slot, lane)
    steps = ring_schedule(n, 2).raw_steps()
    got = ring_exchange_grid(n, slot, slot // 2, steps, data)
    assert torch.equal(got, ring_exchange_grid_ref(n, slot, slot // 2, steps, data)), "ring_exchange_grid off 16 B"
    log(f"  ring_exchange_grid {'staging 4 B off a 16-byte boundary':<34} n={n} chunks=2 slot={slot:>7} "
        f"row={lane * 4:>3} B  equal")
    del flat, data, got
    if big:
        slot = 300_000  # 4 x 4 x 300,000 rows of 512 B = 2.46 GB
        k3_case(f"{16 * slot * 512 / 2**30:.2f} GiB grid (past 2**31 B)", 4, 2, slot, 128)
        torch.cuda.empty_cache()

    def k4_case(name, n, chunks, slot, cspec, fill=0.5, distinct=False, signed=False):
        data = combine_staging(device, n, slot, cspec, gen, fill=fill, distinct=distinct, signed=signed)
        steps = ring_schedule(n, chunks).raw_steps()
        w = slot // chunks
        grid, av, ac = ring_combine_grid(n, slot, w, steps, cspec, data)
        again = ring_combine_grid(n, slot, w, steps, cspec, data)
        pg, pv, pc = ring_combine_grid_ref(n, slot, w, steps, cspec, data)
        torch.cuda.synchronize()
        for a, b in zip(again, (grid, av, ac)):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32)), f"ring_combine_grid {name}: two runs differ"
        assert torch.equal(grid.view(torch.int32), pg.view(torch.int32)), f"ring_combine_grid {name}: grid"
        assert torch.equal(ac, pc), f"ring_combine_grid {name}: counts"
        assert torch.equal(av.view(torch.int32), pv.view(torch.int32)), f"ring_combine_grid {name}: values"
        if signed:  # a NaN of other bits than np.nan's came out of the min and max columns
            other = torch.from_numpy(NANS[1:].view(np.int32).copy()).to(device)
            assert bool(torch.isin(av.view(torch.int32), other).any()), f"{name}: no NaN of other bits came out"
        q = cspec.quantize_mode if cspec.quantize_mode != "off" else np.dtype(cspec.dtype).name
        log(f"  ring_combine_grid  {name:<34} n={n} chunks={chunks} G={cspec.num_groups:>8} "
            f"{q:<10} {ring_combine_tier(cspec):<6} tier  equal, two runs bit-equal")

    dup = CombineSpec(8, ("sum", "min", "max", "avg"), np.int32)
    for n in (2, 3, 4, 8):
        for chunks in (1, 2, 4):
            k4_case("duplicate keys", n, chunks, 1024 * chunks, dup)
    k4_case("G = 1", 4, 2, 4096, CombineSpec(1, ("sum", "min", "max"), np.int32))
    k4_case("all-padding windows", 4, 2, 4096, dup, fill=0.0)
    k4_case("distinct keys", 4, 2, 4096, CombineSpec(8, ("sum", "min", "max"), np.float32), distinct=True)
    for mode in ("int8", "blockfloat"):
        k4_case(f"{mode} payload", 4, 2, 4096,
                CombineSpec(64, ("sum", "avg", "max"), np.float32, quantize_mode=mode, quantize_block=4),
                distinct=True)
    k4_case("G = 2**20, duplicate keys", 4, 2, 1 << 16, CombineSpec(1 << 20, ("sum", "min", "max"), np.int32))
    k4_case("G = 2**20, distinct keys", 4, 2, 1 << 16, CombineSpec(1 << 20, ("sum", "max"), np.float32),
            distinct=True)
    # min and max on the JAX package's order: both zeros in both orders, and NaN, on both tiers
    # (the global tier's atomic fold without a float sum, its ordered fold with one)
    k4_case("+-0 and NaN, distinct keys", 4, 2, 4096, CombineSpec(8, ("min", "max", "sum"), np.float32),
            distinct=True, signed=True)
    k4_case("+-0 and NaN, duplicate keys", 4, 2, 4096, CombineSpec(8, ("max", "min"), np.float32), signed=True)
    k4_case("G = 2**20, +-0 and NaN, duplicates", 4, 2, 1 << 16, CombineSpec(1 << 20, ("min", "max"), np.float32),
            signed=True)
    k4_case("G = 2**20, +-0 and NaN, float sum", 4, 2, 1 << 16,
            CombineSpec(1 << 20, ("sum", "min", "max"), np.float32), distinct=True, signed=True)
    # the global tier past one receiver group (n = 65, tiny slots)
    k4_case("G = 2**14, 2 receiver groups", MAX_EXECUTORS + 1, 2, 8, CombineSpec(1 << 14, ("sum", "max"), np.int32))
    k4_case("G = 2**14, 2 receiver groups, float sum", MAX_EXECUTORS + 1, 2, 8,
            CombineSpec(1 << 14, ("sum", "max"), np.float32), distinct=True)
    if big:
        slot = 7_000_000  # 4 x 4 x 7,000,000 rows of 20 B = 2.24 GB
        k4_case(f"{16 * slot * 20 / 2**30:.2f} GiB grid (past 2**31 B)", 4, 2, slot,
                CombineSpec(8, ("sum", "min", "max"), np.int32))
    torch.cuda.empty_cache()


# -- phase 11: TPC-H Q1 at SF=10 ----------------------------------------------------

#: TPC-H v3 §4.2.3 dates as days since 1992-01-01
_STARTDATE, _CURRENTDATE, _ENDDATE = 0, 1263, 2556  # 1992-01-01, 1995-06-17, 1998-12-31
_Q1_SHIPDATE_MAX = 2436  # 1998-12-01 minus 90 days = 1998-09-02
Q1_ROWS = 59_986_052  # lineitem at SF=10
Q1_AGGS = ("sum", "sum", "sum", "sum", "avg", "avg", "avg")
Q1_INT_AGGS = ("sum", "min", "max", "sum")
#: float32 Q1 against the float64 oracle, relative: the sums run over about
#: 3.7 million rows per executor and group, where the running sum's float32
#: unit in the last place grows to 2**-23 of ~1.4e11; rounding at each of the
#: additions gives about 1e-4 relative (a random walk); 1e-3 leaves room.
Q1_RTOL = 1e-3
#: float32 Q1, fused route against unfused: both fold the same partial rows
#: (at most 4 per group) and differ only in the order of those few
#: additions, a few float32 units in the last place (6e-8 each); the H100
#: reading was 1.172e-7.  1e-5 catches an error in the fold itself.
Q1_ROUTE_RTOL = 1e-5


def q1_lineitem(seed: int, rows: int = Q1_ROWS):
    """Q1's lineitem columns per TPC-H v3 §4.2.3, from ``seed``: returns
    (keys uint32 = 2 * returnflag + linestatus with A/N/R = 0/1/2 and F/O =
    0/1, the shipdate filter, float32 values (qty, extendedprice,
    disc_price, charge, qty, extendedprice, discount), int32 twin values
    (qty, price in cents twice, discount in hundredths))."""
    rng = np.random.default_rng(seed)
    qty = rng.integers(1, 51, rows, dtype=np.int32)
    partkey = rng.integers(1, 200_000 * 10 + 1, rows, dtype=np.int64)
    retail_cents = 90000 + (partkey // 10) % 20001 + 100 * (partkey % 1000)  # P_RETAILPRICE
    del partkey
    price_cents = (qty * retail_cents).astype(np.int32)
    del retail_cents
    disc = rng.integers(0, 11, rows, dtype=np.int32)  # hundredths
    tax = rng.integers(0, 9, rows, dtype=np.int32)
    ship = rng.integers(_STARTDATE, _ENDDATE - 151 + 1, rows, dtype=np.int32) + rng.integers(1, 122, rows, dtype=np.int32)
    receipt = ship + rng.integers(1, 31, rows, dtype=np.int32)
    status = (ship > _CURRENTDATE).astype(np.uint32)  # O after CURRENTDATE
    flag = np.where(receipt <= _CURRENTDATE, np.where(rng.random(rows) < 0.5, 2, 0), 1).astype(np.uint32)
    del receipt
    keys = 2 * flag + status
    mask = ship <= _Q1_SHIPDATE_MAX
    del ship, flag, status
    price = price_cents.astype(np.float64) / 100
    disc_price = price * (1 - disc / 100)
    values = np.empty((rows, 7), np.float32)
    values[:, 0] = qty
    values[:, 1] = price
    values[:, 2] = disc_price
    values[:, 3] = disc_price * (1 + tax / 100)
    values[:, 4] = qty
    values[:, 5] = price
    values[:, 6] = disc / 100
    del price, disc_price, tax
    ints = np.stack([qty, price_cents, price_cents, disc], axis=1)
    return keys, mask, values, ints


def k4_timings(device, args) -> dict:
    """K4 at the recorded call's shapes: held against its plain version
    (bit-equal), on the global tier run once more under
    ``torch.cuda.set_sync_debug_mode("error")`` (a host sync in the call
    raises), timed beside its plain version, beside one
    ``scatter_reduce_`` per column over the whole landed grid and beside its
    byte bound."""
    from sparkucx_tpu_torch.ops.combine import _REDUCE
    from sparkucx_tpu_torch.ops.ring_kernels import ring_combine_grid, ring_combine_grid_ref, ring_combine_tier
    from sparkucx_tpu_torch.ops.sort import key_values

    n, slot, sched, data, cspec = args
    w, steps = slot // sched.chunks, sched.raw_steps()
    grid, av, ac = ring_combine_grid(n, slot, w, steps, cspec, data)
    pg, pv, pc = ring_combine_grid_ref(n, slot, w, steps, cspec, data)
    torch.cuda.synchronize()
    err = max(max_abs_err(grid.view(torch.int32), pg.view(torch.int32)),
              max_abs_err(av.view(torch.int32), pv.view(torch.int32)), max_abs_err(ac, pc))
    assert err == 0, "ring_combine_grid at the path's shapes differs from its plain version"
    del pg, pv, pc
    if ring_combine_tier(cspec) == "global":  # the global tier's call never waits for the device
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            ring_combine_grid(n, slot, w, steps, cspec, data)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.empty_cache()
    k_ms = time_ms(lambda: ring_combine_grid(n, slot, w, steps, cspec, data), 5)
    dev_ms = device_ms(lambda: ring_combine_grid(n, slot, w, steps, cspec, data), 5)
    p_ms = time_ms(lambda: ring_combine_grid_ref(n, slot, w, steps, cspec, data), 2)
    # the library yardstick: the landed grid folded by scatter_reduce_, one call per column
    g = cspec.num_groups
    keys = key_values(grid[:, 0])
    counts = grid[:, -1].view(torch.int32)
    receiver = torch.arange(grid.shape[0], device=device) // (n * slot)
    idx = torch.where((counts > 0) & (keys < g), receiver * g + keys, n * g)
    lib_v = torch.empty((n * g + 1, cspec.width), dtype=cspec.torch_dtype, device=device)
    lib_c = torch.zeros(n * g + 1, dtype=torch.int32, device=device)
    cols = [grid[:, 1 + c].contiguous() for c in range(cspec.width)]
    del keys, receiver

    def library():
        for c, agg in enumerate(cspec.aggs):
            lib_v[:, c].scatter_reduce_(0, idx, cols[c], _REDUCE[agg], include_self=True)
        lib_c.scatter_add_(0, idx, counts)

    l_ms = time_ms(library, 3)
    moved = 2 * data.numel() * 4 + n * g * (cspec.width + 1) * 4
    del grid, av, ac, idx, lib_v, lib_c, cols, counts
    torch.cuda.empty_cache()
    return {
        "name": "ring_combine_grid", "route": "cuda", "source": "sparkucx_tpu_torch/csrc/ring_exchange.cu",
        "replaces": "sparkucx_tpu/ops/pallas_kernels.py:660",
        "launches": None, "max_abs_err": err,
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": moved / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": l_ms,
        "shape": f"n={n}, {n * n * slot} rows of {data.shape[1] * 4} B, G={g}, {ring_combine_tier(cspec)} tier; "
                 f"on the device {dev_ms:.4f} ms",
    }


def tpch_q1(device, seed: int, n: int = 4, reps: int = 3, rows: int = Q1_ROWS):
    """Phase 11: Q1 at SF=10 through ``run_grouped_aggregate`` with the
    fused route (K4) and the unfused one (K1), float32 and an int32 twin.
    Returns (stats, K4 launches of the fused float run, K4's table row)."""
    from dataclasses import replace

    from sparkucx_tpu_torch.config import TpuShuffleConf
    from sparkucx_tpu_torch.ops import columnar, relational
    from sparkucx_tpu_torch.ops.block_kernels import block_gather
    from sparkucx_tpu_torch.ops.relational import AggregateSpec, build_grouped_aggregate, oracle_aggregate, run_grouped_aggregate
    from sparkucx_tpu_torch.ops.ring_kernels import ring_combine_grid

    t0 = time.perf_counter()
    keys, mask, values, ints = q1_lineitem(seed, rows)
    log(f"  lineitem SF=10: {rows} rows made from seed {seed} in {time.perf_counter() - t0:.1f} s; "
        f"{int(mask.sum())} pass l_shipdate <= 1998-09-02")
    cap = -(-rows // n)
    conf = TpuShuffleConf(num_executors=n, exchange_fused_combine=True)
    spec = AggregateSpec.from_conf(conf, capacity=cap, recv_capacity=64, aggs=Q1_AGGS,
                                   dtype=np.dtype(np.float32), with_filter=True)
    assert spec.partial and spec.combine == "auto", spec
    devices = [device] * n

    ok, ov, oc = oracle_aggregate(keys[mask], values[mask].astype(np.float64), Q1_AGGS)
    ring_combine_grid.launches = 0
    fused, fused_s = wall(lambda: run_grouped_aggregate(devices, spec, keys, values, mask=mask))
    launches = ring_combine_grid.launches
    assert launches > 0, "the fused Q1 did not run through K4"

    def unfused_run(s, vals):
        """The unfused route through the host driver: K1's launches set to 0
        just before and read just after; its exchange's inputs kept."""
        seen = {}
        restore = recording(columnar, "exchange_sorted_rows", seen)
        block_gather.launches = 0
        try:
            out, secs = wall(lambda: run_grouped_aggregate(devices, replace(s, combine="off"), keys, vals, mask=mask))
        finally:
            restore()
        assert block_gather.launches > 0, "the unfused Q1 did not run through K1"
        return out, secs, block_gather.launches, seen.pop("args")

    unfused, unfused_s, k1_launches, k1_args = unfused_run(spec, values)
    for name, got in (("fused", fused), ("unfused", unfused)):
        assert np.array_equal(got[0], ok) and np.array_equal(got[2], oc), f"Q1 {name}: groups or counts differ"
        rel = float(np.max(np.abs(got[1] - ov) / np.abs(ov)))
        assert rel <= Q1_RTOL, f"Q1 {name}: relative error {rel} > {Q1_RTOL}"
        secs = fused_s if name == "fused" else unfused_s
        log(f"  Q1 float32 {name:<8} groups {got[0].tolist()} counts {got[2].tolist()}; max relative "
            f"error vs the float64 oracle {rel:.3e} (<= {Q1_RTOL}); host driver {secs:.2f} s")
    rel_fu = float(np.max(np.abs(fused[1] - unfused[1]) / np.abs(unfused[1])))
    assert rel_fu <= Q1_ROUTE_RTOL, f"Q1 fused vs unfused: relative {rel_fu} > {Q1_ROUTE_RTOL}"
    log(f"  Q1 fused vs unfused: max relative difference {rel_fu:.3e} (<= {Q1_ROUTE_RTOL}); "
        f"K1 launches on the unfused route {k1_launches}")
    k1_float = check_k1_columnar(device, "Q1's unfused exchange (float32 partial rows)", k1_args)
    del k1_args

    ispec = replace(spec, aggs=Q1_INT_AGGS, dtype=np.dtype(np.int32))
    want = oracle_aggregate(keys[mask], ints[mask], Q1_INT_AGGS)
    before = ring_combine_grid.launches
    got_f = run_grouped_aggregate(devices, ispec, keys, ints, mask=mask)
    assert ring_combine_grid.launches > before, "the fused int32 Q1 did not run through K4"
    got_u, _, k1_int_launches, k1_args = unfused_run(ispec, ints)
    for a, b, c in zip(got_f, got_u, want):
        assert a.dtype == b.dtype == c.dtype and np.array_equal(a, b) and np.array_equal(a, c), "Q1 int32 twin differs"
    log(f"  Q1 int32 twin (sum qty, min/max price in cents, sum discount): fused == unfused == numpy, bit for bit; "
        f"K1 launches on the unfused route {k1_int_launches}")
    k1_int = check_k1_columnar(device, "Q1's unfused exchange (int32 partial rows)", k1_args)
    del k1_args

    # the routes on device tensors: CUDA events, peak memory, one profile
    spec_d = replace(spec, combine_groups=8).resolve_combine()
    assert spec_d.combine == "dense"
    from sparkucx_tpu_torch.ops.columnar import shard_rows_host

    pk, pv, nv = shard_rows_host(keys, values, n, cap, value_dtype=np.float32)
    pm, _, _ = shard_rows_host(mask.astype(np.uint32), np.zeros((rows, 0), np.int32), n, cap)
    gk = torch.from_numpy(pk.astype(np.int64)).to(device)
    gv = torch.from_numpy(pv).to(device)
    gm = torch.from_numpy(pm.astype(bool)).to(device)
    del pk, pv, pm
    stats = {"rows": rows, "host_driver_fused_s": fused_s, "host_driver_unfused_s": unfused_s,
             "rel_err_fused": float(np.max(np.abs(fused[1] - ov) / np.abs(ov))), "rel_fused_unfused": rel_fu,
             "k4_launches": launches, "k1_launches_unfused": k1_launches,
             "k1_launches_unfused_int": k1_int_launches, "k1_float": k1_float, "k1_int": k1_int}
    outputs = {}
    for name, s in (("fused", spec_d), ("unfused", replace(spec_d, combine="off"))):
        fn = build_grouped_aggregate(devices, s)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ring_combine_grid.launches = block_gather.launches = 0
        outputs[name] = fn(gk, gv, nv, gm)
        torch.cuda.synchronize()
        used = {"ring_combine_grid": ring_combine_grid.launches, "block_gather": block_gather.launches}
        assert used["ring_combine_grid" if name == "fused" else "block_gather"] > 0, (
            f"Q1 {name} on device tensors did not run through its kernel: {used}")
        stats[f"{name}_device_launches"] = used
        stats[f"{name}_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        stats[f"{name}_ms"] = time_ms(lambda: fn(gk, gv, nv, gm), reps)
        stats[f"{name}_busy"] = profile_call(f"Q1 {name}", lambda: fn(gk, gv, nv, gm), top=8)
        log(f"  Q1 {name:<8} on device tensors: {stats[f'{name}_ms']:.4f} ms (median of {reps}), "
            f"peak device memory {stats[f'{name}_peak_gb']:.2f} GB, launches {used}")
    fo, uo = outputs["fused"], outputs["unfused"]
    again = build_grouped_aggregate(devices, spec_d)(gk, gv, nv, gm)
    for a, b in zip(fo[:3], again[:3]):
        assert torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                           b.view(torch.int32) if b.dtype == torch.float32 else b), "two fused Q1 runs differ"
    for a, b in zip(fo[:3], uo[:3]):
        if a.dtype == torch.float32:
            torch.testing.assert_close(a, b, rtol=Q1_ROUTE_RTOL, atol=0)
        else:
            assert torch.equal(a, b)
    log(f"  two fused runs bit-equal; fused == unfused on device (float32 within {Q1_ROUTE_RTOL})")

    # K4 at this path's shapes, recorded from one fused call
    seen = {}
    restore = recording(relational, "combine_axis_grid", seen)
    try:
        build_grouped_aggregate(devices, spec_d)(gk, gv, nv, gm)
    finally:
        restore()
    del gk, gv, gm, outputs, fo, uo, again
    torch.cuda.empty_cache()
    row = k4_timings(device, seen.pop("args"))
    row["launches"] = launches
    log(f"  ring_combine_grid at Q1's shapes: {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
        f"library {row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms  [{row['shape']}]")
    return stats, launches, row


# -- phase 12: TPC-H Q18 stage 1 at SF=1 --------------------------------------------

Q18_ROWS = 6_001_215  # lineitem at SF=1
Q18_ORDERS = 1_500_000


def q18_lineitem(seed: int, orders: int = Q18_ORDERS, rows: int = Q18_ROWS):
    """Q18's stage-1 input at SF=1 per TPC-H v3 §4.2.3: 1,500,000 orders with
    dbgen's sparse keys (8 of every 32: key = (i >> 3) << 5 | (i & 7), up to
    6,000,000), 1..7 lines each, made to sum to 6,001,215 lines, in
    orderkey order; l_quantity in 1..50.  Returns (keys uint32, qty int32)."""
    rng = np.random.default_rng(seed)
    i = np.arange(1, orders + 1, dtype=np.int64)
    orderkeys = ((i >> 3) << 5) | (i & 7)
    lines = rng.integers(1, 8, orders)
    diff = rows - int(lines.sum())
    room = np.flatnonzero(lines < 7) if diff > 0 else np.flatnonzero(lines > 1)
    lines[rng.choice(room, size=abs(diff), replace=False)] += 1 if diff > 0 else -1
    keys = np.repeat(orderkeys, lines).astype(np.uint32)
    qty = rng.integers(1, 51, keys.shape[0], dtype=np.int32)[:, None]
    return keys, qty


def tpch_q18_stage1(device, seed: int, n: int = 4, orders: int = Q18_ORDERS, rows: int = Q18_ROWS) -> dict:
    """Phase 12: GROUP BY l_orderkey SUM(l_quantity), int32, G = 2**23 (K4's
    global tier), fused against unfused and numpy, bit-exact; then K4 at
    this run's shapes against its plain version, timed; then the same GROUP
    BY through the plan-driven aggregate (:func:`plan_driven_aggregate`)."""
    from dataclasses import replace

    from sparkucx_tpu_torch.ops import columnar, relational
    from sparkucx_tpu_torch.ops.block_kernels import block_gather
    from sparkucx_tpu_torch.ops.relational import AggregateSpec, run_grouped_aggregate
    from sparkucx_tpu_torch.ops.ring_kernels import ring_combine_grid, ring_combine_tier

    keys, qty = q18_lineitem(seed, orders, rows)
    assert keys.shape[0] == rows
    cap = -(-rows // n)
    spec = AggregateSpec(n, cap, cap // 2, ("sum",), partial=True, combine="auto")
    g = 1 << int(keys.max()).bit_length()
    resolved = replace(spec, combine_groups=g).resolve_combine()
    tier = ring_combine_tier(resolved.combine_cspec)
    assert resolved.combine == "dense", resolved
    if orders == Q18_ORDERS:  # SF=1: keys up to 6,000,000, the global-memory accumulator
        assert int(keys.max()) == 6_000_000 and g == 1 << 23 and tier == "global", (g, tier)
    uniq, inv = np.unique(keys, return_inverse=True)
    want = (uniq, np.bincount(inv, weights=qty[:, 0]).astype(np.int32)[:, None],
            np.bincount(inv).astype(np.int32))
    seen = {}
    restore = recording(relational, "combine_axis_grid", seen)
    ring_combine_grid.launches = 0
    try:
        fused, fused_s = wall(lambda: run_grouped_aggregate([device] * n, spec, keys, qty))
    finally:
        restore()
    launches = ring_combine_grid.launches
    assert launches > 0, "Q18 stage 1 did not run through K4"
    k4_args = seen.pop("args")
    seen = {}
    restore = recording(columnar, "exchange_sorted_rows", seen)
    block_gather.launches = 0
    try:
        unfused, unfused_s = wall(lambda: run_grouped_aggregate([device] * n, replace(spec, combine="off"), keys, qty))
    finally:
        restore()
    k1_launches = block_gather.launches
    assert k1_launches > 0, "the unfused Q18 stage 1 did not run through K1"
    for a, b, c in zip(fused, unfused, want):
        assert np.array_equal(a, b) and np.array_equal(a, c), "Q18 stage 1: fused, unfused and numpy differ"
    log(f"  Q18 stage 1: {rows} lines, {uniq.size} orders, keys up to {int(keys.max())}, "
        f"G = 2**{g.bit_length() - 1} ({tier} tier): fused == unfused == numpy, bit for bit; K4 launches "
        f"{launches}, K1 launches on the unfused route {k1_launches}; host driver fused {fused_s:.2f} s, "
        f"unfused {unfused_s:.2f} s")
    k1 = check_k1_columnar(device, "Q18's unfused exchange", seen.pop("args"))
    del seen
    torch.cuda.empty_cache()
    row = k4_timings(device, k4_args)
    del k4_args
    log(f"  ring_combine_grid at Q18's shapes: {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
        f"library {row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms  [{row['shape']}]")
    plan = plan_driven_aggregate(device, n, resolved, keys, qty, fused)
    return {"rows": rows, "groups": int(uniq.size), "combine_groups": g, "fused_s": fused_s,
            "unfused_s": unfused_s, "k4_launches": launches, "k1_launches_unfused": k1_launches, "k1": k1,
            "k4": {k: row[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "shape")},
            "plan_driven": plan}


def plan_driven_aggregate(device, n: int, spec, keys: np.ndarray, values: np.ndarray, want, subrounds: int = 4) -> dict:
    """The same GROUP BY through ``run_plan_grouped_aggregate``: an
    ``ExchangePlan`` of ``subrounds`` quota sub-rounds (a quarter of the
    slot each), K4 once a sub-round (counted: 0 just before, read just
    after), equal to the fused route's ``want`` bit for bit; K4 held against
    its plain version on every recorded sub-round and timed on the first."""
    from sparkucx_tpu_torch.ops import ici_exchange
    from sparkucx_tpu_torch.ops.relational import run_plan_grouped_aggregate
    from sparkucx_tpu_torch.ops.ring_kernels import ring_combine_grid, ring_combine_grid_ref
    from sparkucx_tpu_torch.ops.skew import ExchangePlan

    plan = ExchangePlan(slot_rows=-(-spec.capacity // subrounds), chunks_per_round=(subrounds,), combine="dense")
    seen = {}
    restore = recording(ici_exchange, "combine_axis_grid", seen)
    ring_combine_grid.launches = 0
    try:
        got, secs = wall(lambda: run_plan_grouped_aggregate([device] * n, spec, plan, keys, values))
    finally:
        restore()
    launches = ring_combine_grid.launches
    assert launches == subrounds, f"the plan-driven aggregate launched K4 {launches} times, expected {subrounds}"
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b), "the plan-driven aggregate differs from the fused route"
    calls = seen.pop("calls")
    for sn, slot, sched, flat, cspec in calls[1:]:
        w, steps = slot // sched.chunks, sched.raw_steps()
        got_k4 = ring_combine_grid(sn, slot, w, steps, cspec, flat)
        want_k4 = ring_combine_grid_ref(sn, slot, w, steps, cspec, flat)
        torch.cuda.synchronize()
        assert all(torch.equal(x.view(torch.int32), y.view(torch.int32)) for x, y in zip(got_k4, want_k4)), (
            "ring_combine_grid at a plan sub-round differs from its plain version")
        del got_k4, want_k4
    row = k4_timings(device, calls[0])
    del calls, seen
    torch.cuda.empty_cache()
    log(f"  run_plan_grouped_aggregate, {subrounds} sub-rounds of {plan.slot_rows} rows a slot: equal to the fused "
        f"route bit for bit in {secs:.2f} s (host driver); K4 launches {launches}, every sub-round equal to "
        f"ring_combine_grid_ref; the first {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, library "
        f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms  [{row['shape']}]")
    return {"subrounds": subrounds, "quota_rows": plan.slot_rows, "host_driver_s": secs, "k4_launches": launches,
            "k4": {k: row[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "shape")}}


# -- phase 13: the superstep under exchange.impl=pallas -------------------------------


def pallas_superstep(device, n=4, mappers=200, reducers=200, kv_pairs=1000, value_bytes=25000):
    """Phase 13: GroupByTest at groupby_big's widths on four executors sharing
    the card, ``exchange.impl=pallas`` (K2 seal, K3, K1 compaction) against
    ``stock`` (K2 seal, K1) and ``oracle_exchange``; K2, K3 and K1 held
    against their plain versions on the pallas run's own inputs.  Returns
    (the pallas run's launches, K3's table row, the state phases 15 and 16
    start from: the written blocks, every executor's recorded seal inputs,
    the staging geometry, the receive sizes and the checked receive shards)."""
    from sparkucx_tpu_torch.config import TpuShuffleConf
    from sparkucx_tpu_torch.core.block import ShuffleBlockId
    from sparkucx_tpu_torch.ops import ici_exchange
    from sparkucx_tpu_torch.ops.block_kernels import block_gather, block_scatter, block_scatter_ref
    from sparkucx_tpu_torch.ops.exchange import oracle_exchange
    from sparkucx_tpu_torch.ops.ring_kernels import ring_exchange_grid
    from sparkucx_tpu_torch.store import hbm_store
    from sparkucx_tpu_torch.store.hbm_store import default_peer_ranges
    from sparkucx_tpu_torch.transport.tpu import TpuShuffleCluster

    lengths, blocks = groupby_blocks(device, mappers, reducers, kv_pairs, value_bytes, SEED + 10)
    rows = -(-lengths // ROW)
    ranges = default_peer_ranges(reducers, n)
    owned = [[m for m in range(mappers) if m % n == i] for i in range(n)]
    region_rows = max(int(rows[np.ix_(owned[i], range(*ranges[j]))].sum()) for i in range(n) for j in range(n))
    capacity = n * region_rows * ROW
    log(f"  GroupByTest {mappers} x {reducers}, {kv_pairs} pairs/mapper, {value_bytes} B values on {n} "
        f"executors sharing the card: {lengths.sum() / 1e9:.3f} GB payload, staging {capacity / 1e9:.3f} GB "
        f"per executor")

    def run(impl):
        conf = TpuShuffleConf(block_alignment=ROW, staging_capacity_per_executor=capacity, device_staging=True,
                              keep_device_recv=True, host_recv_mode="device", exchange_impl=impl)
        cluster = TpuShuffleCluster(conf, devices=[device] * n)
        meta = cluster.create_shuffle(3, mappers, reducers)
        for m in range(mappers):
            t = cluster.transport(meta.map_owner[m])
            w = t.store.map_writer(3, m)
            for r in range(reducers):
                w.write_partition_device(r, blocks[m][r], length=int(lengths[m, r]))
            t.commit_block(w.commit().pack())
        kernels = (block_scatter, ring_exchange_grid, block_gather)
        for k in kernels:
            k.launches = 0
        _, secs = wall(lambda: cluster.run_exchange(3))
        used = {k.__name__: k.launches for k in kernels}
        assert used["block_scatter"] > 0 and used["block_gather"] > 0, (
            f"exchange.impl={impl}: the seal or the exchange did not run through its kernel: {used}")
        for r in range(reducers):
            j = meta.owner_of_reduce(r)
            packed, entries = cluster.transport(j).fetch_blocks_device([ShuffleBlockId(3, m, r) for m in range(mappers)])
            assert torch.equal(packed, torch.cat([blocks[m][r] for m in range(mappers)])), (
                f"exchange.impl={impl}: reducer {r}'s fetch differs from the written blocks")
        assert len(meta.recv_sizes) == 1, "expected one staging round"
        shards = [meta.recv_device[0][j][: int(meta.recv_sizes[0][j].sum())] for j in range(n)]
        return shards, meta.recv_sizes[0], secs, used

    seen = {"ring": {}, "compact": {}, "seal": {}}
    restores = [recording(ici_exchange, "ring_exchange_grid", seen["ring"]),
                recording(ici_exchange, "compact_slots", seen["compact"]),
                recording(hbm_store, "block_scatter", seen["seal"])]
    try:
        shards, sizes, secs, launches = run("pallas")
    finally:
        for restore in restores:
            restore()
    assert launches["ring_exchange_grid"] > 0, "exchange.impl=pallas did not run through K3"
    log(f"  exchange.impl=pallas: run_exchange {secs * 1e3:.2f} ms wall, launches {launches}; "
        "every reducer's fetch equals its written blocks")

    # K2 at this run's seal (every executor's) and K1 at its compaction
    # (every receiver's), against their plain versions
    seal = []
    for i, (s, c, o, packed, dst) in enumerate(seen.pop("seal")["calls"]):
        got = block_scatter(s, c, o, packed, torch.zeros_like(dst))
        want = block_scatter_ref(s, c, o, packed, torch.zeros_like(dst))
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"block_scatter at executor {i}'s seal: mismatch"
        del got, want
        seal.append((s, c, o, packed))
    staging_rows = dst.shape[0]
    out = torch.zeros_like(dst)
    k2_ms = time_ms(lambda: block_scatter(s, c, o, packed, out), 10)
    k2_plain = time_ms(lambda: block_scatter_ref(s, c, o, packed, out), 3)
    # the library call: one index_copy_ of the packed rows to their staging rows
    idx = plan_index(device, tuple(t.cpu().numpy() for t in (s, c, o)), int(c.sum()))
    k2_lib = time_ms(lambda: out.index_copy_(0, idx, packed[: idx.numel()]), 10)
    k2_bound = (2 * packed.numel() * 4 + 12 * s.numel()) / HBM_BYTES_PER_S * 1e3
    log(f"  block_scatter at the seal: every executor ({i + 1}) equal to block_scatter_ref; executor {i} "
        f"({s.numel()} blocks, {packed.shape[0]} rows of {packed.shape[1] * 4} B): {k2_ms:.4f} ms, "
        f"plain {k2_plain:.4f} ms, library (index_copy_) {k2_lib:.4f} ms, bound {k2_bound:.4f} ms")
    del s, c, o, packed, dst, out, idx
    grid, csizes, cslot, crecv = seen.pop("compact")["args"]
    plans = []
    for j in range(n):
        *plan, filled = ici_exchange.compact_plan(csizes, j, cslot, crecv)
        plans.append((plan, filled))
    k1 = check_k1(device, "the pallas superstep's compaction", grid, plans, crecv)
    del grid, plans
    torch.cuda.empty_cache()
    readings = {"launches": launches, "k2_seal": {"ms": k2_ms, "plain_ms": k2_plain, "library_ms": k2_lib,
                                                  "bound_ms": k2_bound},
                "k1_compaction": k1}

    stock, stock_sizes, stock_secs, stock_launches = run("stock")
    assert np.array_equal(sizes, stock_sizes)
    for j in range(n):
        assert torch.equal(shards[j], stock[j]), f"executor {j}: pallas and stock receive shards differ"
    del stock
    torch.cuda.empty_cache()
    chunks = [[np.concatenate([blocks[m][r].cpu().numpy().reshape(-1).view(np.uint8)
                               for m in owned[i] for r in range(*ranges[j])]) for j in range(n)]
              for i in range(n)]
    expected = oracle_exchange(chunks)
    del chunks
    for j in range(n):
        assert shards[j].cpu().numpy().tobytes() == expected[j], f"executor {j}: receive shard differs from oracle_exchange"
    del expected
    log(f"  every receive shard equals exchange.impl=stock (run_exchange {stock_secs * 1e3:.2f} ms wall, "
        f"launches {stock_launches}) and oracle_exchange")
    readings["run_exchange_ms"] = {"pallas": secs * 1e3, "stock": stock_secs * 1e3}
    keep = {"lengths": lengths, "blocks": blocks, "seal": seal, "staging_rows": staging_rows,
            "capacity": capacity, "sizes": sizes, "shards": shards}
    torch.cuda.empty_cache()

    k3 = check_k3_calls(device, "the superstep's shapes", seen.pop("ring")["calls"])
    readings["k3"] = k3
    row = {
        "name": "ring_exchange_grid", "route": "cuda", "source": "sparkucx_tpu_torch/csrc/ring_exchange.cu",
        "replaces": "sparkucx_tpu/ops/pallas_kernels.py:573",
        "launches": launches["ring_exchange_grid"], "max_abs_err": k3["max_abs_err"],
        "ms": k3["ms"], "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"], "bound_by": "bytes",
        "library_ms": k3["library_ms"],
        "shape": f"n={k3['executors']}, {k3['rows']} rows of {k3['row_bytes']} B, {k3['steps']} steps, windows of "
                 f"{k3['window_rows']} rows; the launch alone {k3['launch_ms']:.4f} ms",
    }
    del seen
    torch.cuda.empty_cache()
    return readings, row, keep


# -- phase 14: K5 against its plain version ------------------------------------------


def fused_case(device, n, slot, lane, gen, rng, per_dest=3, fill=1.0):
    """K5's operands made on the card: per (executor, destination) up to
    ``per_dest`` ragged blocks (about one in five empty) placed back to back
    from the head of the destination slot, so they straddle chunk windows;
    count-0 pads at the packed end; a staging of random (stale) rows, most of
    which no block covers."""
    lens = rng.integers(0, max(1, int(fill * slot) // per_dest) + 1, size=(n, n, per_dest))
    lens[rng.random(lens.shape) < 0.2] = 0
    nb = n * per_dest + 3
    starts, counts, outs = (np.zeros((n, nb), np.int32) for _ in range(3))
    for i in range(n):
        off, b = 0, 0
        for j in range(n):
            at = j * slot
            for k in range(per_dest):
                c = int(lens[i, j, k])
                starts[i, b], counts[i, b], outs[i, b] = at, c, off
                at, off, b = at + c, off + c, b + 1
        outs[i, b:] = off
    p_rows = max(1, int(lens.sum(axis=(1, 2)).max()))
    plan = [torch.from_numpy(a).to(device) for a in (starts, counts, outs)]
    packed = torch.randint(-(2**31), 2**31 - 1, (n * p_rows, lane), dtype=torch.int32, generator=gen, device=device)
    staging = torch.randint(-(2**31), 2**31 - 1, (n * n * slot, lane), dtype=torch.int32, generator=gen, device=device)
    return plan, packed, staging


def check_fused_kernel(device, big=True) -> None:
    """Phase 14: K5 against ``fused_scatter_ring_grid_ref``, bit-equal: the
    grid and the staging it scattered in place; a second run bit-equal."""
    from sparkucx_tpu_torch.ops.ici_exchange import ring_schedule
    from sparkucx_tpu_torch.ops.ring_kernels import fused_scatter_ring_grid, fused_scatter_ring_grid_ref

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 30)
    rng = np.random.default_rng(SEED + 30)

    def case(name, n, chunks, slot, lane, fill=1.0):
        plan, packed, staging = fused_case(device, n, slot, lane, gen, rng, fill=fill)
        steps = ring_schedule(n, chunks).raw_steps()
        w = slot // chunks
        ref_staging = staging.clone()
        again_staging = staging.clone()
        got = fused_scatter_ring_grid(n, slot, w, steps, *plan, packed, staging)
        again = fused_scatter_ring_grid(n, slot, w, steps, *plan, packed, again_staging)
        want = fused_scatter_ring_grid_ref(n, slot, w, steps, *plan, packed, ref_staging)
        torch.cuda.synchronize()
        assert torch.equal(staging, ref_staging), f"fused_scatter_ring_grid {name}: staging"
        assert torch.equal(got, want), f"fused_scatter_ring_grid {name}: grid"
        assert torch.equal(again, got), f"fused_scatter_ring_grid {name}: two runs differ"
        placed = int(plan[1].sum())
        log(f"  fused_scatter_ring_grid {name:<26} n={n} chunks={chunks} slot={slot:>7} row={lane * 4:>3} B "
            f"blocks={plan[1].shape[1]:>3}/executor rows placed={placed:>8}  equal, two runs bit-equal")

    for n in (2, 3, 4, 8):
        for chunks in (1, 2, 4):
            case("ragged+empty+pads+stale", n, chunks, 600 * chunks, 9)
        case("16-byte words", n, 2, 512, 128)
    case("half-full slots", 4, 4, 4096, 128, fill=0.5)
    if big:
        slot = 300_000  # 4 x 4 x 300,000 rows of 512 B = 2.46 GB grid
        case(f"{16 * slot * 512 / 2**30:.2f} GiB grid (past 2**31 B)", 4, 2, slot, 128, fill=0.6)
    torch.cuda.empty_cache()


# -- phase 15: the fused send side at groupby_big's four-executor shape ------------------


def fused_send_side(device, keep, n=4, reps=5) -> dict:
    """Phase 15: phase 13's recorded seal inputs (every executor's plan and
    packed blocks) through ``build_fused_ici_exchange`` on a fresh staging:
    K5, then K1 per receiver.  Held bit-equal to phase 13's K2 -> K3 -> K1
    receive shards; K5 launched once and K2, K3 not at all; K5 held against
    its plain version at this shape and timed beside the two-launch route,
    the plain version, the library pair and the bound.  Returns K5's row."""
    from sparkucx_tpu_torch.ops import ring_kernels
    from sparkucx_tpu_torch.ops.block_kernels import block_gather, block_scatter
    from sparkucx_tpu_torch.ops.exchange import ExchangeSpec
    from sparkucx_tpu_torch.ops.ici_exchange import DEFAULT_CHUNKS_PER_DEST, build_fused_ici_exchange
    from sparkucx_tpu_torch.ops.ring_kernels import (
        fused_scatter_ring_grid, fused_scatter_ring_grid_ref, ring_exchange_grid,
    )

    seal, staging_rows = keep["seal"], keep["staging_rows"]
    slot = staging_rows // n
    nb = max(int(c.numel()) for _, c, _, _ in seal)
    p_rows = max(int(pk.shape[0]) for _, _, _, pk in seal)
    starts, counts, outs = (torch.zeros((n, nb), dtype=torch.int32, device=device) for _ in range(3))
    packed = torch.empty((n * p_rows, LANE), dtype=torch.int32, device=device)
    totals = []
    for i, (s_, c_, o_, pk) in enumerate(seal):
        b, total = int(c_.numel()), int(pk.shape[0])
        starts[i, :b], counts[i, :b], outs[i, :b] = s_, c_, o_
        outs[i, b:] = total  # count-0 pads at the packed end
        packed[i * p_rows : i * p_rows + total] = pk
        totals.append(total)
    keep.pop("seal")
    del seal
    sizes = keep["sizes"]  # row j: rows receiver j got from each sender
    spec = ExchangeSpec(n, staging_rows, staging_rows, LANE)
    fn = build_fused_ici_exchange([device] * n, spec, nb, chunks_per_dest=DEFAULT_CHUNKS_PER_DEST)
    steps, w = fn.schedule.raw_steps(), slot // fn.schedule.chunks
    staging = torch.zeros((n * staging_rows, LANE), dtype=torch.int32, device=device)
    log(f"  {n} executors, {nb} blocks / {max(totals)} packed rows of {ROW} B at most per executor, "
        f"grid {n * staging_rows} rows ({n * staging_rows * ROW / 1e9:.2f} GB), windows of {w} rows")

    kernels = (fused_scatter_ring_grid, block_scatter, ring_exchange_grid, block_gather)
    for k in kernels:
        k.launches = 0
    (recv, rs), secs = wall(lambda: fn(starts, counts, outs, packed, staging, sizes.T))
    launches = {k.__name__: k.launches for k in kernels}
    assert (launches["fused_scatter_ring_grid"], launches["block_scatter"], launches["ring_exchange_grid"]) == (1, 0, 0), (
        f"the fused send side launched {launches}")
    assert np.array_equal(rs.numpy(), sizes), "fused recv_sizes differ from phase 13's"
    for j in range(n):
        used = int(sizes[j].sum())
        assert torch.equal(recv[j * staging_rows : j * staging_rows + used], keep["shards"][j]), (
            f"receiver {j}: the fused send side differs from K2 -> K3 -> K1")
    log(f"  build_fused_ici_exchange: first call {secs * 1e3:.2f} ms wall, launches {launches}; every receive "
        "shard bit-equal to phase 13's K2 -> K3 -> K1")
    del recv
    torch.cuda.empty_cache()

    # K5 against its plain version at this shape, on fresh stagings
    got = fused_scatter_ring_grid(n, slot, w, steps, starts, counts, outs, packed, torch.zeros_like(staging))
    want = fused_scatter_ring_grid_ref(n, slot, w, steps, starts, counts, outs, packed, torch.zeros_like(staging))
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    assert err == 0, "fused_scatter_ring_grid at the fused send side's shapes differs from its plain version"
    del got, want
    torch.cuda.empty_cache()

    k5_ms = time_ms(lambda: fused_scatter_ring_grid(n, slot, w, steps, starts, counts, outs, packed, staging), reps)
    # the kernel alone: one launch on tables built once (no plan check, no upload)
    launch = ring_kernels._Launch(n, slot, w, steps, staging, torch.empty_like(staging), packed=packed)
    lib = ring_kernels._library()
    launch_ms = time_ms(lambda: lib.fused_scatter_launch(
        starts.data_ptr(), counts.data_ptr(), outs.data_ptr(), nb, n, launch.fused, p_rows, staging_rows,
        launch.windows, launch.span_start, launch.num_windows, launch.span_rows, launch.row_bytes, launch.wide,
        launch.stream), reps)
    builder_ms = time_ms(lambda: fn(starts, counts, outs, packed, staging, sizes.T), 3)
    shard = [(starts[i], counts[i], outs[i], packed[i * p_rows : (i + 1) * p_rows],
              staging[i * staging_rows : (i + 1) * staging_rows]) for i in range(n)]

    def two_launches():
        for args in shard:
            block_scatter(*args)
        return ring_exchange_grid(n, slot, w, steps, staging)

    two_ms = time_ms(two_launches, reps)
    plain_ms = time_ms(lambda: fused_scatter_ring_grid_ref(n, slot, w, steps, starts, counts, outs, packed, staging), 1)
    # library pair: index_copy_ of each executor's packed rows, then the
    # sender-major transpose of the whole staging
    idx = []
    for i in range(n):
        c_, s_, o_ = (t.cpu().numpy().astype(np.int64) for t in (counts[i], starts[i], outs[i]))
        idx.append(torch.from_numpy(np.repeat(s_ - o_, c_) + np.arange(int(c_.sum()))).to(device))

    def library():
        for i in range(n):
            shard[i][4].index_copy_(0, idx[i], shard[i][3][: totals[i]])
        return staging.view(n, n, slot, LANE).transpose(0, 1).contiguous()

    lib_ms = time_ms(library, reps)
    # the function's bytes: each packed row read once, the grid written once,
    # and each staging row read once (a covered one as it is written into
    # the staging, which is written once); this two-phase design moves more,
    # re-reading the packed rows' staging copies (2 x packed + 2 x grid)
    grid_bytes = staging.numel() * 4
    bound_ms = (sum(totals) * ROW + 2 * grid_bytes) / HBM_BYTES_PER_S * 1e3
    two_phase_ms = (2 * sum(totals) * ROW + 2 * grid_bytes) / HBM_BYTES_PER_S * 1e3
    row = {
        "name": "fused_scatter_ring_grid", "route": "cuda", "source": "sparkucx_tpu_torch/csrc/ring_exchange.cu",
        "replaces": "sparkucx_tpu/ops/pallas_kernels.py:805",
        "launches": launches["fused_scatter_ring_grid"], "max_abs_err": err,
        "ms": k5_ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": lib_ms,
        "shape": f"n={n}, {sum(totals)} packed rows of {ROW} B in {n} x {nb} blocks, grid {staging.shape[0]} rows, "
                 f"{len(steps)} steps, windows of {w} rows",
    }
    log(f"  fused_scatter_ring_grid at the fused send side's shapes: {k5_ms:.4f} ms (one launch on prebuilt tables "
        f"{launch_ms:.4f} ms), build_fused_ici_exchange {builder_ms:.4f} ms, K2 x {n} + K3 {two_ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound {bound_ms:.4f} ms (the two-phase design's "
        f"bytes {two_phase_ms:.4f} ms)  [{row['shape']}]")
    readings = {"launches": launches, "k5_ms": k5_ms, "k5_launch_ms": launch_ms, "builder_ms": builder_ms,
                "two_launch_ms": two_ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound_ms,
                "two_phase_bytes_ms": two_phase_ms, "first_call_ms": secs * 1e3}
    del starts, counts, outs, packed, staging, shard, idx, launch
    torch.cuda.empty_cache()
    return row, readings


# -- phase 16: the chunked plan at groupby_big's four-executor shape -----------------------


def chunked_plan(device, keep, n=4, mappers=200, reducers=200) -> dict:
    """Phase 16: phase 13's GroupByTest under ``slot_quota_rows`` = a quarter
    of the staging slot and ``pipeline_depth=2``, ``exchange.impl`` stock and
    pallas, ``host_recv_mode='device'``: every fetched block equal to the
    written one, every spliced receive shard equal to phase 13's (which
    equals ``oracle_exchange``), K2, K3 and K1 counted per sub-round and the
    ``run_exchange`` times beside phase 13's single-shot ones, then two more
    timed runs on fresh shuffles, each with the caching allocator's device
    allocations, frees and retries.  On a further shuffle, recorded, K3 and K1 held against their plain versions on every
    sub-round's inputs and timed at those shapes (recording keeps those
    inputs alive, so this run is not the timed one); the device's busy
    share of a third, profiled ``run_exchange``.  Then the ``memmap``
    receive mode, chunked, through the ShuffleManager SPI at phase 4's
    size."""
    from sparkucx_tpu_torch.config import TpuShuffleConf
    from sparkucx_tpu_torch.core.block import ShuffleBlockId
    from sparkucx_tpu_torch.ops import exchange, ici_exchange
    from sparkucx_tpu_torch.ops.block_kernels import block_gather, block_scatter
    from sparkucx_tpu_torch.ops.ring_kernels import ring_exchange_grid
    from sparkucx_tpu_torch.transport.tpu import TpuShuffleCluster

    lengths, blocks, sizes, shards = keep["lengths"], keep["blocks"], keep["sizes"], keep["shards"]
    slot = keep["staging_rows"] // n
    quota = slot // 4
    out = {"slot_quota_rows": quota, "pipeline_depth": 2}
    kernels = (block_scatter, ring_exchange_grid, block_gather)

    def shuffle(cluster, sid):
        meta = cluster.create_shuffle(sid, mappers, reducers)
        for m in range(mappers):
            t = cluster.transport(meta.map_owner[m])
            w = t.store.map_writer(sid, m)
            for r in range(reducers):
                w.write_partition_device(r, blocks[m][r], length=int(lengths[m, r]))
            t.commit_block(w.commit().pack())
        return meta

    for impl in ("stock", "pallas"):
        conf = TpuShuffleConf(block_alignment=ROW, staging_capacity_per_executor=keep["capacity"], device_staging=True,
                              keep_device_recv=True, host_recv_mode="device", exchange_impl=impl,
                              slot_quota_rows=quota, pipeline_depth=2)
        cluster = TpuShuffleCluster(conf, devices=[device] * n)
        meta = shuffle(cluster, 4)
        for k in kernels:
            k.launches = 0
        before = alloc_counters()
        _, secs = wall(lambda: cluster.run_exchange(4))
        allocs = {k: v - before[k] for k, v in alloc_counters().items()}
        used = {k.__name__: k.launches for k in kernels}
        subrounds = cluster.stats.summary("exchange.pipeline.drain").ops
        assert subrounds > 1, f"exchange.impl={impl}: the plan did not chunk"
        want = {"block_scatter": n, "ring_exchange_grid": subrounds if impl == "pallas" else 0,
                "block_gather": n * subrounds}
        assert used == want, f"exchange.impl={impl}: launches {used}, expected {want} ({subrounds} sub-rounds)"
        assert np.array_equal(meta.recv_sizes[0], sizes), f"exchange.impl={impl}: receive sizes differ"
        for j in range(n):
            rows = int(sizes[j].sum())
            assert torch.equal(meta.recv_device[0][j][:rows], shards[j]), (
                f"exchange.impl={impl}: receiver {j}'s spliced shard differs from the single-shot one")
        for r in range(reducers):
            j = meta.owner_of_reduce(r)
            packed, _ = cluster.transport(j).fetch_blocks_device([ShuffleBlockId(4, m, r) for m in range(mappers)])
            assert torch.equal(packed, torch.cat([blocks[m][r] for m in range(mappers)])), (
                f"exchange.impl={impl}: reducer {r}'s fetch differs from the written blocks")
        phase_ms = cluster.device_times_ms(4)
        out[impl] = {"run_exchange_ms": secs * 1e3, "exchange_ms": phase_ms.get("exchange"),
                     "seal_ms": phase_ms.get("seal"), "subrounds": subrounds, "launches": used, "allocator": allocs}
        log(f"  exchange.impl={impl}, slot_quota_rows={quota} (a quarter of the {slot}-row slot), depth 2: "
            f"{subrounds} sub-rounds, run_exchange {secs * 1e3:.2f} ms wall (device: seal {phase_ms.get('seal', 0):.2f} "
            f"ms, exchange {phase_ms.get('exchange', 0):.2f} ms; allocator {allocs}), launches {used}; receive "
            "shards equal the single-shot ones, every fetch equals its written blocks")
        cluster.remove_shuffle(4)
        del meta, packed

        # the same timed run again, twice, on fresh shuffles: whether a slow
        # run comes back, and what the caching allocator did in each
        out[impl]["repeats"] = []
        for sid in (7, 8):
            shuffle(cluster, sid)
            before = alloc_counters()
            _, t = wall(lambda: cluster.run_exchange(sid))
            allocs = {k: v - before[k] for k, v in alloc_counters().items()}
            d = cluster.device_times_ms(sid)
            out[impl]["repeats"].append({"run_exchange_ms": t * 1e3, "seal_ms": d.get("seal"),
                                         "exchange_ms": d.get("exchange"), "allocator": allocs})
            log(f"  exchange.impl={impl}, again: run_exchange {t * 1e3:.2f} ms wall (device: seal "
                f"{d.get('seal', 0):.2f} ms, exchange {d.get('exchange', 0):.2f} ms; allocator {allocs})")
            cluster.remove_shuffle(sid)
        torch.cuda.empty_cache()

        # K3 and K1 at the sub-rounds' own shapes, on a second run's recorded inputs
        shuffle(cluster, 5)
        seen = {"ring": {}, "k1": {}}
        restores = [recording(ici_exchange, "ring_exchange_grid", seen["ring"]),
                    recording(exchange if impl == "stock" else ici_exchange, "block_gather", seen["k1"])]
        try:
            cluster.run_exchange(5)
        finally:
            for restore in restores:
                restore()
        cluster.remove_shuffle(5)
        label = f"the chunked plan's sub-rounds ({impl})"
        assert len(seen["k1"]["calls"]) == n * subrounds
        out[impl]["k1"] = check_k1_calls(device, label, seen["k1"]["calls"])
        if impl == "pallas":
            assert len(seen["ring"]["calls"]) == subrounds
            out[impl]["k3"] = check_k3_calls(device, label, seen["ring"]["calls"])
        del seen
        torch.cuda.empty_cache()

        # the device's busy share of one chunked run_exchange, on a third shuffle
        shuffle(cluster, 6)
        before = alloc_counters()
        out[impl]["busy"] = profile_call(f"chunked run_exchange ({impl})", lambda: cluster.run_exchange(6), top=8)
        log(f"    allocator {({k: v - before[k] for k, v in alloc_counters().items()})}")
        cluster.remove_shuffle(6)
        del cluster
        torch.cuda.empty_cache()
    report = host_route(device, host_recv_mode="memmap", slot_quota_rows=8192, pipeline_depth=2)["report"]
    drain = [line for line in report.splitlines() if line.startswith("exchange.pipeline.drain")]
    log(f"  memmap: {drain[0] if drain else report}")
    return out


# -- phase 17: the ici benchmark mode on the card -------------------------------------------


def ici_benchmark(device, slot_rows=8192, held_width=8) -> dict:
    """Phase 17: ``measure_ici((2, 4, 8), 8192, 128)`` (the CLI's ``-s 4m``)
    on the card: stock against pallas per width, the fused send side at 8.
    Then one more pass at ``held_width`` executors under recording: K1 (the
    stock exchange and every compaction), K3 and K5 held against their plain
    versions on that pass's own inputs, and K1 and K3 timed there."""
    from sparkucx_tpu_torch.ops import exchange, ici_exchange
    from sparkucx_tpu_torch.ops.ring_kernels import fused_scatter_ring_grid, fused_scatter_ring_grid_ref
    from sparkucx_tpu_torch.perf.benchmark import measure_ici
    from sparkucx_tpu_torch.utils.stats import StatsAggregator

    stats = StatsAggregator()
    rows = []
    r = measure_ici((2, 4, 8), slot_rows, 128, stats=stats, device=device,
                    report=lambda impl, n, it, dt, tot: rows.append((impl, n, dt)))
    for n, p in sorted(r["per_n"].items()):
        times = [dt * 1e3 for impl, m, dt in rows if m == n]
        log(f"  n={n}: stock {p['stock_gbps']:.2f} GB/s, pallas {p['pallas_gbps']:.2f} GB/s "
            f"({p['pallas_per_link_gbps']:.3f} GB/s aggregate / {2 * n}), {p['supersteps']} supersteps x "
            f"{p['chunks']} chunks; bit-identical; iterations {', '.join(f'{t:.3f}' for t in times)} ms")
    f = r["fused"]
    log(f"  fused send side (n={f['executors']}): K5 launches {f['k5_launches']}, bit-identical to scatter-then-stock")
    for line in stats.report().splitlines():
        log(f"  {line}")

    seen = {"stock": {}, "ring": {}, "compact": {}, "fused": {}}
    restores = [recording(exchange, "block_gather", seen["stock"]),
                recording(ici_exchange, "ring_exchange_grid", seen["ring"]),
                recording(ici_exchange, "block_gather", seen["compact"]),
                recording(ici_exchange, "fused_scatter_ring_grid", seen["fused"])]
    try:
        measure_ici((held_width,), slot_rows, 128, iterations=1, device=device)
    finally:
        for restore in restores:
            restore()
    label = f"the ici benchmark (n={held_width})"
    r["held"] = {"executors": held_width,
                 "k1_stock": check_k1_calls(device, f"{label}, stock", seen["stock"]["calls"]),
                 "k1_compaction": check_k1_calls(device, f"{label}, compaction", seen["compact"]["calls"]),
                 "k3": check_k3_calls(device, label, seen["ring"]["calls"])}
    (args,) = seen["fused"]["calls"]
    *head, staging = args  # the staging the call scattered into: scattering again changes nothing
    got = fused_scatter_ring_grid(*head, staging.clone())
    want = fused_scatter_ring_grid_ref(*head, staging.clone())
    torch.cuda.synchronize()
    assert torch.equal(got, want), f"fused_scatter_ring_grid at {label}: differs from its plain version"
    log(f"  fused_scatter_ring_grid at {label}: equal to fused_scatter_ring_grid_ref")
    del seen, args, head, staging, got, want
    torch.cuda.empty_cache()
    return r


# -- phase 18: TPC-H Q18 whole at SF=10 ---------------------------------------------------

Q18_SF10_ORDERS = 15_000_000
Q18_SF10_ROWS = 59_986_052  # lineitem at SF=10
Q18_SF10_CUSTOMERS = 1_500_000
Q18_QUANTITY = 300  # TPC-H v3 §2.4.18.3, the substitution parameter's validation value


def order_number(orderkeys: np.ndarray) -> np.ndarray:
    """dbgen's sparse order keys back to the orders' numbers 0, 1, ..."""
    k = orderkeys.astype(np.int64)
    return (((k >> 5) << 3) | (k & 7)) - 1


def q18_tables(seed: int, orders: int = Q18_SF10_ORDERS, rows: int = Q18_SF10_ROWS,
               customers: int = Q18_SF10_CUSTOMERS):
    """Q18's three tables per TPC-H v3 §4.2.3, from ``seed``: lineitem as in
    phase 12 (``q18_lineitem``); orders with dbgen's sparse keys, o_custkey
    in 1..customers never a multiple of 3, o_totalprice the int32 cents of
    its lines' quantity x retail price (900.00-2100.00), o_orderdate in
    [STARTDATE, ENDDATE - 151]; customer keys 1..customers, c_name's number
    being the key.  Returns (l_orderkey, l_quantity (R, 1), o_orderkey,
    o_vals (O, 3) = (custkey, totalprice, orderdate), c_custkey, c_vals (C,
    1))."""
    l_orderkey, l_quantity = q18_lineitem(seed, orders, rows)
    rng = np.random.default_rng(seed + 100)
    i = np.arange(1, orders + 1, dtype=np.int64)
    o_orderkey = (((i >> 3) << 5) | (i & 7)).astype(np.uint32)
    k = rng.integers(0, customers - customers // 3, orders)  # the k-th key that is not a multiple of 3
    o_custkey = 3 * (k // 2) + 1 + (k % 2)
    line_cents = l_quantity[:, 0].astype(np.int64) * rng.integers(90_000, 210_001, rows)
    totalprice = np.bincount(order_number(l_orderkey), weights=line_cents, minlength=orders).astype(np.int32)
    del line_cents
    orderdate = rng.integers(_STARTDATE, _ENDDATE - 151 + 1, orders)
    o_vals = np.stack([o_custkey, totalprice, orderdate], axis=1).astype(np.int32)
    c_custkey = np.arange(1, customers + 1, dtype=np.uint32)
    return l_orderkey, l_quantity, o_orderkey, o_vals, c_custkey, c_custkey.astype(np.int32)[:, None]


def q18_result(orderkey, custkey, name, price, date, qty, limit: int | None = 100) -> np.ndarray:
    """Q18's output rows (c_name, c_custkey, o_orderkey, o_orderdate,
    o_totalprice, sum(l_quantity)) ORDER BY o_totalprice DESC, o_orderdate,
    then o_orderkey (a tie-break, so the LIMIT is exact), LIMIT ``limit``
    (every row with ``None``)."""
    order = np.lexsort((orderkey.astype(np.int64), date, -price.astype(np.int64)))[:limit]
    return np.stack([name[order], custkey[order], orderkey[order].astype(np.int64), date[order],
                     price[order], qty[order]], axis=1).astype(np.int64)


def torch_op_choices(device, rows: torch.Tensor, n: int) -> dict:
    """The two torch-op choices of the join path, timed on the orders
    exchange's rows: ``columnar.take_rows`` (16-byte rows gathered as
    complex128 elements) against ``index_select`` over a seeded permutation,
    and ``relational.row_cumsum`` (one flat scan) against ``torch.cumsum``
    along dim 1 of (n, rows / n) int64."""
    from sparkucx_tpu_torch.ops.columnar import take_rows
    from sparkucx_tpu_torch.ops.relational import row_cumsum

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    idx = torch.randperm(rows.shape[0], device=device, generator=gen)
    assert torch.equal(take_rows(rows, idx), rows.index_select(0, idx)), "take_rows differs from index_select"
    counts = torch.randint(0, 3, (n, rows.shape[0] // n), dtype=torch.int64, device=device, generator=gen)
    assert torch.equal(row_cumsum(counts), torch.cumsum(counts, dim=1)), "row_cumsum differs from torch.cumsum"
    t = time_rounds({"take_rows": lambda: take_rows(rows, idx), "index_select": lambda: rows.index_select(0, idx),
                     "row_cumsum": lambda: row_cumsum(counts), "cumsum_dim1": lambda: torch.cumsum(counts, dim=1)}, 5)
    ms = {k: statistics.median(v) for k, v in t.items()}
    log(f"  torch ops on the orders exchange's {rows.shape[0]} rows of {rows.shape[1] * rows.element_size()} B: "
        f"take_rows {ms['take_rows']:.4f} ms against index_select {ms['index_select']:.4f} ms (equal rows); "
        f"row_cumsum {ms['row_cumsum']:.4f} ms against cumsum along dim 1 {ms['cumsum_dim1']:.4f} ms "
        f"over ({n}, {counts.shape[1]}) int64 (equal sums)")
    del idx, counts
    return ms


def tpch_q18(device, seed: int, n: int = 4, orders: int = Q18_SF10_ORDERS, rows: int = Q18_SF10_ROWS,
             customers: int = Q18_SF10_CUSTOMERS, reps: int = 3) -> dict:
    """Phase 18: TPC-H Q18 whole at SF=10 on four executors sharing the card:
    GROUP BY l_orderkey SUM(l_quantity) (``run_grouped_aggregate``, fused,
    K4), HAVING > 300 on the host, ``run_hash_join`` with orders on
    orderkey, ``run_hash_join`` with customer on custkey (K1 counted for
    each join: 0 just before, read just after), ORDER BY LIMIT 100 on the
    host, against a numpy oracle bit for bit; K1 held against its plain
    version on each join's recorded exchanges, timed at the orders
    exchange; then both joins timed on device tensors."""
    from sparkucx_tpu_torch.ops import columnar, relational
    from sparkucx_tpu_torch.ops.block_kernels import block_gather
    from sparkucx_tpu_torch.ops.relational import (
        AggregateSpec, prepare_hash_join, run_grouped_aggregate, run_hash_join,
    )
    from sparkucx_tpu_torch.ops.ring_kernels import ring_combine_grid

    t0 = time.perf_counter()
    l_orderkey, l_quantity, o_orderkey, o_vals, c_custkey, c_vals = q18_tables(seed, orders, rows, customers)
    log(f"  SF=10: lineitem {rows}, orders {orders}, customer {customers} rows made from seed {seed} "
        f"in {time.perf_counter() - t0:.1f} s")
    devices = [device] * n
    stats = {"lineitem": rows, "orders": orders, "customer": customers}

    # the numpy oracle: sums by order number, the qualifying orders, their customers
    t0 = time.perf_counter()
    sums = np.bincount(order_number(l_orderkey), weights=l_quantity[:, 0], minlength=orders)
    q = np.flatnonzero(sums > Q18_QUANTITY)
    oracle_rows = (o_orderkey[q], o_vals[q, 0], o_vals[q, 0], o_vals[q, 1], o_vals[q, 2], sums[q].astype(np.int64))
    want_all, want = q18_result(*oracle_rows, limit=None), q18_result(*oracle_rows)
    oracle_s = time.perf_counter() - t0

    # stage 1: GROUP BY l_orderkey SUM(l_quantity), fused (K4), every group against the oracle's sums
    cap = -(-rows // n)
    spec = AggregateSpec(n, cap, cap // 2, ("sum",), partial=True, combine="auto")
    seen = {}
    restore = recording(relational, "combine_axis_grid", seen)
    ring_combine_grid.launches = 0
    try:
        (gk, gv, _), agg_s = wall(lambda: run_grouped_aggregate(devices, spec, l_orderkey, l_quantity))
    finally:
        restore()
    k4 = ring_combine_grid.launches
    assert k4 > 0, "Q18's GROUP BY did not run through K4"
    assert gk.size == orders, f"{gk.size} groups, {orders} orders"
    assert np.array_equal(gk, o_orderkey), "Q18's GROUP BY keys differ from the orders' keys"
    assert gv.shape == (orders, 1) and np.array_equal(gv[:, 0], sums.astype(np.int32)), (
        "Q18's GROUP BY sums differ from the numpy oracle's")
    stats["k4_launches"] = k4
    del l_orderkey, l_quantity
    # stage 2: HAVING sum(l_quantity) > 300, on the host
    qual = gv[:, 0] > Q18_QUANTITY
    hk, hv = gk[qual], gv[qual]
    assert hk.size == q.size and np.array_equal(hk, o_orderkey[q]), "HAVING keeps other orders than the oracle's"
    log(f"  GROUP BY l_orderkey (fused, K4 launches {k4}): {gk.size} groups in {agg_s:.2f} s (host driver), "
        f"every key and sum equal to the numpy oracle's; {hk.size} orders with sum(l_quantity) > {Q18_QUANTITY}")
    # K4 against its plain version on the GROUP BY's recorded exchange, timed
    row = k4_timings(device, seen.pop("args"))
    del seen
    stats["k4"] = {k: row[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "shape")}
    log(f"  ring_combine_grid at Q18 SF=10's shapes: equal to ring_combine_grid_ref; {row['ms']:.4f} ms, "
        f"plain {row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms  "
        f"[{row['shape']}]")
    del row
    torch.cuda.empty_cache()

    def counted_join(name, *args):
        """One ``run_hash_join``, K1 counted: 0 just before, read just after;
        its two exchanges' inputs kept."""
        seen = {}
        restore = recording(columnar, "exchange_sorted_rows", seen)
        block_gather.launches = 0
        try:
            out, secs = wall(lambda: run_hash_join(devices, *args))
        finally:
            restore()
        launches = block_gather.launches
        assert launches == 2 * n, f"the {name} join launched K1 {launches} times, expected 2n = {2 * n}"
        stats[f"{name}_k1_launches"] = launches
        stats[f"{name}_host_driver_s"] = secs
        return out, seen["calls"]

    # stage 3: the qualifying aggregates (build) JOIN orders (probe) ON orderkey
    (k3, b3, p3), calls3 = counted_join("orders", hk, hv.astype(np.int32), o_orderkey, o_vals)
    by_key = np.argsort(k3, kind="stable")
    assert (k3.size == q.size and np.array_equal(k3[by_key], o_orderkey[q])
            and np.array_equal(b3[by_key, 0], sums[q].astype(np.int32)) and np.array_equal(p3[by_key], o_vals[q])), (
        "the orders join's rows differ from the numpy oracle's")
    # stage 4: those rows (build, keyed by custkey) JOIN customer (probe) ON custkey
    build4 = np.concatenate([k3.astype(np.int32)[:, None], b3, p3[:, 1:]], axis=1)  # orderkey, sum, price, date
    (k4_, b4, p4), calls4 = counted_join("customer", p3[:, 0].astype(np.uint32), build4, c_custkey, c_vals)
    joined = (b4[:, 0], k4_.astype(np.int64), p4[:, 0], b4[:, 2], b4[:, 3], b4[:, 1])
    every = q18_result(*joined, limit=None)
    assert every.shape == want_all.shape and np.array_equal(every, want_all), (
        "the customer join's rows differ from the numpy oracle's")
    # stage 5: ORDER BY o_totalprice DESC, o_orderdate LIMIT 100, on the host
    got = q18_result(*joined)
    assert got.shape == want.shape and np.array_equal(got, want), "Q18 differs from the numpy oracle"
    log(f"  Q18 SF=10: {len(k3)} joined orders, {len(k4_)} rows with their customers, every row of both joins and "
        f"the {len(got)} result rows equal to the numpy oracle's bit for bit (oracle {oracle_s:.2f} s); K1 launches {stats['orders_k1_launches']} "
        f"and {stats['customer_k1_launches']} (2n each); host drivers {stats['orders_host_driver_s']:.2f} s and "
        f"{stats['customer_host_driver_s']:.2f} s; first row {got[0].tolist()}")
    stats["result_rows"] = int(len(got))
    stats["qualifying_orders"] = int(hk.size)

    # K1 against its plain version on both joins' recorded exchanges, timed at the orders side's receivers
    orders_args = calls3[1]  # the build side is exchanged first, then the probe side
    for label, args in [("Q18's qualifying-orders exchange", calls3[0]), ("Q18's customer join, build", calls4[0]),
                        ("Q18's customer exchange", calls4[1])]:
        hold_k1(device, label, *columnar_plans(args))
    log("  block_gather on the other three exchanges: every receiver equal to block_gather_ref")
    stats["k1_orders"] = check_k1_columnar(device, "Q18's orders exchange", orders_args)
    stats["torch_ops"] = torch_op_choices(device, orders_args[1], n)
    del calls3, calls4, orders_args
    torch.cuda.empty_cache()

    # the two joins on device tensors (run_hash_join's own set-up): CUDA events, peak memory, one profile each
    for name, (bk, bv, pk, pv) in (("orders", (hk, hv.astype(np.int32), o_orderkey, o_vals)),
                                   ("customer", (p3[:, 0].astype(np.uint32), build4, c_custkey, c_vals))):
        fn, args, _ = prepare_hash_join(devices, bk, bv, pk, pv)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        out = fn(*args)
        assert int(out[3].sum()) == (len(k3) if name == "orders" else len(k4_)), f"{name} join on device tensors"
        stats[f"{name}_join_ms"] = time_ms(lambda: fn(*args), reps)
        stats[f"{name}_join_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        stats[f"{name}_join_busy"] = profile_call(f"Q18 {name} join", lambda: fn(*args), top=8)
        log(f"  {name} join on device tensors ({len(bk)} build x {len(pk)} probe rows): "
            f"{stats[f'{name}_join_ms']:.4f} ms (median of {reps}), peak device memory "
            f"{stats[f'{name}_join_peak_gb']:.2f} GB")
        del fn, args, out
    torch.cuda.empty_cache()
    return stats


# -- phase 19: SparkTC --------------------------------------------------------------------

SPARKTC_EDGES, SPARKTC_VERTICES = 200, 100  # spark-examples SparkTC.scala numEdges / numVertices
TC_SCALED_VERTICES = 4096


def sparktc_graph(seed: int, edges: int, vertices: int) -> np.ndarray:
    """SparkTC.scala's ``generateGraph``: distinct random edges (from, to),
    from != to, until there are ``edges``, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    out = np.zeros((0, 2), np.int64)
    while len(out) < edges:
        e = rng.integers(0, vertices, size=(2 * edges, 2))
        out = np.unique(np.concatenate([out, e[e[:, 0] != e[:, 1]]]), axis=0)
    return out[rng.permutation(len(out))[:edges]].astype(np.uint32)


def reachability_oracle(edges: np.ndarray, vertices: int) -> np.ndarray:
    """The closure by scipy: every vertex's breadth-first reach, (a, a) only
    where a lies on a cycle (a strongly connected component of more than one
    vertex, or a self-loop).  (C, 2) uint32, ascending."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import breadth_first_order, connected_components

    g = csr_matrix((np.ones(len(edges), np.int8), (edges[:, 0], edges[:, 1])), shape=(vertices, vertices))
    _, label = connected_components(g, directed=True, connection="strong")
    on_cycle = (np.bincount(label)[label] > 1) | (g.diagonal() > 0)
    parts = []
    for a in range(vertices):
        reach = breadth_first_order(g, a, directed=True, return_predecessors=False)
        reach = reach if on_cycle[a] else reach[reach != a]
        parts.append(np.stack([np.full(reach.size, a), reach], axis=1))
    pairs = np.concatenate(parts).astype(np.int64)
    return pairs[np.argsort((pairs[:, 0] << 32) | pairs[:, 1])].astype(np.uint32)


def pair_mix_host(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Host twin of ops/tc.py ``_pair_mix`` (numpy uint32 wraparound)."""
    with np.errstate(over="ignore"):
        h = a.astype(np.uint32) * np.uint32(2654435761)
        h = h ^ ((h >> np.uint32(15)) | (b.astype(np.uint32) * np.uint32(40503)))
        return h * np.uint32(2654435761)


def tc_spec_for(edges: np.ndarray, closure: np.ndarray, n: int, headroom: float = 1.1):
    """A ``TcSpec`` sized from the closure: each capacity the most any
    executor needs in any round (the last round needs the most, since the
    closure only grows), times ``headroom``, rounded up to 1024 rows."""
    from sparkucx_tpu_torch.ops.relational import hash_owners_host
    from sparkucx_tpu_torch.ops.tc import TcSpec

    def most(owners, weights=None):
        return float(np.bincount(owners, weights=weights, minlength=n).max())

    def size(rows):
        return int(-(-int(rows * headroom) // 1024) * 1024)

    v = int(max(edges.max(), closure.max())) + 1
    outdeg = np.bincount(edges[:, 0], minlength=v)
    src_sorted = edges[np.argsort(edges[:, 0], kind="stable")]
    first = np.cumsum(outdeg) - outdeg
    a, b = closure[:, 0], closure[:, 1]
    tc_recv = most(hash_owners_host(b, n))
    join = most(hash_owners_host(b, n), outdeg[b])
    # the new paths (a, c) of the last round, for the union exchange's receivers
    reps = outdeg[b]
    pos = np.repeat(first[b] - np.cumsum(reps) + reps, reps) + np.arange(int(reps.sum()))
    new_c = src_sorted[pos, 1]
    union = np.bincount(hash_owners_host(pair_mix_host(np.repeat(a, reps), new_c), n), minlength=n) \
        + np.bincount(hash_owners_host(pair_mix_host(a, b), n), minlength=n)
    tc_cap = size(max(most(hash_owners_host(pair_mix_host(a, b), n)), -(-len(edges) // n)))
    join_cap = size(max(join, union.max() - tc_cap))
    return TcSpec(n, size(-(-len(edges) // n)), tc_cap, join_cap,
                  edge_recv_capacity=size(most(hash_owners_host(edges[:, 0], n))), tc_recv_capacity=size(tc_recv))


def transitive_closure(device, label: str, edges: np.ndarray, want: np.ndarray, n: int = 4) -> dict:
    """One graph through ``run_transitive_closure`` (K1 counted: 0 just
    before, read just after; n for the prep, 2n a round), equal to ``want``
    bit for bit; then the rounds again through ``build_tc_prep`` /
    ``build_tc_step``, each timed on the host clock and between CUDA
    events; the last round profiled and its two exchanges' K1 held against
    its plain version (the union exchange timed)."""
    from sparkucx_tpu_torch.ops import columnar
    from sparkucx_tpu_torch.ops.block_kernels import block_gather
    from sparkucx_tpu_torch.ops.tc import build_tc_prep, build_tc_step, check_overflow, run_transitive_closure, shard_pairs

    spec = tc_spec_for(edges, want, n)
    devices = [device] * n
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    block_gather.launches = 0
    (got, rounds), secs = wall(lambda: run_transitive_closure(devices, spec, edges))
    launches = block_gather.launches
    peak = torch.cuda.max_memory_allocated() / 1e9
    assert launches == n * (1 + 2 * rounds), f"{label}: K1 launched {launches} times in {rounds} rounds"
    assert got.shape == want.shape and np.array_equal(got, want), f"{label}: the closure differs from the oracle"
    log(f"  {label}: {len(edges)} edges, closure {len(got)} pairs equal to the oracle bit for bit, {rounds} rounds "
        f"to the fixpoint, K1 launches {launches} (n + 2n a round); run_transitive_closure {secs:.3f} s; "
        f"capacities a executor: tc {spec.tc_capacity}, tc_recv {spec.tc_recv}, join {spec.join_capacity}; "
        f"peak device memory {peak:.2f} GB")

    # the rounds again, each timed
    e_src, e_dst, e_num = shard_pairs(np.unique(edges, axis=0), n, spec.edge_capacity, device)
    prep = build_tc_prep(devices, spec)
    step = build_tc_step(devices, spec)
    sbk, sbc, btotal, _ = prep(e_src, e_dst, e_num)
    state = shard_pairs(np.unique(edges, axis=0), n, spec.tc_capacity, device)
    walls, events = [], []
    for rnd in range(1, rounds + 1):
        last = state
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        *state, count, overflow = step(*state, sbk, sbc, btotal)
        end.record()
        check_overflow(spec, overflow.cpu().numpy(), rnd)
        walls.append((time.perf_counter() - t0) * 1e3)
        events.append(start.elapsed_time(end))
    assert int(count[0]) == len(want), f"{label}: the timed rounds end at {int(count[0])} pairs"
    log(f"  {label} by round, wall ms: {' '.join(f'{x:.3f}' for x in walls)}; between CUDA events ms: "
        f"{' '.join(f'{x:.3f}' for x in events)}")
    busy = profile_call(f"{label}, the last round", lambda: step(*last, sbk, sbc, btotal), top=8)
    seen = {}
    restore = recording(columnar, "exchange_sorted_rows", seen)
    try:
        step(*last, sbk, sbc, btotal)
    finally:
        restore()
    tc_args, union_args = seen["calls"]
    hold_k1(device, f"{label}, the last round's tc exchange", *columnar_plans(tc_args))
    k1 = check_k1_columnar(device, f"{label}, the last round's union exchange", union_args)
    del seen, tc_args, union_args, state, last, sbk, sbc
    torch.cuda.empty_cache()
    return {"edges": int(len(edges)), "closure": int(len(got)), "rounds": rounds, "k1_launches": launches,
            "driver_s": secs, "peak_gb": peak, "round_wall_ms": walls, "round_event_ms": events, "busy_last": busy,
            "k1_union": k1, "tc_capacity": spec.tc_capacity, "join_capacity": spec.join_capacity}


def spark_tc(device, seed: int, vertices: int = TC_SCALED_VERTICES) -> dict:
    """Phase 19: SparkTC's own graph (200 edges over 100 vertices) against
    the port's ``oracle_tc``, and a graph of the same 2:1 edge-vertex ratio
    at ``vertices`` against the scipy reachability oracle."""
    from sparkucx_tpu_torch.ops.tc import oracle_tc

    out = {}
    edges = sparktc_graph(seed, SPARKTC_EDGES, SPARKTC_VERTICES)
    out["sparktc"] = transitive_closure(device, "SparkTC's graph", edges, oracle_tc(edges))
    edges = sparktc_graph(seed + 1, 2 * vertices, vertices)
    t0 = time.perf_counter()
    want = reachability_oracle(edges, vertices)
    log(f"  scaled graph: {vertices} vertices, {len(edges)} edges; scipy oracle {len(want)} pairs in "
        f"{time.perf_counter() - t0:.2f} s")
    out["scaled"] = transitive_closure(device, f"the scaled graph (V={vertices})", edges, want)
    return out


# -- phase 20: the benchmark CLI's modes -------------------------------------------

#: phase 20: the arguments of each mode of ``python -m sparkucx_tpu_torch.perf.benchmark``
#: and the configuration of PERF.md section 4 whose scale it runs at
CLI_MODES = (
    ("superstep --executors 4 -s 256m -o 4 -i 3", "groupby_big, 4 GiB of 512-byte rows a superstep"),
    ("gather -n 200 -s 25m -o 4 -i 3", "groupby_big, the n=1 exchange (5 GiB packed)"),
    ("write -n 200 -s 25m -i 3 --impl host,device", "groupby_big, one map task"),
    ("pipeline --executors 4 -n 6 -s 64m --depths 1,2,3 -i 2", "groupby_big, spilled rounds"),
    ("skew --executors 4 -s 128m --zipf-alpha 1.2 -i 3", "groupby_big, a hot reducer"),
    ("adaptive --executors 8 -s 4m -i 2", "the JAX mode's own matrix"),
    ("sort -n 100000000 --sort-impl radix -i 3", "terasort_10gb"),
    ("sort -n 100000000 --executors 4 -i 3", "terasort_10gb, four executors"),
    ("sort -n 4000000 --executors 2 --batches 4 -i 1", "terasort_10gb, run_external_sort, cut"),
    ("columnar --executors 4 -n 25000000 -s 100 -i 3", "terasort_10gb, 2.5 GB of 100-byte rows"),
    ("groupby --executors 4 -n 50000000 --keys 5000 -i 3", "GroupByTest, numKVPairs 5000"),
    ("groupby --executors 4 -n 50000000 --keys 5000 -i 3 --partial", "GroupByTest, partial aggregation"),
    ("join --executors 4 -n 59986052 --build-rows 15000000 -i 3", "tpch_q18_sf10 scale, lineitem x orders"),
    ("join --executors 4 -n 59986052 --build-rows 15000000 -i 3 --join-type full_outer", "tpch_q18_sf10 scale"),
    ("combine --executors 4 -s 256m --keys 8 -i 3", "tpch_q1_sf10, G = 8 (shared tier)"),
    ("combine --executors 4 -s 256m --keys 8388608 -i 3", "tpch_q18_stage1_sf1, G = 2**23 (global tier)"),
)


def mode_launches(args, lines) -> dict:
    """The kernel launches one run of a mode of the benchmark CLI must count,
    from its parsed arguments and the lines it printed: kernel -> an exact
    count, or (count, "at least") where the count depends on the data."""
    n, reps = args.executors, 1 + args.outstanding * args.iterations
    mode = args.mode
    if mode == "superstep":
        return {"K1": n * reps}
    if mode == "gather":
        return {"K1": reps}
    if mode == "write":
        device_seals = 1 + args.iterations if "device" in args.impl.split(",") or args.impl == "auto" else 0
        return {"K2": device_seals}
    if mode == "pipeline":
        return {"K1": n * args.num_blocks * len(args.depths.split(",")) * (1 + args.iterations)}
    if mode == "skew":
        # "... quota slot Q rows, S sub-rounds": the quota plan's shots
        subrounds = int(next(re.search(r"(\d+) sub-rounds", ln) for ln in lines if "sub-rounds" in ln).group(1))
        return {"K1": n * (1 + args.iterations) * (1 + subrounds)}
    if mode == "adaptive":
        return {"K1": (1, "at least")}
    if mode == "sort":
        if args.batches > 1:
            return {"K1": (n * args.batches * (1 + args.iterations), "at least")}
        if args.sort_impl == "radix":
            return {"K6": reps, "K1": 0}
        return {"K1": n * reps}
    if mode in ("columnar", "groupby"):
        return {"K1": n * reps}
    if mode == "join":
        return {"K1": 2 * n * reps}
    if mode == "combine":
        calls = 1 + 4 * args.iterations  # one off the clock, four an iteration
        return {"K1": n * calls, "K3": calls, "K4": calls}
    raise ValueError(f"no launch counts for mode {mode!r}")


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.uint8)


def _hold_gather(args, got, before) -> bool:
    from sparkucx_tpu_torch.ops.block_kernels import block_gather_ref

    s, c, o, src, out_rows = args[:5]
    filled = min(int(c.sum()), out_rows)  # a packed plan fills a prefix; the rest is unspecified
    return torch.equal(_bits(got[:filled]), _bits(block_gather_ref(s, c, o, src, out_rows)[:filled]))


def _hold_scatter(args, got, before) -> bool:
    from sparkucx_tpu_torch.ops.block_kernels import block_scatter_ref

    return torch.equal(_bits(got), _bits(block_scatter_ref(*args[:4], before)))


def _hold_ring(args, got, before) -> bool:
    from sparkucx_tpu_torch.ops.ring_kernels import ring_exchange_grid_ref

    return torch.equal(_bits(got), _bits(ring_exchange_grid_ref(*args)))


def _hold_combine(args, got, before) -> bool:
    from sparkucx_tpu_torch.ops.ring_kernels import ring_combine_grid_ref

    return all(torch.equal(_bits(g), _bits(w)) for g, w in zip(got, ring_combine_grid_ref(*args)))


def _hold_radix(args, got, before) -> bool:
    from sparkucx_tpu_torch.ops.radix import radix_sort_rows_ref

    return torch.equal(_bits(got), _bits(radix_sort_rows_ref(args[0])))


#: phase 20: each kernel's wrapper and the check of one of its calls against its plain version
HELD = {"K1": ("block_kernels", "block_gather", _hold_gather), "K2": ("block_kernels", "block_scatter", _hold_scatter),
        "K3": ("ring_kernels", "ring_exchange_grid", _hold_ring), "K4": ("ring_kernels", "ring_combine_grid", _hold_combine),
        "K6": ("radix", "radix_sort_rows", _hold_radix)}


def _snapshot(got):
    """A copy of a kernel's result (a tensor or a tuple of them)."""
    return tuple(t.clone() for t in got) if isinstance(got, tuple) else got.clone()


class _Held:
    """One kernel's wrapper during a held run (:func:`holding`).  Calls from
    several threads (phase 23's servers) run one at a time, so each call's
    launches are its own.  A deferred wrapper keeps each call's inputs and a
    device copy of its result, and :meth:`settle` checks them later: the
    plain version (Python loops of slice copies) then stays off the clock
    and off the GIL of the threads being timed."""

    def __init__(self, label: str, name: str, real, check, keep_last: bool, defer: bool = False):
        self.label, self.name, self.real, self.check, self.keep_last = label, name, real, check, keep_last
        self.defer = defer
        # the kernel's own ``launches += 1`` lands here meanwhile, whoever calls it
        self.launches = self.held = self.held_launches = 0
        self.last = self.failed = None
        self.pending = []  # deferred calls: (call number, args, result copy, dst before the call)
        self._lock = threading.Lock()

    def __call__(self, *args, **kwargs):
        with self._lock:
            before = args[4].clone() if self.label == "K2" else None  # K2 scatters into dst in place
            launched = self.launches
            got = self.real(*args, **kwargs)
            if self.defer:
                self.pending.append((self.held, args, _snapshot(got), before))
            elif not self.check(args, got, before):
                # kept: a server thread's caller may turn the raise into a broken reply
                self.failed = f"{self.label} ({self.name}) differs from its plain version on call {self.held}"
                raise AssertionError(self.failed)
            del before
            self.held += 1
            self.held_launches += self.launches - launched
            if self.keep_last:
                self.last = (args, kwargs)
            return got

    def settle(self) -> None:
        """Check the deferred calls against the plain version, then drop them."""
        with self._lock:
            pending, self.pending = self.pending, []
        for number, args, got, before in pending:
            if not self.check(args, got, before):
                self.failed = f"{self.label} ({self.name}) differs from its plain version on call {number}"
                raise AssertionError(self.failed)


def holding(kernels: dict, keep_last: bool = False, defer: bool = False) -> tuple:
    """Hold every call of each kernel against its plain version: ``kernels``
    maps a label to ``(name, function, check)``; the function is replaced, in every
    loaded ``sparkucx_tpu_torch`` module that holds it, by a wrapper that calls
    it, then ``check(args, result, dst before the call (K2) or None)`` on the
    same inputs, and fails on a difference (with ``defer``, on a copy of the
    result when the wrapper's ``settle`` is called).  The kernels' own launch
    counts stay as they were meanwhile.  Returns ``(wrappers, restore)``;
    ``wrapper.held`` counts its calls; with ``keep_last``, ``wrapper.last``
    keeps the last one's arguments (and so its tensors)."""
    patched, wrappers = [], {}
    for label, (name, real, check) in kernels.items():
        wrappers[label] = wrapper = _Held(label, name, real, check, keep_last, defer)
        for key, mod in list(sys.modules.items()):
            if key.startswith("sparkucx_tpu_torch") and getattr(mod, name, None) is real:
                setattr(mod, name, wrapper)
                patched.append((mod, name, real))

    def restore():
        for mod, name, real in patched:
            setattr(mod, name, real)

    return wrappers, restore


def held_kernels(labels=tuple(HELD)) -> dict:
    """:func:`holding`'s ``kernels`` for the labels of ``HELD``."""
    import importlib

    return {label: (HELD[label][1], getattr(importlib.import_module(f"sparkucx_tpu_torch.ops.{HELD[label][0]}"),
                                            HELD[label][1]), HELD[label][2]) for label in labels}


def held_run(fn):
    """``fn()`` with every call of K1, K2, K3, K4 and K6 held against its
    plain version (:func:`holding`) and every kernel's count set to 0 just
    before; fails if any of their launches fell outside a held call.  Returns
    (its result, seconds on the host clock, label -> launches of the run
    for each kernel launched, K5's included)."""
    from sparkucx_tpu_torch.ops.ring_kernels import fused_scatter_ring_grid

    wrappers, restore = holding(held_kernels())
    fused_scatter_ring_grid.launches = 0
    try:
        out, secs = wall(fn)
    finally:
        restore()
    launches = {label: w.launches for label, w in wrappers.items()}
    held = {label: w.held_launches for label, w in wrappers.items()}
    assert held == launches, f"launches in held calls {held} differ from all launches {launches}"
    launches["K5"] = fused_scatter_ring_grid.launches
    return out, secs, {k: v for k, v in launches.items() if v}


def capturing(module, name: str, box: dict):
    """Replace the builder ``module.name`` with one whose built function keeps
    itself and its last call's arguments in ``box["call"]``; returns a
    function restoring the builder."""
    import functools

    real = getattr(module, name)

    def build(*args, **kwargs):
        fn = real(*args, **kwargs)

        @functools.wraps(fn)
        def call(*a):
            box["call"] = (fn, a)
            return fn(*a)

        return call

    setattr(module, name, build)
    return lambda: setattr(module, name, real)


#: phase 20: the modes whose one call is profiled after their held run -> the
#: module and builder of the function a timed iteration calls
PROFILED = {
    "groupby": ("relational", "build_grouped_aggregate"),
    "join": ("relational", "build_hash_join"),
    "combine": ("ici_exchange", "build_combine_exchange"),
}


def profile_mode(text: str, fn, call_args, kernels: dict) -> dict:
    """One call of a mode's built function on its own inputs: its time on the
    host clock (median of 3, ending synchronized); between CUDA events with
    the calls queued behind a sleeping kernel (:func:`device_ms`: no host
    latency shows unless the call waits on the device); the device's busy
    share of one profiled call; and the last call of each kernel it launched
    (``kernels``: label -> (function, (args, kwargs))) alone on the device."""
    wall_ms = []
    fn(*call_args)
    for _ in range(3):
        _, secs = wall(lambda: fn(*call_args))
        wall_ms.append(secs * 1e3)
    queued = device_ms(lambda: fn(*call_args), reps=3)
    busy = profile_call(text, lambda: fn(*call_args), top=8)
    alone = {label: device_ms(lambda: real(*a, **kw), reps=5) for label, (real, (a, kw)) in kernels.items()}
    ms = statistics.median(wall_ms)
    log(f"  {text}: one call {ms:.3f} ms on the host clock (median of 3), {queued:.3f} ms queued behind a "
        f"sleeping kernel; busy {'not traced' if busy is None else f'{busy:.1%}'} in the profiled call; the last "
        f"call alone on the device: {', '.join(f'{k} {v:.4f} ms' for k, v in alone.items())}")
    return {"wall_ms": ms, "queued_ms": queued, "busy": busy, "kernel_alone_ms": alone}


def cli_modes(device, table=CLI_MODES) -> dict:
    """Phase 20: every ported mode of the benchmark CLI through ``main``, on
    the card.  Each mode runs twice.  The timed run: the kernels' launch
    counts set to 0 just before and read just after, each count of
    :func:`mode_launches` required, the printed lines logged.  The held run,
    at the same arguments with one iteration of one call: every call of K1,
    K2, K3, K4 and K6 checked bit for bit against its plain version on the
    same inputs (:func:`holding`), as many calls as the counts require;
    for the modes of ``PROFILED``, one call of the built function then timed
    and profiled on its own inputs.  A mode fails if ``main`` does not
    return 0: each mode asserts its own results (its outputs bit-identical
    across plans, the rows it packed, sorted, grouped or joined)."""
    import contextlib
    import importlib
    import io

    from sparkucx_tpu_torch.perf import benchmark

    def module(name):
        return importlib.import_module(f"sparkucx_tpu_torch.ops.{name}")

    kernels = held_kernels()

    def run(argv):
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            rc = benchmark.main(argv)
        assert rc == 0, f"{' '.join(argv)}: exit {rc}"
        return printed.getvalue().splitlines()

    def require(text, want, got):
        for name, count in want.items():
            if isinstance(count, tuple):
                assert got[name] >= count[0], f"{text}: {name} {got[name]} times, want at least {count[0]}"
            else:
                assert got[name] == count, f"{text}: {name} {got[name]} times, want {count}"

    out = {}
    total = time.perf_counter()
    for text, config in table:
        argv = text.split() + ["--device", device.type]
        args = benchmark._parse_args(argv)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for _, kernel, _ in kernels.values():
            kernel.launches = 0
        t0 = time.perf_counter()
        lines = run(argv)
        secs = time.perf_counter() - t0
        got = {label: kernel.launches for label, (_, kernel, _) in kernels.items()}
        peak = torch.cuda.max_memory_allocated() / 1e9
        log(f"  {text}  [{config}]")
        for line in lines:
            log(f"    {line}")
        require(text, mode_launches(args, lines), got)
        launched = {k: v for k, v in got.items() if v}
        log(f"    launches {launched}; {secs:.2f} s with set-up; peak device memory {peak:.2f} GB")

        # the held run: same shapes, every kernel call against its plain version
        held_argv = argv + ["-i", "1", "-o", "1"]
        box = {}
        unhook = capturing(module(PROFILED[args.mode][0]), PROFILED[args.mode][1], box) if args.mode in PROFILED else None
        torch.cuda.empty_cache()
        wrappers, restore = holding(kernels, keep_last=unhook is not None)
        t0 = time.perf_counter()
        try:
            held_lines = run(held_argv)
        finally:
            restore()
            if unhook is not None:
                unhook()
        held = {name: w.held for name, w in wrappers.items()}
        require(f"{text} (held)", mode_launches(benchmark._parse_args(held_argv), held_lines), held)
        log(f"    held: every kernel call of a run at -i 1 -o 1 equal to its plain version "
            f"({', '.join(f'{k} x{v}' for k, v in held.items() if v)}; {time.perf_counter() - t0:.2f} s)")
        out[text] = {"config": config, "launches": launched, "held": {k: v for k, v in held.items() if v},
                     "seconds": secs, "peak_gb": peak, "lines": lines}
        if "call" in box:
            fn, call_args = box.pop("call")
            last = {k: (kernels[k][1], w.last) for k, w in wrappers.items() if w.held}
            out[text]["profile"] = profile_mode(text, fn, call_args, last)
            del fn, call_args, last
        del wrappers
    log(f"  phase 20 in {time.perf_counter() - total:.1f} s")
    torch.cuda.empty_cache()
    return out


# -- phase 21: the quantized exchange at full width -----------------------------------

QUANT_SLOT = 2**19  #: rows of one (sender, receiver) slot at phase 21: 4 x 4 x 2**19 rows of 512 B = 4 GiB


def peak_gb(fn):
    """(result, GB of device memory ``fn`` holds at its peak above what was
    allocated before it)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, (torch.cuda.max_memory_allocated() - base) / 1e9


def quantized_route(label: str, call, want: dict, record: dict):
    """``call()`` (one call of a quantized builder) under :func:`held_run`,
    its launches held to ``want`` (label -> count); the calls of the
    ops/ici_exchange.py wrappers named in ``record`` (name -> box) recorded
    for their timing.  Returns (its result, the launches)."""
    from sparkucx_tpu_torch.ops import ici_exchange

    def recorded():
        restores = [recording(ici_exchange, name, box) for name, box in record.items()]
        try:
            return call()
        finally:
            for restore in reversed(restores):
                restore()

    out, secs, launches = held_run(recorded)
    assert launches == want, f"{label}: launches {launches}, want {want}"
    log(f"  {label}: first call, every kernel call held against its plain version, {secs * 1e3:.2f} ms wall; "
        f"launches {launches}")
    return out, launches


def quantized_exchange(device, seed: int, geometry: dict, n: int = 4, slot: int = QUANT_SLOT, reps: int = 3) -> dict:
    """Phase 21: the quantized exchange (ops/ici_exchange.py) on four
    executors sharing the card, ``int8`` and ``blockfloat`` at block 128.

    At ``n x n x slot`` rows of 512 bytes (float32, 4 GiB at slot 2**19;
    receive sizes drawn from ``seed`` as ``measure_quantized_ici`` draws
    them): ``quantize_rows`` on the card bit-equal to the CPU on a 1,048,576
    row sample; ``build_quantized_exchange`` with K3 counted once and K1 n
    times, within ``error_bound`` of the stock float32 exchange with equal
    receive sizes; every K3 call (132-byte rows) and K1 call held bit for
    bit against its plain version and timed; quantize, K3, K1, dequantize,
    the route, the float32 stock route and the float32 K3 route timed in
    rounds with their bounds and peak memory; one profile.  Then on phase
    13's plan geometry (``geometry``) with seeded float payloads,
    ``build_quantized_fused_exchange`` (K2 n, K3 once, K1 n, K5 never) equal
    bit for bit to ``build_quantized_exchange`` on the staging K2 filled,
    within bound of the stock exchange, every K2, K3 and K1 call held.
    Finally ``measure_quantized_ici(n, slot, 128)``.  Returns the readings."""
    from sparkucx_tpu_torch.ops.block_kernels import block_scatter
    from sparkucx_tpu_torch.ops.compress import QuantizeSpec, dequantize_rows, quantize_rows
    from sparkucx_tpu_torch.ops.exchange import ExchangeSpec, build_exchange
    from sparkucx_tpu_torch.ops.ici_exchange import (
        build_ici_exchange, build_quantized_exchange, build_quantized_fused_exchange, compact_slots,
    )
    from sparkucx_tpu_torch.ops.ring_kernels import ring_exchange_grid
    from sparkucx_tpu_torch.perf.benchmark import max_err_rows, measure_quantized_ici

    devices = [device] * n
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, slot + 1, size=(n, n)).astype(np.int32)  # sizes[i, j]: rows i sends j
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    send_rows = n * slot
    spec = ExchangeSpec(n, send_rows, send_rows, LANE)
    data = torch.randn((n * send_rows, LANE), generator=gen, device=device)
    data_i32 = data.view(torch.int32)
    amax = float(data.abs().max())
    filled = int(sizes.sum())
    stock = build_exchange(devices, spec)
    ring32 = build_ici_exchange(devices, spec)
    (ref_i32, ref_rs), stock_peak = peak_gb(lambda: stock(data_i32, sizes))
    ref = ref_i32.view(torch.float32)
    log(f"  {n} executors, {data.shape[0]} rows of {LANE * 4} B ({data.numel() * 4 / 2**30:.2f} GiB float32), "
        f"slot {slot} rows, {filled} rows received in all")
    out = {"rows": int(data.shape[0]), "row_bytes": LANE * 4, "received_rows": filled, "modes": {}}
    for mode in ("int8", "blockfloat"):
        q = QuantizeSpec(mode=mode, block_size=128)
        qw = q.quantized_width(LANE)
        sample = data[: 1 << 20]
        on_card = quantize_rows(q, sample).cpu()
        assert torch.equal(on_card, quantize_rows(q, sample.cpu())), (
            f"quantize_rows ({mode}) on the card differs from the CPU")
        del on_card
        log(f"  {mode}: quantize_rows on the card equals the CPU bit for bit on {sample.shape[0]} rows; "
            f"payload {qw} int32 lanes = {qw * 4} B a row")
        fn = build_quantized_exchange(devices, spec, q)
        seen = {"ring_exchange_grid": {}, "block_gather": {}}
        (recv, rs), launches = quantized_route(
            f"build_quantized_exchange ({mode})", lambda: fn(data, sizes), {"K1": n, "K3": 1}, seen)
        assert torch.equal(rs, ref_rs), f"{mode}: receive sizes differ from the stock exchange's"
        err = max_err_rows(recv, ref, sizes, send_rows)
        bound = q.error_bound(amax)
        assert err <= bound + 1e-7, f"{mode}: {err} above the bound {bound}"
        del recv
        log(f"  {mode}: within {err:.6g} of the stock float32 exchange (bound {bound:.6g}), receive sizes equal")
        k3 = check_k3_calls(device, f"the quantized exchange ({mode})", seen["ring_exchange_grid"]["calls"])
        k1 = check_k1_calls(device, f"the quantized compaction ({mode})", seen["block_gather"]["calls"])
        del seen
        torch.cuda.empty_cache()

        # the route split, in rounds, beside the float32 routes at the same shape
        payload = quantize_rows(q, data)
        steps, w = fn.schedule.raw_steps(), slot // fn.schedule.chunks
        grid = ring_exchange_grid(n, slot, w, steps, payload)
        outq = compact_slots(grid, sizes, slot, send_rows)
        t = time_rounds({
            "quantize": lambda: quantize_rows(q, data),
            "k3": lambda: ring_exchange_grid(n, slot, w, steps, payload),
            "k1": lambda: compact_slots(grid, sizes, slot, send_rows),
            "dequantize": lambda: dequantize_rows(q, outq, LANE),
            "route": lambda: fn(data, sizes),
            "f32_stock": lambda: stock(data_i32, sizes),
            "f32_k3_route": lambda: ring32(data_i32, sizes),
        }, reps)
        ms = {k: statistics.median(v) for k, v in t.items()}
        del grid, outq
        torch.cuda.empty_cache()
        _, q_peak = peak_gb(lambda: quantize_rows(q, data))
        _, route_peak = peak_gb(lambda: fn(data, sizes))
        _, ring_peak = peak_gb(lambda: ring32(data_i32, sizes))
        fbytes, qbytes = data.numel() * 4, payload.numel() * 4
        del payload
        bounds = {
            "quantize": (fbytes + qbytes) / HBM_BYTES_PER_S * 1e3,
            "k3": 2 * qbytes / HBM_BYTES_PER_S * 1e3,
            "k1": 2 * filled * qw * 4 / HBM_BYTES_PER_S * 1e3,
            "dequantize": (qbytes + fbytes) / HBM_BYTES_PER_S * 1e3,
            "route": 2 * fbytes / HBM_BYTES_PER_S * 1e3,
            "f32_stock": (filled * LANE * 4 + fbytes) / HBM_BYTES_PER_S * 1e3,
            "f32_k3_route": 2 * fbytes / HBM_BYTES_PER_S * 1e3,
        }
        log(f"  {mode}, median of {reps} rounds (ms, bound by bytes): " + ", ".join(
            f"{k} {ms[k]:.4f} ({bounds[k]:.4f})" for k in ms))
        log(f"  {mode}: peak device memory above the input, quantize {q_peak:.2f} GB, the route {route_peak:.2f} "
            f"GB; float32 stock {stock_peak:.2f} GB, float32 K3 route {ring_peak:.2f} GB")
        busy = profile_call(f"build_quantized_exchange ({mode})", lambda: fn(data, sizes), top=8)
        out["modes"][mode] = {"launches": launches, "max_err": err, "err_bound": bound, "ms": ms,
                              "by_round": t, "bound_ms": bounds, "k3": k3, "k1": k1,
                              "peak_gb": {"quantize": q_peak, "route": route_peak, "f32_stock": stock_peak,
                                          "f32_k3_route": ring_peak}, "busy": busy}
        del fn
        torch.cuda.empty_cache()
    del ref, ref_i32, data, data_i32, stock, ring32
    torch.cuda.empty_cache()

    # the fused route on phase 13's plan geometry, float payloads made from the seed
    seal, staging_rows, sizes13 = geometry["seal"], geometry["staging_rows"], geometry["sizes"]
    nb = max(c.size for _, c, _, _ in seal)
    p_rows = max(p for _, _, _, p in seal)
    plan = np.zeros((3, n, nb), np.int32)
    for i, (s_, c_, o_, p) in enumerate(seal):
        b = c_.size
        plan[0, i, :b], plan[1, i, :b], plan[2, i, :b] = s_, c_, o_
        plan[2, i, b:] = p  # count-0 pads at the packed end
    starts, counts, outs = (torch.from_numpy(a).to(device) for a in plan)
    packed = torch.randn((n * p_rows, LANE), generator=gen, device=device)
    spec13 = ExchangeSpec(n, staging_rows, staging_rows, LANE)
    size_matrix = np.ascontiguousarray(sizes13.T)  # row i: rows sender i sent each receiver
    log(f"  fused route on phase 13's plan: {n} x {nb} blocks, {sum(p for *_, p in seal)} packed rows, staging "
        f"{n * staging_rows} rows of {LANE * 4} B")
    out["fused"] = {}
    for mode in ("int8", "blockfloat"):
        q = QuantizeSpec(mode=mode, block_size=128)
        ffn = build_quantized_fused_exchange(devices, spec13, q, nb)
        staging = torch.zeros((n * staging_rows, LANE), dtype=torch.float32, device=device)
        seen = {"block_scatter": {}, "ring_exchange_grid": {}, "block_gather": {}}
        (recv_f, rs_f), launches = quantized_route(
            f"build_quantized_fused_exchange ({mode})",
            lambda: ffn(starts, counts, outs, packed, staging, size_matrix), {"K1": n, "K2": n, "K3": 1}, seen)
        assert np.array_equal(rs_f.numpy(), sizes13), f"{mode}: fused receive sizes differ from phase 13's"
        # staging now holds what K2 placed from the plan: the unfused route on it
        recv_u, rs_u = build_quantized_exchange(devices, spec13, q)(staging, size_matrix)
        assert torch.equal(rs_u, rs_f) and torch.equal(recv_u.view(torch.int32), recv_f.view(torch.int32)), (
            f"{mode}: the fused route differs from build_quantized_exchange on the staging K2 filled")
        del recv_u
        sref, srs = build_exchange(devices, spec13)(staging.view(torch.int32), size_matrix)
        assert torch.equal(srs, rs_f)
        err = max_err_rows(recv_f, sref.view(torch.float32), size_matrix, staging_rows)
        bound = q.error_bound(float(packed.abs().max()))
        assert err <= bound + 1e-7, f"{mode} fused: {err} above the bound {bound}"
        del recv_f, sref
        log(f"  {mode} fused: bit-equal to build_quantized_exchange on the staging K2 filled; within {err:.6g} "
            f"of the stock float32 exchange (bound {bound:.6g})")
        k3 = check_k3_calls(device, f"the fused quantized route ({mode})", seen["ring_exchange_grid"]["calls"], reps=3)
        k1 = check_k1_calls(device, f"the fused quantized compaction ({mode})", seen["block_gather"]["calls"], reps=3)
        s0, c0, o0, src0, dst0 = seen["block_scatter"]["calls"][0]
        k2_ms = time_ms(lambda: block_scatter(s0, c0, o0, src0, dst0), reps)
        live = plan[1, 0] > 0
        idx = torch.from_numpy(np.repeat(plan[0, 0][live].astype(np.int64) - plan[2, 0][live],
                                         plan[1, 0][live]) + np.arange(int(plan[1, 0].sum()))).to(device)
        k2_lib = time_ms(lambda: dst0.index_copy_(0, idx, src0[: idx.numel()]), reps)
        k2_bound = (2 * idx.numel() * LANE * 4 + 12 * nb) / HBM_BYTES_PER_S * 1e3
        route_ms = time_ms(lambda: ffn(starts, counts, outs, packed, staging, size_matrix), reps)
        log(f"  {mode} fused: K2 at executor 0 ({int(c0.sum())} rows in {nb} blocks) {k2_ms:.4f} ms, library "
            f"(index_copy_) {k2_lib:.4f} ms, bound {k2_bound:.4f} ms; the fused route {route_ms:.4f} ms")
        out["fused"][mode] = {"launches": launches, "max_err": err, "err_bound": bound, "k3": k3, "k1": k1,
                              "k2_ms": k2_ms, "k2_library_ms": k2_lib, "k2_bound_ms": k2_bound,
                              "route_ms": route_ms}
        del seen, s0, c0, o0, src0, dst0, idx, staging, ffn
        torch.cuda.empty_cache()
    del starts, counts, outs, packed
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ici = measure_quantized_ici(n, slot, LANE, device=device)
    log(f"  measure_quantized_ici({n}, {slot}, {LANE}) in {time.perf_counter() - t0:.1f} s: n={ici['n']}, "
        f"f32 {ici['f32_gbps']:.2f} GB/s; " + "; ".join(
            f"{m}: {c['gbps']:.2f} GB/s ({c['speedup_vs_f32']:.3f}x), wire_reduction {c['wire_reduction']:.4f}, "
            f"max_err {c['max_err']:.6g} <= err_bound {c['err_bound']:.6g}" for m, c in ici["modes"].items()))
    out["measure_quantized_ici"] = ici
    torch.cuda.empty_cache()
    return out


# -- phase 22: the walkthroughs and the spilling reduce side -------------------------


def _matched(pattern: str, lines) -> int:
    return int(next(m for m in (re.search(pattern, ln) for ln in lines) if m).group(1))


#: phase 22: each walkthrough -> the launches its ``main`` must count, from
#: the lines it printed (every kernel not named: none)
WALKTHROUGHS = {
    "01_transport_loopback.py": lambda lines: {},  # the host's loopback transport
    # one exchange, K1 once a receiver of two; the device-side fetch, K1 once
    "02_hbm_shuffle.py": lambda lines: {"K1": 2 + 1},
    # impl='auto' resolves to the sample sort over four executors: one
    # exchange, K1 once a receiver
    "03_terasort.py": lambda lines: {"K1": 4},
    # four executors: GROUP BY with its combine off, one exchange (K1 4); the
    # join's two sides (K1 8); SparkTC's edges once (K1 4), then two
    # exchanges a round (K1 8 a round)
    "04_workloads.py": lambda lines: {"K1": 4 + 8 + 4 + 8 * _matched(r"in (\d+) rounds", lines)},
    "05_manager_pipeline.py": lambda lines: {"K1": 2},  # one exchange, K1 once a receiver of two
    # one sample sort a device batch over four executors, K1 once a receiver
    "06_external_sort.py": lambda lines: {"K1": 4 * _matched(r"through (\d+) device batches", lines)},
}


def walkthroughs(device) -> dict:
    """Phase 22, first half: each walkthrough's ``main`` on the card,
    checking its own oracle, its OK lines logged; every kernel call held
    against its plain version and the launches, set to 0 just before and
    read just after, held to the counts of ``WALKTHROUGHS``."""
    import contextlib
    import importlib.util
    import io

    here = os.path.join(os.path.dirname(os.path.abspath(__file__)), "sparkucx_tpu_torch", "examples")
    out = {}
    for script, expected in WALKTHROUGHS.items():
        spec = importlib.util.spec_from_file_location(f"walkthrough_{script[:2]}", os.path.join(here, script))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            _, secs, launched = held_run(lambda: mod.main(["--device", device.type]))
        lines = printed.getvalue().splitlines()
        assert lines and all(ln.startswith("OK") for ln in lines), f"{script}: {lines}"
        log(f"  {script} ({secs:.2f} s), launches {launched}, every kernel call held against its plain version:")
        for line in lines:
            log(f"    {line}")
        want = expected(lines)
        assert launched == want, f"{script}: launches {launched}, want {want}"
        out[script] = {"lines": lines, "launches": launched, "seconds": secs}
    return out


# -- phase 23 ---------------------------------------------------------------

#: the JVM shim's fixture shuffle (scripts/gen_shim_fixtures.py, FixtureCheck.java)
FIX_SHUFFLE, FIX_WRITER, FIX_REDUCE, FIX_TAG = 7, 3, 5, 0x1122334455667788
FIX_BODY = bytes(range(256))


def run_threads(fn, k: int) -> list:
    """``fn(0) .. fn(k - 1)`` on ``k`` threads; their results, each thread's
    exception raised here."""
    with ThreadPoolExecutor(max_workers=k) as pool:
        return [f.result() for f in [pool.submit(fn, i) for i in range(k)]]


def groupby_host_blocks(device, mappers, reducers, kv_pairs, value_bytes, seed):
    """:func:`groupby_blocks`' map output, each mapper's rows also copied to
    the host once: (lengths (M, R), per-mapper device blocks, per-mapper flat
    uint8 host array, byte offset of each block in it (M, R))."""
    lengths, blocks = groupby_blocks(device, mappers, reducers, kv_pairs, value_bytes, seed)
    rows = -(-lengths // ROW)
    starts = (np.cumsum(rows, axis=1) - rows) * ROW
    host = [torch.cat(b).cpu().numpy().reshape(-1).view(np.uint8) for b in blocks]
    return lengths, blocks, host, starts


def _check_batch(got, lengths, host, starts, r, first_map=0) -> int:
    """Every fetched block of reducer ``r`` equal to the written bytes;
    returns the bytes checked."""
    nbytes = 0
    for k, blk in enumerate(got):
        m = first_map + k
        ln = int(lengths[m, r])
        assert blk is not None and len(blk) == ln, f"block ({m}, {r}): {None if blk is None else len(blk)} B, wrote {ln}"
        s0 = int(starts[m, r])
        assert np.array_equal(np.frombuffer(blk, np.uint8), host[m][s0 : s0 + ln]), (
            f"block ({m}, {r}) differs from the written bytes")
        nbytes += ln
    return nbytes


def launch_marks(wrappers: dict) -> dict:
    """Each held kernel's (launches, launches inside held calls) so far
    (``wrappers`` from :func:`holding`)."""
    return {label: (w.launches, w.held_launches) for label, w in wrappers.items()}


def launched_since(wrappers: dict, marks: dict) -> dict:
    """label -> launches since ``marks`` (:func:`launch_marks`) for each
    kernel launched, once every deferred call has been checked against its
    plain version (``settle``); fails if any launch fell outside a held
    call."""
    out = {}
    for w in wrappers.values():
        w.settle()
    for label, w in wrappers.items():
        n, h = w.launches - marks[label][0], w.held_launches - marks[label][1]
        assert n == h, f"{label}: {n} launches since the mark, {h} of them in held calls"
        if n:
            out[label] = n
    return out


def daemon_groupby(device, n: int, mode: str, data, wrappers: dict, serve_batches: list, clients: int = 4) -> dict:
    """Phase 23 (a): a ``ShuffleDaemon`` with ``n`` executors on the card,
    ``clients`` ``DaemonClient`` connections writing GroupByTest's map output
    over loopback TCP (CreateShuffle, OpenMapWriter, WritePartition,
    CommitMap: the committed lengths held against the written ones), one
    RunExchange (K1 once a receiver), then every reducer's blocks in one
    FetchBlock batch each, every byte held against the written ones, under
    ``hostRecvMode=mode`` (under ``device`` K1 once a batch: a reducer's
    blocks lie in one round on one consumer; none under ``array``), then the
    serving side alone (every batch resolved to host views, no socket).
    Every kernel call is held against its plain version (``wrappers``,
    :func:`holding`); a serve batch's K1 call goes to ``serve_batches``, to be
    timed once the hold is lifted."""
    from sparkucx_tpu_torch.config import TpuShuffleConf
    from sparkucx_tpu_torch.core.block import ShuffleBlockId
    from sparkucx_tpu_torch.shuffle.daemon import DaemonClient, ShuffleDaemon
    from sparkucx_tpu_torch.store.hbm_store import default_peer_ranges

    lengths, _, host, starts = data
    mappers, reducers = lengths.shape
    padded = -(-lengths // ROW) * ROW
    owner = np.arange(mappers) % n
    region = max(int(padded[owner == e][:, a:b].sum()) for e in range(n) for a, b in default_peer_ranges(reducers, n))
    conf = TpuShuffleConf(block_alignment=ROW, staging_capacity_per_executor=n * region, num_executors=n,
                          host_recv_mode=mode, keep_device_recv=mode == "device")
    payload = int(lengths.sum())
    d = ShuffleDaemon(conf, num_executors=n, devices=[device] * n)
    cs = [DaemonClient(d.address, conf) for _ in range(clients)]
    sid = 0
    serve = {"K1": reducers} if mode == "device" else {}
    out = {"executors": n, "mode": mode, "payload_gb": payload / 1e9, "blocks": int(mappers * reducers)}
    try:
        cs[0].create_shuffle(sid, mappers, reducers)

        def write(k):
            c = cs[k]
            for m in range(k, mappers, clients):
                w = c.open_map_writer(sid, m)
                for r in range(reducers):
                    ln = int(lengths[m, r])
                    if ln:
                        c.write_partition(w, r, memoryview(host[m])[int(starts[m, r]) : int(starts[m, r]) + ln])
                assert c.commit_map(w).tolist() == lengths[m].tolist(), f"map {m}: committed lengths differ"

        mark = launch_marks(wrappers)
        _, out["write_s"] = wall(lambda: run_threads(write, clients))
        assert not launched_since(wrappers, mark), "a daemon write launched a kernel"
        mark = launch_marks(wrappers)
        _, out["run_exchange_s"] = wall(lambda: cs[0].run_exchange(sid))
        out["exchange_launches"] = launched_since(wrappers, mark)
        assert out["exchange_launches"] == {"K1": n}, out["exchange_launches"]
        out["device_ms"] = d.manager.cluster.device_times_ms(sid)
        assert cs[0].stats(sid)["exchanged"]

        def fetch(k, upto=reducers):
            return [(r, cs[k].fetch_blocks([ShuffleBlockId(sid, m, r) for m in range(mappers)]))
                    for r in range(k, upto, clients)]

        mark = launch_marks(wrappers)
        fetched, out["fetch_s"] = wall(lambda: run_threads(fetch, clients))
        out["fetch_launches"] = launched_since(wrappers, mark)
        assert out["fetch_launches"] == serve, f"K1 once a FetchBlock batch under 'device': {out['fetch_launches']}"
        checked = sum(_check_batch(got, lengths, host, starts, r) for part in fetched for r, got in part)
        assert checked == payload
        del fetched
        if serve:
            serve_batches.append((out, f"the daemon's serve batch (n={n})", wrappers["K1"].last[0][:5]))
            # the card's share of the serving work: the first 20 reducers' batches again, traced
            mark = launch_marks(wrappers)
            few = min(20, reducers)
            out["fetch_busy"] = profile_call(f"the daemon's fetch of {few} reducers (n={n}, 'device')",
                                             lambda: run_threads(lambda k: fetch(k, few), clients))
            assert launched_since(wrappers, mark) == {"K1": few}
        # the serving side's own leg, no socket: every batch resolved to host
        # views (slices of the host shards; under 'device' K1 and one copy to
        # page-locked memory a batch), on one thread
        cluster = d.manager.cluster

        def resolve():
            for r in range(reducers):  # each batch's views dropped as a send would drop them
                cluster.received_block_views([ShuffleBlockId(sid, m, r) for m in range(mappers)])

        mark = launch_marks(wrappers)
        _, out["resolve_s"] = wall(resolve)
        assert launched_since(wrappers, mark) == serve
        cs[0].remove_shuffle(sid)
    finally:
        for c in cs:
            c.close()
        d.close()
    gb = out["payload_gb"]
    out["write_gbps"], out["fetch_gbps"] = gb / out["write_s"], gb / out["fetch_s"]
    log(f"  daemon, {n} executor(s), hostRecvMode={mode}: {gb:.3f} GB in {out['blocks']} blocks; write "
        f"{out['write_s']:.3f} s ({out['write_gbps']:.3f} GB/s over {clients} connections), RunExchange "
        f"{out['run_exchange_s'] * 1e3:.2f} ms (seal {out['device_ms'].get('seal', 0):.2f}, exchange "
        f"{out['device_ms'].get('exchange', 0):.2f} ms on the device; launches {out['exchange_launches']}), "
        f"fetch {out['fetch_s']:.3f} s ({out['fetch_gbps']:.3f} GB/s; launches {out['fetch_launches']}), every "
        f"byte equal to the written ones; the batches resolved to host views alone, one thread: "
        f"{out['resolve_s']:.3f} s; every kernel call held against its plain version")
    return out


def daemon_write_split(device, data, maps: int = 40) -> dict:
    """Where a daemon write's wall time goes, measured on the daemon itself:
    the first ``maps`` mappers' blocks written to a daemon with one executor
    (``array``) over one connection, every WritePartition's round trip timed
    on the client (the frame sent, its ack parsed); then over four
    connections; then over four with the interpreter's thread switch interval
    cut from its 5 ms to 0.1 ms (the clients' and the daemon's threads share
    one GIL: a thread that wakes from a socket wait queues for it for up to
    one interval while another runs Python)."""
    from sparkucx_tpu_torch.config import TpuShuffleConf
    from sparkucx_tpu_torch.shuffle.daemon import DaemonClient, ShuffleDaemon

    lengths, _, host, starts = data
    maps = min(maps, lengths.shape[0])
    lengths = lengths[:maps]
    reducers = lengths.shape[1]
    padded = int((-(-lengths // ROW) * ROW).sum())
    conf = TpuShuffleConf(block_alignment=ROW, staging_capacity_per_executor=padded, num_executors=1)
    gb = int(lengths.sum()) / 1e9
    out = {"maps": maps, "gb": gb, "frames": int((lengths > 0).sum())}
    default = sys.getswitchinterval()
    for key, clients, switch in (("one_connection", 1, default), ("four_connections", 4, default),
                                 ("four_connections_switch_0.1ms", 4, 1e-4)):
        d = ShuffleDaemon(conf, num_executors=1, devices=[device])
        cs = [DaemonClient(d.address, conf) for _ in range(clients)]
        rtts = []
        try:
            cs[0].create_shuffle(0, maps, reducers)

            def write(k):
                c, mine = cs[k], []
                for m in range(k, maps, clients):
                    w = c.open_map_writer(0, m)
                    for r in range(reducers):
                        ln = int(lengths[m, r])
                        if ln:
                            t0 = time.perf_counter()
                            c.write_partition(w, r, memoryview(host[m])[int(starts[m, r]) : int(starts[m, r]) + ln])
                            mine.append(time.perf_counter() - t0)
                    assert c.commit_map(w).tolist() == lengths[m].tolist()
                rtts.extend(mine)

            sys.setswitchinterval(switch)
            try:
                _, secs = wall(lambda: run_threads(write, clients))
            finally:
                sys.setswitchinterval(default)
        finally:
            for c in cs:
                c.close()
            d.close()
        rt = np.asarray(rtts) * 1e6
        out[key] = {"s": secs, "gbps": gb / secs, "rtt_p50_us": float(np.percentile(rt, 50)),
                    "rtt_p99_us": float(np.percentile(rt, 99))}
    log(f"  a daemon write measured, the first {maps} mappers ({gb:.3f} GB, {out['frames']} frames): "
        + "; ".join(f"{k.replace('_', ' ')} {v['gbps']:.3f} GB/s, a WritePartition round trip "
                    f"p50 {v['rtt_p50_us']:.0f} us, p99 {v['rtt_p99_us']:.0f} us"
                    for k, v in out.items() if isinstance(v, dict)))
    return out


def daemon_fixtures(device, wrappers: dict) -> dict:
    """Phase 23 (a), last: the raw ``jvm/fixtures/*.bin`` frames against a
    daemon on the card (``hostRecvMode=device``), in the order of
    ``tests/test_daemon.py``'s replay: every ack ok, the fetch replies' sizes
    and bytes as the shim expects (K1 once a fetch frame), a removed
    shuffle's fetch all misses, and the oversized frame dropping only its own
    connection.  Every kernel call is held against its plain version
    (``wrappers``, :func:`holding`)."""
    import socket
    import struct

    from sparkucx_tpu_torch.config import TpuShuffleConf
    from sparkucx_tpu_torch.core.block import ShuffleBlockId
    from sparkucx_tpu_torch.shuffle.daemon import DaemonClient, ShuffleDaemon, _read_frame

    here = os.path.join(os.path.dirname(os.path.abspath(__file__)), "jvm", "fixtures")
    fx = {name: open(os.path.join(here, name), "rb").read() for name in sorted(os.listdir(here))}
    conf = TpuShuffleConf(staging_capacity_per_executor=1 << 20, num_executors=1, host_recv_mode="device",
                          keep_device_recv=True)
    d = ShuffleDaemon(conf, num_executors=1, devices=[device])
    client = DaemonClient(d.address)
    raw = socket.create_connection(d.address, timeout=30)

    def ack(name):
        raw.sendall(fx[name])
        op, meta, body = _read_frame(raw)
        assert meta.get("ok") is True, f"{name}: {meta}"
        return meta, body

    def fetch(name):
        raw.sendall(fx[name])
        hdr = _recv_all(raw, 20)
        _, hlen, blen = struct.unpack("<IQQ", hdr)
        reply = _recv_all(raw, hlen)
        body = _recv_all(raw, blen)
        tag, count = struct.unpack_from("<QI", reply)
        assert tag == FIX_TAG
        return [struct.unpack_from("<q", reply, 12 + 8 * i)[0] for i in range(count)], body

    m0, m1r6, m3 = b"\xaa" * 100, b"\xcc" * 77, b"\xbb" * 300
    start = launch_marks(wrappers)
    try:
        ack("01_create_shuffle.bin")
        burn = [client.open_map_writer(FIX_SHUFFLE, m) for m in (0, 1, 3)]
        assert burn == [0, 1, 2]
        client.write_partition(burn[0], FIX_REDUCE, m0)
        client.write_partition(burn[1], 6, m1r6)
        client.write_partition(burn[2], FIX_REDUCE, m3)
        assert ack("02_open_map_writer.bin")[0]["writer"] == FIX_WRITER
        ack("03_write_partition.bin")
        assert np.frombuffer(ack("04_commit_map.bin")[1], "<i8")[FIX_REDUCE] == len(FIX_BODY)
        for w in burn:
            client.commit_map(w)
        mark = launch_marks(wrappers)
        ack("05_run_exchange.bin")
        assert launched_since(wrappers, mark) == {"K1": 1}, "K1 once at the fixture RunExchange (one receiver)"
        mark = launch_marks(wrappers)
        assert fetch("06_fetch.bin") == ([100, 300], m0 + m3)
        assert fetch("08_fetch_aqe_maprange.bin") == ([0, 256], FIX_BODY)
        assert fetch("09_fetch_coalesced_empty.bin") == ([100, 0, 0, 77, 256, 0, 300, 0], m0 + m1r6 + FIX_BODY + m3)
        launches = launched_since(wrappers, mark).get("K1", 0)
        assert launches == 3, f"K1 once a fixture fetch: {launches}"
        ack("07_remove_shuffle.bin")
        assert fetch("06_fetch.bin") == ([-1, -1], b"")
        over = socket.create_connection(d.address, timeout=30)
        over.sendall(fx["10_oversized_frame.bin"])
        assert over.recv(1) == b"", "the daemon accepted an oversized frame"
        over.close()
        client.create_shuffle(55, 1, 1)
        w = client.open_map_writer(55, 0)
        client.write_partition(w, 0, b"alive")
        client.commit_map(w)
        client.run_exchange(55)
        assert client.fetch_blocks([ShuffleBlockId(55, 0, 0)]) == [b"alive"]
    finally:
        raw.close()
        client.close()
        d.close()
    total = launched_since(wrappers, start)
    assert total == {"K1": 1 + 3 + 2}, f"the replay and the shuffle after it: {total}"
    log(f"  the JVM shim's {len(fx)} fixture frames against the daemon on the card: every reply as the shim "
        f"expects, K1 {launches} in the fetches (one a fetch), {total['K1']} in all, each held against its plain "
        "version; the oversized frame dropped and the daemon serving after it")
    return {"frames": len(fx), "fetch_launches": {"K1": launches}, "launches": total}


def _recv_all(sock, n: int) -> bytes:
    out = b""
    while len(out) < n:
        chunk = sock.recv(n - len(out))
        assert chunk, "the daemon closed the connection mid-reply"
        out += chunk
    return out


def peer_device_staged(device, data, wrappers: dict, serve_batches: list, checksum_maps: int = 40,
                       split_reducers: int = 40) -> dict:
    """Phase 23 (b): two ``PeerTransport``s in one process.  Executor 0's
    store stages GroupByTest's map output on the card through
    ``write_partition_device`` and seals it (K2 once); executor 1 fetches
    every block over loopback TCP, one reducer's blocks a batch, at
    ``wire.streams`` 1 and 4 (K1 once a batch on executor 0's serving side);
    then with ``wire.checksum`` on at both ends (a second serving plane over
    the same store), streams 4, over one reducer's first ``checksum_maps``
    blocks (CRC32C is pure Python, a few MB/s); then the first
    ``split_reducers`` reducers again at streams 1 and 4 with the
    interpreter's thread switch interval cut from 5 ms to 0.1 ms (the
    server's lanes and the client's share one GIL).  Every fetched byte equal
    to the written ones, every kernel call held against its plain version
    (``wrappers``, :func:`holding`); a serve batch's K1 call goes to
    ``serve_batches``, to be timed once the hold is lifted."""
    from sparkucx_tpu_torch.config import TpuShuffleConf
    from sparkucx_tpu_torch.core.block import MemoryBlock, ShuffleBlockId
    from sparkucx_tpu_torch.transport.peer import PeerTransport

    lengths, blocks, host, starts = data
    mappers, reducers = lengths.shape
    total_rows = int((-(-lengths // ROW)).sum())
    payload = int(lengths.sum())
    base = dict(block_alignment=ROW, staging_capacity_per_executor=total_rows * ROW, device_staging=True,
                max_blocks_per_request=mappers)
    server = PeerTransport(TpuShuffleConf(**base), executor_id=0, device=device)
    addr = server.init()
    out = {"payload_gb": payload / 1e9, "blocks": int(mappers * reducers)}
    default = sys.getswitchinterval()
    try:
        server.store.create_shuffle(0, mappers, reducers)
        for m in range(mappers):
            w = server.store.map_writer(0, m)
            for r in range(reducers):
                w.write_partition_device(r, blocks[m][r], length=int(lengths[m, r]))
            w.commit()
        mark = launch_marks(wrappers)
        _, out["seal_s"] = wall(lambda: server.store.seal(0))
        out["seal_launches"] = launched_since(wrappers, mark)
        assert out["seal_launches"] == {"K2": 1}, out["seal_launches"]
        bufs = [MemoryBlock(np.zeros(max(1, int(lengths[m].max())), np.uint8), size=max(1, int(lengths[m].max())))
                for m in range(mappers)]

        def fetch_all(client, maps, rs):
            """Each reducer's non-empty blocks in one batch, as a Spark
            reducer asks (it skips the blocks its map statuses size 0; the
            store answers an empty block of a device round as missing)."""
            nbytes = 0
            for r in rs:
                ms = [m for m in range(maps) if lengths[m, r]]
                for m in ms:
                    bufs[m].size = bufs[m].data.size  # a fetch leaves the block's size behind
                reqs = client.fetch_blocks_by_block_ids(0, [ShuffleBlockId(0, m, r) for m in ms],
                                                        [bufs[m] for m in ms], [None] * len(ms))
                deadline = time.monotonic() + 120
                while not all(q.completed() for q in reqs):
                    client.progress()
                    client.wait_for_activity(0.002)
                    assert time.monotonic() < deadline, f"reducer {r}: fetch timed out"
                got = [b""] * maps
                for m, q in zip(ms, reqs):
                    res = q.wait(1)
                    assert res.status.name == "SUCCESS", f"block ({m}, {r}): {res.error}"
                    got[m] = bufs[m].host_view()[: bufs[m].size].tobytes()
                nbytes += _check_batch(got, lengths, host, starts, r)
            return nbytes

        runs = (("streams1", 1, False, mappers, reducers, default), ("streams4", 4, False, mappers, reducers, default),
                ("streams4_checksum", 4, True, min(checksum_maps, mappers), 1, default),
                ("streams1_switch_0.1ms", 1, False, mappers, min(split_reducers, reducers), 1e-4),
                ("streams4_switch_0.1ms", 4, False, mappers, min(split_reducers, reducers), 1e-4))
        for key, streams, checksum, maps, rs, switch in runs:
            conf = TpuShuffleConf(**base, wire_streams=streams, wire_checksum=checksum)
            client = PeerTransport(conf, executor_id=1, device=device)
            checked = None
            if checksum:  # the server decides whether chunk frames carry a CRC
                checked = PeerTransport(conf, executor_id=0, store=server.store)
                client.add_executor(0, checked.init())
            else:
                client.add_executor(0, addr)
            try:
                mark = launch_marks(wrappers)
                sys.setswitchinterval(switch)
                try:
                    nbytes, secs = wall(lambda: fetch_all(client, maps, range(rs)))
                finally:
                    sys.setswitchinterval(default)
                row = {"gb": nbytes / 1e9, "s": secs, "gbps": nbytes / 1e9 / secs,
                       "blocks": int((lengths[:maps, :rs] > 0).sum()),
                       "launches": launched_since(wrappers, mark)}
                # a request is served on the thread of the lane it came in on: the counts are exact
                assert row["launches"] == {"K1": rs}, f"K1 once a fetch batch: {row['launches']}"
                assert nbytes == int(lengths[:maps, :rs].sum())
                if key == "streams1":
                    serve_batches.append((out, "the peer server's serve batch", wrappers["K1"].last[0][:5]))
                    mark = launch_marks(wrappers)
                    few = min(20, reducers)
                    row["busy"] = profile_call(f"the peer fetch of {few} reducers (streams 1)",
                                               lambda: fetch_all(client, maps, range(few)))
                    assert launched_since(wrappers, mark) == {"K1": few}
                lanes = client.wire_lane_stats()
                row["syscalls_per_mb"] = sum(x["rx_syscalls"] for x in lanes) / max(sum(x["rx_bytes"] for x in lanes) / 1e6, 1e-9)
                row["p99_frame_stall_ms"] = max(x["rx_stall_p99_ns"] for x in lanes) / 1e6
                out[key] = row
            finally:
                client.close()
                if checked is not None:
                    checked.server.close()
        assert out["streams1"]["gb"] == out["streams4"]["gb"] == payload / 1e9
    finally:
        server.close()
    log(f"  peer to peer, device-staged: {out['payload_gb']:.3f} GB in {out['blocks']} blocks, seal "
        f"{out['seal_s'] * 1e3:.2f} ms ({out['seal_launches']}); fetch streams 1 {out['streams1']['gbps']:.3f} GB/s "
        f"(K1 {out['streams1']['launches']['K1']}, one a batch), streams 4 {out['streams4']['gbps']:.3f} GB/s "
        f"(K1 {out['streams4']['launches']['K1']}); checksum on, streams 4, "
        f"{out['streams4_checksum']['blocks']} blocks: {out['streams4_checksum']['gbps'] * 1e3:.2f} MB/s; "
        "every byte equal to the written ones, every kernel call held against its plain version")
    for key in ("streams1", "streams4", "streams1_switch_0.1ms", "streams4_switch_0.1ms"):
        row = out[key]
        log(f"    {key.replace('_', ' ')}: {row['gbps']:.3f} GB/s over {row['blocks']} blocks, "
            f"{row['syscalls_per_mb']:.1f} receive syscalls/MB, p99 frame stall {row['p99_frame_stall_ms']:.2f} ms")
    return out


def cli_wire(device) -> dict:
    """Phase 23 (c): ``python -m sparkucx_tpu_torch.perf.benchmark wire`` at
    the JAX mode's measurement defaults (8 blocks of 32 MiB, streams 1, 2, 4,
    5 iterations) through ``main``, then a ``server`` process on an
    ephemeral port and a ``client`` through ``main`` fetching its blocks."""
    import contextlib
    import io

    from sparkucx_tpu_torch.perf import benchmark

    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        assert benchmark.main(["wire", "-n", "8", "-s", "32m", "-i", "5", "--streams", "1,2,4"]) == 0
    lines = printed.getvalue().splitlines()
    wire = {}
    for ln in lines:
        m = re.match(r"wire streams (\d+): ([\d.]+) GB/s, ([\d.]+) syscalls/MB, p99 frame stall ([\d.]+) ms", ln)
        if m:
            wire[int(m.group(1))] = {"gbps": float(m.group(2)), "syscalls_per_mb": float(m.group(3)),
                                     "p99_frame_stall_ms": float(m.group(4))}
            log(f"  {ln}")
    assert sorted(wire) == [1, 2, 4], lines
    server = subprocess.Popen(
        [sys.executable, "-m", "sparkucx_tpu_torch.perf.benchmark", "server", "-a", "127.0.0.1:0", "-n", "8", "-s", "32m"],
        cwd=os.path.dirname(os.path.abspath(__file__)), stdout=subprocess.PIPE, text=True,
    )
    try:
        line = server.stdout.readline().strip()
        m = re.fullmatch(r"serving 8 x 33554432 B blocks on (127\.0\.0\.1:\d+)", line)
        assert m, f"the server printed {line!r}"
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            assert benchmark.main(["client", "-a", m.group(1), "-n", "8", "-s", "32m", "-i", "3", "-o", "8"]) == 0
        client_lines = printed.getvalue().splitlines()
    finally:
        server.send_signal(__import__("signal").SIGINT)
        try:
            server.wait(timeout=60)
        except subprocess.TimeoutExpired:
            server.kill()
            server.wait(timeout=60)
    assert len(client_lines) == 3 and all("268435456 bytes" in ln for ln in client_lines), client_lines
    for ln in client_lines:
        log(f"  client: {ln}")
    best = max(float(re.search(r"\(([\d.]+) GB/s\)", ln).group(1)) for ln in client_lines)
    return {"wire": wire, "client_gbps": best, "server": line}


def daemon_write_costs(data, alignment: int = ROW) -> dict:
    """Where a daemon write's host time goes: each leg alone, on one thread,
    over the same blocks — the JSON control header (``json.dumps`` by the
    client, ``json.loads`` by the daemon), the socket (every WritePartition
    frame as the client builds it, through a loopback socket pair and read
    back with the daemon's ``recv_exact``), and the store
    (``MapWriter.write_partition`` into host staging)."""
    import json as _json
    import socket
    import struct

    from sparkucx_tpu_torch.config import TpuShuffleConf
    from sparkucx_tpu_torch.shuffle.daemon import DaemonOp, _frame
    from sparkucx_tpu_torch.store.hbm_store import HbmBlockStore
    from sparkucx_tpu_torch.transport.peer import recv_exact

    lengths, _, host, starts = data
    mappers, reducers = lengths.shape
    cells = [(m, r) for m in range(mappers) for r in range(reducers) if lengths[m, r]]

    def view(m, r):
        return memoryview(host[m])[int(starts[m, r]) : int(starts[m, r]) + int(lengths[m, r])]

    t0 = time.perf_counter()
    for m, r in cells:
        _json.loads(_json.dumps({"writer": m, "reduce_id": r}).encode())
    json_s = time.perf_counter() - t0
    a, b = socket.socketpair()
    try:
        def send():
            for m, r in cells:
                a.sendall(_frame(DaemonOp.WRITE_PARTITION, {"writer": m, "reduce_id": r}, view(m, r)))

        def receive():
            for _ in cells:
                _, hlen, blen = struct.unpack("<IQQ", recv_exact(b, 20))
                recv_exact(b, hlen)
                recv_exact(b, blen)

        t0 = time.perf_counter()
        sender = threading.Thread(target=send)
        sender.start()
        receive()
        sender.join()
        socket_s = time.perf_counter() - t0
    finally:
        a.close()
        b.close()
    padded = int((-(-lengths // alignment) * alignment).sum())
    store = HbmBlockStore(TpuShuffleConf(block_alignment=alignment, staging_capacity_per_executor=padded))
    try:
        store.create_shuffle(0, mappers, reducers)
        t0 = time.perf_counter()
        for m in range(mappers):
            w = store.map_writer(0, m)
            for r in range(reducers):
                w.write_partition(r, view(m, r))
            w.commit()
        store_s = time.perf_counter() - t0
    finally:
        store.close()
    gb = int(lengths.sum()) / 1e9
    log(f"  a daemon write's legs alone, one thread, {gb:.3f} GB in {len(cells)} frames: JSON headers "
        f"{json_s:.3f} s, the socket (frames built, sent, read back) {socket_s:.3f} s, the store's staging "
        f"copies {store_s:.3f} s")
    return {"gb": gb, "frames": len(cells), "json_s": json_s, "socket_s": socket_s, "store_s": store_s}


def serving_plane(device, seed: int, mappers: int = 200, reducers: int = 200, kv_pairs: int = 1000,
                  value_bytes: int = 25000, daemon_kv_pairs: int = 250, cli: bool = True) -> dict:
    """Phase 23: the Spark-facing daemon and the peer wire on the card, at
    GroupByTest's big gate: numKVPairs cut to 1000 for the peers (as in
    phase 3, ~5 GB) and to ``daemon_kv_pairs`` for the daemon, whose host
    route (a JSON frame, an ack and three host copies a block) moves ~0.11
    GB/s.  Every call of K1, K2, K3, K4 and K6 in the phase is held against
    its plain version (:func:`holding`; each part checks its own launches
    with :func:`launched_since`); the serve batches' K1 calls are timed
    after the hold is lifted."""
    wrappers, restore = holding(held_kernels(), keep_last=True, defer=True)
    serve_batches = []  # (the part's result, label, K1 arguments)
    out = {"daemon": {}}
    try:
        serving_parts(device, seed, mappers, reducers, kv_pairs, value_bytes, daemon_kv_pairs, cli, wrappers,
                      serve_batches, out)
    except Exception as e:
        failed = [w.failed for w in wrappers.values() if w.failed]
        if failed:  # the part broke because a kernel call differed: say so
            raise AssertionError("; ".join(failed)) from e
        raise
    finally:
        restore()
    for w in wrappers.values():
        w.settle()
    out["held_calls"] = {label: w.held for label, w in wrappers.items() if w.held}
    assert {label: w.launches for label, w in wrappers.items()} == {
        label: w.held_launches for label, w in wrappers.items()}, "a launch of phase 23 fell outside a held call"
    log(f"  phase 23's held calls, each equal to its plain version: {out['held_calls']}")
    for part, label, args in serve_batches:
        part["k1_serve_batch"] = check_k1_calls(device, label, [args])
    return out


def serving_parts(device, seed, mappers, reducers, kv_pairs, value_bytes, daemon_kv_pairs, cli, wrappers,
                  serve_batches, out) -> None:
    """:func:`serving_plane`'s parts in order, their results into ``out``."""
    data = groupby_host_blocks(device, mappers, reducers, daemon_kv_pairs, value_bytes, seed)
    for n, mode in ((1, "array"), (1, "device"), (4, "array"), (4, "device")):
        out["daemon"][f"n{n}_{mode}"] = daemon_groupby(device, n, mode, data, wrappers, serve_batches)
    mark = launch_marks(wrappers)
    out["daemon_write_split"] = daemon_write_split(device, data)
    out["daemon_write_costs"] = daemon_write_costs(data)
    assert not launched_since(wrappers, mark)
    del data
    out["fixtures"] = daemon_fixtures(device, wrappers)
    data = groupby_host_blocks(device, mappers, reducers, kv_pairs, value_bytes, seed)
    out["peer"] = peer_device_staged(device, data, wrappers, serve_batches)
    del data
    torch.cuda.empty_cache()
    if cli:
        mark = launch_marks(wrappers)
        out["cli"] = cli_wire(device)
        assert not launched_since(wrappers, mark), "the wire modes serve host bytes: no kernel"


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=SEED, help="seed of the TPC-H data and the graphs (phases 11-12, 18-19)")
    parser.add_argument("--only-serving-plane", action="store_true",
                        help="run phase 1 and phase 23 only (a quick check of the serving plane; no kernel table)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available — this script needs one NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from sparkucx_tpu_torch.ops import cuda_build

    device = torch.device("cuda", 0)
    log("phase 1: environment")
    card = card_line()
    log(f"  {card}")
    log(f"  python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("  TF32 off for matmul and cuDNN (no float math runs here; set for the record)")
    t0 = time.perf_counter()
    cuda_build.build_all()
    log(f"  kernels built in {time.perf_counter() - t0:.2f} s into {cuda_build.build_dir()}")
    for name, text in cuda_build.last_build_log.items():
        for line in text.splitlines():
            if "Used" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    if args.only_serving_plane:
        log("phase 23: the shuffle daemon and the peer wire on the card (GroupByTest's big gate)")
        log(json.dumps({"serving_plane": serving_plane(device, args.seed + 6)}))
        return 0

    log("phase 2: kernels against their plain versions")
    check_kernels(device)
    check_radix(device)

    log("phase 3: main path, device route (write -> commit -> run_exchange -> fetch_blocks_device)")
    stats, state = main_path(device)
    launches = stats["launches"]
    assert launches["block_gather"] > 0 and launches["block_scatter"] > 0, (
        f"the main path did not run through both kernels: {launches}"
    )

    log("phase 4: host route through the ShuffleManager SPI")
    route = host_route(device)
    assert route["exchange_launches"] == {"K1": route["rounds"]} and not route["read_launches"], (
        "phase 4: K1 once a staging round (one executor, one shot), and no launch in the reads")

    log("phase 5: four executors sharing the card")
    shared_device_exchange(device)

    log("phase 6: kernel times at the main paths' shapes")
    table = kernel_timings(device, state, launches)
    del state
    torch.cuda.empty_cache()
    table.append(radix_timings(device, TERASORT_ROWS))
    log_table(table[:2])

    log("phase 7: TeraSort 10 GB on the card (build_distributed_sort, impl='radix')")
    sort_stats, k6_launches = terasort(device, TERASORT_ROWS)
    assert k6_launches > 0, "the TeraSort path did not run through K6"
    table[2]["launches"] = k6_launches
    log_table(table[2:])

    log("phase 8: host drivers (run_distributed_sort, run_external_sort)")
    host_drivers(device)

    log("phase 9: the distributed sort with four executors sharing the card")
    shared_device_sort(device)
    sort_stats["shared_n4"] = shared_device_sort_uncut(device)

    log("phase 10: K3 and K4 against their plain versions")
    check_ring_kernels(device)

    log("phase 11: TPC-H Q1 at SF=10, four executors sharing the card (GROUP BY, fused combine)")
    q1_stats, k4_launches, k4_row = tpch_q1(device, args.seed)
    assert k4_launches > 0, "the Q1 path did not run through K4"
    table.append(k4_row)

    log("phase 12: TPC-H Q18 stage 1 at SF=1 (G = 2**23)")
    q18_stats = tpch_q18_stage1(device, args.seed + 1)
    assert q18_stats["k4_launches"] > 0, "the Q18 path did not run through K4"

    log("phase 13: the superstep under exchange.impl=pallas, four executors sharing the card")
    superstep, k3_row, keep = pallas_superstep(device)
    assert superstep["launches"]["ring_exchange_grid"] > 0, "the pallas superstep did not run through K3"
    table.append(k3_row)
    log_table(table[3:])

    log("phase 14: K5 against its plain version")
    check_fused_kernel(device)

    # phase 21 runs the fused quantized route on phase 13's plan geometry (phase 15 consumes the seal)
    geometry = {"seal": [(s.cpu().numpy(), c.cpu().numpy(), o.cpu().numpy(), int(pk.shape[0]))
                         for s, c, o, pk in keep["seal"]],
                "staging_rows": keep["staging_rows"], "sizes": keep["sizes"]}

    log("phase 15: the fused send side at groupby_big's four-executor shape (build_fused_ici_exchange)")
    k5_row, fused = fused_send_side(device, keep)
    assert k5_row["launches"] == 1, "the fused send side did not run through K5"
    table.append(k5_row)
    log_table(table[-1:])

    log("phase 16: the chunked plan at groupby_big's four-executor shape (slot_quota_rows, pipeline_depth=2)")
    chunked = chunked_plan(device, keep)
    del keep
    torch.cuda.empty_cache()

    log("phase 17: python -m sparkucx_tpu_torch.perf.benchmark ici on the card (measure_ici)")
    ici = ici_benchmark(device)

    log("phase 18: TPC-H Q18 whole at SF=10, four executors sharing the card (GROUP BY, two hash joins)")
    q18 = tpch_q18(device, args.seed + 2)

    log("phase 19: SparkTC, four executors sharing the card (run_transitive_closure)")
    tc = spark_tc(device, args.seed + 3)

    log("phase 20: the benchmark CLI's modes on the card (python -m sparkucx_tpu_torch.perf.benchmark)")
    modes = cli_modes(device)

    log("phase 21: the quantized exchange at 4 GiB, four executors sharing the card (K3 at 132-byte rows)")
    quantized = quantized_exchange(device, args.seed + 4, geometry)
    del geometry
    torch.cuda.empty_cache()

    log("phase 22: the six walkthroughs on the card, then the spilling reduce side")
    walks = walkthroughs(device)
    # GroupByTest at 1,000 records of 1,000 B a mapper (1 MB a reducer), keys
    # drawn from 4,000 so that they repeat, each reducer spilling past 256 KiB
    spilled = host_route(device, kv_pairs=1000, seed=args.seed + 5, keyspace=4000, grouped=True,
                         reduce_memory_budget=256 << 10)
    assert spilled["exchange_launches"] == {"K1": spilled["rounds"]} and not spilled["read_launches"], (
        "phase 22: K1 once a staging round (one executor, one shot), and no launch in the reads")
    assert min(spilled["spills"]) > 0, "a reducer did not spill under the 256 KiB budget"
    spilled = {k: v for k, v in spilled.items() if k != "report"}

    log(json.dumps({"main_path": {k: v for k, v in stats.items() if k != "launches"}}))
    sort_stats["k6"] = {k: table[2][k] for k in ("steps_ms", "design_bytes_ms", "first_design_bound_ms")}
    log(json.dumps({"terasort": sort_stats}))
    log(json.dumps({"groupby": {"q1_sf10": q1_stats, "q18_stage1_sf1": q18_stats}}))
    log(json.dumps({"pallas_superstep": superstep}))
    log(json.dumps({"fused_send_side": fused, "chunked_plan": chunked}))
    log(json.dumps({"ici": {str(n): p for n, p in ici["per_n"].items()}, "ici_held": ici["held"]}))
    log(json.dumps({"tpch_q18_sf10": q18, "sparktc": tc}))
    log(json.dumps({"benchmark_modes": {k: {f: v for f, v in m.items() if f != "lines"} for k, m in modes.items()}}))
    log(json.dumps({"quantized_exchange": quantized}))
    log("phase 23: the shuffle daemon and the peer wire on the card (GroupByTest's big gate)")
    t0 = time.perf_counter()
    serving = serving_plane(device, args.seed + 6)
    log(f"  phase 23 took {time.perf_counter() - t0:.1f} s")

    log(json.dumps({"walkthroughs": walks, "spilling_reduce_side": spilled}))
    log(json.dumps({"serving_plane": serving}))
    log(card_line())
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    log(json.dumps({"kernels": [{k: e[k] for k in keys} for e in table]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
