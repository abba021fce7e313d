"""Drive sparkucx_tpu_torch's main path on one CUDA card and check it.

    python3 chip_smoke.py

Builds the Hopper kernels from ``sparkucx_tpu_torch/csrc`` (nvcc, sm_90a, one
process per source, all started together), then runs nine phases; any
failure propagates and the exit code is non-zero:

1. environment: card, power limit, versions, kernel build time;
2. each kernel against its plain PyTorch version, bit-exact: K1 and K2 on
   ragged plans (empty blocks, count=0 pads at the packed end, 1-row blocks,
   one block covering the whole source, a source above 2**31 bytes, a row
   width off the 16-byte path); K6 (the radix pass) on N = 0, 1, 2, one whole
   tile and one row past it, a last tile that ends inside a 256-row chunk,
   all-equal keys, keys 0xFFFFFFFF, keys >= 2**31, three keys over 1M rows
   with payload = row id (stability), float32 rows, widths 1, 2 and 25, and
   a 2.2 GB buffer past 2**31 bytes;
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
   the whole sort of the TeraSort rows, and one pass);
7. the TeraSort main path: 100,000,000 rows of 100 B (10 GB, the reference's
   "TeraSort 10GB") made on the card, sorted by ``build_distributed_sort``
   with ``impl='radix'`` (K6's launch count set to 0 before and read after),
   held bit for bit against ``torch.sort(stable=True)`` + ``index_select``,
   then ``radix`` and ``single`` timed on the same data;
8. the host drivers: ``run_distributed_sort`` (n=1, radix, 1M rows) and
   ``run_external_sort`` (three batches) against ``oracle_sort``;
9. the sample sort with four executors sharing the card, exchange through K1
   (one launch per receiver): the host driver on 25M rows (2.5 GB, cut from
   10 GB because it holds the dataset several times in host memory) against
   the library sort, then K1 held against its plain version on that run's
   own exchange (its fused 100-byte rows and every receiver's plan); then
   ``build_distributed_sort`` on the uncut 10 GB made on the card, checked
   and timed, with its peak device memory.

The last line is ``{"ok": true, "device": {...}}``; the line before it holds
the kernel table as JSON.  Exits non-zero without a result when CUDA is not
available.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

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


def wall(fn):
    """(result, seconds) of ``fn`` on the host clock, ending synchronized."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


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

    def gather_case(name, src, starts, counts, pads=0):
        total = int(counts.sum())
        outs = np.cumsum(counts) - counts
        starts = np.concatenate([starts, np.zeros(pads, np.int64)])
        counts = np.concatenate([counts, np.zeros(pads, np.int64)])
        outs = np.concatenate([outs, np.full(pads, total, np.int64)])
        s, c, o = plan_tensors(starts, counts, outs, device)
        got = block_gather(s, c, o, src, total)
        want = block_gather_ref(s, c, o, src, total)
        torch.cuda.synchronize()
        assert torch.equal(got[:total], want[:total]), f"block_gather {name}: mismatch"
        log(f"  block_gather  {name:<28} blocks={len(counts):>6} rows={total:>9}  equal")

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
    gather_case("only pads", src, np.zeros(0, np.int64), np.zeros(0, np.int64), pads=3)
    odd = rand_rows(4096, 33)  # 132-byte rows: the 4-byte path
    starts, counts = _ragged_plan(rng, 300, 4096, 40)
    gather_case("132-byte rows", odd, starts, counts, pads=2)
    high = min((1 << 31) // ROW - 1000, big_rows // 2)  # blocks straddle and pass 2**31 B
    big = rand_rows(big_rows)
    starts, counts = _ragged_plan(rng, 500, big_rows, 2000, lo=high)
    gather_case(f"{big_rows * ROW / 2**30:.1f} GiB source, high rows", big, starts, counts, pads=1)

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


def host_route(device, mappers=100, reducers=100, kv_pairs=100, value_bytes=1000):
    from sparkucx_tpu_torch.config import TpuShuffleConf
    from sparkucx_tpu_torch.shuffle.manager import TpuShuffleManager
    from sparkucx_tpu_torch.utils.codec import encode_records

    rng = np.random.default_rng(SEED + 1)
    oracle = {r: [] for r in range(reducers)}
    t0 = time.perf_counter()
    with TpuShuffleManager(TpuShuffleConf(host_recv_mode="array"), devices=[device]) as mgr:
        mgr.register_shuffle(1, mappers, reducers)
        for m in range(mappers):
            keys = rng.integers(0, 2**31 - 1, size=kv_pairs)
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
        mgr.run_exchange(1)
        records = 0
        for r in range(reducers):
            got = sorted(mgr.get_reader(1, r, r + 1).read())
            assert got == sorted(oracle[r]), f"reducer {r}: records differ from the oracle"
            records += len(got)
    assert records == mappers * kv_pairs
    log(f"  GroupByTest {mappers} x {reducers}: {records} records read back equal "
        f"({time.perf_counter() - t0:.2f} s)")


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
    from sparkucx_tpu_torch.ops.block_kernels import (
        block_gather, block_gather_ref, block_scatter, block_scatter_ref, plan_tensors,
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
    moved = 2 * total * ROW + 12
    table.append({
        "name": "block_gather", "route": "cuda", "source": "sparkucx_tpu_torch/csrc/block_copy.cu",
        "replaces": "sparkucx_tpu/ops/pallas_kernels.py:158",
        "launches": launches["block_gather"], "max_abs_err": err,
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes", "library_ms": l_ms,
        "shape": f"1 block of {total} rows of {ROW} B (the n=1 exchange)",
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
    fb = (2 * f_total * ROW + 12 * mappers) / HBM_BYTES_PER_S * 1e3
    log(f"  block_gather at one reducer's fetch ({mappers} blocks, {f_total} rows): "
        f"{fk:.4f} ms, plain {fp:.4f} ms, bound {fb:.4f} ms")

    return table


def log_table(table) -> None:
    for k in table:
        log(f"  {k['name']:<14} {k['ms']:9.4f} ms  plain {k['plain_ms']:10.4f} ms  "
            f"library {k['library_ms']:9.4f} ms  bound {k['bound_ms']:8.4f} ms  "
            f"launches {k['launches']}  [{k['shape']}]")


# -- K6: the radix sort ----------------------------------------------------


def radix_sort_plain(rows: torch.Tensor) -> torch.Tensor:
    """The whole sort through K6's plain version, pass by pass."""
    from sparkucx_tpu_torch.ops.radix import BITS, NUM_PASSES, radix_pass_ref

    for p in range(NUM_PASSES):
        rows = radix_pass_ref(rows, p * BITS)
    return rows


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
    """Phase 2, K6: the kernel against its plain version, bit-equal, on the
    edge cases; ``big_rows`` rows of 100 B make a buffer past 2**31 bytes."""
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
        log(f"  radix_pass    {name:<34} rows={rows.shape[0]:>9} words={rows.shape[1]:>2} tiles={tiles:>5}  equal")
        return got

    for n in (0, 1, 2):
        case(f"N={n}", rand_rows(n, 25), passes=True)
    case("one whole tile, every pass", rand_rows(TILE_ROWS, 25), passes=True)
    case("one row past a tile, every pass", rand_rows(TILE_ROWS + 1, 25), passes=True)
    # the last tile holds 1001 rows: it ends inside the kernel's 256-row chunk
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
    """K6 at the TeraSort shape: the whole sort (NUM_PASSES launches) and one
    pass, beside the plain version, the library sort and the bandwidth bound."""
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
    lib = library_sort_rows(rows)
    assert torch.equal(got, lib), "radix sort at the TeraSort shape differs from the library sort"
    del got, want, lib
    torch.cuda.empty_cache()
    k_ms = time_ms(lambda: radix_sort_rows(rows), 5)
    out = torch.empty_like(rows)
    pass_ms = time_ms(lambda: radix_pass(rows, 0, out=out), 5)
    # one pass split into its steps: histogram kernel, dests (one torch
    # cumsum), scatter kernel
    hist = radix._histogram(rows, 0)
    dests = radix.pass_dests(hist)
    hist_ms = time_ms(lambda: radix._histogram(rows, 0), 5)
    dests_ms = time_ms(lambda: radix.pass_dests(hist), 5)
    scatter_ms = time_ms(lambda: radix._scatter(rows, 0, dests, out), 5)
    log(f"  radix_pass one pass, by step: histogram {hist_ms:.4f} ms, dests {dests_ms:.4f} ms, "
        f"scatter {scatter_ms:.4f} ms (bound {2 * n * row_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms)")
    del out, hist, dests
    torch.cuda.empty_cache()
    p_ms = time_ms(lambda: radix_sort_plain(rows), 2)
    torch.cuda.empty_cache()
    l_ms = time_ms(lambda: library_sort_rows(rows), 5)
    pass_bytes = 2 * n * row_bytes + 4 * n
    bound_ms = NUM_PASSES * pass_bytes / HBM_BYTES_PER_S * 1e3
    floor_ms = 2 * n * row_bytes / HBM_BYTES_PER_S * 1e3
    log(f"  radix_pass one pass: {pass_ms:.4f} ms, bound {pass_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms "
        f"({pass_bytes / pass_ms / 1e6:.1f} GB/s); one-pass floor of any sort "
        f"2 x N x {row_bytes} B / BW = {floor_ms:.4f} ms")
    log(f"  radix sort {NUM_PASSES} passes: {k_ms:.4f} ms = {n / k_ms / 1e3:.1f} M rows/s "
        f"({n * row_bytes / k_ms / 1e6:.1f} GB/s of rows sorted)")
    del rows
    torch.cuda.empty_cache()
    return {
        "name": "radix_pass", "route": "cuda", "source": "sparkucx_tpu_torch/csrc/radix_sort.cu",
        "replaces": "sparkucx_tpu/ops/radix.py:254",
        "launches": None, "max_abs_err": err,
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": l_ms,
        "shape": f"whole sort of {n} rows of {row_bytes} B, {NUM_PASSES} passes; ms per pass {pass_ms:.4f}",
    }


# -- phase 7 ---------------------------------------------------------------


def profile_call(name: str, fn, top: int = 6):
    """One call of ``fn`` under torch.profiler: the device time by kernel
    (its largest ``top``) and the device's busy share of the call's wall
    time.  Returns the busy share, or None when the trace holds no device time."""
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
    return busy_us / wall_us


def terasort(device, n: int = 100_000_000, reps: int = 3):
    """TeraSort at the reference's 10 GB through the sort's entry point,
    impl='radix', checked bit for bit against the library sort; then 'radix'
    and 'single' timed on the same data.  Returns (stats, K6 launches)."""
    from sparkucx_tpu_torch.ops.radix import radix_pass
    from sparkucx_tpu_torch.ops.sort import SortSpec, build_distributed_sort

    keys, payload = terasort_data(device, n)
    gb = n * 100 / 1e9
    log(f"  {n} rows of 100 B (1 uint32 key + 24 int32 payload lanes) = {gb:.3f} GB, uniform keys")
    radix = build_distributed_sort([device], SortSpec(1, n, n, impl="radix"))
    single = build_distributed_sort([device], SortSpec(1, n, n))
    assert single.spec.impl == "single"
    torch.cuda.reset_peak_memory_stats()

    radix_pass.launches = 0
    (ko, po, counts), secs = wall(lambda: radix(keys, payload, [n]))
    launches = radix_pass.launches
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


def shared_device_sort(device, n_rows: int = 25_000_000, n: int = 4) -> int:
    """The sample sort with four executors on the card through the host
    driver: exchange through K1.  Then K1 against its plain version on that
    run's own exchange: the fused rows and every receiver's plan.  Returns
    K1's launches in the run."""
    from sparkucx_tpu_torch.ops import sort as sort_mod
    from sparkucx_tpu_torch.ops.block_kernels import block_gather, block_gather_ref, plan_tensors
    from sparkucx_tpu_torch.ops.columnar import receive_plan
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
    exchange = sort_mod.exchange_sorted_rows

    def recording_exchange(cspec, rows, sizes):
        seen.update(cspec=cspec, rows=rows, sizes=sizes)
        return exchange(cspec, rows, sizes)

    sort_mod.exchange_sorted_rows = recording_exchange
    try:
        torch.cuda.reset_peak_memory_stats()
        before = block_gather.launches
        t0 = time.perf_counter()
        sk, sp = run_distributed_sort([device] * n, spec, keys_h, payload_h)
        secs = time.perf_counter() - t0
        launches = block_gather.launches - before
    finally:
        sort_mod.exchange_sorted_rows = exchange
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
    cspec, rows, sizes = seen["cspec"], seen["rows"], seen["sizes"]
    rc = cspec.recv_capacity
    for j in range(n):
        plan = plan_tensors(*receive_plan(sizes, j, cspec.capacity, rc), device)
        total = min(int(sizes[:, j].sum()), rc)
        got = block_gather(*plan, rows, rc)
        want = block_gather_ref(*plan, rows, rc)
        torch.cuda.synchronize()
        assert torch.equal(got[:total], want[:total]), f"block_gather at the n={n} sort's receiver {j}: mismatch"
    log(f"  block_gather at the n={n} sort's exchange: every receiver ({n} segments, about "
        f"{total} rows of {rows.shape[1] * 4} B each) equal to block_gather_ref")
    out = torch.empty((rc, rows.shape[1]), dtype=rows.dtype, device=device)
    k_ms = time_ms(lambda: block_gather(*plan, rows, rc, out=out), 10)
    p_ms = time_ms(lambda: block_gather_ref(*plan, rows, rc, out=out), 10)
    b_ms = (2 * total * rows.shape[1] * 4 + 12 * n) / HBM_BYTES_PER_S * 1e3
    log(f"  block_gather at receiver {n - 1} of the n={n} sort ({total} rows of {rows.shape[1] * 4} B): "
        f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {b_ms:.4f} ms")
    del seen, rows, out, got, want
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


def main() -> int:
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
    host_route(device)

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

    log(json.dumps({"main_path": {k: v for k, v in stats.items() if k != "launches"}}))
    log(json.dumps({"terasort": sort_stats}))
    log(card_line())
    log(json.dumps({"kernels": [{k: v for k, v in e.items() if k != "shape"} for e in table]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
