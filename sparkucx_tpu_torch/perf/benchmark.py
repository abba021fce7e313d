"""Transport benchmark CLI of the port — the ``ici`` mode of
``sparkucx_tpu/perf/benchmark.py``.

    python -m sparkucx_tpu_torch.perf.benchmark ici [-s 4m] [-i 5] [--executors N] [--chunks C] [--device cpu|cuda]

* ``ici`` — the scheduled ring exchange (ops/ici_exchange.py
  ``build_ici_exchange``: K3, then K1 compaction) head to head with the
  stock exchange (ops/exchange.py ``build_exchange``: K1 per receiver) at
  2, 4 and 8 executors sharing one device (or ``--executors N``), each peer
  slot ``-s`` bytes of 512-byte rows.  Per width, both are fed the same
  seeded slot-layout payload with ragged per-peer sizes, held bit-identical
  (every receiver's rows and the receive sizes), then timed over ``-i``
  iterations of four chained exchanges each.  At the widest width the fused
  send side (``build_fused_ici_exchange``: K5, then K1) is held against
  scatter-then-stock, with K5's launch count.  Prints one line per
  iteration, a summary per width and the ``StatsAggregator`` report.

Bandwidth is reported as aggregate GB/s (bytes sent to other executors /
wall seconds) and, as the JAX mode prints it, per link = aggregate / 2n, the
share of one of a bidirectional ring's 2n directed links.  Executors sharing
one card have no links: there the per-link figure is only aggregate / 2n.

Every other mode of the JAX CLI is not ported yet (ROADMAP queue A item 11)
and exits with a message.  The run is on the card unless ``--device cpu``
is given; without a card it fails.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from sparkucx_tpu_torch.config import parse_size
from sparkucx_tpu_torch.utils.devices import resolve_devices
from sparkucx_tpu_torch.utils.stats import StatsAggregator

#: the JAX CLI's modes; only ``ici`` is ported
MODES = (
    "server", "client", "superstep", "pipeline", "gather", "sort", "columnar", "groupby", "join", "write",
    "skew", "adaptive", "wire", "ici", "combine", "failover", "elastic", "compress", "tenants", "obs",
    "gray", "fanin", "queries",
)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _same_rows(a: torch.Tensor, b: torch.Tensor, sizes: np.ndarray, recv_rows: int) -> bool:
    """Every receiver's received rows (the prefix ``sizes`` gives) equal."""
    for j in range(sizes.shape[0]):
        used = int(sizes[:, j].sum())
        lo = j * recv_rows
        if not torch.equal(a[lo : lo + used], b[lo : lo + used]):
            return False
    return True


def measure_ici(
    executors_list=(2, 4, 8), slot_rows: int = 1024, lane: int = 128,
    chunks_per_dest: int = 0, iterations: int = 5, report=None, stats=None, device="cuda",
) -> dict:
    """Measurement core of the ``ici`` mode (module docstring).  Executors
    share ``device``, so the widths are not clamped by a device count.
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


def run_ici(args) -> None:
    size = parse_size(args.block_size)
    slot_rows = max(1, size // 512)
    stats = StatsAggregator()

    def report(impl, n, it, dt, tot):
        print(
            f"n={n} {impl:6} iter {it}: {tot} remote bytes in {dt*1e3:.1f} ms "
            f"= {tot / dt / 1e9:.2f} GB/s",
            flush=True,
        )

    widths = (2, 4, 8) if args.executors <= 1 else (args.executors,)
    r = measure_ici(
        widths, slot_rows, 128, chunks_per_dest=args.chunks,
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


def _parse_args(argv):
    p = argparse.ArgumentParser(prog="sparkucx-tpu-torch-perf", description=__doc__.split("\n")[0])
    p.add_argument("mode", choices=MODES)
    p.add_argument("-s", "--block-size", default="4m", help="bytes per peer slot (512-byte rows)")
    p.add_argument("-i", "--iterations", type=int, default=5)
    p.add_argument("--executors", type=int, default=1, help="one width instead of 2, 4 and 8")
    p.add_argument(
        "--chunks", type=int, default=0,
        help="FAST chunks per destination; 0 picks ops/ici_exchange.py DEFAULT_CHUNKS_PER_DEST",
    )
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"), help="where the executors run")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = _parse_args(argv if argv is not None else sys.argv[1:])
    if args.mode != "ici":
        print(
            f"mode {args.mode!r} is not ported yet (ROADMAP queue A item 11, benchmarks); "
            "this CLI runs 'ici'",
            file=sys.stderr,
        )
        return 2
    run_ici(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
