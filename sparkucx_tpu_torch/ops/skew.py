"""Skew-aware exchange planning — per-destination quotas and hot-lane chunking.

Port of ``sparkucx_tpu/ops/skew.py``: the plan and its geometry, verbatim.
One skewed reduce partition sizes every peer slot to the hottest
destination; ``conf.slot_quota_rows`` caps the slot and chunks oversized
peer payloads across additional sub-rounds, which ride the ``RoundPipeline``
overlap (transport/pipeline.py).  Everything here is geometry over host ints
and arrays, except the two functions that touch payloads:

* ``quota_slot_rows`` — the quota-capped, pow2-bucketed slot;
* ``plan_exchange`` / ``ExchangePlan`` — per staging round, how many
  quota-sized sub-rounds cover the hottest lane;
* ``chunk_size_rows`` — one sub-round's size row (host numpy);
* ``slice_subround`` — one sub-round's payload slice; it takes a torch
  tensor (where the JAX code takes ``xp=jnp``) and stays on its device, so
  a device-sealed payload never visits the host;
* ``piece_slices`` / ``reassemble_round`` — the receiver side: splice the
  sub-rounds' tight sender-major shards back into the exact buffer the
  single-shot exchange would have produced;
* ``staging_occupancy`` / ``pad_rows_pow2`` — telemetry, and the pow2 row
  padding of spliced device shards (a torch tensor, kept on its device).

The planner never sees payload bytes, only the size matrix.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch


def quota_slot_rows(slot_rows: int, quota_rows: int) -> int:
    """The quota-capped compile bucket for a per-peer slot: cap ``slot_rows``
    at ``quota_rows`` (``<= 0`` disables the cap — today's behavior), then
    round up to the next power of two.

    The result is what the transports hand ``_exchange_fn`` (times ``n``), so
    skewed and uniform shuffles whose caps land in one bucket share a compiled
    executable — a pow2 slot is a fixed point of ``bucket_send_rows``, so the
    existing cache keying applies unchanged."""
    if slot_rows <= 0:
        raise ValueError("slot_rows must be positive")
    cap = slot_rows if quota_rows <= 0 else min(slot_rows, quota_rows)
    bucket = 1
    while bucket < cap:
        bucket <<= 1
    return bucket


@dataclass(frozen=True)
class ExchangePlan:
    """One shuffle's declarative exchange schedule — THE exchange interface.

    The geometry core is unchanged: ``chunks_per_round[r]`` quota-sized
    sub-rounds cover staging round ``r``'s hottest lane, and ``slot_rows`` is
    the per-peer slot every sub-round stages (the compile bucket).  Around it,
    the plan now carries everything the unified executor
    (transport/executor.py) interprets and the serve plane reads:

    * ``single_shot`` — drain style.  True is the historical quota-off
      engine: whole padded shards retained directly (supports donation of
      device-sealed payloads and elastic degraded recovery).  False is the
      chunked engine: each staging round's tight sub-round shards are
      spliced back into the exact single-shot layout (bit-identical over the
      valid prefix; no trailing padding kept).
    * ``round_order`` — submission order over staging rounds (a permutation;
      empty = natural order).  Produced by the staging-footprint reordering
      pass (ops/planner.py, after arXiv:2112.01075); results are always
      emitted back in natural round order.
    * ``lowering`` — the collective tier (``conf.exchange_impl`` vocabulary:
      'stock' | 'pallas' | 'auto'), interpreted by ``build_plan_exchange``.
    * ``pipeline_depth`` — the superstep overlap window for this shuffle.
    * ``streams`` / ``codec`` / ``quantize_mode`` + ``quantize_block`` /
      ``hedge_ms`` — the serve/wire-plane tiers chosen for this shuffle's
      traffic (fetch striping, page codec, lossy aggregation quantization,
      hedged-fetch delay).  The collective executor never quantizes shuffle
      bytes (payloads are exact); these fields parameterize the fetch path,
      the aggregation plane, and the bench harness, and land in the per-
      shuffle ``exchange.plan`` trace event.
    * ``combine`` — the receive-side compute-in-exchange tier for partial
      grouped aggregations (``'off' | 'dense' | 'sorted'``).  ``dense`` folds
      every landed window into a fixed per-group accumulator inside the
      exchange (O(groups) post-exchange memory and drain bytes, one fused
      kernel launch under the DMA lowering); ``sorted`` is the bounded
      per-superstep sort/merge fallback when the key domain is not
      dense-representable.  Only meaningful when the shuffle carries an
      ``AggregateSpec`` with partial aggregation; raw block exchanges ignore
      it.  Chosen from all-gathered geometry only (SPMD lockstep — see
      ops/planner.py).
    """

    slot_rows: int
    chunks_per_round: Tuple[int, ...]
    single_shot: bool = False
    round_order: Tuple[int, ...] = ()
    lowering: str = "stock"
    pipeline_depth: int = 2
    streams: int = 1
    codec: str = "off"
    quantize_mode: str = "off"
    quantize_block: int = 128
    hedge_ms: int = 0
    combine: str = "off"

    @property
    def num_subrounds(self) -> int:
        return sum(self.chunks_per_round)

    def subrounds(self) -> List[Tuple[int, int, int]]:
        """Flat submission order: ``(staging_round, chunk, num_chunks)`` per
        sub-round, chunk-major within each staging round — the order the
        pipeline submits and the single drain worker reassembles."""
        out: List[Tuple[int, int, int]] = []
        for rnd, nchunks in enumerate(self.chunks_per_round):
            for chunk in range(nchunks):
                out.append((rnd, chunk, nchunks))
        return out

    def ordered_subrounds(self) -> List[Tuple[int, int, int]]:
        """``subrounds()`` permuted by ``round_order``: whole staging rounds
        are reordered as units (chunk order within a round is load-bearing —
        the splice reassembles in chunk order), so the executor can submit
        lighter rounds first while the drain still groups by round."""
        if not self.round_order:
            return self.subrounds()
        if sorted(self.round_order) != list(range(len(self.chunks_per_round))):
            raise ValueError(
                f"round_order {self.round_order} is not a permutation of "
                f"{len(self.chunks_per_round)} staging rounds"
            )
        out: List[Tuple[int, int, int]] = []
        for rnd in self.round_order:
            nchunks = self.chunks_per_round[rnd]
            for chunk in range(nchunks):
                out.append((rnd, chunk, nchunks))
        return out

    def staged_rows(self, num_executors: int) -> int:
        """Total staged rows across the whole exchange (``n`` executors x
        ``n`` slots x ``slot_rows``, summed over sub-rounds) — the memory/wire
        quantity the quota exists to shrink; under the dense lowering this
        times ``row_bytes`` is exactly the wire traffic."""
        n = num_executors
        return self.num_subrounds * n * n * self.slot_rows

    def describe(self) -> dict:
        """JSON-safe flat view for the per-shuffle ``exchange.plan`` trace
        event and the flight recorder (every value a scalar or short list)."""
        return {
            "slot_rows": self.slot_rows,
            "chunks_per_round": list(self.chunks_per_round),
            "num_subrounds": self.num_subrounds,
            "single_shot": self.single_shot,
            "round_order": list(self.round_order),
            "lowering": self.lowering,
            "pipeline_depth": self.pipeline_depth,
            "streams": self.streams,
            "codec": self.codec,
            "quantize_mode": self.quantize_mode,
            "quantize_block": self.quantize_block,
            "hedge_ms": self.hedge_ms,
            "combine": self.combine,
        }


def plan_exchange(
    round_max_rows: Sequence[int], slot_rows: int, quota_rows: int
) -> ExchangePlan:
    """Plan the sub-round schedule from per-staging-round hottest-lane sizes.

    ``round_max_rows[r]`` is the max over (sender, destination) of the used
    rows in staging round ``r`` — cluster-wide (all executors' seals; the SPMD
    executor all-gathers it so every process derives the same plan).  Each
    round gets ``ceil(max / quota_slot)`` chunks, at least one so empty rounds
    still run their collective (SPMD lockstep)."""
    q = quota_slot_rows(slot_rows, quota_rows)
    chunks = tuple(max(1, -(-int(m) // q)) for m in round_max_rows)
    return ExchangePlan(slot_rows=q, chunks_per_round=chunks)


def chunk_size_rows(size_row, chunk: int, quota_slot: int) -> np.ndarray:
    """One sub-round's size-matrix row: the rows of each destination's payload
    that fall in window ``[chunk * quota_slot, (chunk + 1) * quota_slot)``.

    Summing over chunks reproduces ``size_row`` exactly (row conservation —
    property-tested), so the logical per-round receive sizes every consumer
    slices by are the sums the drain worker accumulates."""
    lo = chunk * quota_slot
    return np.clip(np.asarray(size_row, dtype=np.int32) - np.int32(lo), 0, quota_slot).astype(np.int32)


def slice_subround(payload: torch.Tensor, num_executors: int, chunk: int, quota_slot: int) -> torch.Tensor:
    """The sender side of one sub-round: slice row window ``chunk`` out of
    every peer slot of a ``(n * staging_slot, lane)`` slot-layout payload and
    relocate into the quota-capped ``(n * quota_slot, lane)`` slot layout, on
    the payload's device.

    With ``chunk == 0`` and ``quota_slot >= staging_slot`` this is exactly
    ``rebucket_slots`` (the unchunked relocation).  Rows of the window beyond
    a destination's used count are staging garbage/zeros — the sub-round's
    size row (``chunk_size_rows``) keeps them out of every valid output, same
    contract as the unchunked exchange."""
    rows, lane = int(payload.shape[0]), int(payload.shape[1])
    n = num_executors
    if rows % n:
        raise ValueError(f"payload rows {rows} not a multiple of {n} executors")
    slot = rows // n
    lo = chunk * quota_slot
    if lo >= slot:
        # window entirely past the staging slot: all-pad sub-round (this
        # executor's lanes are cold while a hotter peer still streams)
        return torch.zeros((n * quota_slot, lane), dtype=payload.dtype, device=payload.device)
    hi = min(lo + quota_slot, slot)
    piece = payload.reshape(n, slot, lane)[:, lo:hi, :]
    if hi - lo < quota_slot:
        piece = torch.nn.functional.pad(piece, (0, 0, 0, quota_slot - (hi - lo)))
    return piece.reshape(n * quota_slot, lane)


def piece_slices(sub_sizes: Sequence[np.ndarray]) -> List[Tuple[int, int, int]]:
    """Receiver-side splice plan for one staging round: given each sub-round's
    received size row (``sub_sizes[c][i]`` = rows received from sender ``i``
    in sub-round ``c``, each a tight sender-major shard), the pieces of the
    reassembled buffer in sender-major order as ``(sub_round, start_row,
    rows)`` — sender ``i``'s chunks concatenate across sub-rounds in chunk
    order, restoring the exact layout the single-shot exchange produces.
    Zero-row pieces are skipped."""
    starts = [np.concatenate([[0], np.cumsum(s)[:-1]]).astype(np.int64) for s in sub_sizes]
    out: List[Tuple[int, int, int]] = []
    n = len(sub_sizes[0]) if sub_sizes else 0
    for sender in range(n):
        for c, sizes in enumerate(sub_sizes):
            rows = int(sizes[sender])
            if rows:
                out.append((c, int(starts[c][sender]), rows))
    return out


def reassemble_round(
    sub_shards: Sequence[np.ndarray], sub_sizes: Sequence[np.ndarray], row_bytes: int
) -> np.ndarray:
    """Splice one receiver's sub-round shards (flat uint8, tight sender-major)
    back into the single-shot receive buffer: byte-for-byte what the flat
    exchange would have produced over the valid prefix."""
    pieces = [
        sub_shards[c][start * row_bytes : (start + rows) * row_bytes]
        for c, start, rows in piece_slices(sub_sizes)
    ]
    if not pieces:
        return np.zeros(0, dtype=np.uint8)
    return np.concatenate(pieces)


def staging_occupancy(size_rows, slot_rows: int) -> Tuple[int, int]:
    """(used, padded) rows of a staged slot-layout buffer: ``size_rows`` used
    rows spread over ``size_rows.size`` slots of ``slot_rows`` capacity.  The
    padding telemetry both transports feed ``StatsAggregator`` — padded /
    (used + padded) is the fraction of staged HBM (and, under the dense
    lowering, wire bytes) the skew wastes."""
    arr = np.asarray(size_rows)
    used = int(arr.sum())
    return used, int(arr.size) * slot_rows - used


def pad_rows_pow2(shard: torch.Tensor) -> torch.Tensor:
    """Pad a ``(rows, lane)`` tensor with zero rows up to the next power of
    two, on its device.  Spliced device shards have data-dependent row
    counts; the JAX package pads them so its jit-compiled gather sees a
    bounded set of shapes, and the port keeps the same shard shapes."""
    rows = int(shard.shape[0])
    bucket = 1 << max(rows - 1, 0).bit_length()
    if bucket == rows:
        return shard
    return torch.nn.functional.pad(shard, (0, 0, 0, bucket - rows))
