"""Exchange planners — legacy knobs, optimization passes, telemetry feedback.

Port of ``sparkucx_tpu/ops/planner.py`` (a verbatim copy: pure Python over
``ops/skew.ExchangePlan``).  ``PlanSignals.from_registry`` reads any object
whose ``snapshot()`` yields samples with ``family``, ``name``, ``labels`` and
``value``; the transport plans from its cluster's ``obs/metrics.py``
registry, as the JAX package's does.

``ExchangePlan`` (ops/skew.py) is the declarative exchange interface: rounds,
per-round chunking, lowering tier, overlap depth, and the serve-plane tiers
(streams, codec, quantization, hedge delay).  This module produces plans:

* :class:`StaticPlanner` — the legacy conf knobs mapped 1:1 onto a plan.
  ``slot_quota_rows == 0`` becomes the single-shot plan (whole padded slots,
  donation, elastic recovery); ``> 0`` becomes the chunked plan
  (``plan_exchange``).  With ``conf.planner_optimize`` off (the default) the
  mapping is EXACT: the unified executor interpreting a static plan is
  byte-identical to the pre-plan engines.
* Plan-optimization passes — pure plan->plan rewrites gated behind
  ``conf.planner_optimize`` / the adaptive planner, because they change the
  schedule geometry (never the bytes): pow2 slot bucketing (idempotent over
  ``plan_exchange`` output, a safety net for hand-built plans), chunk
  coalescing (grow the slot while total staged rows don't grow — fewer
  collective launches for the same wire bytes), and staging-footprint
  sub-round reordering after "Memory-efficient array redistribution through
  portable collective communication" (arXiv:2112.01075) — lighter staging
  rounds submit first so the depth-d in-flight window's peak co-resident
  footprint shrinks.
* :class:`AdaptivePlanner` — re-plans per shuffle per epoch from the
  telemetry the JAX package's obs plane exports, instead of ~20 static
  knobs: predicted padding (from the sealed size matrices) picks the quota,
  ``rx_stall_p99_ns`` + peer health set the hedge delay, observed
  compression ratios keep or drop the codec, credit stalls widen the wire
  stripes, and drain-lane occupancy deepens the pipeline.

SPMD lockstep: every multi-controller process must derive the identical
collective schedule.  The adaptive planner therefore splits its inputs —
anything that shapes the COLLECTIVE schedule (quota, chunking, ordering,
lowering) is a pure function of :class:`PlanContext` fields the SPMD executor
all-gathers (round maxes, used-row totals), while :class:`PlanSignals`
telemetry (which may differ per host) only steers serve-plane fields that
never enter a collective (hedge, codec, streams).  ``pipeline_depth`` may
vary per host safely: depth changes WHEN stages overlap, never the order
collectives are submitted in.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Tuple

from sparkucx_tpu_torch.ops.skew import (
    ExchangePlan,
    plan_exchange,
    quota_slot_rows,
)


def _pow2_ceil(rows: int) -> int:
    bucket = 1
    while bucket < rows:
        bucket <<= 1
    return bucket


@dataclass(frozen=True)
class PlanSignals:
    """The metric snapshot a plan was justified by — the planner-relevant
    slice of a ``MetricsRegistry.snapshot()``.  All fields default to the
    'healthy, nothing observed yet' reading, so a cold cluster plans exactly
    like the static mapping."""

    #: staged-slot padding observed on past exchanges (ops family,
    #: padded / (used + padded) over exchange.pipeline.drain)
    padding_fraction: float = 0.0
    #: drain-lane occupancy: drain time / submit time over past exchanges
    #: (> 1 means the host-side drain is the bottleneck, worth more overlap)
    drain_occupancy: float = 0.0
    #: worst per-lane receive stall tail across the wire plane, ns
    rx_stall_p99_ns: int = 0
    #: time fetch readers spent blocked on the credit gate, ns
    credit_stall_ns: int = 0
    #: minimum peer health EWMA across remotes ([0, 1]; 1 = healthy)
    worst_peer_health: float = 1.0
    #: circuit breakers currently open across remotes
    breakers_open: int = 0
    #: observed wire compression ratio (raw / encoded; 1.0 = incompressible
    #: or codec off — below ~1.05 the encode cost buys nothing)
    compression_ratio: float = 1.0

    @classmethod
    def from_registry(cls, registry) -> "PlanSignals":
        """Distill one registry snapshot into planner signals.  Unknown or
        absent families simply keep their defaults — the planner must work
        against any subset of providers (SPMD hosts register fewer)."""
        padding = drain_occ = None
        used = padded = 0.0
        submit_ns = drain_ns = 0.0
        rx_stall = credit_stall = 0
        health = None
        breakers = 0
        raw_bytes = encoded_bytes = 0.0
        for s in registry.snapshot():
            kind = dict(s.labels).get("kind", "")
            if s.family == "ops" and kind == "exchange.pipeline.drain":
                if s.name == "used_rows_total":
                    used = s.value
                elif s.name == "padded_rows_total":
                    padded = s.value
                elif s.name == "total_ns_total":
                    drain_ns = s.value
            elif s.family == "ops" and kind == "exchange.pipeline.submit":
                if s.name == "total_ns_total":
                    submit_ns = s.value
            elif s.family == "wire":
                if s.name == "rx_stall_p99_ns":
                    rx_stall = max(rx_stall, int(s.value))
                elif s.name == "credit_stall_ns":
                    credit_stall = max(credit_stall, int(s.value))
                elif s.name == "peer_health":
                    health = s.value if health is None else min(health, s.value)
                elif s.name == "breaker_open":
                    breakers += int(s.value)
            elif s.family == "compress":
                if s.name in ("raw_bytes", "tx_raw_bytes"):
                    raw_bytes += s.value
                elif s.name in ("encoded_bytes", "tx_encoded_bytes"):
                    encoded_bytes += s.value
        if used + padded > 0:
            padding = padded / (used + padded)
        if submit_ns > 0:
            drain_occ = drain_ns / submit_ns
        return cls(
            padding_fraction=padding if padding is not None else 0.0,
            drain_occupancy=drain_occ if drain_occ is not None else 0.0,
            rx_stall_p99_ns=rx_stall,
            credit_stall_ns=credit_stall,
            worst_peer_health=health if health is not None else 1.0,
            breakers_open=breakers,
            compression_ratio=raw_bytes / encoded_bytes if encoded_bytes > 0 else 1.0,
        )

    def describe(self) -> dict:
        """JSON-safe flat view for the ``exchange.plan`` trace event."""
        return {
            "padding_fraction": round(self.padding_fraction, 4),
            "drain_occupancy": round(self.drain_occupancy, 4),
            "rx_stall_p99_ns": int(self.rx_stall_p99_ns),
            "credit_stall_ns": int(self.credit_stall_ns),
            "worst_peer_health": round(self.worst_peer_health, 4),
            "breakers_open": int(self.breakers_open),
            "compression_ratio": round(self.compression_ratio, 4),
        }


@dataclass(frozen=True)
class PlanContext:
    """What a planner sees about one shuffle, all host ints — the same
    metadata-before-data discipline as the seal itself.  In the SPMD
    deployment every field except ``signals`` is derived from all-gathered
    quantities, so every process constructs an identical context and hence an
    identical collective schedule."""

    num_executors: int
    #: rows per peer slot as sealed (send_rows // n)
    staging_slot_rows: int
    #: per staging round, the cluster-wide hottest (sender, dest) lane rows
    round_max_rows: Tuple[int, ...]
    #: total used rows across all executors/rounds/lanes (0 = unknown)
    used_rows_total: int = 0
    row_bytes: int = 128
    platform: str = "cpu"
    #: the shuffle carries a partial grouped aggregation (an ``AggregateSpec``
    #: with ``partial=True``) — the only traffic whose landed rows are
    #: combinable inside the exchange.  Static spec geometry, identical on
    #: every SPMD process by construction.
    agg_partial: bool = False
    #: dense key-domain size (groups) when the aggregation keys are
    #: dense-representable, else 0 (forces the sorted fallback)
    agg_groups: int = 0
    #: aggregate payload lanes (value columns; key/count lanes excluded)
    agg_width: int = 0
    #: bytes per aggregate value-lane element
    agg_itemsize: int = 4
    #: local telemetry — serve-plane decisions only (see module docstring)
    signals: PlanSignals = PlanSignals()

    @property
    def num_rounds(self) -> int:
        return len(self.round_max_rows)

    @property
    def recv_staging_bytes(self) -> int:
        """Bytes one receiver's sender-major grid stages per sub-round — what
        the dense combine accumulator must undercut to be worth fusing."""
        return self.num_executors * self.staging_slot_rows * self.row_bytes

    @property
    def combine_acc_bytes(self) -> int:
        """Bytes of the dense per-group accumulator (``agg_width`` value
        lanes plus one int32 count lane per group)."""
        return self.agg_groups * (self.agg_width * self.agg_itemsize + 4)

    def predicted_padding(self, slot_rows: int) -> float:
        """Padding fraction the single-shot plan would stage at ``slot_rows``
        per peer slot — derivable before any exchange runs (the adaptive
        quota decision must not depend on per-host telemetry; see the SPMD
        lockstep note in the module docstring)."""
        staged = self.num_executors * self.num_executors * slot_rows * max(
            self.num_rounds, 1
        )
        if staged <= 0 or self.used_rows_total <= 0:
            return 0.0
        return max(0.0, 1.0 - self.used_rows_total / staged)

    @property
    def mean_lane_rows(self) -> float:
        """Mean used rows per (sender, dest) lane across the shuffle."""
        lanes = self.num_executors * self.num_executors * max(self.num_rounds, 1)
        return self.used_rows_total / lanes if lanes else 0.0


def _combine_tier(conf, ctx: PlanContext, *, dense_only: bool = False) -> str:
    """The ``combine`` plan field: receive-side compute-in-exchange tier.

    Derived from conf plus all-gathered spec geometry ONLY (``agg_*`` fields
    are static properties of the cluster-wide ``AggregateSpec``), so every
    SPMD process lands on the same tier — the fused combine changes the
    collective's output shape, which must agree in lockstep.  ``dense`` needs
    a dense-representable key domain whose accumulator undercuts the recv
    staging it replaces; otherwise the static planner honors the knob with
    the bounded ``sorted`` fallback while the adaptive planner
    (``dense_only=True``) declines — fusing without the O(groups) memory win
    is pure dispatch-tax speculation it cannot justify from geometry."""
    if not (getattr(conf, "exchange_fused_combine", False) and ctx.agg_partial):
        return "off"
    if ctx.agg_groups > 0 and ctx.combine_acc_bytes < ctx.recv_staging_bytes:
        return "dense"
    return "off" if dense_only else "sorted"


# ----------------------------------------------------------------------
# plan-optimization passes (pure plan -> plan; geometry only, never bytes)


def pass_pow2_bucket(plan: ExchangePlan, ctx: PlanContext) -> ExchangePlan:
    """Pow2-bucket the slot: ``plan_exchange`` output is already a fixed
    point, so this is the safety net for hand-built plans — a non-pow2 slot
    would fragment the compile cache (the bucketing discipline the
    cache-hygiene analyzer pass enforces on the transports)."""
    bucket = _pow2_ceil(max(1, plan.slot_rows))
    if bucket == plan.slot_rows:
        return plan
    chunks = tuple(
        max(1, -(-int(m) // bucket)) for m in _round_needs(plan)
    )
    return dataclasses.replace(plan, slot_rows=bucket, chunks_per_round=chunks)


def _round_needs(plan: ExchangePlan) -> Tuple[int, ...]:
    """Per-round row need implied by the plan itself (chunks x slot) — an
    upper bound on the true round max, used when re-bucketing a plan whose
    context is unknown."""
    return tuple(c * plan.slot_rows for c in plan.chunks_per_round)


def pass_coalesce_chunks(plan: ExchangePlan, ctx: PlanContext) -> ExchangePlan:
    """Chunk coalescing: repeatedly double the slot while the total staged
    rows do not grow — e.g. 2 chunks of q collapse into 1 chunk of 2q (same
    wire bytes, half the collective launches and their dispatch overhead).
    Rounds with odd chunk counts keep the smaller slot (3 chunks of q would
    become 2 of 2q = more padding), because ``staged_rows`` would grow.
    Single-shot plans are already one launch per round — left untouched."""
    if plan.single_shot or not plan.chunks_per_round:
        return plan
    ceiling = quota_slot_rows(max(ctx.staging_slot_rows, 1), 0)
    best = plan
    while best.slot_rows < ceiling:
        q2 = best.slot_rows * 2
        chunks2 = tuple(
            max(1, -(-int(m) // q2)) for m in ctx.round_max_rows
        ) if ctx.round_max_rows else tuple(
            max(1, -(-need // q2)) for need in _round_needs(best)
        )
        cand = dataclasses.replace(best, slot_rows=q2, chunks_per_round=chunks2)
        if cand.staged_rows(ctx.num_executors) > best.staged_rows(ctx.num_executors):
            break
        if cand.num_subrounds >= best.num_subrounds:
            break  # no launch saved either: stop before inflating the bucket
        best = cand
    return best


def pass_reorder_rounds(plan: ExchangePlan, ctx: PlanContext) -> ExchangePlan:
    """Staging-footprint sub-round reordering (arXiv:2112.01075): submit
    staging rounds in ascending footprint (chunk count, then round index for
    stability), so the depth-d pipeline window co-resides the small rounds'
    buffers first and the peak transient footprint is set by one heavy round
    instead of several adjacent ones.  Results are re-emitted in natural
    round order by the executor, so consumers never observe the permutation."""
    nrounds = len(plan.chunks_per_round)
    if nrounds <= 1:
        return plan
    order = tuple(
        sorted(range(nrounds), key=lambda r: (plan.chunks_per_round[r], r))
    )
    if order == tuple(range(nrounds)):
        return plan
    return dataclasses.replace(plan, round_order=order)


DEFAULT_PASSES: Tuple[Callable[[ExchangePlan, PlanContext], ExchangePlan], ...] = (
    pass_pow2_bucket,
    pass_coalesce_chunks,
    pass_reorder_rounds,
)


def optimize_plan(
    plan: ExchangePlan,
    ctx: PlanContext,
    passes: Optional[Sequence[Callable]] = None,
) -> ExchangePlan:
    """Run the optimization pipeline over a plan.  Every pass preserves
    coverage (each round's chunks x slot still covers its hottest lane) and
    therefore bytes; only schedule geometry changes."""
    for p in DEFAULT_PASSES if passes is None else passes:
        plan = p(plan, ctx)
    return plan


# ----------------------------------------------------------------------
# planners


class StaticPlanner:
    """Legacy conf knobs -> plan, 1:1.

    ``slot_quota_rows == 0`` maps to the single-shot plan (the pow2 slot
    bucket, one chunk per round, whole padded shards retained — including
    donation of device-sealed payloads and elastic degraded recovery);
    ``> 0`` maps to ``plan_exchange``'s chunked schedule (tight spliced
    shards, exactly the retired quota engine).  Every other plan field copies
    its conf knob verbatim, so existing configs produce byte-identical
    exchanges and wire frames through the unified executor
    (tests/test_torch_planner.py holds the port to the JAX planner)."""

    def __init__(self, conf) -> None:
        self.conf = conf

    def plan(self, ctx: PlanContext) -> ExchangePlan:
        conf = self.conf
        if conf.slot_quota_rows > 0:
            base = plan_exchange(
                ctx.round_max_rows, ctx.staging_slot_rows, conf.slot_quota_rows
            )
            plan = dataclasses.replace(base, single_shot=False)
        else:
            plan = ExchangePlan(
                slot_rows=quota_slot_rows(max(ctx.staging_slot_rows, 1), 0),
                chunks_per_round=(1,) * max(ctx.num_rounds, 1),
                single_shot=True,
            )
        plan = dataclasses.replace(
            plan,
            lowering=conf.exchange_impl,
            pipeline_depth=max(1, int(conf.pipeline_depth)),
            streams=conf.wire_streams,
            codec=conf.wire_compress_codec,
            quantize_mode=conf.quantize_mode,
            quantize_block=conf.quantize_block_size,
            hedge_ms=conf.fetch_hedge_ms,
            combine=_combine_tier(conf, ctx),
        )
        if getattr(conf, "planner_optimize", False):
            plan = optimize_plan(plan, ctx)
        return plan


class AdaptivePlanner:
    """Telemetry-fed planner: per shuffle per epoch, pick the schedule from
    what the obs plane measured instead of static knobs.

    Decisions (all deterministic; thresholds are the ``planner.*`` knobs):

    * quota/chunking — when no static quota is forced and the single-shot
      plan's PREDICTED padding (from the sealed size matrices — agreed
      cluster-wide, never local telemetry) exceeds
      ``planner_target_padding``, search the pow2 quotas in
      [``planner_min_quota_rows``, slot] for the one minimizing predicted
      staged rows (``sum ceil(max_r / q) * q`` per round — the exact staging
      and dense-wire footprint ``plan_exchange`` will realize), breaking
      ties toward the larger quota (fewer collective launches).  The search
      returning the full slot means chunking cannot shrink the footprint
      (hottest lane already at a pow2 boundary) and the plan stays
      single-shot.
    * combine — keep the receive-side fused combine only when the dense
      accumulator's predicted bytes undercut the recv staging it replaces
      (spec geometry — agreed cluster-wide); never the sorted fallback.
    * hedge delay — with degraded peers (health EWMA < 0.5 or an open
      breaker) and an observed stall tail, hedge at ~2x the p99 stall,
      clamped to [conf.fetch_hedge_ms, conf.fetch_hedge_max_ms].
    * codec — drop a configured codec when the observed ratio says the
      encode cost buys < 5% shrink; keep it otherwise.
    * streams — double the stripes (up to 8) when fetch readers spent real
      time blocked on the credit gate.
    * depth — one extra overlap round (up to 4) when the drain lane is the
      bottleneck (occupancy > 1).

    The optimization pipeline always runs on adaptive plans."""

    def __init__(self, conf) -> None:
        self.conf = conf
        self._static = StaticPlanner(conf)

    def plan(self, ctx: PlanContext) -> ExchangePlan:
        conf = self.conf
        sig = ctx.signals
        plan = self._static.plan(ctx)
        # -- collective schedule: derived from agreed geometry only --------
        if conf.slot_quota_rows == 0 and ctx.round_max_rows:
            slot = quota_slot_rows(max(ctx.staging_slot_rows, 1), 0)
            if ctx.predicted_padding(slot) > conf.planner_target_padding:
                # pow2-quota search: minimize predicted staged rows (exactly
                # what plan_exchange will stage: ceil(max/q) chunks of q per
                # round), ties to the LARGER quota — fewer launches for the
                # same footprint.  q == slot reproduces the single-shot
                # footprint, so "search says slot" means chunking can't help.
                def _staged(q: int) -> int:
                    return sum(
                        max(1, -(-int(m) // q)) * q for m in ctx.round_max_rows
                    )

                floor = _pow2_ceil(max(1, conf.planner_min_quota_rows))
                candidates = []
                q = floor
                while q < slot:
                    candidates.append(q)
                    q <<= 1
                candidates.append(slot)
                quota = min(reversed(candidates), key=_staged, default=slot)
                if quota < slot:
                    base = plan_exchange(
                        ctx.round_max_rows, ctx.staging_slot_rows, quota
                    )
                    plan = dataclasses.replace(
                        plan,
                        slot_rows=base.slot_rows,
                        chunks_per_round=base.chunks_per_round,
                        single_shot=False,
                        round_order=(),
                    )
        if plan.combine != "off":
            # adaptive keeps the fusion only when the dense accumulator is a
            # predicted memory win (all-gathered geometry — lockstep-safe);
            # the sorted fallback's dispatch-tax bet is left to the static
            # knob mapping
            plan = dataclasses.replace(
                plan, combine=_combine_tier(conf, ctx, dense_only=True)
            )
        # -- serve plane: local telemetry is safe here ---------------------
        degraded = sig.worst_peer_health < 0.5 or sig.breakers_open > 0
        if degraded and sig.rx_stall_p99_ns > 0:
            hedge = max(conf.fetch_hedge_ms, int(sig.rx_stall_p99_ns * 2 // 1_000_000))
            if conf.fetch_hedge_max_ms:
                hedge = min(hedge, conf.fetch_hedge_max_ms)
            plan = dataclasses.replace(plan, hedge_ms=hedge)
        if plan.codec != "off" and sig.compression_ratio < 1.05:
            plan = dataclasses.replace(plan, codec="off")
        if sig.credit_stall_ns > 1_000_000:
            plan = dataclasses.replace(plan, streams=min(max(plan.streams, 1) * 2, 8))
        if sig.drain_occupancy > 1.0:
            plan = dataclasses.replace(
                plan, pipeline_depth=min(plan.pipeline_depth + 1, 4)
            )
        return optimize_plan(plan, ctx)


def make_planner(conf):
    """The conf-selected planner (``spark.shuffle.tpu.planner.mode``)."""
    if getattr(conf, "planner_mode", "static") == "adaptive":
        return AdaptivePlanner(conf)
    return StaticPlanner(conf)


# ----------------------------------------------------------------------
# Lineage hashing (the JAX package's query/ cross-query shuffle reuse)
#
# The JAX lineage cache (sparkucx_tpu/query/lineage.py) keys a sealed shuffle
# by input fingerprint + canonical plan serialization + the conf tiers that
# affect the exchanged BYTES.  The helpers live here because this module owns
# the plan vocabulary: which ExchangePlan fields shape result bytes and which
# are serve-plane overlap/transport tuning.


def canonical_plan(plan: ExchangePlan, fields: Optional[Sequence[str]] = None) -> str:
    """Deterministic serialization of a plan (sorted keys, no whitespace).

    ``fields`` restricts the view — the lineage cache passes the
    byte-affecting field set so two plans differing only in serve-plane
    tuning (hedge delay, stripe width, overlap depth) canonicalize
    identically, while any collective-schedule or lossy-tier difference
    yields distinct bytes."""
    import json

    d = plan.describe()
    if fields is not None:
        keep = set(fields)
        d = {k: v for k, v in d.items() if k in keep}
    return json.dumps(d, sort_keys=True, separators=(",", ":"))


def lineage_hash(*parts: str) -> str:
    """SHA-256 over length-prefixed parts — the lineage key combinator.

    Length-prefixing keeps the encoding injective (``("ab", "c")`` and
    ``("a", "bc")`` hash differently), so dag canonicalizations, input
    fingerprints, and conf signatures can be folded in any fixed order
    without delimiter collisions."""
    import hashlib

    h = hashlib.sha256()
    for part in parts:
        data = part.encode()
        h.update(str(len(data)).encode())
        h.update(b":")
        h.update(data)
    return h.hexdigest()
