"""The plan executor — one engine interprets every ``ExchangePlan``.

Port of ``sparkucx_tpu/transport/executor.py``.  A planner (ops/planner.py)
chooses the schedule, and :func:`execute_plan` interprets it: the sub-round
submission order (including the staging-footprint permutation, re-emitting
results in natural round order), the per-round chunk accumulation on the
single drain worker, the ``RoundPipeline`` wiring, and the occupancy/bytes
telemetry (intermediate chunks record zero rows; a round's final chunk
records the round's staging occupancy).

The transport owns everything deployment-shaped and passes it in as
closures: how a sub-round's payload is assembled and dispatched, how a chunk
is materialized host-side, and how a finished round's chunks splice into the
receive state.

``build_plan_exchange`` is the lowering dispatch for one plan's geometry.
Its flat builders take the executors' ``devices`` where the JAX builders
take a mesh; the hierarchical route is not ported yet.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from sparkucx_tpu_torch.ops.exchange import ExchangeSpec, build_exchange
from sparkucx_tpu_torch.ops.ici_exchange import (
    DEFAULT_CHUNKS_PER_DEST,
    build_combine_exchange,
    build_ici_exchange,
    build_quantized_exchange,
)
from sparkucx_tpu_torch.ops.skew import ExchangePlan
from sparkucx_tpu_torch.transport.pipeline import RoundPipeline
from sparkucx_tpu_torch.utils.stats import StatsAggregator

#: every receive mode any deployment understands, in doc order
HOST_RECV_MODES: Tuple[str, ...] = ("array", "memmap", "device")


def validate_host_recv_mode(
    mode: str,
    *,
    allowed: Sequence[str] = HOST_RECV_MODES,
    where: str = "this transport",
) -> str:
    """THE ``host_recv_mode`` gate — called before any staging allocation.
    An *unknown* mode is a typo (``ValueError`` naming the full vocabulary);
    a known mode a deployment cannot serve names the deployment and what it
    does support."""
    if mode not in HOST_RECV_MODES:
        raise ValueError(f"unknown host_recv_mode {mode!r} (array|memmap|device)")
    if mode not in allowed:
        raise ValueError(
            f"host_recv_mode {mode!r} is not supported by {where} "
            f"({'|'.join(allowed)})"
        )
    return mode


def build_plan_exchange(
    devices: Sequence,
    *,
    num_executors: int,
    send_rows: int,
    lane: int,
    impl: str,
    num_slices: int = 1,
    quantize=None,
    combine=None,
    recv_rows: Optional[int] = None,
):
    """THE lowering dispatch: one exchange for a plan's geometry.

    ``impl`` is the *resolved* tier (``resolve_exchange_impl`` over the
    plan's ``lowering`` field): ``'stock'`` is ``build_exchange`` and
    ``'pallas'`` the scheduled ring ``build_ici_exchange`` (K3, then K1
    compaction); a ``QuantizeSpec`` routes to the lossy
    ``build_quantized_exchange`` (quantize, K3, K1, dequantize) and a
    ``CombineSpec`` to the receive-side fused-combine exchange
    ``build_combine_exchange`` (K4).  The receive side holds
    ``recv_rows`` rows per receiver, by default the worst case, every region
    full (``recv_rows = send_rows``).  Callers keep their own caches; this
    function is the one place a key miss turns into a lowering."""
    spec = ExchangeSpec(
        num_executors=num_executors,
        send_rows=send_rows,
        recv_rows=send_rows if recv_rows is None else recv_rows,
        lane=lane,
    )
    if combine is not None:
        # the fused combine is inherently the scheduled ring (the fold rides
        # the superstep); flat executors only
        return build_combine_exchange(
            devices, spec, combine, chunks_per_dest=DEFAULT_CHUNKS_PER_DEST
        )
    if quantize is not None:
        # the quantized exchange is inherently the scheduled ring; ``impl``
        # (stock|pallas) does not choose among its routes
        return build_quantized_exchange(devices, spec, quantize)
    if num_slices > 1:
        raise NotImplementedError(
            "the two-phase multi-slice exchange is not ported yet (ROADMAP queue A "
            "item 4: ops/hierarchy.py)"
        )
    if impl == "pallas":
        return build_ici_exchange(devices, spec, chunks_per_dest=DEFAULT_CHUNKS_PER_DEST)
    return build_exchange(devices, spec)


def execute_plan(
    plan: ExchangePlan,
    *,
    submit: Callable[[int, int, int], Any],
    drain_chunk: Callable[[int, int, int, Any], Any],
    finish_round: Callable[[int, int, List[Any]], Any],
    result_bytes: Callable[[Any], int],
    occupancy: Callable[[Any], Tuple[int, int]],
    stats: Optional[StatsAggregator] = None,
    name: str = "exchange.pipeline",
    interrupt: Optional[Callable[[], Optional[BaseException]]] = None,
) -> List[Any]:
    """Interpret one plan: submit every sub-round through the depth-bounded
    ``RoundPipeline``, accumulate each staging round's drained chunks, and
    return one ``finish_round`` result per staging round in NATURAL round
    order (whatever ``plan.round_order`` the optimizer chose — the
    permutation is a submission-side schedule, never an observable layout).

    * ``submit(rnd, chunk, nchunks)`` — assemble + dispatch one sub-round's
      exchange, return the drain ticket.  Runs on the caller's thread in
      plan order; poll your abort conditions here (or pass ``interrupt``).
    * ``drain_chunk(rnd, chunk, nchunks, ticket)`` — materialize one
      sub-round host-side; the returned part is queued for its round.
    * ``finish_round(rnd, nchunks, parts)`` — splice a round's parts (chunk
      order) into the round result the transport's receive state keeps.

    Telemetry contract: every sub-round is one ``<name>.submit``/
    ``<name>.drain`` op pair; a drain that completes a round records
    ``occupancy(result)`` rows and ``result_bytes(result)``, an
    intermediate chunk records zeros."""
    subs = plan.ordered_subrounds()
    # a round's drained parts so far, chunk order: appended and consumed ONLY
    # by the pipeline's single in-order drain worker, so no lock is needed
    pending: Dict[int, List[Any]] = {}

    def _submit(i: int):
        rnd, chunk, nchunks = subs[i]
        return submit(rnd, chunk, nchunks)

    def _drain(i: int, ticket):
        rnd, chunk, nchunks = subs[i]
        parts = pending.setdefault(rnd, [])
        parts.append(drain_chunk(rnd, chunk, nchunks, ticket))
        if len(parts) < nchunks:
            return None
        del pending[rnd]
        return rnd, finish_round(rnd, nchunks, parts)

    pipe = RoundPipeline(
        max(1, int(plan.pipeline_depth)),
        _submit,
        _drain,
        name=name,
        stats=stats,
        result_bytes=lambda r: 0 if r is None else int(result_bytes(r[1])),
        result_rows=lambda r: (0, 0) if r is None else occupancy(r[1]),
        interrupt=interrupt,
    )
    done = [r for r in pipe.run(len(subs)) if r is not None]
    done.sort(key=lambda t: t[0])
    return [result for _, result in done]
