"""Pipelined multi-round superstep engine — overlap staging, exchange and drain.

Port of ``sparkucx_tpu/transport/pipeline.py`` (``CreditGate`` and
``RoundPipeline``, verbatim).  A shuffle that spills or is chunked runs one
exchange per sub-round.  While sub-round k's kernels run on the card, sub-round
k+1 is assembled and queued, and sub-round k-1's received shards drain on a
background worker.

The engine is transport-agnostic: callers hand it two callbacks,

* ``submit(round) -> ticket`` — assemble the round's payload, queue its
  kernels and the asynchronous device-to-host copies, record a CUDA event on
  the submitting thread's stream behind them, and return what the drain
  needs.  Runs on the caller's thread, in round order.
* ``drain(round, ticket) -> result`` — complete the round host-side: wait on
  the ticket's event (``torch.cuda.Event.synchronize``), then read the
  page-locked host copies, write spill memmaps, keep device shards.  Runs on
  the drain worker for ``depth > 1``; inline for ``depth == 1``.  The worker
  thread's current CUDA stream is not the submitter's, so a drain launches
  nothing on the card: it only waits on events recorded where the work was
  queued.

``run(num_rounds)`` returns the drain results in round order.  ``depth``
bounds the in-flight window: at most ``depth`` rounds are submitted whose
drains have not completed.  ``depth == 1`` is the serial engine: submit then
drain inline, one round at a time.

Failure contract: exceptions from either callback propagate out of ``run()``
(submit errors first, then the earliest-round drain error).

Observability: every stage is wrapped in a ``utils.trace`` span
(``<name>.submit`` / ``<name>.drain``, tagged with the round and depth) and,
when a ``StatsAggregator`` is given, recorded as an operation of the same kind.

Thread-safety: every field is assigned once in ``__init__`` and cross-thread
state flows only through ``Future`` results and the internally-locked
``StatsAggregator``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, List, Optional, Tuple

from sparkucx_tpu_torch.core.operation import OperationStats
from sparkucx_tpu_torch.utils.stats import StatsAggregator
from sparkucx_tpu_torch.utils.trace import span


class CreditGate:
    """Byte-budget flow control shared by the fetch reader and the pipeline.

    ``acquire(n)`` blocks until ``used + n <= budget`` — except that a request
    larger than the whole budget is admitted *alone* (when nothing else is in
    flight), so one oversized round can never deadlock the gate.  ``release``
    returns credits and wakes waiters.  The gate never lets concurrent
    admissions exceed the budget (modulo the documented oversized-alone case)
    and drains back to zero when all holders release.
    """

    def __init__(self, budget: int) -> None:
        if budget <= 0:
            raise ValueError(f"credit budget must be positive, got {budget}")
        self.budget = budget
        self._lock = threading.Condition()
        self._used = 0  #: guarded by self._lock
        self._stall_ns = 0  #: guarded by self._lock (time spent waiting for credit)

    def acquire(self, nbytes: int, timeout: Optional[float] = None) -> bool:
        nbytes = max(0, int(nbytes))
        t0 = time.monotonic_ns()
        with self._lock:
            ok = self._lock.wait_for(
                lambda: self._used + nbytes <= self.budget or self._used == 0,
                timeout=timeout,
            )
            if not ok:
                return False
            self._used += nbytes
            self._stall_ns += time.monotonic_ns() - t0
        return True

    def try_acquire(self, nbytes: int) -> bool:
        nbytes = max(0, int(nbytes))
        with self._lock:
            if self._used + nbytes <= self.budget or self._used == 0:
                self._used += nbytes
                return True
            return False

    def release(self, nbytes: int) -> None:
        nbytes = max(0, int(nbytes))
        with self._lock:
            self._used = max(0, self._used - nbytes)
            self._lock.notify_all()

    @property
    def used(self) -> int:
        with self._lock:
            return self._used

    @property
    def stall_ns(self) -> int:
        with self._lock:
            return self._stall_ns


class RoundPipeline:
    """Run ``num_rounds`` submit/drain pairs with up to ``depth`` in flight."""

    def __init__(
        self,
        depth: int,
        submit: Callable[[int], Any],
        drain: Callable[[int, Any], Any],
        *,
        name: str = "pipeline",
        stats: Optional[StatsAggregator] = None,
        result_bytes: Optional[Callable[[Any], int]] = None,
        result_rows: Optional[Callable[[Any], Tuple[int, int]]] = None,
        credits: Optional[CreditGate] = None,
        round_bytes: Optional[Callable[[int], int]] = None,
        interrupt: Optional[Callable[[], Optional[BaseException]]] = None,
    ) -> None:
        if depth < 1:
            raise ValueError(f"pipeline depth must be >= 1, got {depth}")
        if credits is not None and round_bytes is None:
            raise ValueError("credits requires round_bytes to cost each round")
        self.depth = depth
        self._submit_cb = submit
        self._drain_cb = drain
        self.name = name
        self.stats = stats
        self._result_bytes = result_bytes
        # result_rows(result) -> (used_rows, padded_rows): staging occupancy
        # of the round, surfaced as the drain span's padding telemetry
        self._result_rows = result_rows
        # Optional byte-budget gate shared with the wire path: round k's
        # submit blocks until its round_bytes(k) fit the budget alongside the
        # rounds already in flight; the credits return when the round drains
        # (or its stage raises).  Composes with the depth window — depth
        # bounds rounds, credits bound bytes, whichever is tighter wins.
        self._credits = credits
        self._round_bytes = round_bytes
        # Optional abort probe, polled before every submit (both engines): a
        # non-None return aborts the run by raising it there, so the pipeline
        # stops launching rounds whose plan went stale (elastic recovery uses
        # this to stop on a membership-epoch change).  Rounds already
        # submitted still drain — their credits/resources settle normally.
        self._interrupt = interrupt

    # -- instrumented stage wrappers --------------------------------------

    def _submit(self, rnd: int) -> Any:
        if self._interrupt is not None:
            exc = self._interrupt()
            if exc is not None:
                raise exc
        if self._credits is not None:
            self._credits.acquire(self._round_bytes(rnd))
        op = OperationStats()
        try:
            with span(f"{self.name}.submit", round=rnd, depth=self.depth):
                ticket = self._submit_cb(rnd)
        except BaseException:
            if self._credits is not None:  # round never reaches drain
                self._credits.release(self._round_bytes(rnd))
            raise
        op.mark_done()
        if self.stats is not None:
            self.stats.record(f"{self.name}.submit", op)
        return ticket

    def _drain(self, rnd: int, ticket: Any) -> Any:
        op = OperationStats()
        try:
            with span(f"{self.name}.drain", round=rnd, depth=self.depth):
                result = self._drain_cb(rnd, ticket)
        finally:
            if self._credits is not None:
                self._credits.release(self._round_bytes(rnd))
        op.mark_done(
            recv_size=self._result_bytes(result) if self._result_bytes else 0
        )
        if self.stats is not None:
            used, padded = (
                self._result_rows(result) if self._result_rows else (0, 0)
            )
            self.stats.record(
                f"{self.name}.drain", op, used_rows=used, padded_rows=padded
            )
        return result

    # -- the engine --------------------------------------------------------

    def run(self, num_rounds: int) -> List[Any]:
        if num_rounds < 0:
            raise ValueError(f"num_rounds must be >= 0, got {num_rounds}")
        depth = min(self.depth, max(num_rounds, 1))
        if depth <= 1:
            # Serial engine: identical op order to the historical loop (and
            # the reference both pipeline depths must be bit-identical to).
            return [self._drain(rnd, self._submit(rnd)) for rnd in range(num_rounds)]
        return self._run_pipelined(num_rounds, depth)

    def _run_pipelined(self, num_rounds: int, depth: int) -> List[Any]:
        results: List[Any] = [None] * num_rounds
        inflight: deque = deque()  # (round, ticket) submitted, drain not queued
        futures: List = []         # (round, Future) in round order
        submit_exc: Optional[BaseException] = None
        pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix=f"{self.name}-drain")
        try:
            for rnd in range(num_rounds):
                # Backpressure: round k submits only once round k-depth has
                # fully drained, so host+device memory stays bounded by the
                # ring of `depth` rounds, not by the round count.  (During the
                # loop futures[i] is exactly round i — rounds are handed to the
                # worker in order.  result() is cached, so re-collecting below
                # is free; a drain error here aborts further submission.)
                if rnd >= depth:
                    futures[rnd - depth][1].result()
                inflight.append((rnd, self._submit(rnd)))
                if len(inflight) >= depth:
                    r0, t0 = inflight.popleft()
                    futures.append((r0, pool.submit(self._drain, r0, t0)))
        except BaseException as e:  # noqa: BLE001 — re-raised below
            submit_exc = e
        if submit_exc is None:
            while inflight:
                r0, t0 = inflight.popleft()
                futures.append((r0, pool.submit(self._drain, r0, t0)))
        pool.shutdown(wait=True)
        exc = submit_exc
        for r0, fut in futures:
            try:
                results[r0] = fut.result()
            except BaseException as e:  # noqa: BLE001
                if exc is None:
                    exc = e  # earliest round's failure wins, like the serial loop
        if exc is not None:
            raise exc
        return results
