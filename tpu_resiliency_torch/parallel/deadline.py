"""Deadline enforcement for host-blocking collectives.

The port of ``tpu_resiliency/parallel/deadline.py``.  A deadline here does
not *stop* the op (an enqueued NCCL collective or a CUDA event wait cannot
be cancelled from Python); it stops the op from wedging the **caller**:

- the wrapped op executes on a reusable worker thread owned by a
  :class:`DeadlineLane`;
- the caller's wait is watched by a
  :class:`~tpu_resiliency_torch.ops.quorum.StampTripwire` in event mode
  parked on the lane's beat event with the op's budget as the wait timeout
  (no polling sleep, staleness observed at wake latency);
- on trip, the caller is released with a typed :class:`CollectiveTimeout`
  naming the op and the implicated mesh axis, and the stuck worker is
  **abandoned** (its eventual result, if any, is discarded).  A fresh
  worker serves the next submission.

Clock contract: op stamps use the sanctioned ns helpers from
``ops/quorum.py`` (``now_stamp_ns``/``stamp_age_ns``/``clamp_future_ns``)
so deadline ages share the wrap-safe epoch of every other liveness stamp.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Optional

from ..ops.quorum import (
    StampTripwire,
    clamp_future_ns,
    now_stamp_ns,
    stamp_age_ns,
)
from ..telemetry import counter
from ..utils.logging import get_logger

log = get_logger("coll.deadline")

_ABANDONED = counter(
    "tpurx_collective_workers_abandoned_total",
    "Deadline-lane worker threads abandoned mid-op (op exceeded budget; "
    "the thread is still blocked inside the collective)",
)


class CollectiveTimeout(RuntimeError):
    """A wrapped collective exceeded its deadline budget.

    Typed so the degrade ladder (``parallel/degrade.py``) can catch exactly
    the deadline trip — not arbitrary op failures — and so logs name the op
    and the implicated mesh axis instead of a bare hang.
    """

    def __init__(self, op: str, axis: str, budget_ms: float,
                 age_ms: Optional[float] = None):
        age = f" (age {age_ms:.1f}ms)" if age_ms is not None else ""
        super().__init__(
            f"collective '{op}' exceeded its {budget_ms:.0f}ms deadline "
            f"on mesh axis '{axis or '?'}'{age}"
        )
        self.op = op
        self.axis = axis
        self.budget_ms = budget_ms
        self.age_ms = age_ms


class _Op:
    """One submitted op: fn + completion slot, first-finisher-wins."""

    __slots__ = ("fn", "op", "axis", "budget_ms", "done", "result",
                 "exc", "timed_out", "_lock")

    def __init__(self, fn: Callable[[], Any], op: str, axis: str,
                 budget_ms: float):
        self.fn = fn
        self.op = op
        self.axis = axis
        self.budget_ms = budget_ms
        self.done = threading.Event()
        self.result: Any = None
        self.exc: Optional[BaseException] = None
        self.timed_out = False
        self._lock = threading.Lock()

    def finish(self, *, result=None, exc=None, timed_out=False) -> bool:
        """Settle the op exactly once; returns False if already settled
        (a trip raced the completion — first wins, the loser's outcome is
        discarded)."""
        with self._lock:
            if self.done.is_set():
                return False
            self.result = result
            self.exc = exc
            self.timed_out = timed_out
            self.done.set()
            return True


class DeadlineLane:
    """Reusable deadlined-execution lane: one worker thread + one tripwire.

    One op runs at a time (callers serialize on the lane lock — collectives
    on one mesh are ordered anyway).  The persistent tripwire's budget
    function reads the in-flight op: ``inf`` while idle (chunked re-arm
    waits, the tripwire's suppressed mode), the op's budget while one is in
    flight.  The worker beats the tripwire event on every completion; a
    missing beat past budget IS the detection.

    Worst-case detection latency is ~2x budget when a submission pulse races
    an in-progress wait (the tripwire re-checks true op age on every wake,
    so a fresh op is never tripped early — lateness only, never spurious).
    """

    def __init__(self, name: str = "coll"):
        self.name = name
        self._lock = threading.Lock()          # one op at a time
        self._state = threading.Lock()         # protects _current/_worker
        self._current: Optional[_Op] = None
        self._start_ns = 0
        self._queue: "threading.Condition" = threading.Condition()
        self._pending: Optional[_Op] = None
        self._worker: Optional[threading.Thread] = None
        self._worker_gen = 0
        self.abandoned = 0
        self._beat = threading.Event()
        self._tripwire = StampTripwire(
            on_stale=self._on_stale,
            budget_ms_fn=self._budget_ms,
            event=self._beat,
            age_ns_fn=self._age_ns,
            name=f"tpurx-coll-deadline-{name}",
        ).start()

    # -- tripwire feeds ----------------------------------------------------

    def _budget_ms(self) -> float:
        with self._state:
            op = self._current
        return op.budget_ms if op is not None else float("inf")

    def _age_ns(self) -> int:
        return clamp_future_ns(stamp_age_ns(now_stamp_ns(), self._start_ns))

    def _on_stale(self, age_ms: float) -> None:
        with self._state:
            op = self._current
            if op is None:
                return
            self._current = None
            # the worker is still blocked inside op.fn: abandon it — the
            # next submit spawns a fresh one (abort-ladder pattern)
            self._worker = None
            self._worker_gen += 1
        self.abandoned += 1
        _ABANDONED.inc()
        log.warning(
            "deadline trip: op=%s axis=%s budget=%.0fms age=%.1fms "
            "(worker abandoned)", op.op, op.axis, op.budget_ms, age_ms,
        )
        op.finish(timed_out=True)

    # -- worker ------------------------------------------------------------

    def _ensure_worker(self) -> None:
        with self._state:
            if self._worker is not None and self._worker.is_alive():
                return
            gen = self._worker_gen
            self._worker = threading.Thread(
                target=self._worker_loop, args=(gen,),
                name=f"tpurx-coll-worker-{self.name}", daemon=True,
            )
            self._worker.start()

    def _worker_loop(self, gen: int) -> None:
        while True:
            with self._queue:
                while self._pending is None:
                    with self._state:
                        if gen != self._worker_gen:
                            return  # abandoned while idle (lane reset)
                    self._queue.wait(timeout=0.5)
                op, self._pending = self._pending, None
            try:
                result = op.fn()
                exc = None
            except BaseException as e:  # noqa: BLE001 — delivered to caller
                result, exc = None, e
            with self._state:
                stale = gen != self._worker_gen
                if not stale and self._current is op:
                    self._current = None
            if stale:
                # this worker was abandoned mid-op: the caller already got
                # CollectiveTimeout; discard the late outcome and exit
                log.info("abandoned worker finished late op=%s", op.op)
                return
            op.finish(result=result, exc=exc)
            self._beat.set()  # wake the tripwire: fresh

    # -- public ------------------------------------------------------------

    def run(self, fn: Callable[[], Any], *, op: str, axis: str = "",
            budget_ms: float) -> Any:
        """Execute ``fn()`` under ``budget_ms``; raise
        :class:`CollectiveTimeout` if it does not settle in time.

        ``budget_ms <= 0`` runs inline (no deadline, no thread handoff) —
        the zero-overhead opt-out.
        """
        if budget_ms <= 0:
            return fn()
        submitted = _Op(fn, op, axis, budget_ms)
        with self._lock:
            self._ensure_worker()
            with self._state:
                self._start_ns = now_stamp_ns()
                self._current = submitted
            with self._queue:
                self._pending = submitted
                self._queue.notify()
            # pulse the beat so a tripwire parked in its idle/re-arm wait
            # re-reads the budget (now finite) for this op
            self._beat.set()
            # the tripwire is the deadline authority; the local timeout is
            # a generous fail-safe should the watcher thread itself die
            settled = submitted.done.wait(timeout=budget_ms / 1e3 * 2 + 5.0)
            if not settled:
                submitted.finish(timed_out=True)
                with self._state:
                    if self._current is submitted:
                        self._current = None
                        self._worker = None
                        self._worker_gen += 1
                self.abandoned += 1
                _ABANDONED.inc()
        if submitted.timed_out:
            raise CollectiveTimeout(op, axis, budget_ms,
                                    age_ms=self._age_ns() / 1e6)
        if submitted.exc is not None:
            raise submitted.exc
        return submitted.result

    def stop(self) -> None:
        self._tripwire.stop()
        with self._state:
            self._worker_gen += 1
            self._worker = None
        with self._queue:
            self._queue.notify_all()


_shared_lane: Optional[DeadlineLane] = None
_shared_lock = threading.Lock()


def shared_lane() -> DeadlineLane:
    """The process-wide default lane (resiliency-layer collectives are tiny
    and ordered; one lane serializes them exactly as the mesh would)."""
    global _shared_lane
    with _shared_lock:
        if _shared_lane is None:
            _shared_lane = DeadlineLane("shared")
        return _shared_lane


def _reset_shared_lane_for_tests() -> None:
    global _shared_lane
    with _shared_lock:
        if _shared_lane is not None:
            _shared_lane.stop()
        _shared_lane = None
