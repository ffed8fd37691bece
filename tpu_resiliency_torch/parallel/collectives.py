"""Self-healing collectives: the resiliency layer's wrapped collective API.

The port of ``tpu_resiliency/parallel/collectives.py``.  Every
resiliency-layer collective (the fused quorum readback in
``ops/quorum.py``, the timeout-stats max reduce) runs through
:class:`ResilientCollective`, which makes the op itself the resiliency
boundary:

1. **deadline** — the op executes on a :class:`~.deadline.DeadlineLane`
   whose event-mode :class:`~tpu_resiliency_torch.ops.quorum.StampTripwire`
   watches the budget; exceeding it raises a typed
   :class:`~.deadline.CollectiveTimeout` naming the op and implicated mesh
   axis instead of wedging the host thread;
2. **telemetry** — per-op latency keyed by the DispatchTail program
   identity (``record_dispatch`` stamps every wrapped op):
   ``tpurx_collective_latency_ns{op,axis}``,
   ``tpurx_collective_timeouts_total{op}``,
   ``tpurx_collective_degrades_total{op,action}``;
3. **degrade** — an ordered policy ladder (``parallel/degrade.py``):
   bounded retry → re-layout onto a fallback lane → targeted mesh-shrink.

:func:`instrument_dispatch` / :func:`observe_latency_ns` are the single
instrumentation choke point.  The ring-shift builder
(``build_shift_permute``) comes with the checkpoint-replication slice.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.distributed as dist

from ..inprocess.fingerprint import record_dispatch
from ..telemetry import counter, flight, histogram
from ..utils import env
from ..utils.logging import get_logger
from ..utils.retry import RetryExhausted
from .deadline import CollectiveTimeout, DeadlineLane, shared_lane
from .distributed import default_device
from .degrade import (
    RELAYOUT,
    RETRY,
    SHRINK,
    DegradePolicy,
    default_relayout,
    trip_shrink,
)
from .health import health

log = get_logger("coll")

# -- telemetry (single declaration site for the collective plane) -----------

_LATENCY_NS = histogram(
    "tpurx_collective_latency_ns",
    "Dispatch-to-settle latency of instrumented collectives, keyed by the "
    "DispatchTail op identity",
    labels=("op", "axis"),
)
_TIMEOUTS = counter(
    "tpurx_collective_timeouts_total",
    "Wrapped collectives that exceeded their deadline budget",
    labels=("op",),
)
_DEGRADES = counter(
    "tpurx_collective_degrades_total",
    "Degrade-ladder rungs taken by wrapped collectives",
    labels=("op", "action"),
)

# flight-recorder events: trace.py pairs dispatch/settle into spans keyed
# on (op, axis)
EV_DISPATCH = flight.declare_event(
    "collective.dispatch", "op", "axis", "deadline_ms", "lane"
)
EV_SETTLE = flight.declare_event("collective.settle", "op", "axis", "status")


# -- instrumentation choke point --------------------------------------------


def instrument_dispatch(op: str) -> int:
    """Stamp ``op`` into the rank's dispatch tail (the at-abort fingerprint
    feed) and return the ns start stamp for :func:`observe_latency_ns` —
    the ONE dispatch-side instrumentation path (straggler's
    ``OpCollector.wrap`` routes through here too)."""
    record_dispatch(op)
    return time.monotonic_ns()


def observe_latency_ns(op: str, elapsed_ns: int, axis: str = "") -> None:
    """Completion-side half of the choke point: one latency histogram,
    op names shared with the fingerprint vocabulary."""
    _LATENCY_NS.labels(op, axis).observe(elapsed_ns)


# -- soak fault arming (link_degrade campaign) ------------------------------

_FAULT_CLASS = "coll_stall"


def _stall_armed() -> bool:
    """``TPURX_FAULT=coll_stall`` (+ rank filter): this rank's *primary*
    collective lane stalls past its deadline — a wedged/degraded link.
    Fallback lanes stay healthy, so the degrade ladder can prove the
    retry → re-layout path end to end (soak class ``link_degrade``)."""
    spec = env.FAULT.get() or ""
    if spec.split(":", 1)[0] != _FAULT_CLASS:
        return False
    ranks = env.FAULT_RANKS.get()
    if ranks:
        rank = env.RANK.get()
        return rank is not None and int(rank) in {
            int(r) for r in str(ranks).split(",") if r.strip()
        }
    return True


# -- the wrapper ------------------------------------------------------------


class ResilientCollective:
    """A deadlined, telemetered, degradable collective.

    ``fn`` is the primary lane (the real collective); ``fallback``, when
    given, is the re-layout lane (reduced/alternate group, or a host/store
    path) the *relayout* and *shrink* rungs switch to.  Without a fallback
    those rungs re-run the primary after the re-layout prep.

    ``deadline_ms``/``retries``/``policy`` default to the env knobs
    (``TPURX_COLL_DEADLINE_MS`` / ``TPURX_COLL_RETRIES`` /
    ``TPURX_COLL_DEGRADE``) read at call time, so a soak can re-arm a
    running process.  ``deadline_ms <= 0`` runs inline: no worker handoff,
    no deadline — the zero-overhead opt-out.
    """

    def __init__(
        self,
        op: str,
        fn: Callable[..., Any],
        *,
        axis: str = "",
        fallback: Optional[Callable[..., Any]] = None,
        deadline_ms: Optional[float] = None,
        retries: Optional[int] = None,
        policy: Optional[DegradePolicy] = None,
        lane: Optional[DeadlineLane] = None,
        relayout: Callable[[], str] = default_relayout,
    ):
        self.op = op
        self.fn = fn
        self.axis = axis
        self.fallback = fallback
        self._deadline_ms = deadline_ms
        self._retries = retries
        self._policy = policy
        self._lane = lane
        self.relayout = relayout

    # -- config reads (call-time so knobs re-arm live processes) -----------

    def budget_ms(self) -> float:
        if self._deadline_ms is not None:
            return self._deadline_ms
        return float(env.COLL_DEADLINE_MS.get())

    def policy(self) -> DegradePolicy:
        pol = self._policy or DegradePolicy.from_env()
        if self._retries is not None:
            pol = DegradePolicy(rungs=pol.rungs, retries=self._retries)
        return pol

    def lane(self) -> DeadlineLane:
        return self._lane if self._lane is not None else shared_lane()

    # -- attempt machinery -------------------------------------------------

    def _attempt(self, fn, args, kwargs, budget_ms: float, lane_kind: str):
        t0 = instrument_dispatch(self.op)
        flight.record(EV_DISPATCH, self.op, self.axis, budget_ms, lane_kind)
        stalled = lane_kind == "primary" and _stall_armed()

        def call():
            if stalled:
                # armed link fault: the primary lane wedges past budget
                time.sleep(budget_ms / 1e3 * 2 + 0.1)
            return fn(*args, **kwargs)

        try:
            out = self.lane().run(
                call, op=self.op, axis=self.axis, budget_ms=budget_ms
            )
        except CollectiveTimeout:
            flight.record(EV_SETTLE, self.op, self.axis, "timeout")
            raise
        elapsed = time.monotonic_ns() - t0
        flight.record(EV_SETTLE, self.op, self.axis, "ok")
        observe_latency_ns(self.op, elapsed, self.axis)
        health().note_ok(self.op, self.axis, elapsed)
        return out

    def _note_timeout(self) -> None:
        _TIMEOUTS.labels(self.op).inc()
        health().note_timeout(self.op, self.axis)

    def _degrade_lane(self):
        """(fn, lane_kind) the post-re-layout attempt runs on."""
        if self.fallback is not None:
            return self.fallback, "fallback"
        return self.fn, "primary_relaid"

    # -- the call ----------------------------------------------------------

    def __call__(self, *args, **kwargs):
        budget = self.budget_ms()
        if budget <= 0:
            t0 = instrument_dispatch(self.op)
            flight.record(EV_DISPATCH, self.op, self.axis, 0.0, "inline")
            out = self.fn(*args, **kwargs)
            flight.record(EV_SETTLE, self.op, self.axis, "ok")
            observe_latency_ns(self.op, time.monotonic_ns() - t0, self.axis)
            return out
        pol = self.policy()
        start = health().start_rung(self.op, self.axis)
        last: Optional[CollectiveTimeout] = None
        if not start:
            try:
                return self._attempt(self.fn, args, kwargs, budget, "primary")
            except CollectiveTimeout as exc:
                last = exc
                self._note_timeout()
            rungs = pol.rungs
        else:
            # health bias (consecutive trips, or a consumed at-abort degrade
            # verdict): the primary attempt is known-doomed — start the
            # ladder at the armed rung instead of burning its deadline
            log.warning(
                "collective %s@%s: starting at rung '%s' (route bias)",
                self.op, self.axis or "-", start,
            )
            rungs = pol.rungs_from(start)
        for rung in rungs:
            if rung == RETRY:
                r = pol.retrier(self.op)
                while True:
                    try:
                        r.backoff(last)
                    except RetryExhausted:
                        break
                    try:
                        out = self._attempt(
                            self.fn, args, kwargs, budget, "primary"
                        )
                        health().note_recovered(self.op, self.axis, RETRY)
                        return out
                    except CollectiveTimeout as exc:
                        last = exc
                        self._note_timeout()
            elif rung == RELAYOUT:
                _DEGRADES.labels(self.op, RELAYOUT).inc()
                health().note_degrade(self.op, self.axis, RELAYOUT)
                detail = self.relayout()
                fn2, kind = self._degrade_lane()
                log.warning(
                    "collective degrade: op=%s axis=%s action=relayout "
                    "lane=%s (%s)", self.op, self.axis or "-", kind, detail,
                )
                try:
                    out = self._attempt(fn2, args, kwargs, budget * 2, kind)
                    health().note_recovered(self.op, self.axis, RELAYOUT)
                    return out
                except CollectiveTimeout as exc:
                    last = exc
                    self._note_timeout()
            elif rung == SHRINK:
                _DEGRADES.labels(self.op, SHRINK).inc()
                health().note_degrade(self.op, self.axis, SHRINK)
                detail = trip_shrink(self.op, self.axis)
                fn2, kind = self._degrade_lane()
                log.warning(
                    "collective degrade: op=%s axis=%s action=shrink "
                    "lane=%s (%s)", self.op, self.axis or "-", kind, detail,
                )
                try:
                    out = self._attempt(fn2, args, kwargs, budget * 2, kind)
                    health().note_recovered(self.op, self.axis, SHRINK)
                    return out
                except CollectiveTimeout as exc:
                    last = exc
                    self._note_timeout()
        # degrade ladder exhausted: this CollectiveTimeout escapes to the
        # caller — drop the black box while the ring still shows the ladder
        flight.dump("collective_timeout")
        raise last if last is not None else CollectiveTimeout(
            self.op, self.axis, budget
        )


def wrap_collective(fn: Callable[..., Any], op: str, **kw) -> ResilientCollective:
    """Decorator-style construction: ``g = wrap_collective(f, "my_op",
    axis="data")``."""
    return ResilientCollective(op, fn, **kw)


# -- wrapped resiliency-layer collectives -----------------------------------


def _allreduce_max(values: List[float]) -> List[float]:
    x = torch.tensor(values, dtype=torch.float32, device=default_device())
    dist.all_reduce(x, op=dist.ReduceOp.MAX)
    return [float(v) for v in x.cpu()]


_device_max: Optional[ResilientCollective] = None


def device_max_reduce(values: List[float]) -> List[float]:
    """Element-wise max of each process's value vector, via one all-reduce
    MAX over the default process group (NCCL on the card, gloo on the CPU)
    routed through the resilient wrapper.  Must be called by every process
    (collective)."""
    global _device_max
    if _device_max is None:
        _device_max = ResilientCollective(
            "device_max_reduce", _allreduce_max, axis="processes"
        )
    return _device_max(values)


def make_timeouts_reduce_fn():
    """Adapter for a timeouts calculator's ``reduce_fn``: takes/returns the
    {stat_key: value} dict, reducing values on device through the wrapped
    :func:`device_max_reduce` — the call is deadlined and degradable like
    every resiliency-layer collective.

    Keys must match across processes (guaranteed when ranks run the same
    section schedule)."""

    def reduce_fn(vals: Dict[str, float]) -> Dict[str, float]:
        keys = sorted(vals)
        merged = device_max_reduce([vals[k] for k in keys])
        return dict(zip(keys, merged))

    return reduce_fn


def _reset_for_tests() -> None:
    from .deadline import _reset_shared_lane_for_tests
    from .health import _reset_health_for_tests

    global _device_max
    _device_max = None
    _reset_shared_lane_for_tests()
    _reset_health_for_tests()
