"""Link/route health state for wrapped collectives.

The port of ``tpu_resiliency/parallel/health.py``.  Tracks per-(op, axis)
outcome history so the degrade policy can start at the right rung instead
of re-walking the ladder from the top every call:

- a route that just timed out N times in a row has a *suspect* link — the
  next call should not burn N more deadlines re-proving it;
- a route that recovered through a lower rung starts there next time.

Consuming the at-abort degrade verdict of the attribution engine comes
with the in-process slice.

State is process-local and advisory: it biases the ladder's starting rung;
it never skips the final fail-fast raise when every rung is exhausted.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Optional, Tuple

from ..telemetry import gauge

# consecutive deadline trips after which a route is suspect (the next call
# skips the retry rung: re-trying a known-bad link burns whole deadlines)
SUSPECT_AFTER = 2

_EWMA_ALPHA = 0.2

# the RankRiskModel's route component: worst consecutive-trip pressure
# across this process's routes, normalized so a route reaching suspect is
# 0.5 and saturation needs sustained tripping past it
_SUSPECT_BIAS = gauge(
    "tpurx_route_suspect_bias",
    "Worst consecutive-timeout pressure across this rank's collective "
    "routes, 0-1 (0.5 = a route just crossed the suspect threshold)",
)


@dataclasses.dataclass
class RouteState:
    op: str
    axis: str = ""
    ewma_latency_ns: float = 0.0
    ok_count: int = 0
    timeout_count: int = 0
    consecutive_timeouts: int = 0
    degrade_count: int = 0
    last_action: str = ""
    # rung the next call should start at ("" = ladder top); set by verdict
    # consumption or by consecutive-timeout escalation
    start_rung: str = ""
    start_rung_reason: str = ""

    @property
    def suspect(self) -> bool:
        return self.consecutive_timeouts >= SUSPECT_AFTER or bool(self.start_rung)


class RouteHealth:
    """Registry of per-(op, axis) route states."""

    def __init__(self):
        self._lock = threading.Lock()
        self._routes: Dict[Tuple[str, str], RouteState] = {}

    def route(self, op: str, axis: str = "") -> RouteState:
        with self._lock:
            key = (op, axis)
            st = self._routes.get(key)
            if st is None:
                st = self._routes[key] = RouteState(op=op, axis=axis)
            return st

    def _bias_locked(self) -> float:
        worst = max(
            (st.consecutive_timeouts for st in self._routes.values()),
            default=0,
        )
        return min(1.0, worst / float(2 * SUSPECT_AFTER))

    def note_ok(self, op: str, axis: str, latency_ns: int) -> None:
        st = self.route(op, axis)
        with self._lock:
            st.ok_count += 1
            st.consecutive_timeouts = 0
            if st.ewma_latency_ns <= 0:
                st.ewma_latency_ns = float(latency_ns)
            else:
                st.ewma_latency_ns += _EWMA_ALPHA * (
                    latency_ns - st.ewma_latency_ns
                )
            bias = self._bias_locked()
        _SUSPECT_BIAS.set(bias)

    def note_timeout(self, op: str, axis: str) -> None:
        st = self.route(op, axis)
        with self._lock:
            st.timeout_count += 1
            st.consecutive_timeouts += 1
            bias = self._bias_locked()
        _SUSPECT_BIAS.set(bias)

    def note_degrade(self, op: str, axis: str, action: str) -> None:
        st = self.route(op, axis)
        with self._lock:
            st.degrade_count += 1
            st.last_action = action

    def note_recovered(self, op: str, axis: str, action: str) -> None:
        """A degrade rung completed the op: the route is serviceable via
        ``action`` — remember it as the starting rung so the next call does
        not re-walk the dead rungs above it."""
        st = self.route(op, axis)
        with self._lock:
            st.consecutive_timeouts = 0
            st.last_action = action
            if action not in ("", "retry"):
                st.start_rung = action
                st.start_rung_reason = "recovered via this rung"
            bias = self._bias_locked()
        _SUSPECT_BIAS.set(bias)

    def start_rung(self, op: str, axis: str = "") -> str:
        """Rung the ladder should start at for this route ('' = top)."""
        st = self.route(op, axis)
        with self._lock:
            if st.start_rung:
                return st.start_rung
            if st.consecutive_timeouts >= SUSPECT_AFTER:
                return "relayout"
            return ""


_health: Optional[RouteHealth] = None
_health_lock = threading.Lock()


def health() -> RouteHealth:
    global _health
    with _health_lock:
        if _health is None:
            _health = RouteHealth()
        return _health


def _reset_health_for_tests() -> None:
    global _health
    with _health_lock:
        _health = None
    _SUSPECT_BIAS.set(0.0)
