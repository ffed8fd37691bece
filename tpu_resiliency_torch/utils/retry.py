"""Bounded retry/backoff policy — one audited degradation behaviour.

The port's copy of ``tpu_resiliency/utils/retry.py``, cut to what the
collective degrade ladder uses:

- :class:`RetryPolicy` — bounded exponential backoff with full jitter and
  an optional wall-clock deadline.  Immutable; sites share or specialize
  via :meth:`RetryPolicy.with_` (dataclasses.replace).
- :class:`Retrier` — drives one retry *episode* at a call site::

      r = Retrier("coll_op", policy)
      while True:
          try:
              return do_thing()
          except CollectiveTimeout as exc:
              r.backoff(exc)          # sleeps, or raises RetryExhausted

Telemetry (per-site labels, the same series as the JAX package):

- ``tpurx_retry_attempts_total{site}`` — tries entered (first + re-tries);
- ``tpurx_retry_backoffs_total{site}`` — failures that slept and retried;
- ``tpurx_retry_exhausted_total{site}`` — episodes that gave up.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Callable, Optional

from ..telemetry import counter
_ATTEMPTS = counter(
    "tpurx_retry_attempts_total",
    "Attempts entered at a retrying call site",
    labels=("site",),
)
_BACKOFFS = counter(
    "tpurx_retry_backoffs_total",
    "Failures that backed off and retried",
    labels=("site",),
)
_EXHAUSTED = counter(
    "tpurx_retry_exhausted_total",
    "Retry episodes that gave up (attempts or deadline exhausted)",
    labels=("site",),
)


class RetryExhausted(RuntimeError):
    """Raised by :meth:`Retrier.backoff` when the policy's attempt or
    deadline budget is spent.  ``__cause__`` chains the last failure."""

    def __init__(self, site: str, attempts: int, elapsed: float,
                 last_exc: Optional[BaseException]):
        super().__init__(
            f"{site}: retry budget exhausted after {attempts} attempts "
            f"({elapsed:.1f}s): {last_exc!r}"
        )
        self.site = site
        self.attempts = attempts
        self.elapsed = elapsed
        self.last_exc = last_exc


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff + full jitter + optional deadline.

    ``delay(n)`` for the n-th failure (1-based) draws uniformly from
    ``[min_delay_fraction, 1] * min(max_delay, base_delay * multiplier**(n-1))``
    — full jitter desynchronizes retry storms across a pod (every rank
    hammering a restarted store host on the same beat is the failure mode
    this exists to prevent).
    """

    max_attempts: Optional[int] = 5     # None = unbounded (deadline-gated)
    base_delay: float = 0.2             # first backoff (s)
    max_delay: float = 30.0             # backoff ceiling (s)
    multiplier: float = 2.0
    min_delay_fraction: float = 0.5     # jitter floor (1.0 = no jitter)
    deadline: Optional[float] = None    # wall-clock budget per episode (s)

    def with_(self, **overrides) -> "RetryPolicy":
        return dataclasses.replace(self, **overrides)

    def delay(self, failure_count: int, rng: Optional[random.Random] = None) -> float:
        raw = min(
            self.max_delay,
            self.base_delay * (self.multiplier ** max(0, failure_count - 1)),
        )
        frac = self.min_delay_fraction
        if frac >= 1.0:
            return raw
        r = (rng or random).uniform(frac, 1.0)
        return raw * r


class Retrier:
    """One retry episode at one call site.

    ``backoff(exc)`` either sleeps the next policy delay and returns (the
    caller's loop re-tries) or raises :class:`RetryExhausted`.  The sleep
    never overshoots a deadline: the final backoff is clamped so the last
    attempt still runs inside the budget.
    """

    def __init__(
        self,
        site: str,
        policy: RetryPolicy,
        deadline: Optional[float] = None,
        sleep: Callable[[float], None] = time.sleep,
        clock: Callable[[], float] = time.monotonic,
        rng: Optional[random.Random] = None,
    ):
        self.site = site
        self.policy = policy
        self._sleep = sleep
        self._clock = clock
        self._rng = rng
        self._t0 = clock()
        budget = deadline if deadline is not None else policy.deadline
        self._deadline_t = None if budget is None else self._t0 + budget
        self.failures = 0
        self.attempts = 1  # entering the loop is the first attempt
        self.last_exc: Optional[BaseException] = None
        _ATTEMPTS.labels(site).inc()

    @property
    def elapsed(self) -> float:
        return self._clock() - self._t0

    def remaining(self) -> Optional[float]:
        if self._deadline_t is None:
            return None
        return self._deadline_t - self._clock()

    def _exhaust(self) -> RetryExhausted:
        _EXHAUSTED.labels(self.site).inc()
        return RetryExhausted(self.site, self.attempts, self.elapsed,
                              self.last_exc)

    def backoff(self, exc: Optional[BaseException] = None) -> None:
        """Record a failure, then sleep the next backoff — or raise
        :class:`RetryExhausted` (chaining ``exc``) when the budget is spent."""
        self.failures += 1
        self.last_exc = exc if exc is not None else self.last_exc
        cap = self.policy.max_attempts
        if cap is not None and self.failures >= cap:
            raise self._exhaust() from exc
        delay = self.policy.delay(self.failures, self._rng)
        remaining = self.remaining()
        if remaining is not None:
            if remaining <= 0:
                raise self._exhaust() from exc
            delay = min(delay, max(0.0, remaining))
        _BACKOFFS.labels(self.site).inc()
        _ATTEMPTS.labels(self.site).inc()
        self.attempts += 1
        if delay > 0:
            self._sleep(delay)
