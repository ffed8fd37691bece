"""Monotonic stamp source for the flight recorder and profiling records.

The port's cut of ``tpu_resiliency/telemetry/clock.py``: :func:`mono_ns`,
with the ``TPURX_CLOCK_TEST_SKEW_NS`` test skew.  The store-mediated
clock-offset calibration comes with the store slice.
"""

from __future__ import annotations

import time

from ..utils import env

_TEST_SKEW = 0
try:
    _TEST_SKEW = env.CLOCK_TEST_SKEW_NS.get()
except ValueError:
    _TEST_SKEW = 0

if _TEST_SKEW:
    def mono_ns() -> int:
        return time.monotonic_ns() + _TEST_SKEW
else:
    mono_ns = time.monotonic_ns
