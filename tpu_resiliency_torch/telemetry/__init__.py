"""The port's telemetry plane (counterpart of ``tpu_resiliency/telemetry``).

- :mod:`.registry` — process-local metrics (counters / gauges / fixed-bucket
  ns histograms) with a no-op fast path under ``TPURX_TELEMETRY=0``;
- :mod:`.flight` — the fault-episode flight-recorder ring;
- :mod:`.clock` — the monotonic stamp source of the ring.

The exporter, the cross-rank aggregate and the trace merger wait for a
later slice.
"""

from .registry import (
    BYTE_BUCKETS,
    DEFAULT_NS_BUCKETS,
    ENV_TELEMETRY,
    NOOP,
    Counter,
    Gauge,
    Histogram,
    Registry,
    counter,
    gauge,
    get_registry,
    histogram,
    telemetry_enabled,
    valid_metric_name,
)

__all__ = [
    "BYTE_BUCKETS",
    "DEFAULT_NS_BUCKETS",
    "ENV_TELEMETRY",
    "NOOP",
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "counter",
    "gauge",
    "get_registry",
    "histogram",
    "telemetry_enabled",
    "valid_metric_name",
]
