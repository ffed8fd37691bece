"""Process-local metrics registry.

The port's copy of ``tpu_resiliency/telemetry/registry.py`` (without the
windowed rate view, which only the policy loop reads).  The port has its
own registry and registers the same metric names as the JAX package.

Design constraints (the reason this is not a prometheus_client dependency):

- **Near-zero hot-path overhead.**  ``Counter.inc`` is one lock acquire and
  one float add; ``Histogram.observe`` adds a bisect over a fixed bucket
  table.  Instrumentation sites in heartbeat and step paths run every few
  milliseconds, so anything allocating or formatting per event is out.
- **No-op fast path.**  With ``TPURX_TELEMETRY=0`` every constructor returns
  the shared :data:`NOOP` metric whose methods are empty — call sites keep a
  single unconditional ``metric.inc()`` and pay only a no-op method call.
  Metric *names* are still recorded (registration is one-time, not hot) so
  tooling can enumerate the catalog regardless of the switch.
- **Snapshot-friendly.**  ``snapshot()`` emits a plain-JSON structure, the
  input of the cross-rank aggregation and the OpenMetrics renderer that a
  later slice ports.

Values observed into histograms are **monotonic nanoseconds** by convention
(:data:`DEFAULT_NS_BUCKETS` spans 1 µs – 68 s in powers of four); byte-sized
histograms can pass their own bucket table.
"""

from __future__ import annotations

import bisect
import re
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from ..utils import env

ENV_TELEMETRY = env.TELEMETRY.name

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# 1 µs .. ~68 s in powers of 4 — covers a heartbeat send and a full
# rendezvous round (~seconds) in one table.
DEFAULT_NS_BUCKETS: Tuple[float, ...] = tuple(
    1_000.0 * (4 ** i) for i in range(14)
)

# 4 KiB .. 16 GiB in powers of 8 — for byte-sized observations (drain chunks).
BYTE_BUCKETS: Tuple[float, ...] = tuple(4096.0 * (8 ** i) for i in range(8))


def telemetry_enabled() -> bool:
    """The global switch: ``TPURX_TELEMETRY=0`` disables collection."""
    return env.TELEMETRY.get()


def valid_metric_name(name: str) -> bool:
    return bool(_NAME_RE.match(name))


class _NoopTimer:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP_TIMER = _NoopTimer()


class _NoopMetric:
    """Shared do-nothing metric returned by disabled registries."""

    __slots__ = ()

    def labels(self, *values, **kv) -> "_NoopMetric":
        return self

    def inc(self, amount: float = 1.0) -> None:
        pass

    def dec(self, amount: float = 1.0) -> None:
        pass

    def set(self, value: float) -> None:
        pass

    def observe(self, value: float) -> None:
        pass

    def time_ns(self):
        return _NOOP_TIMER



NOOP = _NoopMetric()


class _TimerCtx:
    """Context manager observing the enclosed duration in monotonic ns."""

    __slots__ = ("_metric", "_t0")

    def __init__(self, metric: "Histogram"):
        self._metric = metric

    def __enter__(self):
        self._t0 = time.monotonic_ns()
        return self

    def __exit__(self, *exc):
        self._metric.observe(time.monotonic_ns() - self._t0)
        return False


class _Metric:
    """Base for the three concrete kinds.  A metric with ``label_names`` is a
    family: ``labels(v1, v2)`` (or ``labels(name=v)``) returns a child that
    shares the family entry in the registry."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "", label_names: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], "_Metric"] = {}

    def labels(self, *values, **kv) -> "_Metric":
        if kv:
            if values:
                raise ValueError("pass label values positionally OR by name")
            values = tuple(str(kv[n]) for n in self.label_names)
        else:
            values = tuple(str(v) for v in values)
        if len(values) != len(self.label_names):
            raise ValueError(
                f"{self.name}: expected labels {self.label_names}, got {values}"
            )
        with self._lock:
            child = self._children.get(values)
            if child is None:
                child = self._make_child()
                self._children[values] = child
            return child

    def _make_child(self) -> "_Metric":
        raise NotImplementedError

    def _sample_rows(self) -> List[Tuple[Dict[str, str], dict]]:
        """[(labels_dict, value_dict)] for this family (children or self)."""
        if self.label_names:
            with self._lock:
                items = list(self._children.items())
            return [
                (dict(zip(self.label_names, values)), child._value_dict())
                for values, child in items
            ]
        return [({}, self._value_dict())]

    def _value_dict(self) -> dict:
        raise NotImplementedError


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name: str, help: str = "", label_names: Sequence[str] = ()):
        super().__init__(name, help, label_names)
        self._value = 0.0

    def _make_child(self) -> "Counter":
        return Counter(self.name, self.help)

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def _value_dict(self) -> dict:
        with self._lock:
            return {"value": self._value}


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, name: str, help: str = "", label_names: Sequence[str] = ()):
        super().__init__(name, help, label_names)
        self._value = 0.0

    def _make_child(self) -> "Gauge":
        return Gauge(self.name, self.help)

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value -= amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def _value_dict(self) -> dict:
        with self._lock:
            return {"value": self._value}


class Histogram(_Metric):
    """Fixed-bucket histogram (cumulative-on-render, per-bucket in memory)."""

    kind = "histogram"

    def __init__(
        self,
        name: str,
        help: str = "",
        label_names: Sequence[str] = (),
        buckets: Sequence[float] = DEFAULT_NS_BUCKETS,
    ):
        super().__init__(name, help, label_names)
        self.bounds = tuple(sorted(float(b) for b in buckets))
        if not self.bounds:
            raise ValueError(f"{name}: histogram needs at least one bucket")
        self._counts = [0] * (len(self.bounds) + 1)  # +1 = overflow (+Inf)
        self._sum = 0.0
        self._count = 0

    def _make_child(self) -> "Histogram":
        return Histogram(self.name, self.help, buckets=self.bounds)

    def observe(self, value: float) -> None:
        idx = bisect.bisect_left(self.bounds, value)
        with self._lock:
            self._counts[idx] += 1
            self._sum += value
            self._count += 1

    def time_ns(self) -> _TimerCtx:
        return _TimerCtx(self)

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def quantile(self, q: float) -> float:
        """Bucket-resolution quantile estimate (upper bound of the bucket the
        q-th observation falls in; +Inf overflow reports the top bound)."""
        with self._lock:
            total = self._count
            counts = list(self._counts)
        if total == 0:
            return 0.0
        target = max(1, int(q * total + 0.5))
        seen = 0
        for i, c in enumerate(counts):
            seen += c
            if seen >= target:
                return self.bounds[min(i, len(self.bounds) - 1)]
        return self.bounds[-1]

    def _value_dict(self) -> dict:
        with self._lock:
            return {
                "bounds": list(self.bounds),
                "counts": list(self._counts),
                "sum": self._sum,
                "count": self._count,
            }


class Registry:
    """Thread-safe named-metric registry.

    Duplicate registration with identical (kind, label_names) returns the
    existing metric (modules are imported once, but tests re-import); any
    mismatch raises — two call sites silently sharing one name with
    different shapes is the bug this catches.
    """

    def __init__(self, enabled: Optional[bool] = None):
        self.enabled = telemetry_enabled() if enabled is None else bool(enabled)
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}
        # name -> (kind, label_names); kept even when disabled so the
        # catalog stays enumerable
        self._declared: Dict[str, Tuple[str, Tuple[str, ...]]] = {}

    # -- registration ------------------------------------------------------

    def _register(self, cls, name: str, help: str, label_names, **kw):
        if not valid_metric_name(name):
            raise ValueError(f"invalid OpenMetrics metric name: {name!r}")
        label_names = tuple(label_names)
        for ln in label_names:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r} on {name}")
        with self._lock:
            declared = self._declared.get(name)
            if declared is not None and declared != (cls.kind, label_names):
                raise ValueError(
                    f"metric {name!r} already registered as {declared}, "
                    f"conflicting with ({cls.kind}, {label_names})"
                )
            self._declared[name] = (cls.kind, label_names)
            if not self.enabled:
                return NOOP
            metric = self._metrics.get(name)
            if metric is None:
                metric = cls(name, help, label_names=label_names, **kw)
                self._metrics[name] = metric
            return metric

    def counter(self, name: str, help: str = "", labels: Sequence[str] = ()):
        if not name.endswith("_total"):
            raise ValueError(f"counter {name!r} must end with '_total'")
        return self._register(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", labels: Sequence[str] = ()):
        return self._register(Gauge, name, help, labels)

    def histogram(
        self,
        name: str,
        help: str = "",
        labels: Sequence[str] = (),
        buckets: Sequence[float] = DEFAULT_NS_BUCKETS,
    ):
        return self._register(Histogram, name, help, labels, buckets=buckets)

    # -- introspection -----------------------------------------------------

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._declared)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def value_of(self, name: str, labels: Optional[Dict[str, str]] = None) -> float:
        """Convenience for tests/bench: current value of a counter/gauge
        sample (0.0 when absent/disabled)."""
        metric = self.get(name)
        if metric is None:
            return 0.0
        for label_dict, value in metric._sample_rows():
            if labels is None or label_dict == {k: str(v) for k, v in labels.items()}:
                if "value" in value:
                    return value["value"]
                return value.get("sum", 0.0)
        return 0.0

    def collect(self) -> List[dict]:
        """[{name, kind, help, labels, samples: [(labels_dict, value_dict)]}]"""
        with self._lock:
            metrics = list(self._metrics.values())
        return [
            {
                "name": m.name,
                "kind": m.kind,
                "help": m.help,
                "labels": list(m.label_names),
                "samples": m._sample_rows(),
            }
            for m in metrics
        ]

    def snapshot(self) -> dict:
        """JSON-safe state for cross-rank aggregation."""
        out = {}
        for fam in self.collect():
            out[fam["name"]] = {
                "kind": fam["kind"],
                "labels": fam["labels"],
                "samples": [
                    {"labels": labels, **value} for labels, value in fam["samples"]
                ],
            }
        return out


_default_registry: Optional[Registry] = None
_default_lock = threading.Lock()


def get_registry() -> Registry:
    """The process-wide default registry (created on first use; the enable
    switch is read once, at creation)."""
    global _default_registry
    if _default_registry is None:
        with _default_lock:
            if _default_registry is None:
                _default_registry = Registry()
    return _default_registry


def counter(name: str, help: str = "", labels: Sequence[str] = ()):
    return get_registry().counter(name, help, labels)


def gauge(name: str, help: str = "", labels: Sequence[str] = ()):
    return get_registry().gauge(name, help, labels)


def histogram(
    name: str,
    help: str = "",
    labels: Sequence[str] = (),
    buckets: Sequence[float] = DEFAULT_NS_BUCKETS,
):
    return get_registry().histogram(name, help, labels, buckets=buckets)


