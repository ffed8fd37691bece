"""Cycle-stamped profiling event recorder.

The port's copy of ``tpu_resiliency/utils/profiling.py``: a tiny
append-only event log around the restart pipeline (FAILURE_DETECTED →
RENDEZVOUS_* → WORKER_START_*), written as JSON lines with the same event
names, so one tool reads the streams of both packages.  Each record is
mirrored into the flight-recorder ring.  The quorum monitor's default
``on_stale`` records :attr:`ProfilingEvent.HANG_DETECTED` here.
"""

from __future__ import annotations

import atexit
import collections
import enum
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from . import env


class ProfilingEvent(str, enum.Enum):
    # Detection
    FAILURE_DETECTED = "failure_detected"
    HANG_DETECTED = "hang_detected"
    STRAGGLER_DETECTED = "straggler_detected"
    # Restart pipeline
    RENDEZVOUS_STARTED = "rendezvous_started"
    RENDEZVOUS_COMPLETED = "rendezvous_completed"
    WORKER_START_REQUESTED = "worker_start_requested"
    WORKER_STARTED = "worker_started"
    WORKER_STOP_REQUESTED = "worker_stop_requested"
    WORKER_STOPPED = "worker_stopped"
    # Checkpointing
    CHECKPOINT_SAVE_STARTED = "checkpoint_save_started"
    CHECKPOINT_SAVE_FINALIZED = "checkpoint_save_finalized"
    CHECKPOINT_LOAD_STARTED = "checkpoint_load_started"
    CHECKPOINT_LOAD_COMPLETED = "checkpoint_load_completed"
    # In-process restart
    INPROCESS_INTERRUPTED = "inprocess_interrupted"
    INPROCESS_RESTART_STARTED = "inprocess_restart_started"
    INPROCESS_RESTART_COMPLETED = "inprocess_restart_completed"
    ABORT_STAGE = "abort_stage"  # one per abort-ladder rung, with outcome
    # Health
    HEALTH_CHECK_STARTED = "health_check_started"
    HEALTH_CHECK_COMPLETED = "health_check_completed"
    HEALTH_FAILURE = "health_failure"
    NODE_EXCLUDE_REQUESTED = "node_exclude_requested"


ENV_HISTORY = env.PROFILING_HISTORY.name
_DEFAULT_HISTORY = 4096

# Test-skew-aware monotonic stamps, duplicated from telemetry/clock.py:
# the telemetry package imports utils, so it cannot be imported here at
# module scope.
try:
    _TEST_SKEW = env.CLOCK_TEST_SKEW_NS.get()
except ValueError:
    _TEST_SKEW = 0

if _TEST_SKEW:
    def _mono_ns() -> int:
        return time.monotonic_ns() + _TEST_SKEW
else:
    _mono_ns = time.monotonic_ns

_flight_mod_cache: Any = None


def _flight():
    """Lazy handle on telemetry.flight (None until it is importable)."""
    global _flight_mod_cache
    if _flight_mod_cache is None:
        try:
            from ..telemetry import flight as fl
        except ImportError:
            return None
        _flight_mod_cache = fl
    return _flight_mod_cache


class ProfilingRecorder:
    """Thread-safe in-memory recorder with optional JSONL file sink.

    The sink fd is opened once (lazily, on the first record) and held
    line-buffered for the life of the process — the restart pipeline emits
    events from hot paths, and an open()/close() per event costs two
    syscalls plus a dentry walk each time.  In-memory history is a bounded
    deque (``TPURX_PROFILING_HISTORY``, default 4096): the file keeps the
    full stream, the deque only serves in-process queries like
    :meth:`latency_ns`, so a multi-day crash-looping job cannot grow the
    heap without bound.
    """

    def __init__(
        self,
        path: Optional[str] = None,
        cycle: int = 0,
        history: Optional[int] = None,
    ):
        self._path = path
        self._cycle = cycle
        self._lock = threading.Lock()
        if history is None:
            try:
                history = env.PROFILING_HISTORY.get()
            except ValueError:
                history = _DEFAULT_HISTORY
        self._events: "collections.deque[Dict[str, Any]]" = collections.deque(
            maxlen=history if history > 0 else None
        )
        self._file = None

    def set_cycle(self, cycle: int) -> None:
        self._cycle = cycle

    def _sink(self):
        """The persistent line-buffered sink (None when pathless/broken)."""
        if self._file is None and self._path:
            try:
                self._file = open(self._path, "a", buffering=1)
            except OSError:
                self._path = None  # don't retry the open on every event
                return None
            atexit.register(self.close)
            self._write_meta_locked(self._file)
        return self._file

    def _write_meta_locked(self, f) -> None:
        """Append the host/clock meta header the trace merger keys on."""
        fl = _flight()
        if fl is None or f is None:
            return
        try:
            f.write(json.dumps(fl._meta("profiling"), default=repr) + "\n")
        except (OSError, ValueError):
            pass

    def write_meta(self) -> None:
        """Re-emit the meta record (call after clock calibration so the
        file carries the estimated offset, not just the header's None)."""
        with self._lock:
            self._write_meta_locked(self._sink())

    def close(self) -> None:
        with self._lock:
            f, self._file = self._file, None
            self._path = None
        if f is not None:
            try:
                f.close()
            except OSError:
                pass

    def record(self, event: ProfilingEvent, **extra: Any) -> Dict[str, Any]:
        fl = _flight()
        rec = {
            "ts": time.time(),  # tpurx: disable=TPURX016 -- record label; durations use mono_ns
            "mono_ns": _mono_ns(),
            "event": str(event.value),
            "cycle": self._cycle,
            "pid": os.getpid(),
            **extra,
        }
        if fl is not None:
            eid = fl.current_episode_id()
            if eid:
                rec.setdefault("episode", eid)
            fl.record(fl.EV_PROFILING, str(event.value), self._cycle)
        with self._lock:
            self._events.append(rec)
            f = self._sink()
            if f is not None:
                try:
                    f.write(json.dumps(rec) + "\n")
                except (OSError, ValueError):
                    pass
        return rec

    @property
    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def latency_ns(self, start: ProfilingEvent, end: ProfilingEvent) -> Optional[int]:
        """Monotonic delta between the last `start` and the first later `end`."""
        events = self.events
        start_ns = None
        for rec in events:
            if rec["event"] == start.value:
                start_ns = rec["mono_ns"]
            elif rec["event"] == end.value and start_ns is not None:
                return rec["mono_ns"] - start_ns
        return None


_global_recorder = ProfilingRecorder(path=env.PROFILING_FILE.get())


def get_recorder() -> ProfilingRecorder:
    return _global_recorder


def record_event(event: ProfilingEvent, **extra: Any) -> Dict[str, Any]:
    return _global_recorder.record(event, **extra)
