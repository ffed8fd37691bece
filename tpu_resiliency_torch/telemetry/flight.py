"""Always-on fault-episode flight recorder: a black box for the hot seams.

The port's cut of ``tpu_resiliency/telemetry/flight.py``, holding what the
collective wrapper uses: :func:`declare_event`, :func:`record` and
:func:`dump`.

- **Preallocated ring, lock-free append.**  One slot store per event —
  ``ring[next(counter) & mask] = (mono_ns, name, episode, args)`` — no
  allocation beyond the slot tuple, no lock (the itertools counter is
  GIL-atomic).
- **``TPURX_FLIGHT=0`` no-op** — the module-level :func:`record` becomes
  a shared no-op, same discipline as the registry's ``TPURX_TELEMETRY=0``.
  Call sites must use attribute access (``flight.record(...)``), never
  ``from ... import record``, so :func:`configure` rebinds take effect.
- **Declared event names.**  Every event name is declared exactly once at
  module scope via :func:`declare_event` with a literal string and its
  positional field names.  The names are the JAX package's, so dumps of
  both packages merge onto one timeline.
- **Dumps are the product.**  :func:`dump` snapshots the ring to a JSONL
  file whose records are shaped like ``utils/profiling.py`` lines.  Dump
  hooks, the clock offset in the meta record, the SIGUSR2 trigger and the
  ``GET /flight`` endpoint wait for a later slice.
"""

from __future__ import annotations

import itertools
import json
import os
import re
import socket
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ..utils import env
from ..utils.logging import get_logger
from .clock import mono_ns

log = get_logger("telemetry.flight")

# -- event-name registry -----------------------------------------------------

_EVENT_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*(\.[a-z][a-z0-9_]*)+$")
_EVENT_FIELDS: Dict[str, Tuple[str, ...]] = {}


def declare_event(name: str, *fields: str) -> str:
    """Register a flight-event name with its positional field names.

    Names are dotted (``subsystem.event``); the part before the first dot
    becomes the trace category.  One declaration per name, literal string,
    at module scope — enforced by ``tests/test_repo_hygiene.py``.
    """
    if not _EVENT_NAME_RE.match(name):
        raise ValueError(f"invalid flight event name {name!r}")
    if name in _EVENT_FIELDS:
        raise ValueError(f"flight event {name!r} declared twice")
    _EVENT_FIELDS[name] = tuple(fields)
    return name


def event_names() -> List[str]:
    return sorted(_EVENT_FIELDS)


def event_fields(name: str) -> Tuple[str, ...]:
    return _EVENT_FIELDS[name]


EV_DUMP = declare_event("flight.dump", "reason")
# mirror of every utils/profiling.py record, so the ring alone tells the
# restart-pipeline story even when no profiling sink file is configured
EV_PROFILING = declare_event("profiling.event", "name", "cycle")

# -- current-episode cell ----------------------------------------------------
# the episode lifecycle (which sets the cell) comes with a later slice;
# the cell lives here so the hot append can tag every event with the live
# episode id in one list index.

_EPISODE_CELL: List[str] = [""]


def current_episode_id() -> str:
    return _EPISODE_CELL[0]


# -- the ring ----------------------------------------------------------------


class FlightRecorder:
    """Preallocated, overwrite-oldest event ring."""

    __slots__ = ("_ring", "_mask", "_counter", "capacity")

    def __init__(self, capacity: int):
        cap = 1
        while cap < max(2, capacity):
            cap <<= 1
        self.capacity = cap
        self._ring: List[Optional[tuple]] = [None] * cap
        self._mask = cap - 1
        self._counter = itertools.count()

    def record(self, name: str, *args: Any) -> None:
        # HOT PATH: one counter bump, one tuple, one slot store.  Under
        # concurrent appends two threads may claim distinct slots out of
        # order — fine, the dump sorts by timestamp.
        self._ring[next(self._counter) & self._mask] = (
            mono_ns(), name, _EPISODE_CELL[0], args,
        )

    def __len__(self) -> int:
        return sum(1 for slot in self._ring if slot is not None)

    def snapshot(self) -> List[tuple]:
        """Occupied slots, oldest first (torn slots racing an in-flight
        append are simply whichever tuple won the store — never invalid)."""
        slots = [s for s in self._ring if s is not None]
        slots.sort(key=lambda s: s[0])
        return slots


class _NoopRecorder:
    capacity = 0

    def record(self, name: str, *args: Any) -> None:
        return None

    def __len__(self) -> int:
        return 0

    def snapshot(self) -> List[tuple]:
        return []


NOOP = _NoopRecorder()

_recorder: Any = NOOP
_dump_lock = threading.Lock()
_dump_seq = itertools.count()
_dump_paths: List[str] = []       # files this process wrote, oldest first
_last_dump_ns: Dict[str, int] = {}  # reason -> mono_ns of last dump


def flight_enabled() -> bool:
    try:
        return bool(env.FLIGHT.get())
    except ValueError:
        return True


def configure(
    enabled: Optional[bool] = None, capacity: Optional[int] = None
) -> None:
    """(Re)build the process recorder and rebind :func:`record`."""
    global _recorder, record
    if enabled is None:
        enabled = flight_enabled()
    if capacity is None:
        capacity = env.FLIGHT_RING.get()
    _recorder = FlightRecorder(capacity) if enabled else NOOP
    record = _recorder.record


def get_flight() -> Any:
    return _recorder


configure()


def _host() -> str:
    return socket.gethostname().split(".")[0]


def _meta(reason: str) -> Dict[str, Any]:
    meta: Dict[str, Any] = {
        "event": "_flight_meta",
        "mono_ns": mono_ns(),
        # wall stamp is deliberate: it names the dump for humans grepping
        # a fleet's dump dirs, never enters duration math
        "ts": time.time(),  # tpurx: disable=TPURX016 -- dump label, not a duration operand
        "host": _host(),
        "pid": os.getpid(),
        "rank": env.RANK.get(),
        "reason": reason,
        "episode": current_episode_id(),
        "events": len(_recorder),
        "capacity": getattr(_recorder, "capacity", 0),
    }
    return meta


def _records(reason: str) -> List[Dict[str, Any]]:
    host = _host()
    pid = os.getpid()
    rank = env.RANK.get()
    out = [_meta(reason)]
    for t_ns, name, episode, args in _recorder.snapshot():
        rec: Dict[str, Any] = {
            "mono_ns": t_ns, "event": name, "host": host, "pid": pid,
            "rank": rank,
        }
        if episode:
            rec["episode"] = episode
        fields = _EVENT_FIELDS.get(name, ())
        for i, val in enumerate(args):
            rec[fields[i] if i < len(fields) else f"arg{i}"] = val
        out.append(rec)
    return out


def dump(
    reason: str, path: Optional[str] = None, min_interval_s: float = 2.0
) -> Optional[str]:
    """Write the ring to a JSONL black-box file; returns the path.

    Per-reason throttled (``min_interval_s``) so a trip→ladder→timeout
    cascade produces one dump per distinct trigger, not one per retry.
    Never raises: a dump failing must not worsen the fault being dumped.
    """
    if _recorder is NOOP:
        return None
    now = mono_ns()
    with _dump_lock:
        last = _last_dump_ns.get(reason)
        if (
            path is None and last is not None
            and now - last < min_interval_s * 1e9
        ):
            return None
        _last_dump_ns[reason] = now
    record(EV_DUMP, reason)
    try:
        records = _records(reason)
        if path is None:
            base = env.FLIGHT_DIR.get() or tempfile.gettempdir()
            os.makedirs(base, exist_ok=True)
            path = os.path.join(
                base,
                f"flight-{_host()}-{os.getpid()}"
                f"-{next(_dump_seq):04d}-{reason}.jsonl",
            )
        with open(path, "w") as f:
            for rec in records:
                f.write(json.dumps(rec, default=repr) + "\n")
        with _dump_lock:
            _dump_paths.append(path)
            keep = max(1, env.FLIGHT_DUMP_KEEP.get())
            stale, _dump_paths[:] = _dump_paths[:-keep], _dump_paths[-keep:]
        for old in stale:
            try:
                os.unlink(old)
            except OSError:
                pass
        # one line through the root logger names every dump
        log.warning(
            "flight dump (%s): %s (%d events, episode=%s)",
            reason, path, len(records) - 1, current_episode_id() or "-",
        )
        return path
    except Exception:  # noqa: BLE001 - dumping must never worsen a fault
        log.exception("flight dump (%s) failed", reason)
        return None
