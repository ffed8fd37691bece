"""At-abort collective fingerprint: the last K dispatched device programs.

The port's cut of ``tpu_resiliency/inprocess/fingerprint.py``: every
instrumented dispatch records its name and stamp into a small ring (the
:class:`DispatchTail`), so attribution can see which collective was in
flight when a rank stopped.  The entry layout is the JAX package's.

This slice keeps the tail in process memory.  The shared-memory arena that
lets a monitor process read a wedged rank's tail post-mortem comes with the
in-process slice, together with the monitor.

Concurrency: single writer (the dispatching thread), any number of readers.
Entries are written body-first, sequence-last; a reader that observes a
torn entry (seq mismatch on re-read) drops it — the fingerprint is a
diagnostic, losing the newest entry beats locking the dispatch path.
"""

from __future__ import annotations

import struct
import threading
from typing import List, Optional

from ..ops.quorum import now_stamp_ns

MAGIC = b"TPUFPT01"
NAME_LEN = 48
DEFAULT_CAPACITY = 8

_HEADER = struct.Struct("<8sII")              # magic, capacity, reserved
_ENTRY = struct.Struct(f"<Qq{NAME_LEN}s")     # seq, stamp_ms, name
HEADER_SIZE = _HEADER.size
ENTRY_SIZE = _ENTRY.size


def arena_size(capacity: int) -> int:
    return HEADER_SIZE + capacity * ENTRY_SIZE


class DispatchTail:
    """Ring of the last ``capacity`` dispatched device programs."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = capacity
        self._buf = memoryview(bytearray(arena_size(capacity)))
        self._seq = 0
        self._lock = threading.Lock()
        _HEADER.pack_into(self._buf, 0, MAGIC, capacity, 0)

    def record(self, name: str, stamp_ms: Optional[int] = None) -> None:
        """Record one dispatched program (called at dispatch, before any
        block): two packs and a slot copy."""
        if stamp_ms is None:
            stamp_ms = now_stamp_ns() // 1_000_000
        raw = name.encode(errors="replace")[: NAME_LEN - 1]
        with self._lock:
            seq = self._seq + 1
            off = HEADER_SIZE + ((seq - 1) % self.capacity) * ENTRY_SIZE
            # body first, seq last: readers treat a seq/body mismatch as torn
            _ENTRY.pack_into(self._buf, off, 0, stamp_ms, raw)
            _ENTRY.pack_into(self._buf, off, seq, stamp_ms, raw)
            self._seq = seq

    def snapshot(self, now_ms: Optional[int] = None) -> List[dict]:
        """Entries oldest→newest: ``[{"op", "age_ms", "seq"}, ...]``."""
        if now_ms is None:
            now_ms = now_stamp_ns() // 1_000_000
        out = []
        for i in range(self.capacity):
            off = HEADER_SIZE + i * ENTRY_SIZE
            seq, stamp_ms, raw = _ENTRY.unpack_from(self._buf, off)
            if seq == 0:
                continue
            # torn-write check: the slot for seq must still hold seq
            seq2, _, _ = _ENTRY.unpack_from(self._buf, off)
            if seq2 != seq:
                continue
            out.append({
                "op": raw.split(b"\x00", 1)[0].decode(errors="replace"),
                "age_ms": max(0, now_ms - stamp_ms),
                "seq": int(seq),
            })
        out.sort(key=lambda e: e["seq"])
        return out


# -- process-global tail (one per rank) -------------------------------------

_global_tail = DispatchTail()


def record_dispatch(name: str) -> None:
    """Record one dispatched device program into this rank's tail.  The
    collective wrapper calls it for every wrapped op."""
    _global_tail.record(name)


def snapshot_tail(now_ms: Optional[int] = None) -> List[dict]:
    return _global_tail.snapshot(now_ms)
