"""The chaos soak's pure pieces: the seeded fault schedule and the rings'
detect->recover latencies.

Copies of ``benchmarks/soak_launcher.py``'s ``_gen_fault_schedule`` and
``_ring_latencies`` (the port keeps its own; it imports nothing of the JAX
package or its benchmarks).  The same arguments give a byte-identical
schedule, and the same event stream the same latencies.
"""

from __future__ import annotations

import random


def _gen_fault_schedule(seed, nproc, horizon, probs, shift_at=None,
                        shift_mult=1.0):
    """Pre-draw the whole injection timeline: ``probs`` maps fault kind ->
    per-step probability; from ``shift_at`` on, every probability is
    multiplied by ``shift_mult`` (the fault-regime step the adaptive
    policy must chase).  Same seed -> byte-identical schedule."""
    rng = random.Random(seed)
    faults: dict = {str(r): {} for r in range(nproc)}
    for r in range(nproc):
        for step in range(1, horizon):
            mult = (
                shift_mult
                if shift_at is not None and step >= shift_at
                else 1.0
            )
            draw = rng.random()
            for kind, p_kind in probs.items():
                if draw < p_kind * mult:
                    faults[str(r)][str(step)] = kind
                    break
                draw -= p_kind * mult
    return {
        "seed": seed,
        "nproc": nproc,
        "horizon": horizon,
        "shift_at": shift_at,
        "shift_mult": shift_mult,
        "faults": faults,
    }


def _ring_latencies(events):
    """Derive detect->recover latencies (ms) for both rings from the
    profiling JSONL's events, in time order.

    Outer: FAILURE_DETECTED -> next WORKER_STARTED recorded by the SAME pid
    (the launcher records both; the wrapper's worker_started is a worker
    pid and never pairs).
    Inner: earliest DETECTION event in a worker pid (HANG_DETECTED from the
    quorum tripwire, INPROCESS_INTERRUPTED for exceptions;
    INPROCESS_RESTART_STARTED as the fallback anchor) ->
    INPROCESS_RESTART_COMPLETED in the same pid, so a detection-latency
    regression moves the measured number, not just teardown+re-entry.
    """
    outer, inner = [], []
    pending_outer = None
    pending_inner = {}
    for ev in events:
        name = ev.get("event")
        if name == "failure_detected" and pending_outer is None:
            pending_outer = ev["mono_ns"], ev["pid"]
        elif name == "worker_started" and pending_outer is not None:
            t0, pid = pending_outer
            if ev["pid"] == pid and ev["mono_ns"] > t0:
                outer.append((ev["mono_ns"] - t0) / 1e6)
                pending_outer = None
        elif name in ("hang_detected", "inprocess_interrupted",
                      "inprocess_restart_started"):
            # setdefault keeps the EARLIEST anchor: real detection when
            # recorded, restart entry otherwise
            pending_inner.setdefault(ev["pid"], ev["mono_ns"])
        elif name == "inprocess_restart_completed":
            t0 = pending_inner.pop(ev["pid"], None)
            if t0 is not None and ev["mono_ns"] > t0:
                inner.append((ev["mono_ns"] - t0) / 1e6)
    return outer, inner
