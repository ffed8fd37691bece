"""An exception raised from the step loop; the ring's monitor thread polls
its interruption log for it."""

from __future__ import annotations

from . import InjectedFault


def fire(cw, step: int) -> None:
    raise InjectedFault(f"injected exception at step {step}")
