"""The port's public freeze of the quorum heartbeat
(``QuorumMonitor.stop_auto_beat``): no beats and no pings, so the tick lane
has to trip the ring."""

from __future__ import annotations

import time

POLL_S = 0.05
UNSEEN_S = 30.0  # a freeze still undetected then is a failed fault


def fire(cw, step: int) -> None:
    cw.quorum.monitor.stop_auto_beat()
    t_end = time.monotonic() + UNSEEN_S
    while time.monotonic() < t_end:
        time.sleep(POLL_S)
    raise RuntimeError(f"frozen quorum beat at step {step} not detected in {UNSEEN_S} s")
