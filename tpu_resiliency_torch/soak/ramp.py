"""The ramping degradation of the predict-and-evacuate scenario.

One rank's node health worsens round by round, and rank 0's straggler
report scores it slower and slower; nothing hard-faults until the
scenario's deadline.  The policy's fused rank risk reads both through the
cross-rank snapshot feed and must evacuate the victim first.  Shared by
the soak's ``--ramp-degrade`` workload (``soak/workloads/evac.py``) and
``chip_smoke.py``'s policy phase (b), the same scenario with the flagship's
train state.
"""

from __future__ import annotations


def publish_ramp(reg, rank: int, world: int, step: int, victim: int,
                 ramp_rounds: int, check: str) -> None:
    """Set this round's ramp gauges in ``reg``: the victim's
    ``tpurx_health_score{check}`` rises to 1 over ``ramp_rounds`` steps,
    and on rank 0 the victim's ``tpurx_straggler_score`` falls to 0.2 while
    every other rank stays at 1."""
    if rank == victim:
        reg.gauge("tpurx_health_score", labels=("check",)).labels(check).set(
            min(1.0, step / ramp_rounds))
    if rank == 0:
        strag = reg.gauge("tpurx_straggler_score", labels=("rank",))
        for r in range(world):
            strag.labels(str(r)).set(
                max(0.2, 1.0 - step / ramp_rounds) if r == victim else 1.0)
