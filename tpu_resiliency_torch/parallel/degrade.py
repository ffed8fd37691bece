"""Ordered degrade policy for wrapped collectives.

The port of ``tpu_resiliency/parallel/degrade.py``.  When an op trips its
deadline, recovery is selected from the cheapest viable tier — not jumped
straight to a job-wide restart.  The ladder, composed via
``TPURX_COLL_DEGRADE`` (default ``retry,relayout,shrink``):

1. **retry** — bounded re-attempts of the primary lane through
   :class:`~tpu_resiliency_torch.utils.retry.Retrier` (site ``coll_<op>``,
   full jitter; a transient link hiccup costs one backoff, nothing else);
2. **relayout** — re-run on the fallback lane when one is registered
   (reduced/alternate group or a host path), else re-run the primary;
3. **shrink** — a *targeted* mesh shrink through the in-process abort
   ladder.  That ladder (``inprocess/abort.py``) comes with the in-process
   slice of the port; until then this rung raises NotImplementedError.

A route's health bias (``parallel/health.py``) can start the ladder below
the top — e.g. a consumed at-abort verdict, or a route that already proved
its link dead — so known-bad rungs are not re-walked every call.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from ..utils import env
from ..utils.logging import get_logger
from ..utils.retry import RetryPolicy, Retrier

log = get_logger("coll.degrade")

RETRY = "retry"
RELAYOUT = "relayout"
SHRINK = "shrink"
ACTIONS = (RETRY, RELAYOUT, SHRINK)

# retry rung cadence: deadline trips are already slow (a whole budget each),
# so backoffs stay short — the bound is what matters
_RETRY_RUNG_POLICY = RetryPolicy(base_delay=0.05, max_delay=1.0)


@dataclasses.dataclass(frozen=True)
class DegradePolicy:
    """Parsed ladder composition + retry budget (immutable, per-wrapper)."""

    rungs: Tuple[str, ...] = ACTIONS
    retries: int = 2

    @classmethod
    def from_env(cls) -> "DegradePolicy":
        spec = env.COLL_DEGRADE.get() or ""
        rungs = tuple(
            r for r in (s.strip() for s in spec.split(",")) if r
        )
        bad = [r for r in rungs if r not in ACTIONS]
        if bad:
            log.warning("TPURX_COLL_DEGRADE: unknown rung(s) %s ignored", bad)
            rungs = tuple(r for r in rungs if r in ACTIONS)
        return cls(rungs=rungs, retries=max(0, int(env.COLL_RETRIES.get())))

    def rungs_from(self, start: str) -> Tuple[str, ...]:
        """The ladder from ``start`` down ('' or unknown = full ladder)."""
        if start in self.rungs:
            return self.rungs[self.rungs.index(start):]
        return self.rungs

    def retrier(self, op: str) -> Retrier:
        return Retrier(
            f"coll_{op}",
            _RETRY_RUNG_POLICY.with_(max_attempts=self.retries + 1),
        )


def default_relayout() -> str:
    """Re-layout prep before the relayout rung's re-run.  The JAX package
    drops compiled executables here so the re-run re-traces; eager PyTorch
    keeps no compiled program per topology, so there is nothing to drop."""
    return "nothing to drop (eager)"


def trip_shrink(op: str, axis: str, culprits: Tuple[int, ...] = ()) -> str:
    """The targeted-shrink rung.  It needs the in-process abort ladder
    (``inprocess/abort.py``), which comes with the in-process slice."""
    raise NotImplementedError(
        f"collective {op}@{axis or '-'}: the shrink rung needs the abort "
        "ladder of the in-process slice of the port (inprocess/abort.py), "
        "which is not ported yet; compose TPURX_COLL_DEGRADE without "
        "'shrink' until it lands"
    )
