"""The fault timeline of a run, drawn whole from the seed before the window
opens.

As the port's chaos soak does (``soak/schedule.py``), the timeline is
pre-drawn from ``random.Random(seed)``, so the same seed gives the same
timeline.  Unlike the soak's per-step draw, every seed gets the same
faults: the traffic file's offsets, from its set of gaps in a seeded
order, and its classes in its own order.  A seed changes the order of the
gaps and nothing else, so each class is the same in every run; a window
with one fault is the same in every run.
"""

from __future__ import annotations

import random
from typing import List, Optional, Tuple


def fault_times(spec: Optional[dict], seed: int,
                seconds: float) -> List[Tuple[float, str]]:
    """``[(offset_s, class), ...]`` of the faults due inside a window of
    ``seconds``: the first at ``spec["first_s"]``, then one after each gap
    of ``spec["gaps_s"]`` in a seeded order; the classes cycle through
    ``spec["classes"]`` in the file's order.  No spec, no faults."""
    if not spec:
        return []
    gaps = list(spec["gaps_s"])
    random.Random(int(seed)).shuffle(gaps)
    classes = list(spec["classes"])
    offsets = [float(spec["first_s"])]
    for gap in gaps:
        offsets.append(offsets[-1] + float(gap))
    return [(t, classes[i % len(classes)])
            for i, t in enumerate(offsets) if t < seconds]
