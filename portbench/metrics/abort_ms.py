"""Median over the run's injected faults of the abort ladder's time, the sum
of its stages' durations (``CallWrapper.last_ladder_results``)."""

import statistics


def read(run):
    v = [f["abort_ms"] for f in run.faults if f["injected"] and "abort_ms" in f]
    return statistics.median(v) if v else None
