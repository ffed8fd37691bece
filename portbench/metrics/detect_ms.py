"""Median over the run's injected faults of the time from the fault to the
ring's trip (``CallWrapper.trip_ns``)."""

import statistics


def read(run):
    v = [f["detect_ms"] for f in run.faults if f["injected"] and "detect_ms" in f]
    return statistics.median(v) if v else None
