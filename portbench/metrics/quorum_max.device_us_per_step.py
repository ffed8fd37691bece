"""Kernel 1's device time in the trace (every launch of both quorum lanes),
in microseconds per step of the window."""


def read(run):
    if run.trace is None or not run.steps:
        return None
    launches, ns = run.trace.matching("local_max_")
    return ns / 1e3 / run.steps if launches else None
