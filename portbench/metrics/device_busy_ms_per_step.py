"""Milliseconds per step of the traced window in which an operation ran on
the card.  Device time is not stretched by the profiler's cost on the host,
so beside the untraced step time it gives the untraced idle share."""


def read(run):
    if run.trace is None or not run.steps or run.trace.busy_s <= 0:
        return None
    return 1e3 * run.trace.busy_s / run.steps
