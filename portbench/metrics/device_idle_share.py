"""Percent of the traced window in which no operation ran on the card."""


def read(run):
    return run.trace.idle_share() if run.trace is not None else None
