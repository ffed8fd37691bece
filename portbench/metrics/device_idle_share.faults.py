"""Percent of the traced window of a cell with faults in which no operation ran on the card."""


def read(run):
    return run.trace.idle_share() if run.trace is not None else None
