"""Tokens of every step completed in a window with faults, replayed steps
included, over the window's seconds: what detection and restart cost."""


def read(run):
    return run.tokens / run.window_s if run.window_s else None
