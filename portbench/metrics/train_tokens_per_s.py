"""Tokens of every step completed in the window over the window's seconds
(host clock, the window closed by a device synchronize)."""


def read(run):
    return run.tokens / run.window_s if run.window_s else None
