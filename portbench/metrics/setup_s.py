"""Set-up time: process start to the window's start (weights, the always-on
set, the warm-up steps, a cell's save; the first run in a checkout also
builds the port's kernels)."""


def read(run):
    return run.setup_s
