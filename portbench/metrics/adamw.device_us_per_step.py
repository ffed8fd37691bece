"""Kernel 4's device time in the trace (``ops/csrc/adamw.cu``, the step's
fused AdamW update over every leaf), in microseconds per step of the
window.  A program without the kernel reads nothing."""


def read(run):
    if run.trace is None or not run.steps:
        return None
    launches, ns = run.trace.matching("tpurx_adamw_kernel")
    return ns / 1e3 / run.steps if launches else None
