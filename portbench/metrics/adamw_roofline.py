"""Kernel 4 (``ops/csrc/adamw.cu``) against the least traffic of the AdamW
update, 28 bytes a parameter of the configuration
(``adamw_counts.adamw_bytes_per_step``), over its device time in the trace, in
percent.  Every step of the window updates every leaf once, whatever the
number of launches it takes.  A program without the kernel reads
nothing."""

from portbench import adamw_counts


def read(run):
    if run.trace is None or not run.steps:
        return None
    launches, ns = run.trace.matching("tpurx_adamw_kernel")
    if not launches or not ns:
        return None
    bound_s = adamw_counts.adamw_bound_s_per_step(run.model)
    return 100.0 * run.steps * bound_s / (ns / 1e9)
