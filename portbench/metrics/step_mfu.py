"""Model FLOPs of the steps in the traced window over the card's bf16 peak
times the window, in percent (``portbench.counts``)."""

from portbench import counts


def read(run):
    if run.trace is None or not run.steps:
        return None
    flops = run.steps * counts.train_flops_per_step(run.model, run.rows, run.seq)
    return 100.0 * flops / (counts.PEAK_BF16_FLOPS * run.trace.window_s)
