"""Median over the run's injected faults of the restore: the process group
rebuilt (``init_distributed``), the committed save loaded
(``load_checkpoint``) and copied into the trainer (``load_state_tree``),
timed around the calls."""

import statistics


def read(run):
    v = [f["restore_ms"] for f in run.faults if f["injected"] and "restore_ms" in f]
    return statistics.median(v) if v else None
