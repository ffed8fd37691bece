"""Kernel 1 (``ops/csrc/quorum_max.cu``, both quorum lanes) against its
byte bound at the launched size, over its device time in the trace, in
percent.  One process drives one card, so each launch reduces
``run.quorum_n_local`` ages; at one age the lane is bound by launches, not
bytes, and the share is tiny."""

from portbench import counts


def read(run):
    if run.trace is None:
        return None
    launches, ns = run.trace.matching("local_max_")
    if not launches or not ns:
        return None
    return 100.0 * launches * counts.local_max_bound_s(run.quorum_n_local) / (ns / 1e9)
