"""The comparison that decides ``correct``.

The program's readings come from its own warm-up (:mod:`portbench.driver`):
the loss of each of the first three steps, each leaf's first gradient as
AdamW got it (its first moment after one step, over 1 - b1), each leaf's
change after three steps (the fp32 master's), and in a cell with faults
the loss of the first steps replayed after each restore and the restored
state against the committed save.  The reference (``reference/decoder.py``)
follows the same three steps from the same weights and rows in float32.

Numbers compared, each against a limit:

- ``loss_gap``: the largest gap of a step's loss from the reference's, as a
  share of the reference's, over the warm-up and every replay;
- ``grad_gap``: the largest gap of a leaf's gradient norm from the
  reference's, as a share of the larger of that leaf's reference norm and
  the median leaf's;
- ``grad_diff``: the largest norm of a leaf's gradient's difference from
  the reference's, on the same scale: the norms above move little under
  rounding that is as likely up as down, which this catches;
- ``change_gap``: the gap of norms again for the change after three steps, over the
  leaves whose reference gradient is at least a thousandth of the median
  leaf's (a leaf with no gradient moves under AdamW by round-off alone);
- ``restore_mismatch``: elements of a restored state that differ from the
  save, over every restore (exact: 0);
- ``restores_missing``: injected faults after which the run did not restore
  and check the state (exact: 0);
- ``shm_left``: shared-memory segments the run left in ``/dev/shm``
  (exact: 0).

The limits of the first four live in the configuration's file (they are
set from sound runs of the program and from the control, as ``PERF.md``
records); the last three are exact.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Optional, Tuple

REFERENCE_STEPS = 3
NO_GRADIENT = 1e-3
EXACT = ("restore_mismatch", "restores_missing", "shm_left")


def _leaf_gap(prog: List[float], ref: List[float], keep: List[bool],
              scale: Optional[List[float]] = None) -> Tuple[float, int]:
    """(gap, leaf) of the worst kept leaf: ``|prog - ref|`` over the larger
    of that leaf's ``scale`` (the reference's norm, ``ref`` itself by
    default) and the median kept leaf's."""
    scale = ref if scale is None else scale
    if len(prog) != len(ref) or not ref:
        return math.inf, -1
    kept = [s for s, k in zip(scale, keep) if k]
    floor = statistics.median(kept) if kept else 0.0
    gaps = [(abs(p - r) / max(s, floor) if max(s, floor) > 0 else abs(p - r), i)
            for i, (p, r, s, k) in enumerate(zip(prog, ref, scale, keep)) if k]
    return max(gaps) if gaps else (math.inf, -1)


def gaps(prog: dict, ref: dict, replays: List[List[float]] = (),
         worst: Optional[dict] = None) -> Dict[str, float]:
    """``loss_gap``, ``grad_gap``, ``grad_diff`` and ``change_gap`` of
    readings ``prog`` (``loss``, ``grad_norm``, ``change_norm``, as the
    reference returns them) against the reference's; ``replays`` are losses
    of the first steps again after restores.  ``worst``, when given, gets
    the index of the leaf each per-leaf number came from."""
    want = ref["loss"][:REFERENCE_STEPS]
    losses = [prog["loss"][:REFERENCE_STEPS], *replays]
    loss = [abs(p - r) / abs(r) for seq in losses for p, r in zip(seq, want)]
    if len(prog["loss"]) < len(want):
        loss.append(math.inf)
    grad_ref = ref["grad_norm"]
    med = statistics.median(grad_ref) if grad_ref else 0.0
    moved = [g >= NO_GRADIENT * med for g in grad_ref]
    every = [True] * len(grad_ref)
    leaf = {
        "grad_gap": _leaf_gap(prog["grad_norm"], grad_ref, every),
        "grad_diff": _leaf_gap(ref.get("grad_diff_norm", []),
                               [0.0] * len(grad_ref), every, grad_ref),
        "change_gap": _leaf_gap(prog["change_norm"], ref["change_norm"], moved),
    }
    if worst is not None:
        worst.update({k: i for k, (_, i) in leaf.items()})
    return {"loss_gap": max(loss), **{k: g for k, (g, _) in leaf.items()}}


def numbers(run, ref: dict, worst: Optional[dict] = None) -> Dict[str, float]:
    """Every number compared, from the run's readings and the reference's."""
    out = gaps({"loss": run.losses, "grad_norm": run.grad_norm,
                "change_norm": run.change_norm}, ref, run.replay_losses, worst)
    if run.traffic.get("faults"):
        injected = [f for f in run.faults if f["injected"]]
        out["restore_mismatch"] = float(sum(run.restore_mismatch))
        out["restores_missing"] = float(max(0, len(injected) - len(run.restore_mismatch)))
    out["shm_left"] = float(len(run.shm_left))
    return out


def judge(values: Dict[str, float],
          limits: Dict[str, float]) -> Tuple[bool, Dict[str, dict]]:
    """(correct, {name: {"value", "limit"}}): correct when every number is
    at most its limit (a NaN or a missing limit is not)."""
    compared = {}
    for name, value in values.items():
        limit = 0.0 if name in EXACT else limits.get(name)
        compared[name] = {"value": value if math.isfinite(value) else None,
                          "limit": limit}
    ok = all(c["limit"] is not None and c["value"] is not None
             and c["value"] <= c["limit"] for c in compared.values())
    return ok, compared
