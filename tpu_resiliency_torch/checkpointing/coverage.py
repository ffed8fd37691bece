"""Interval/volume coverage accounting over shard index boxes.

Restore-side coverage used to be proven with a full-size boolean array per
leaf (``covered = np.zeros(global_shape, dtype=bool)``), which doubles the
peak host memory of restoring a 1 GiB leaf just to answer "do the shards
tile the array?".  Shard indices are axis-aligned boxes — the question is
answerable from metadata alone by coordinate compression: project every box
boundary onto each axis, walk the resulting grid cells, and sum the volume
of cells inside at least one box.  Exact for arbitrary overlap, and the
grid is at most ``(2*shards)^ndim`` cells — shard counts are process
counts, so this is microseconds where the boolean array was gigabytes.
"""

from __future__ import annotations

import itertools
import math
from typing import Sequence, Tuple

#: a box is one (start, stop) half-open interval per dimension
Box = Sequence[Sequence[int]]


def union_volume(global_shape: Sequence[int], boxes: Sequence[Box]) -> int:
    """Exact element count of the union of ``boxes`` clipped to
    ``global_shape``.  Scalar shapes (``()``) count as volume 1 covered by
    any box."""
    dims = len(global_shape)
    if dims == 0:
        return 1 if boxes else 0
    clipped = []
    for box in boxes:
        if len(box) != dims:
            raise ValueError(
                f"box rank {len(box)} != shape rank {dims} ({box!r})"
            )
        cb = []
        for (a, b), size in zip(box, global_shape):
            a, b = max(0, int(a)), min(int(size), int(b))
            if a >= b:
                cb = None
                break
            cb.append((a, b))
        if cb is not None:
            clipped.append(cb)
    if not clipped:
        return 0
    cuts = [
        sorted({edge for box in clipped for edge in box[d]})
        for d in range(dims)
    ]
    cells_per_dim = [list(zip(c, c[1:])) for c in cuts]
    vol = 0
    for cell in itertools.product(*cells_per_dim):
        if any(
            all(a <= lo and hi <= b for (lo, hi), (a, b) in zip(cell, box))
            for box in clipped
        ):
            vol += math.prod(hi - lo for lo, hi in cell)
    return vol


def covers(global_shape: Sequence[int], boxes: Sequence[Box]) -> bool:
    """True iff the boxes jointly tile every element of ``global_shape``."""
    total = math.prod(int(s) for s in global_shape)
    if total == 0:
        return True  # nothing to cover
    return union_volume(global_shape, boxes) == total


def contiguous_offset(
    global_shape: Sequence[int], box: Box, itemsize: int
) -> Tuple[int, int] | None:
    """If ``box`` selects a C-contiguous byte range of the row-major array,
    return ``(byte_offset, byte_length)``; else None.

    Contiguous iff at most one dimension is partial and every dimension
    before it has extent 1 — the restore engine reads such shards straight
    into the leaf's final buffer with zero intermediate copies (whole-leaf
    shards and leading-axis sharding, the two dominant layouts)."""
    dims = len(global_shape)
    nbytes = math.prod(int(s) for s in global_shape) * itemsize
    partial = [
        d
        for d in range(dims)
        if not (int(box[d][0]) == 0 and int(box[d][1]) == int(global_shape[d]))
    ]
    if not partial:
        return 0, nbytes
    d = partial[0]
    if partial != [d] or math.prod(int(s) for s in global_shape[:d]) != 1:
        return None
    inner = math.prod(int(s) for s in global_shape[d + 1:]) * itemsize
    a, b = int(box[d][0]), int(box[d][1])
    return a * inner, (b - a) * inner
