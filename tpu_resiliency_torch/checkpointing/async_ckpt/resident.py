"""Registry of shm-resident committed checkpoint generations.

The staging pool (``staging.py``) already double-buffers the last save's
bytes in POSIX shm; once the save COMMITS, those buffers are byte-identical
to the durable shard files and sealed by the same per-chunk crc32 index the
writer just persisted.  This module promotes that committed generation to a
first-class read source: at finalize, the checkpointer publishes a
:class:`ResidentCheckpoint` (shard metadata + per-chunk digests + live shm
buffer views), and ``load_checkpoint`` sources chunks from it ahead of disk
— a same-host in-process restart restores without opening a checkpoint
file, verifying every chunk against the committed index on the way out.

Lifecycle (the registry is the single source of truth for validity):

- **publish** happens once per committed save, per process.  Publishing a
  generation with a different plan signature invalidates every resident
  generation of the old layout — a layout change re-shapes the staging
  pool, so the old buffers are about to be reclaimed.
- **invalidate-on-reuse**: the checkpointer re-acquires pooled staging
  trees by plan signature; the moment a tree leaves the pool for a new
  save, any resident generation backed by it is unpublished (its buffers
  are about to be overwritten).
- **retire**: when the staging pool declines a tree (pool full, layout
  drained), ownership of the shm transfers to the registry; the backing
  segments are closed when the generation is invalidated instead of
  immediately, keeping the warm source alive across pool churn.

This publish/invalidate protocol is also the ordering backbone of the
device-digest D2H-skip path: ``StagedTree.content_id`` records which
committed save's bytes a pooled tree holds, and a delta save may skip a
shard's transfer only when the tree it reuses carries the *baseline*
generation's content — a skipped shard's segment is published resident
as-is, so the invalidate-on-reuse + content_id pair is what guarantees the
published bytes equal the device bytes the fingerprints vouched for.

Thread-safety: all registry mutation happens under one module lock; the
published buffer views are read-only from the restore engine's perspective
(writes only ever happen after an invalidate-on-reuse).
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, List, Optional, Tuple

from ...utils.logging import get_logger

log = get_logger("ckpt.resident")

_LOCK = threading.Lock()
_BY_DIR: Dict[str, "ResidentCheckpoint"] = {}


class ResidentCheckpoint:
    """One committed generation's shm-resident read source.

    ``shards`` maps ``(leaf_idx, shard_idx)`` to the committed index entry
    for that shard (``chunks``/``crc``/geometry, exactly what the process
    index recorded) plus a ``buf`` memoryview over the staged shm segment.
    ``complete`` marks a generation that covers the WHOLE tree (single
    process); partial generations still serve their own shards, overlaid on
    the disk metadata.
    """

    __slots__ = (
        "ckpt_dir", "save_id", "plan_sig", "process_index", "shards",
        "leaf_paths", "treedef_repr", "complete", "tree", "retired",
    )

    def __init__(
        self,
        ckpt_dir: str,
        save_id: str,
        plan_sig: str,
        process_index: int,
        shards: Dict[Tuple[int, int], Dict[str, Any]],
        leaf_paths: List[str],
        treedef_repr: str,
        complete: bool,
        tree: Any,
    ):
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        self.save_id = save_id
        self.plan_sig = plan_sig
        self.process_index = process_index
        self.shards = shards
        self.leaf_paths = leaf_paths
        self.treedef_repr = treedef_repr
        self.complete = complete
        self.tree = tree            # backing StagedTree (keeps shm mapped)
        self.retired = False        # True -> registry owns the tree's close

    def as_meta(self) -> Dict[str, Any]:
        """A ``metadata.json``-shaped dict synthesized from the resident
        index — lets the restore plan build without touching disk."""
        return {
            "format": "tpurx-ckpt-v1",
            "treedef": self.treedef_repr,
            "leaf_paths": list(self.leaf_paths),
            "num_processes": 1,
            "shards": [
                {**{k: v for k, v in s.items() if k != "buf"},
                 "process_index": self.process_index}
                for s in self.shards.values()
            ],
        }

    def buffers(self) -> Dict[Tuple[int, int], memoryview]:
        """(leaf_idx, shard_idx) -> read view of that shard's staged bytes."""
        return {
            key: s["buf"][: int(s["nbytes"])]
            for key, s in self.shards.items()
            if s.get("buf") is not None
        }


def publish(rc: ResidentCheckpoint) -> None:
    """Install ``rc`` as the resident generation for its directory; evict
    the directory's previous generation and — on layout change — every
    generation with a different plan signature."""
    evicted: List[ResidentCheckpoint] = []
    with _LOCK:
        for d in list(_BY_DIR):
            old = _BY_DIR[d]
            if d == rc.ckpt_dir or old.plan_sig != rc.plan_sig:
                evicted.append(_BY_DIR.pop(d))
        _BY_DIR[rc.ckpt_dir] = rc
    for old in evicted:
        _close_if_retired(old)
    log.debug("resident checkpoint published: %s (complete=%s, %d shards)",
              rc.ckpt_dir, rc.complete, len(rc.shards))


def lookup(ckpt_dir: str) -> Optional[ResidentCheckpoint]:
    with _LOCK:
        return _BY_DIR.get(os.path.abspath(ckpt_dir))


def invalidate(ckpt_dir: Optional[str] = None) -> None:
    """Unpublish one directory's generation (or every generation)."""
    with _LOCK:
        if ckpt_dir is None:
            evicted = list(_BY_DIR.values())
            _BY_DIR.clear()
        else:
            rc = _BY_DIR.pop(os.path.abspath(ckpt_dir), None)
            evicted = [rc] if rc is not None else []
    for rc in evicted:
        _close_if_retired(rc)


def invalidate_tree(tree: Any) -> None:
    """Unpublish every generation backed by ``tree`` WITHOUT closing it —
    the caller is about to reuse the buffers for a new save."""
    with _LOCK:
        for d in [d for d, rc in _BY_DIR.items() if rc.tree is tree]:
            _BY_DIR.pop(d)


def retire_tree(tree: Any) -> bool:
    """The staging pool is letting go of ``tree``.  If a resident
    generation still reads from it, take ownership (close at invalidate)
    and return True; else return False (caller closes)."""
    with _LOCK:
        owned = False
        for rc in _BY_DIR.values():
            if rc.tree is tree:
                rc.retired = True
                owned = True
        return owned


def _close_if_retired(rc: ResidentCheckpoint) -> None:
    if rc.retired and rc.tree is not None:
        try:
            rc.tree.close(unlink=True)
        except Exception:  # noqa: BLE001 - eviction is best-effort cleanup
            log.debug("resident tree close failed for %s", rc.ckpt_dir,
                      exc_info=True)
    rc.tree = None
    rc.shards = {}
