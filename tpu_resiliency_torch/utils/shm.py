"""Shared-memory helpers with explicit lifecycle ownership.

``multiprocessing.shared_memory`` registers every segment with the
``resource_tracker``, which (a) double-unlinks segments that a peer process
already cleaned up — the ``resource_tracker: '/psm_…': No such file``
warning spam — and (b) tears segments down when the FIRST tracking process
exits, even if a sibling still uses them.  This framework owns segment
lifecycle explicitly (creator unlinks; the shm janitor reaps crash debris),
so segments are untracked on create/attach.  Python 3.13 grew
``track=False`` for exactly this; this helper covers 3.12.
"""

from __future__ import annotations

from multiprocessing import resource_tracker, shared_memory


def untrack(shm: shared_memory.SharedMemory) -> None:
    try:
        resource_tracker.unregister(shm._name, "shared_memory")  # noqa: SLF001
    except (KeyError, ValueError, OSError):
        pass


def create_shm(size: int, name: str | None = None) -> shared_memory.SharedMemory:
    shm = shared_memory.SharedMemory(create=True, size=max(1, size), name=name)
    untrack(shm)
    return shm


def attach_shm(name: str) -> shared_memory.SharedMemory:
    shm = shared_memory.SharedMemory(name=name)
    untrack(shm)
    return shm


def unlink_shm(shm: shared_memory.SharedMemory) -> None:
    """Unlink an UNTRACKED segment without the double-unregister.

    ``SharedMemory.unlink()`` also unregisters from the resource tracker;
    for a segment we already untracked that second unregister makes the
    tracker process print a KeyError.  Unlink the POSIX name directly."""
    try:
        shared_memory._posixshmem.shm_unlink(shm._name)  # noqa: SLF001
    except (FileNotFoundError, OSError, AttributeError):
        pass
