"""Checkpointing of the port: async global saves of a tree of tensors.

The counterpart of ``tpu_resiliency/checkpointing``, with
``dcp_compat.py`` (``torch.distributed.checkpoint`` interop) in the place of
``orbax_compat.py``.  ``local/`` holds the
node-local checkpoints with peer replication, and
``async_ckpt/peer_source.py`` sources a global restore from peers' memory.
The on-disk format is the JAX package's (shard files, per-chunk crc rows,
``metadata.json``), so a checkpoint written by either package restores in
the other, bit for bit.

- The device snapshot is a ``copy_`` of every tensor leaf into a reused
  ring slot on the trainer's stream; a stager thread fingerprints every
  leaf on the card in one launch per save (``async_ckpt/device_digest.py``,
  a hand-written CUDA kernel), and copies the shards that changed since the committed
  baseline to the host, on a copy stream, into page-locked POSIX shared
  memory (``async_ckpt/staging.py``).
- A plain worker subprocess (``async_ckpt/worker_main.py``) writes the
  shards from shared memory.  Its import chain holds no ``torch``: this
  package's ``__init__`` files import nothing that does, and the
  checkpointer and loader below load on first use.
"""

from .async_ckpt.core import AsyncCallsQueue, AsyncRequest
from .integrity import (
    CheckpointCorruptError,
    ChunkReader,
    read_verified_blob,
    read_verified_shard,
    verify_blob,
    verify_blob_file,
)

_LAZY = {"AsyncCheckpointer", "load_checkpoint"}


def __getattr__(name):
    # the checkpointer imports torch; the writer process imports this
    # package and must not
    if name in _LAZY:
        from .async_ckpt import checkpointer

        return getattr(checkpointer, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "AsyncCallsQueue",
    "AsyncRequest",
    "AsyncCheckpointer",
    "load_checkpoint",
    "CheckpointCorruptError",
    "ChunkReader",
    "read_verified_blob",
    "read_verified_shard",
    "verify_blob",
    "verify_blob_file",
]
