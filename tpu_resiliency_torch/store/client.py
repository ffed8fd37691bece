"""Store client errors.

The port's copy of the error type of ``tpu_resiliency/store/client.py``,
which the async checkpoint core's cross-rank consensus
(``checkpointing/async_ckpt/core.py::store_sync_fn``) catches.  The
clients themselves come with the store slice (``ROADMAP.md`` Queue 1
item 5).
"""

from __future__ import annotations


class StoreError(RuntimeError):
    pass
