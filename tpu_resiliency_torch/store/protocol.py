"""Wire encoding helpers of the tpurx KV store.

The port's copy of the integer encoding in ``tpu_resiliency/store/protocol.py``:
integers travel as ASCII decimal bytes, so the store stays type-agnostic.
The frame codec and the opcodes come with the store slice (``ROADMAP.md``
Queue 1 item 5).
"""

from __future__ import annotations


def itob(value: int) -> bytes:
    return str(int(value)).encode()
