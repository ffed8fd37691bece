"""Process-group bootstrap from the launcher-provided env.

The port of ``tpu_resiliency/parallel/distributed.py``.  The JAX package
calls ``jax.distributed.initialize`` with a coordinator derived from the
``TPURX_*`` env; here one process drives one device and the same env feeds
``torch.distributed.init_process_group``:

    from tpu_resiliency_torch.parallel import init_distributed
    device = init_distributed()          # idempotent

- NCCL on the card, gloo on the CPU (``device="cpu"``).  ``backend="gloo"``
  on a CUDA device lets several processes share one card (NCCL refuses two
  ranks on one GPU); gloo stages CUDA tensors through the host.  The
  backend is the caller's choice or this default, never picked silently.
- World size and rank come from ``TPURX_WORLD_SIZE`` / ``TPURX_RANK``
  (falling back to ``WORLD_SIZE`` / ``RANK``); the card is
  ``TPURX_LOCAL_RANK``.  The rendezvous address defaults to the store host
  at store port + 1, the JAX package's coordinator convention.
- A world of one process gets an in-memory ``HashStore`` instead of a TCP
  rendezvous, so the NCCL path also runs on a single card with no launcher.
- ``store=`` takes a c10d store for the rendezvous instead: the in-process
  restart ring passes a ``PrefixStore`` scoped to the iteration, so each
  iteration's world rendezvouses on fresh keys.
- :func:`reset` forgets the device after the abort ladder's
  ``AbortTorchDistributed`` destroyed the groups, so the next
  ``init_distributed`` builds a new world.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..utils import env as _env
from ..utils.device import DeviceLike, resolve_device
from ..utils.logging import get_logger

log = get_logger("distributed")

_device: Optional[torch.device] = None


def init_distributed(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    device: DeviceLike = None,
    store=None,
    backend: Optional[str] = None,
) -> torch.device:
    """Initialize the default process group from tpurx env (idempotent).
    Returns the device this process drives.  ``backend=None`` is NCCL on
    the card and gloo on the CPU; ``"nccl"`` or ``"gloo"`` is taken as
    given (NCCL on the CPU raises)."""
    global _device
    if dist.is_initialized():
        if _device is None:
            raise RuntimeError(
                "torch.distributed was initialized outside init_distributed"
            )
        return _device
    if world_size is None:
        world_size = _env.WORLD_SIZE.get()
    if rank is None:
        rank = _env.RANK.get()
    if device is None and torch.cuda.is_available():
        device = torch.device("cuda", _env.LOCAL_RANK.get())
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"NCCL needs a CUDA device, not {dev}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if world_size <= 1 and store is None:
        dist.init_process_group(
            backend, store=dist.HashStore(), rank=0, world_size=1
        )
    elif store is not None:
        log.info(
            "init_process_group(%s, store, world_size=%s, rank=%s)",
            backend, world_size, rank,
        )
        dist.init_process_group(
            backend, store=store, world_size=world_size, rank=rank
        )
    else:
        if init_method is None:
            host = _env.STORE_ADDR.get()
            port = _env.STORE_PORT.get() + 1
            init_method = f"tcp://{host}:{port}"
        log.info(
            "init_process_group(%s, %s, world_size=%s, rank=%s)",
            backend, init_method, world_size, rank,
        )
        dist.init_process_group(
            backend, init_method=init_method, world_size=world_size, rank=rank
        )
    _device = dev
    return dev


def reset() -> None:
    """Forget the default group's device: the groups were destroyed (the
    abort ladder's ``AbortTorchDistributed``), and the next
    :func:`init_distributed` builds a new world."""
    global _device
    _device = None


def default_device() -> torch.device:
    """The device of the default process group (set by
    :func:`init_distributed`)."""
    if _device is None:
        raise RuntimeError("call init_distributed() first")
    return _device
