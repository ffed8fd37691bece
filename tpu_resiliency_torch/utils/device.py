"""The one rule for where the port runs.

Every entry point takes ``device=None``, which means the CUDA card.  The
CPU is used only when the caller passes ``device="cpu"``, as the tests do.
Without a card and without that explicit choice, an entry point raises: the
port never drifts to the CPU on its own.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → the current CUDA device; ``"cpu"`` → the CPU.  Raises
    RuntimeError for CUDA without a card, ValueError for anything else."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use a CUDA device or 'cpu'")
    return dev
