"""The training feed: the batch of each step, drawn on the device from the
seed and the step's index, so a step replayed after a restore sees the
rows it saw first, and every step's rows differ from every other's."""

from __future__ import annotations

from typing import Tuple

import torch

from .weights import generator

_FEED_STREAM = 0x5EED_1000


def batch(model: dict, seed: int, step: int, rows: int, seq: int,
          device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(tokens, targets), int64 ``[rows, seq]``: uniform token ids, the
    targets the tokens shifted by one."""
    g = generator(device, seed, _FEED_STREAM + int(step))
    x = torch.randint(0, model["vocab"], (rows, seq + 1), generator=g,
                      device=g.device)
    return x[:, :-1], x[:, 1:]
