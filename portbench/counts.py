"""Operation and byte counts behind the roofline and utilization metrics,
and the card's published peaks.

Peaks are NVIDIA's data sheet for one H100 SXM (dense, no sparsity) at its
700 W limit.  A share is always the least time the card could take over
the time it took; the caller says what bounds it.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def matmul_params(model: dict) -> int:
    """Parameters that enter a matrix product: per layer the four attention
    projections and the two feed-forward matrices, plus the embedding once
    more as the tied output head."""
    d, f, layers = model["d_model"], model["d_ff"], model["n_layers"]
    return layers * (4 * d * d + 2 * d * f) + model["vocab"] * d


def train_flops_per_seq(model: dict, seq: int) -> int:
    """Model FLOPs of one training step on one sequence: 6 per matmul
    parameter per token (forward, and backward for inputs and weights),
    plus attention's two score products at 12 * layers * d * seq^2 (forward
    and backward, the causal half not taken off).  No recomputation is
    counted."""
    return (6 * matmul_params(model) * seq
            + 12 * model["n_layers"] * model["d_model"] * seq * seq)


def train_flops_per_step(model: dict, batch: int, seq: int) -> int:
    return batch * train_flops_per_seq(model, seq)


def local_max_bytes(n: int) -> int:
    """Kernel 1 (``quorum_max.cu``): n int32 ages read once, one int32
    written."""
    return 4 * n + 4


def local_max_bound_s(n: int) -> float:
    """The least time kernel 1 can take at n ages: it is bound by bytes (one
    compare per age is far below the card's integer rate)."""
    return local_max_bytes(n) / HBM_BYTES_PER_S
