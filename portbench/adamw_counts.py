"""Byte counts behind kernel 4's roofline (``ops/csrc/adamw.cu``, the step's
fused AdamW update): the least traffic of the update, whatever implements
it, so that no later design of the update can read above its bound."""

from __future__ import annotations

from portbench.counts import HBM_BYTES_PER_S, matmul_params


def model_params(model: dict) -> int:
    """Parameters of the decoder: those of :func:`counts.matmul_params`,
    plus per layer the two norm scales, and once the positions and the final
    norm scale."""
    norms_and_positions = 2 * model["n_layers"] + model["max_seq"] + 1
    return matmul_params(model) + norms_and_positions * model["d_model"]


def adamw_bytes(n_params: int) -> int:
    """The least traffic of one AdamW update of ``n_params`` parameters:
    read the gradient, mu, nu and the master, write mu, nu, the master and
    the parameter, 28 bytes a parameter for bf16 parameters with an f32
    master (and for f32 parameters without one)."""
    return 28 * n_params


def adamw_bound_s(n_params: int) -> float:
    """The least time of one AdamW update of ``n_params`` parameters: it is
    bound by bytes (about 30 flops a parameter are far below the card's
    rate)."""
    return adamw_bytes(n_params) / HBM_BYTES_PER_S


def adamw_bytes_per_step(model: dict) -> int:
    """:func:`adamw_bytes` of every parameter of the decoder."""
    return adamw_bytes(model_params(model))


def adamw_bound_s_per_step(model: dict) -> float:
    """:func:`adamw_bound_s` of every parameter of the decoder."""
    return adamw_bound_s(model_params(model))
