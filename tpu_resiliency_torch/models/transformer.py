"""Decoder-only transformer reference workload, in PyTorch.

The port of ``tpu_resiliency/models/transformer.py``: the workload the
resiliency stack guards in the smoke run and benchmarks, not part of the
resiliency capability surface.  It computes what the JAX model computes:

- bf16 weights and activations with an fp32 master copy in the optimizer on
  the card, f32 everywhere on the CPU (``TransformerConfig.resolved_dtype``);
- RMSNorm with the variance in f32 and the reciprocal cast to the working
  type before the multiplies; attention as plain matmul, causal mask and
  f32 softmax; tanh-approximated GELU (``jax.nn.gelu``'s default); output
  logits tied to the embedding; f32 log-softmax loss averaged over every
  position;
- AdamW (b1=0.9, b2=0.95, eps=1e-8, wd=0.01 on every leaf) written out as
  the JAX step writes it, not ``torch.optim.AdamW``, which orders the same
  arithmetic differently.

Parameters live in an ``nn.Module`` (:class:`Transformer`) whose attribute
names are the JAX pytree keys, so :func:`params_from_jax` maps one onto the
other.  Unlike the jitted JAX step, :func:`make_train_step` updates the
parameters and the optimizer state **in place** and returns the same
objects.  f32 matrix products on the card run in full f32:
:func:`init_params` sets ``torch.backends.cuda.matmul.allow_tf32 = False``.

Tensor-parallel sharding (the ``mesh=`` argument of the JAX functions)
comes with a later slice; this one trains on one device per process.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import DeviceLike, resolve_device
from ..utils.tree import leaves as tree_leaves


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab: int = 32000
    d_model: int = 512
    n_heads: int = 8
    n_layers: int = 4
    d_ff: int = 2048
    max_seq: int = 1024
    dtype: Any = None  # resolved to bf16 on CUDA, f32 on the CPU

    def resolved_dtype(self, device: torch.device) -> torch.dtype:
        if self.dtype is not None:
            return self.dtype
        return torch.bfloat16 if device.type == "cuda" else torch.float32


_LAYER_KEYS = ("wq", "wk", "wv", "wo", "w1", "w2", "ln1_scale", "ln2_scale")


class Layer(nn.Module):
    """One decoder block's weights (names as in the JAX pytree)."""

    def __init__(self, weights: Dict[str, torch.Tensor]):
        super().__init__()
        for key in _LAYER_KEYS:
            setattr(self, key, nn.Parameter(weights[key]))


class Transformer(nn.Module):
    """The parameter tree: ``embed``, ``pos``, ``layers[i]`` and
    ``ln_f_scale``, as in the JAX package."""

    def __init__(self, cfg: TransformerConfig, weights: Dict[str, Any]):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(weights["embed"])
        self.pos = nn.Parameter(weights["pos"])
        self.layers = nn.ModuleList(Layer(w) for w in weights["layers"])
        self.ln_f_scale = nn.Parameter(weights["ln_f_scale"])

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return forward(self, tokens, self.cfg)


def _place(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False


def init_params(
    cfg: TransformerConfig,
    generator: Optional[torch.Generator] = None,
    device: DeviceLike = None,
) -> Transformer:
    """Random parameters: normal weights scaled by 1/sqrt(fan_in) (0.02 for
    the embeddings), unit norm scales.  ``generator`` defaults to one on
    ``device`` seeded with 0.  The values differ from the JAX package's
    (another generator); tests pass the JAX values through
    :func:`params_from_jax` instead."""
    dev = resolve_device(device)
    _place(dev)
    g = generator if generator is not None else torch.Generator(dev).manual_seed(0)
    dt = cfg.resolved_dtype(dev)

    def dense(shape, scale=None):
        scale = scale if scale is not None else (1.0 / np.sqrt(shape[0]))
        w = torch.randn(shape, generator=g, device=g.device, dtype=torch.float32)
        return (w * scale).to(device=dev, dtype=dt)

    def ones(n):
        return torch.ones(n, device=dev, dtype=dt)

    d, f = cfg.d_model, cfg.d_ff
    weights: Dict[str, Any] = {
        "embed": dense((cfg.vocab, d), scale=0.02),
        "pos": dense((cfg.max_seq, d), scale=0.02),
        "layers": [],
        "ln_f_scale": ones(d),
    }
    for _ in range(cfg.n_layers):
        weights["layers"].append({
            "wq": dense((d, d)), "wk": dense((d, d)), "wv": dense((d, d)),
            "wo": dense((d, d)), "w1": dense((d, f)), "w2": dense((f, d)),
            "ln1_scale": ones(d), "ln2_scale": ones(d),
        })
    return Transformer(cfg, weights)


def params_from_jax(
    tree: Dict[str, Any], cfg: TransformerConfig, device: DeviceLike = None
) -> Transformer:
    """Map the JAX parameter pytree, converted to numpy (``embed``, ``pos``,
    ``layers[i].{wq,wk,wv,wo,w1,w2,ln1_scale,ln2_scale}``, ``ln_f_scale``),
    onto the port's module, in ``cfg``'s working type on ``device``."""
    dev = resolve_device(device)
    _place(dev)
    dt = cfg.resolved_dtype(dev)

    def leaf(a):
        host = torch.from_numpy(np.array(a, dtype=np.float32))
        return host.to(device=dev, dtype=dt)

    weights = {
        "embed": leaf(tree["embed"]),
        "pos": leaf(tree["pos"]),
        "layers": [{k: leaf(layer[k]) for k in _LAYER_KEYS}
                   for layer in tree["layers"]],
        "ln_f_scale": leaf(tree["ln_f_scale"]),
    }
    return Transformer(cfg, weights)


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    var = torch.mean(torch.square(x.to(torch.float32)), dim=-1, keepdim=True)
    return (x * torch.reciprocal(torch.sqrt(var + 1e-6)).to(x.dtype)) * scale


def forward(params: Transformer, tokens: torch.Tensor,
            cfg: TransformerConfig) -> torch.Tensor:
    """Causal LM forward -> logits [B, T, vocab] in the working type."""
    B, T = tokens.shape
    idx = tokens.long()
    h = params.embed[idx] + params.pos[:T][None, :, :]
    n_heads = cfg.n_heads
    head_dim = cfg.d_model // n_heads
    causal = torch.tril(torch.ones((T, T), dtype=torch.bool, device=h.device))

    for layer in params.layers:
        x = _rmsnorm(h, layer.ln1_scale)
        q = (x @ layer.wq).reshape(B, T, n_heads, head_dim)
        kk = (x @ layer.wk).reshape(B, T, n_heads, head_dim)
        v = (x @ layer.wv).reshape(B, T, n_heads, head_dim)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, kk)
        # the reference divides by np.sqrt(head_dim): a float64 numpy
        # scalar, which JAX does not treat as weakly typed, so the quotient
        # (and the mask below) is f32 whatever the working type
        scores = scores.to(torch.float32) / math.sqrt(head_dim)
        scores = torch.where(causal[None, None], scores, -1e9)
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        attn = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, T, cfg.d_model)
        h = h + attn @ layer.wo
        x = _rmsnorm(h, layer.ln2_scale)
        ff = F.gelu(x @ layer.w1, approximate="tanh")
        h = h + ff @ layer.w2

    h = _rmsnorm(h, params.ln_f_scale)
    return h @ params.embed.T  # weight tying


def loss_fn(params: Transformer, batch: Tuple[torch.Tensor, torch.Tensor],
            cfg: TransformerConfig) -> torch.Tensor:
    tokens, targets = batch
    logits = forward(params, tokens, cfg).to(torch.float32)
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    return nll.mean()


def init_opt_state(params: Transformer) -> Dict[str, Any]:
    """AdamW state: f32 ``mu``/``nu`` per parameter (in
    ``params.parameters()`` order), an int32 step ``count`` on the device,
    and an fp32 ``master`` copy when the parameters are low precision."""
    leaves = list(params.parameters())
    state: Dict[str, Any] = {
        "mu": [torch.zeros_like(p, dtype=torch.float32) for p in leaves],
        "nu": [torch.zeros_like(p, dtype=torch.float32) for p in leaves],
        "count": torch.zeros((), dtype=torch.int32, device=leaves[0].device),
    }
    if any(p.dtype != torch.float32 for p in leaves):
        # fp32 master copy: bf16 params would silently drop sub-ulp updates
        state["master"] = [p.detach().to(torch.float32).clone() for p in leaves]
    return state


def make_train_step(cfg: TransformerConfig, lr: float = 1e-3):
    """Train step: (params, opt_state, batch) -> (params, opt_state, loss).

    Forward, backward, then the AdamW update of the JAX step, leaf by leaf:
    ``mu2 = b1*mu + (1-b1)*g``, ``nu2 = b2*nu + (1-b2)*g^2``, bias
    correction by ``count``, then ``m2 = m - lr*(mu_hat/(sqrt(nu_hat)+eps)
    + wd*m)`` on the fp32 master (weight decay on every leaf, embeddings and
    norm scales included), cast down into the parameter.  Parameters and
    state are updated in place; the returned loss is a 0-d device tensor
    (reading it syncs the device)."""
    b1, b2, eps, wd = 0.9, 0.95, 1e-8, 0.01

    def step(params: Transformer, opt: Dict[str, Any], batch):
        params.zero_grad(set_to_none=True)
        loss = loss_fn(params, batch, cfg)
        loss.backward()
        with torch.no_grad():
            count = opt["count"] + 1
            cf = count.to(torch.float32)
            bc1 = 1 - b1 ** cf
            bc2 = 1 - b2 ** cf
            masters: List[Optional[torch.Tensor]] = opt.get("master") or [
                None] * len(opt["mu"])
            for p, mu, nu, master in zip(
                params.parameters(), opt["mu"], opt["nu"], masters
            ):
                g32 = p.grad.to(torch.float32)
                mu.copy_(b1 * mu + (1 - b1) * g32)
                nu.copy_(b2 * nu + (1 - b2) * torch.square(g32))
                mu_hat = mu / bc1
                nu_hat = nu / bc2
                # update in fp32 against the master copy; cast down only for
                # the compute params (sub-ulp updates accumulate in the master)
                m = master if master is not None else p.to(torch.float32)
                m2 = m - lr * (mu_hat / (torch.sqrt(nu_hat) + eps) + wd * m)
                if master is not None:
                    master.copy_(m2)
                p.copy_(m2)
            opt["count"] = count
        return params, opt, loss.detach()

    return step


def _nest(params: Transformer, leaves: List[torch.Tensor]) -> Dict[str, Any]:
    """``leaves`` (in ``params.parameters()`` order) as the JAX parameter
    tree: ``embed``, ``pos``, ``layers[i].{wq,...}``, ``ln_f_scale``."""
    tree: Dict[str, Any] = {"layers": [{} for _ in params.layers]}
    for (name, _), leaf in zip(params.named_parameters(), leaves):
        parts = name.split(".")
        if parts[0] == "layers":
            tree["layers"][int(parts[1])][parts[2]] = leaf
        else:
            tree[parts[0]] = leaf
    return tree


def state_tree(params: Transformer, opt: Dict[str, Any]) -> Dict[str, Any]:
    """The trainer's state as the JAX package's train-state tree:
    ``{"params": {embed, pos, layers[i].{wq,...}, ln_f_scale}, "opt": {mu,
    nu, count[, master]}}``, with ``mu``, ``nu`` and ``master`` shaped like
    ``params``.  The leaves are the live tensors (parameters detached, which
    shares their storage), not copies: a checkpoint snapshot reads them
    where the step updates them.  The layout needs no transposes, as in
    :func:`params_from_jax`."""
    opt_tree: Dict[str, Any] = {
        "mu": _nest(params, opt["mu"]),
        "nu": _nest(params, opt["nu"]),
        "count": opt["count"],
    }
    if "master" in opt:
        opt_tree["master"] = _nest(params, opt["master"])
    return {"params": _nest(params, [p.detach() for p in params.parameters()]),
            "opt": opt_tree}


def load_state_tree(params: Transformer, opt: Dict[str, Any],
                    tree: Dict[str, Any]) -> None:
    """Copy a restored :func:`state_tree`-shaped ``tree`` into the module
    and the optimizer state, in place (leaf counts and shapes must match)."""
    dsts, srcs = tree_leaves(state_tree(params, opt)), tree_leaves(tree)
    if len(dsts) != len(srcs):
        raise ValueError(f"state has {len(dsts)} leaves, tree has {len(srcs)}")
    with torch.no_grad():
        for dst, src in zip(dsts, srcs):
            if dst.shape != src.shape:
                raise ValueError(f"shape {tuple(src.shape)} != {tuple(dst.shape)}")
            dst.copy_(src)


def make_batch(cfg: TransformerConfig, batch_size: int, seq: int,
               seed: int = 0, device: DeviceLike = None):
    """(tokens, targets) int32 [batch, seq]: the JAX package's numpy draw
    (``default_rng(seed)``, ``targets = roll(tokens, -1)``), bit for bit."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, size=(batch_size, seq), dtype=np.int32)
    targets = np.roll(tokens, -1, axis=1)
    return torch.from_numpy(tokens).to(dev), torch.from_numpy(targets).to(dev)
