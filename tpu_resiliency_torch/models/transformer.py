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

**Sharding** (``mesh=``, a ``("data", "model")`` DeviceMesh from
``parallel.make_mesh``).  Each process holds its box of every leaf, placed
as the JAX package's ``_specs``: ``wq``/``wk``/``wv``/``w1`` split by
columns and ``wo``/``w2`` by rows on ``"model"`` (heads contiguously: 8 heads
on 2 ranks are 4 each), ``embed`` by vocab rows on ``"model"``, the rest
replicated; the batch is split on ``"data"``.  GSPMD's collectives become
the explicit ones of ``parallel/tensor_parallel.py``: a masked embedding
lookup summed over ``"model"``, partial sums of the row-split matmuls
summed over it, and the vocab-split tied logits gathered whole, as the JAX
logits are constrained replicated.  The loss is the global mean (each
rank's local mean averaged over ``"data"``) and the gradients are averaged
over ``"data"`` before AdamW, which updates each local shard elementwise as
before.  The module keeps its mesh (``Transformer.mesh``), so
:func:`forward`, :func:`loss_fn` and :func:`state_tree` follow it; with
``mesh=None`` nothing of this runs, and a ``(1, 1)`` mesh issues no
collective and computes what the unsharded module computes, bit for bit.
On a mesh :func:`state_tree` wraps the local shards as ``DTensor`` leaves
(no copy, no collective) whose placements mirror ``_specs``: that is what
the sharded checkpoint saves and restores.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..ops.adamw import LeafTable, adamw_reference, fused_adamw
from ..parallel.mesh import DpTp, dp_tp
from ..telemetry import flight
from ..parallel.tensor_parallel import (
    copy_to_tp,
    gather_from_tp,
    mean_over,
    reduce_from_tp,
)
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

# The dimension of each parameter split over the "model" axis, or None for
# a replicated one: the JAX package's ``_specs``
# (``tpu_resiliency/models/transformer.py:45-60``).
_MODEL_DIM = {"embed": 0, "pos": None, "ln_f_scale": None,
              "wq": 1, "wk": 1, "wv": 1, "wo": 0, "w1": 1, "w2": 0,
              "ln1_scale": None, "ln2_scale": None}


def _model_dim(name: str) -> Optional[int]:
    """The split dimension of parameter ``name`` (``layers.0.wq`` or ``wq``)."""
    return _MODEL_DIM[name.rsplit(".", 1)[-1]]


def _box(key: str, shape: Tuple[int, ...], ax: Optional[DpTp]) -> Tuple[slice, ...]:
    """This rank's box of a full leaf of ``shape``: its ``1/tp`` slice of
    the split dimension (contiguous, in "model" coordinate order)."""
    box = [slice(None)] * len(shape)
    dim = _MODEL_DIM[key]
    if ax is not None and dim is not None:
        n = shape[dim] // ax.tp
        box[dim] = slice(ax.tp_index * n, (ax.tp_index + 1) * n)
    return tuple(box)


def _check_split(cfg: "TransformerConfig", ax: DpTp) -> None:
    for what, n in (("vocab", cfg.vocab), ("n_heads", cfg.n_heads),
                    ("d_ff", cfg.d_ff)):
        if n % ax.tp:
            raise ValueError(f"{what}={n} does not split over model={ax.tp}")


def _resolve(device: DeviceLike, mesh) -> torch.device:
    """The device of an entry point: ``device``, or with a mesh and no
    ``device`` the mesh's own device type (its CUDA card, or the CPU for a
    mesh built on the CPU).  A device that is not of the mesh's type
    raises; a CUDA mesh without a card raises (``resolve_device``)."""
    if mesh is None:
        return resolve_device(device)
    if device is None and mesh.device_type == "cpu":
        device = "cpu"
    dev = resolve_device(device)
    if dev.type != mesh.device_type:
        raise ValueError(f"device {dev} does not match the {mesh.device_type} mesh")
    return dev


class Layer(nn.Module):
    """One decoder block's weights (names as in the JAX pytree)."""

    def __init__(self, weights: Dict[str, torch.Tensor]):
        super().__init__()
        for key in _LAYER_KEYS:
            setattr(self, key, nn.Parameter(weights[key]))


class Transformer(nn.Module):
    """The parameter tree: ``embed``, ``pos``, ``layers[i]`` and
    ``ln_f_scale``, as in the JAX package."""

    def __init__(self, cfg: TransformerConfig, weights: Dict[str, Any],
                 mesh=None):
        super().__init__()
        self.cfg = cfg
        self.mesh = mesh  # the DeviceMesh the leaves are split over, or None
        self.embed = nn.Parameter(weights["embed"])
        self.pos = nn.Parameter(weights["pos"])
        self.layers = nn.ModuleList(Layer(w) for w in weights["layers"])
        self.ln_f_scale = nn.Parameter(weights["ln_f_scale"])

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return forward(self, tokens, self.cfg)


def _place(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False


def _axes(cfg: TransformerConfig, mesh) -> Optional[DpTp]:
    if mesh is None:
        return None
    ax = dp_tp(mesh)
    _check_split(cfg, ax)
    return ax


def init_params(
    cfg: TransformerConfig,
    generator: Optional[torch.Generator] = None,
    device: DeviceLike = None,
    mesh=None,
) -> Transformer:
    """Random parameters: normal weights scaled by 1/sqrt(fan_in) (0.02 for
    the embeddings), unit norm scales.  ``generator`` defaults to one on
    ``device`` seeded with 0.  The values differ from the JAX package's
    (another generator); tests pass the JAX values through
    :func:`params_from_jax` instead.  With ``mesh`` every full tensor is
    drawn as without one and this rank keeps its box, so every mesh starts
    from the unsharded module's weights."""
    dev = _resolve(device, mesh)
    ax = _axes(cfg, mesh)
    _place(dev)
    g = generator if generator is not None else torch.Generator(dev).manual_seed(0)
    dt = cfg.resolved_dtype(dev)

    def dense(key, shape, scale=None):
        scale = scale if scale is not None else (1.0 / np.sqrt(shape[0]))
        w = torch.randn(shape, generator=g, device=g.device, dtype=torch.float32)
        # a column box is a strided view: every leaf is its own dense tensor
        return (w * scale)[_box(key, shape, ax)].to(device=dev, dtype=dt).contiguous()

    def ones(n):
        return torch.ones(n, device=dev, dtype=dt)

    d, f = cfg.d_model, cfg.d_ff
    weights: Dict[str, Any] = {
        "embed": dense("embed", (cfg.vocab, d), scale=0.02),
        "pos": dense("pos", (cfg.max_seq, d), scale=0.02),
        "layers": [],
        "ln_f_scale": ones(d),
    }
    for _ in range(cfg.n_layers):
        weights["layers"].append({
            "wq": dense("wq", (d, d)), "wk": dense("wk", (d, d)),
            "wv": dense("wv", (d, d)), "wo": dense("wo", (d, d)),
            "w1": dense("w1", (d, f)), "w2": dense("w2", (f, d)),
            "ln1_scale": ones(d), "ln2_scale": ones(d),
        })
    return Transformer(cfg, weights, mesh)


def params_from_jax(
    tree: Dict[str, Any], cfg: TransformerConfig, device: DeviceLike = None,
    mesh=None,
) -> Transformer:
    """Map the JAX parameter pytree, converted to numpy (``embed``, ``pos``,
    ``layers[i].{wq,wk,wv,wo,w1,w2,ln1_scale,ln2_scale}``, ``ln_f_scale``),
    onto the port's module, in ``cfg``'s working type on ``device``.  The
    tree holds full arrays; with ``mesh`` this rank keeps its box of each."""
    dev = _resolve(device, mesh)
    ax = _axes(cfg, mesh)
    _place(dev)
    dt = cfg.resolved_dtype(dev)

    def leaf(key, a):
        a = np.asarray(a)
        host = torch.from_numpy(np.array(a[_box(key, a.shape, ax)], dtype=np.float32))
        return host.to(device=dev, dtype=dt)

    weights = {
        "embed": leaf("embed", tree["embed"]),
        "pos": leaf("pos", tree["pos"]),
        "layers": [{k: leaf(k, layer[k]) for k in _LAYER_KEYS}
                   for layer in tree["layers"]],
        "ln_f_scale": leaf("ln_f_scale", tree["ln_f_scale"]),
    }
    return Transformer(cfg, weights, mesh)


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    var = torch.mean(torch.square(x.to(torch.float32)), dim=-1, keepdim=True)
    return (x * torch.reciprocal(torch.sqrt(var + 1e-6)).to(x.dtype)) * scale


def _mesh_axes(params: Transformer, mesh) -> Optional[DpTp]:
    """The axes of the mesh ``params`` is split over; an explicit ``mesh``
    must be that one."""
    if mesh is not None and mesh is not params.mesh:
        raise ValueError("the parameters are not placed on this mesh")
    return None if params.mesh is None else dp_tp(params.mesh)


def _embed(table: torch.Tensor, idx: torch.Tensor,
           ax: Optional[DpTp]) -> torch.Tensor:
    """Rows ``idx`` of the embedding; over a vocab split on "model", each
    rank looks up the ids in its rows, zeroes the rest, and the partial
    lookups are summed."""
    if ax is None or ax.tp == 1:
        return table[idx]
    local = idx - ax.tp_index * table.shape[0]
    inside = (local >= 0) & (local < table.shape[0])
    rows = table[torch.where(inside, local, 0)].masked_fill(~inside[..., None], 0)
    return reduce_from_tp(rows, ax.tp_group)


def forward(params: Transformer, tokens: torch.Tensor,
            cfg: TransformerConfig, mesh=None) -> torch.Tensor:
    """Causal LM forward -> logits [B, T, vocab] in the working type (B is
    this rank's rows of the batch on a mesh; the logits are whole)."""
    ax = _mesh_axes(params, mesh)
    tp = None if ax is None else ax.tp_group
    B, T = tokens.shape
    idx = tokens.long()
    h = _embed(params.embed, idx, ax) + params.pos[:T][None, :, :]
    n_heads = cfg.n_heads // (1 if ax is None else ax.tp)
    head_dim = cfg.d_model // cfg.n_heads
    causal = torch.tril(torch.ones((T, T), dtype=torch.bool, device=h.device))

    for layer in params.layers:
        x = copy_to_tp(_rmsnorm(h, layer.ln1_scale), tp)
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
        attn = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(
            B, T, n_heads * head_dim)
        h = h + reduce_from_tp(attn @ layer.wo, tp)
        x = copy_to_tp(_rmsnorm(h, layer.ln2_scale), tp)
        ff = F.gelu(x @ layer.w1, approximate="tanh")
        h = h + reduce_from_tp(ff @ layer.w2, tp)

    h = _rmsnorm(h, params.ln_f_scale)
    return gather_from_tp(copy_to_tp(h, tp) @ params.embed.T, tp)  # weight tying


def loss_fn(params: Transformer, batch: Tuple[torch.Tensor, torch.Tensor],
            cfg: TransformerConfig, mesh=None) -> torch.Tensor:
    """Mean next-token NLL; on a mesh the global mean over every rank's
    rows (the local means averaged over "data")."""
    ax = _mesh_axes(params, mesh)
    tokens, targets = batch
    logits = forward(params, tokens, cfg).to(torch.float32)
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    loss = nll.mean()
    return loss if ax is None else mean_over(loss, ax.dp_group)


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


SP_ENQUEUE = flight.declare_span("step.enqueue")
SP_LOAD_TREE = flight.declare_span("state.load_tree")


def make_train_step(cfg: TransformerConfig, lr: float = 1e-3, mesh=None):
    """Train step: (params, opt_state, batch) -> (params, opt_state, loss).

    Forward, backward, then the AdamW update of the JAX step, leaf by leaf:
    ``mu2 = b1*mu + (1-b1)*g``, ``nu2 = b2*nu + (1-b2)*g^2``, bias
    correction by ``count``, then ``m2 = m - lr*(mu_hat/(sqrt(nu_hat)+eps)
    + wd*m)`` on the fp32 master (weight decay on every leaf, embeddings and
    norm scales included), cast down into the parameter.  On a card the
    update is one launch of kernel 4 over every leaf
    (:func:`~tpu_resiliency_torch.ops.adamw.fused_adamw`, the same results
    bit for bit); on the CPU it is the eager loop
    (:func:`~tpu_resiliency_torch.ops.adamw.adamw_reference`).  Parameters
    and state are updated in place; the returned loss is a 0-d device
    tensor (reading it syncs the device).

    With ``mesh`` the step takes parameters placed on that mesh
    (:func:`init_params` / :func:`params_from_jax` with the same ``mesh``)
    and this rank's rows of the batch (:func:`make_batch`): the loss is the
    global mean, each gradient is summed over "data" (the loss's mean over
    "data" already divided it), and the update runs on the local shards.
    The mesh's device is resolved here, so a CUDA mesh without a card
    raises before any step.  Each call is a ``step.enqueue`` flight span:
    the host's enqueue of the step, which nothing in it waits for."""
    b1, b2, eps, wd = 0.9, 0.95, 1e-8, 0.01
    hyper = dict(lr=lr, b1=b1, b2=b2, eps=eps, wd=wd)
    table = LeafTable()
    if mesh is not None:
        _resolve(None, mesh)
        _axes(cfg, mesh)

    def step(params: Transformer, opt: Dict[str, Any], batch):
        flight.record(SP_ENQUEUE.begin)
        try:
            return _step(params, opt, batch)
        finally:
            flight.record(SP_ENQUEUE.end)

    def _step(params: Transformer, opt: Dict[str, Any], batch):
        ax = _mesh_axes(params, mesh)
        params.zero_grad(set_to_none=True)
        loss = loss_fn(params, batch, cfg)
        loss.backward()
        with torch.no_grad():
            if ax is not None and ax.dp > 1:
                for p in params.parameters():
                    dist.all_reduce(p.grad, group=ax.dp_group)
            count = opt["count"] + 1
            cf = count.to(torch.float32)
            bc1 = 1 - b1 ** cf
            bc2 = 1 - b2 ** cf
            ps = list(params.parameters())
            args = (ps, [p.grad for p in ps], opt["mu"], opt["nu"],
                    opt.get("master"), bc1, bc2)
            if ps[0].is_cuda:
                fused_adamw(*args, **hyper, table=table)
            else:
                adamw_reference(*args, **hyper)
            opt["count"] = count
        return params, opt, loss.detach()

    return step


def _nest(params: Transformer, leaves: List[torch.Tensor]) -> Dict[str, Any]:
    """``leaves`` (in ``params.parameters()`` order) as the JAX parameter
    tree: ``embed``, ``pos``, ``layers[i].{wq,...}``, ``ln_f_scale``.  On a
    mesh each leaf is wrapped as a ``DTensor`` of its parameter's
    placement."""
    tree: Dict[str, Any] = {"layers": [{} for _ in params.layers]}
    for (name, _), leaf in zip(params.named_parameters(), leaves):
        if params.mesh is not None:
            leaf = _as_dtensor(leaf, params.mesh, _model_dim(name))
        parts = name.split(".")
        if parts[0] == "layers":
            tree["layers"][int(parts[1])][parts[2]] = leaf
        else:
            tree[parts[0]] = leaf
    return tree


def _as_dtensor(local: torch.Tensor, mesh, dim: Optional[int]):
    """``local`` as this rank's shard of a DTensor on ``mesh``: sharded on
    ``dim`` over "model" (replicated over "data"), or replicated.  No copy
    and no collective: the DTensor's local tensor shares ``local``'s
    storage."""
    placements = [Replicate()] * mesh.ndim
    shape = list(local.shape)
    if dim is not None:
        model = mesh.mesh_dim_names.index("model")
        placements[model] = Shard(dim)
        shape[dim] *= mesh.size(model)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def _local(t: Any) -> Any:
    """A DTensor's local shard; anything else as it is."""
    return t.to_local() if isinstance(t, DTensor) else t


def state_tree(params: Transformer, opt: Dict[str, Any]) -> Dict[str, Any]:
    """The trainer's state as the JAX package's train-state tree:
    ``{"params": {embed, pos, layers[i].{wq,...}, ln_f_scale}, "opt": {mu,
    nu, count[, master]}}``, with ``mu``, ``nu`` and ``master`` shaped like
    ``params``.  The leaves are the live tensors (parameters detached, which
    shares their storage), not copies: a checkpoint snapshot reads them
    where the step updates them.  The layout needs no transposes, as in
    :func:`params_from_jax`.  On a mesh the leaves of ``params``, ``mu``,
    ``nu`` and ``master`` are ``DTensor``s over the live local shards with
    the placements of the JAX ``_specs``; ``count`` stays a plain tensor
    (the same on every rank)."""
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
    and the optimizer state, in place (leaf counts and shapes must match;
    ``DTensor`` leaves are copied shard to local shard)."""
    dsts, srcs = tree_leaves(state_tree(params, opt)), tree_leaves(tree)
    if len(dsts) != len(srcs):
        raise ValueError(f"state has {len(dsts)} leaves, tree has {len(srcs)}")
    with flight.span(SP_LOAD_TREE), torch.no_grad():
        for dst, src in zip(dsts, srcs):
            if dst.shape != src.shape:
                raise ValueError(f"shape {tuple(src.shape)} != {tuple(dst.shape)}")
            _local(dst).copy_(_local(src))


def make_batch(cfg: TransformerConfig, batch_size: int, seq: int,
               seed: int = 0, device: DeviceLike = None, mesh=None):
    """(tokens, targets) int32 [batch, seq]: the JAX package's numpy draw
    (``default_rng(seed)``, ``targets = roll(tokens, -1)``), bit for bit.
    With ``mesh`` this rank gets its ``batch_size / dp`` rows of the same
    draw (the JAX batch's ``P("data", None)`` split)."""
    dev = _resolve(device, mesh)
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, size=(batch_size, seq), dtype=np.int32)
    targets = np.roll(tokens, -1, axis=1)
    if mesh is not None:
        ax = dp_tp(mesh)
        if batch_size % ax.dp:
            raise ValueError(f"batch {batch_size} does not split over data={ax.dp}")
        n = batch_size // ax.dp
        rows = slice(ax.dp_index * n, (ax.dp_index + 1) * n)
        tokens, targets = tokens[rows], targets[rows]
    return (torch.from_numpy(np.ascontiguousarray(tokens)).to(dev),
            torch.from_numpy(np.ascontiguousarray(targets)).to(dev))
