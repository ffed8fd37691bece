"""Plain float32 reference of the decoder the port trains, written afresh.

Plain PyTorch operations, no kernel of the port and nothing it made: the
weights come from ``portbench.weights`` (the benchmark's own draw from the
seed, cast to float32), the rows from ``portbench.feed``.  The block is the
port's (``tpu_resiliency_torch/models/transformer.py``), which departs from
GPT-2 as the configuration files list under ``assumed``:

- pre-norm RMSNorm (eps 1e-6, no bias) where GPT-2 has LayerNorm with bias;
- no bias on any linear layer;
- attention as a plain matmul with a causal mask (-1e9) and a softmax;
- tanh-approximated GELU, d_ff wide; learned positions; logits tied to the
  embedding; the loss the mean next-token NLL over every position;
- AdamW as the port writes it: ``mu = b1 mu + (1-b1) g``, ``nu = b2 nu +
  (1-b2) g^2``, bias correction by the step count, then ``m -= lr *
  (mu_hat / (sqrt(nu_hat) + eps) + wd * m)`` on every leaf, with the
  port's fixed constants below and the configuration's ``lr``.

Everything runs in float32 with TF32 off.  ``precision="fp8"`` is the
control: every matrix product takes its operands rounded to float8 e4m3
with a per-tensor scale (the usual fp8 recipe; gradients pass the rounding
straight through), the nearest precision below the bf16 the configurations
state.  A batch is processed in blocks of the configuration's
``reference_rows`` rows whose gradients add up, so the reference fits on
the card at the cell's batch once the program has been freed.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

from .. import feed, weights

FP8_MAX = 448.0  # largest finite float8 e4m3fn
# AdamW's constants, fixed in the port's make_train_step
B1, B2, EPS, WD = 0.9, 0.95, 1e-8, 0.01


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        amax = x.detach().abs().amax()
        scale = torch.where(amax > 0, FP8_MAX / amax, torch.ones_like(amax))
        return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale

    @staticmethod
    def backward(ctx, grad):
        return grad


def _matmuls(precision: str) -> Callable:
    if precision == "f32":
        return lambda eq, a, b: torch.einsum(eq, a, b)
    if precision == "fp8":
        return lambda eq, a, b: torch.einsum(eq, _Fp8.apply(a), _Fp8.apply(b))
    raise ValueError(f"precision must be f32 or fp8, got {precision!r}")


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x / torch.sqrt(torch.mean(x * x, dim=-1, keepdim=True) + 1e-6) * scale


def nll_sum(p: List[torch.Tensor], model: dict, tokens: torch.Tensor,
            targets: torch.Tensor, mm: Callable) -> torch.Tensor:
    """Summed next-token NLL of ``tokens`` -> ``targets`` under the leaves
    ``p`` (in ``weights.names`` order)."""
    B, T = tokens.shape
    H = model["n_heads"]
    hd = model["d_model"] // H
    embed, pos, ln_f = p[0], p[1], p[2]
    h = embed[tokens] + pos[:T][None]
    causal = torch.tril(torch.ones((T, T), dtype=torch.bool, device=h.device))
    for i in range(model["n_layers"]):
        wq, wk, wv, wo, w1, w2, ln1, ln2 = p[3 + 8 * i: 11 + 8 * i]
        x = _rmsnorm(h, ln1)
        q = mm("btd,de->bte", x, wq).reshape(B, T, H, hd)
        k = mm("btd,de->bte", x, wk).reshape(B, T, H, hd)
        v = mm("btd,de->bte", x, wv).reshape(B, T, H, hd)
        scores = mm("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        probs = torch.softmax(torch.where(causal, scores, -1e9), dim=-1)
        attn = mm("bhqk,bkhd->bqhd", probs, v).reshape(B, T, H * hd)
        h = h + mm("btd,de->bte", attn, wo)
        x = _rmsnorm(h, ln2)
        h = h + mm("btf,fd->btd", F.gelu(mm("btd,df->btf", x, w1),
                                         approximate="tanh"), w2)
    logits = mm("btd,vd->btv", _rmsnorm(h, ln_f), embed)
    return F.cross_entropy(logits.reshape(B * T, -1), targets.reshape(-1),
                           reduction="sum")


def train(config: dict, seed: int, steps: int = 3, precision: str = "f32",
          device="cuda", half_batch: bool = False, keep_grad: bool = False,
          against: Optional[List[torch.Tensor]] = None) -> Dict[str, list]:
    """Train the reference from the seed's weights for ``steps`` steps on the
    seed's batches 1..steps.  Returns the loss of each step, each leaf's
    gradient norm at step 1, and each leaf's change after the last step;
    with ``against`` (another run's step-1 gradients, leaf by leaf, on any
    device) each leaf's norm of the difference from it, and with
    ``keep_grad`` its own step-1 gradients on the host.

    ``half_batch`` plants a fault for the comparison's checks: each step
    takes only the first half of its rows, the mean over them."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model, lr = config["model"], config["lr"]
    rows, seq = config["batch"], config["seq"]
    block = config.get("reference_rows", 1)
    mm = _matmuls(precision)
    start = [w.to(torch.float32) for w in weights.leaves(
        weights.make(model, seed, device, getattr(torch, config["dtype"])))]
    p = [w.clone().requires_grad_(True) for w in start]
    mu = [torch.zeros_like(w) for w in start]
    nu = [torch.zeros_like(w) for w in start]
    out: Dict[str, list] = {"loss": []}
    for step in range(1, steps + 1):
        tokens, targets = feed.batch(model, seed, step, rows, seq, device)
        if half_batch:
            tokens, targets = tokens[: rows // 2], targets[: rows // 2]
        n = tokens.numel()
        total = 0.0
        for r in range(0, tokens.shape[0], block):
            part = nll_sum(p, model, tokens[r:r + block], targets[r:r + block], mm)
            (part / n).backward()
            total += float(part.detach())
        out["loss"].append(total / n)
        with torch.no_grad():
            if step == 1:
                out["grad_norm"] = torch.stack(
                    [torch.linalg.vector_norm(w.grad) for w in p]).tolist()
                if against is not None:
                    out["grad_diff_norm"] = torch.stack(
                        [torch.linalg.vector_norm(w.grad - a.to(w.grad.device))
                         for w, a in zip(p, against)]).tolist()
                if keep_grad:
                    out["grad"] = [w.grad.to("cpu", copy=True) for w in p]
            bc1, bc2 = 1 - B1 ** step, 1 - B2 ** step
            for w, m, v in zip(p, mu, nu):
                g = w.grad
                m.mul_(B1).add_(g, alpha=1 - B1)
                v.mul_(B2).addcmul_(g, g, value=1 - B2)
                w.sub_(lr * ((m / bc1) / (torch.sqrt(v / bc2) + EPS) + WD * w))
                w.grad = None
    with torch.no_grad():
        out["change_norm"] = torch.stack(
            [torch.linalg.vector_norm(w - w0) for w, w0 in zip(p, start)]).tolist()
    return out
