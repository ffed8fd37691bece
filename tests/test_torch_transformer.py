"""The port's transformer (``tpu_resiliency_torch/models/transformer.py``)
against the JAX package, in f32 on the CPU.

Both packages start from the same parameters — JAX ``init_params`` pulled to
numpy and mapped onto the port's module by ``params_from_jax`` — and the
same ``make_batch`` draw.  Tolerances, and why:

- loss: abs 1e-5.  Both compute an f32 mean of 64 log-softmax terms near
  ln(256) ~ 5.5, whose ulp is 4.8e-7; different summation orders (XLA vs
  PyTorch matmul, softmax and mean kernels) move the last bits only.
- gradients: rtol 1e-4 with atol 1e-6 * max|g| per leaf — f32 backward
  through two layers, summed in another order.
- parameters after one AdamW step: the update is lr * mu_hat /
  (sqrt(nu_hat) + eps), which on the first step is about lr * sign(g); where
  |g| is tiny against max|g| that sign is rounding noise, so those elements
  are excluded (and counted: at most 5% of a leaf).  The rest agree to
  rtol 1e-4, atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_resiliency.models import transformer as jt
from tpu_resiliency_torch.models import transformer as tt

KW = dict(vocab=256, d_model=64, n_heads=4, n_layers=2, d_ff=128, max_seq=32)
CFG_J = jt.TransformerConfig(**KW)
CFG_T = tt.TransformerConfig(**KW)
LR = 1e-2

LEAVES = ["embed", "pos", "ln_f_scale"] + [
    f"layers.{i}.{k}" for i in range(KW["n_layers"])
    for k in ("wq", "wk", "wv", "wo", "w1", "w2", "ln1_scale", "ln2_scale")
]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _by_name(module):
    return dict(module.named_parameters())


@pytest.fixture(scope="module")
def both():
    """JAX loss, grads and one-step params; the same on the port."""
    params_j = jt.init_params(CFG_J, key=jax.random.PRNGKey(7))
    tree = _np_tree(params_j)
    batch_j = jt.make_batch(CFG_J, 2, 32, seed=3)
    batch_t = tt.make_batch(CFG_T, 2, 32, seed=3, device="cpu")
    loss_j, grads_j = jax.value_and_grad(
        lambda p: jt.loss_fn(p, batch_j, CFG_J))(params_j)
    new_j, _, _ = jt.make_train_step(CFG_J, lr=LR)(
        params_j, jt.init_opt_state(params_j), batch_j)

    params_t = tt.params_from_jax(tree, CFG_T, device="cpu")
    loss_t = tt.loss_fn(params_t, batch_t, CFG_T)
    loss_t.backward()
    grads_t = {n: p.grad.clone() for n, p in params_t.named_parameters()}
    params_t = tt.params_from_jax(tree, CFG_T, device="cpu")
    tt.make_train_step(CFG_T, lr=LR)(params_t, tt.init_opt_state(params_t), batch_t)
    return {
        "loss": (float(loss_j), float(loss_t.detach())),
        "grads": (_by_name(tt.params_from_jax(_np_tree(grads_j), CFG_T, device="cpu")),
                  grads_t),
        "step": (_by_name(tt.params_from_jax(_np_tree(new_j), CFG_T, device="cpu")),
                 _by_name(params_t)),
    }


@pytest.mark.parametrize("seed", [0, 1, 99])
def test_make_batch_bit_exact(seed):
    tok_j, tgt_j = jt.make_batch(CFG_J, 3, 17, seed=seed)
    tok_t, tgt_t = tt.make_batch(CFG_T, 3, 17, seed=seed, device="cpu")
    assert tok_t.dtype == tgt_t.dtype == torch.int32
    np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_j))
    np.testing.assert_array_equal(tgt_t.numpy(), np.asarray(tgt_j))


def test_loss_matches_jax(both):
    loss_j, loss_t = both["loss"]
    assert np.isfinite(loss_t)
    assert abs(loss_j - loss_t) < 1e-5, (loss_j, loss_t)


@pytest.mark.parametrize("leaf", LEAVES)
def test_grads_match_jax(both, leaf):
    g_j, g_t = (t[leaf].detach().numpy() for t in
                (both["grads"][0], both["grads"][1]))
    np.testing.assert_allclose(
        g_t, g_j, rtol=1e-4, atol=1e-6 * float(np.abs(g_j).max()))


@pytest.mark.parametrize("leaf", LEAVES)
def test_one_step_params_match_jax(both, leaf):
    g = both["grads"][0][leaf].detach().numpy()
    p_j = both["step"][0][leaf].detach().numpy()
    p_t = both["step"][1][leaf].detach().numpy()
    # elements whose first-step update is sign-of-rounding-noise: |g| below
    # 1e-3 of the leaf's largest gradient
    noisy = np.abs(g) < 1e-3 * np.abs(g).max()
    assert noisy.mean() < 0.05, f"{leaf}: {noisy.mean():.3%} excluded"
    np.testing.assert_allclose(p_t[~noisy], p_j[~noisy], rtol=1e-4, atol=1e-6)
    # the excluded ones still moved by at most one step of size ~lr
    assert np.abs(p_t - p_j).max() <= 2.5 * LR


def test_train_step_learns():
    """Five steps on a fixed batch lower the loss (memorization), as the
    JAX package's test requires."""
    params = tt.init_params(CFG_T, torch.Generator().manual_seed(0), device="cpu")
    opt = tt.init_opt_state(params)
    batch = tt.make_batch(CFG_T, 8, 32, device="cpu")
    step = tt.make_train_step(CFG_T, lr=1e-2)
    losses = []
    for _ in range(5):
        params, opt, loss = step(params, opt, batch)
        losses.append(float(loss))
    assert losses[-1] < losses[0]
    assert int(opt["count"]) == 5
    assert "master" not in opt  # f32 parameters need no master copy


def test_forward_shape_and_uniform_start():
    params = tt.init_params(CFG_T, torch.Generator().manual_seed(0), device="cpu")
    tokens, targets = tt.make_batch(CFG_T, 2, 32, device="cpu")
    logits = tt.forward(params, tokens, CFG_T)
    assert logits.shape == (2, 32, CFG_T.vocab)
    assert logits.dtype == torch.float32
    loss = float(tt.loss_fn(params, (tokens, targets), CFG_T).detach())
    assert abs(loss - np.log(CFG_T.vocab)) < 1.0  # random init ≈ uniform
    assert torch.equal(params(tokens), logits)


def test_init_params_deterministic_per_generator():
    a = tt.init_params(CFG_T, torch.Generator().manual_seed(5), device="cpu")
    b = tt.init_params(CFG_T, torch.Generator().manual_seed(5), device="cpu")
    c = tt.init_params(CFG_T, torch.Generator().manual_seed(6), device="cpu")
    assert torch.equal(a.embed, b.embed)
    assert not torch.equal(a.embed, c.embed)
    assert torch.equal(a.layers[1].ln2_scale, torch.ones(CFG_T.d_model))
    assert sum(p.numel() for p in a.parameters()) == sum(
        np.asarray(x).size for x in jax.tree_util.tree_leaves(jt.init_params(CFG_J)))


def test_bf16_keeps_fp32_master():
    cfg = tt.TransformerConfig(**KW, dtype=torch.bfloat16)
    params = tt.init_params(cfg, device="cpu")
    opt = tt.init_opt_state(params)
    assert params.embed.dtype == torch.bfloat16
    assert all(m.dtype == torch.float32 for m in opt["master"])
    step = tt.make_train_step(cfg, lr=1e-2)
    batch = tt.make_batch(cfg, 2, 32, device="cpu")
    _, opt, loss = step(params, opt, batch)
    assert np.isfinite(float(loss))
    # the compute params are the master rounded to bf16
    assert torch.equal(params.embed, opt["master"][0].to(torch.bfloat16))


def test_rmsnorm_and_gelu_match_jax():
    """Two details of the reference held on their own: RMSNorm casts the
    reciprocal to the working type before the multiplies, and GELU is the
    tanh form (``jax.nn.gelu``'s default).  f32, rtol 1e-6 (a few ulp)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    want = np.asarray(jt._rmsnorm(jnp.asarray(x), jnp.asarray(scale)))
    got = tt._rmsnorm(torch.from_numpy(x), torch.from_numpy(scale)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = torch.nn.functional.gelu(torch.from_numpy(x), approximate="tanh").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_resolved_dtype():
    assert CFG_T.resolved_dtype(torch.device("cpu")) == torch.float32
    assert CFG_T.resolved_dtype(torch.device("cuda", 0)) == torch.bfloat16
    pinned = tt.TransformerConfig(dtype=torch.float32)
    assert pinned.resolved_dtype(torch.device("cuda", 0)) == torch.float32
