"""The port's dp x tp sharded train step (``mesh=``) against the JAX
package's on the same mesh, on the CPU.

The JAX side is ``init_params`` / ``make_batch`` / ``make_train_step`` with
``mesh=`` on a ``("data", "model")`` mesh of (2, 2) over four of the CPU
devices ``tests/conftest.py`` provides.  The port side is four gloo ranks
(subprocesses that import only torch, numpy and the port, spawned once for
the module) on a (2, 2) ``DeviceMesh``: each takes the JAX initial weights
through ``params_from_jax(mesh=)``, its rows of the same batch through
``make_batch(mesh=)``, and trains two steps.  The configuration is the
dryrun's (``__graft_entry__.py::dryrun_multichip``: vocab 512, d_model 128,
4 heads, 2 layers, d_ff 256, max_seq 64), f32, batch 2 * dp x 64.

Tolerances are those of ``tests/test_torch_transformer.py``, and for the
same reasons: the loss before and after two steps to abs 1e-5; each rank's
local shard of every gradient to rtol 1e-4 with atol 1e-6 * max|g| of the
leaf; the one-step parameters to rtol 1e-4 / atol 1e-6 outside the
elements whose first Adam step is the sign of rounding noise (|g| below
1e-3 of the leaf's largest, at most 5% of a leaf).  A (1, 1) mesh in one
process gives the unsharded route's losses and parameters exactly.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from tpu_resiliency.models import transformer as jt
from tpu_resiliency.parallel.mesh import make_mesh as jax_make_mesh
from tpu_resiliency_torch.models import transformer as tt
from tpu_resiliency_torch.parallel import init_distributed, make_mesh
from tpu_resiliency_torch.parallel import tensor_parallel as tp_mod
from tpu_resiliency_torch.utils import tree as ttree

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
KW = dict(vocab=512, d_model=128, n_heads=4, n_layers=2, d_ff=256, max_seq=64)
DP, TP = 2, 2
WORLD = DP * TP
BATCH, SEQ = 2 * DP, 64
LR = 1e-2

# one rank of the gloo world: imports only torch, numpy and the port
_RANK_SCRIPT = r"""
import json, sys
import numpy as np
sys.path.insert(0, sys.argv[1])
import torch
import torch.distributed as dist
from tpu_resiliency_torch.models import transformer as tt
from tpu_resiliency_torch.parallel import dp_tp, init_distributed, make_mesh
rank, world, url, src, out = (int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                              sys.argv[5], sys.argv[6])
kw, dp, tp, batch_size, seq, lr = json.loads(sys.argv[7])
init_distributed(init_method=url, world_size=world, rank=rank, device="cpu")
mesh = make_mesh(("data", "model"), (dp, tp), device="cpu")
ax = dp_tp(mesh)
cfg = tt.TransformerConfig(**kw)
with np.load(src) as f:
    flat = dict(f)
tree = {k: flat[k] for k in ("embed", "pos", "ln_f_scale")}
tree["layers"] = [{k.split(".")[2]: v for k, v in flat.items()
                   if k.startswith(f"layers.{i}.")} for i in range(cfg.n_layers)]
params = tt.params_from_jax(tree, cfg, mesh=mesh)
opt = tt.init_opt_state(params)
batch = tt.make_batch(cfg, batch_size, seq, mesh=mesh)
step = tt.make_train_step(cfg, lr=lr, mesh=mesh)
params, opt, first = step(params, opt, batch)
arrays = {}
for name, p in params.named_parameters():
    arrays["grad." + name] = p.grad.numpy().copy()
    arrays["step." + name] = p.detach().numpy().copy()
params, opt, second = step(params, opt, batch)
after = tt.loss_fn(params, batch, cfg).detach()
np.savez(out, **arrays)
bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
       or m == "tpu_resiliency" or m.startswith("tpu_resiliency.")]
print(json.dumps({"rank": rank, "coord": [ax.dp_index, ax.tp_index],
                  "rows": int(batch[0].shape[0]),
                  "losses": [float(first), float(second), float(after)],
                  "foreign_modules": bad}), flush=True)
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _named(tree):
    """The JAX parameter tree as ``{port parameter name: array}``."""
    out = {k: np.asarray(tree[k]) for k in ("embed", "pos", "ln_f_scale")}
    for i, layer in enumerate(tree["layers"]):
        for k, v in layer.items():
            out[f"layers.{i}.{k}"] = np.asarray(v)
    return out


def _split_dims(cfg):
    """Parameter name -> the dimension the JAX ``_specs`` put on "model"."""
    spec_tree = jt._specs(cfg)
    dims = {}
    for k in ("embed", "pos", "ln_f_scale"):
        dims[k] = _model_dim(spec_tree[k])
    for i, layer in enumerate(spec_tree["layers"]):
        for k, spec in layer.items():
            dims[f"layers.{i}.{k}"] = _model_dim(spec)
    return dims


def _model_dim(spec):
    return next((d for d, ax in enumerate(spec) if ax == "model"), None)


def _box(full, dim, tp_index):
    if dim is None:
        return full
    n = full.shape[dim] // TP
    sl = [slice(None)] * full.ndim
    sl[dim] = slice(tp_index * n, (tp_index + 1) * n)
    return full[tuple(sl)]


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    cfg = jt.TransformerConfig(**KW)
    mesh = jax_make_mesh(("data", "model"), (DP, TP), devices=jax.devices()[:WORLD])
    params = jt.init_params(cfg, mesh=mesh)
    tree0 = _np_tree(params)
    batch = jt.make_batch(cfg, BATCH, SEQ, mesh=mesh)
    _, grads = jax.value_and_grad(lambda p: jt.loss_fn(p, batch, cfg, mesh))(params)
    grads = _np_tree(grads)
    step = jt.make_train_step(cfg, mesh=mesh, lr=LR)
    p1, o1, first = step(params, jt.init_opt_state(params), batch)
    one = _np_tree(p1)
    p2, _, second = step(p1, o1, batch)
    after = jt.loss_fn(p2, batch, cfg, mesh)
    src = tmp_path_factory.mktemp("mesh") / "params0.npz"
    np.savez(src, **_named(tree0))
    return {
        "cfg": cfg, "tree0": tree0, "src": str(src),
        "losses": [float(first), float(second), float(after)],
        "grads": _named(grads), "step": _named(one), "dims": _split_dims(cfg),
    }


@pytest.fixture(scope="module")
def port_ranks(jax_run, tmp_path_factory):
    out = tmp_path_factory.mktemp("ranks")
    url = f"tcp://127.0.0.1:{_free_port()}"
    args = json.dumps([KW, DP, TP, BATCH, SEQ, LR])
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _RANK_SCRIPT, REPO, str(r), str(WORLD), url,
             jax_run["src"], str(out / f"rank{r}.npz"), args],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO,
            env=dict(os.environ, OMP_NUM_THREADS="1"),
        )
        for r in range(WORLD)
    ]
    results = []
    try:
        for p in procs:
            stdout, err = p.communicate(timeout=180)
            assert p.returncode == 0, err[-3000:]
            results.append(json.loads(stdout.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    results.sort(key=lambda r: r["rank"])
    for r in results:
        with np.load(out / f"rank{r['rank']}.npz") as f:
            r["arrays"] = dict(f)
    return results


def test_mesh_losses_match_jax(jax_run, port_ranks):
    """Loss of the first and second step and after two steps, abs 1e-5, on
    every rank; each rank sits at its (data, model) coordinate with its
    rows of the batch, and imports neither JAX nor the JAX package."""
    for r in port_ranks:
        assert not r["foreign_modules"], r["foreign_modules"]
        assert r["coord"] == [r["rank"] // TP, r["rank"] % TP]
        assert r["rows"] == BATCH // DP
        for got, want in zip(r["losses"], jax_run["losses"]):
            assert np.isfinite(got)
            assert abs(got - want) < 1e-5, (r["rank"], r["losses"], jax_run["losses"])
    assert jax_run["losses"][2] < jax_run["losses"][0]


def test_mesh_grads_match_jax(jax_run, port_ranks):
    """Each rank's local shard of every gradient (dp-averaged) against its
    box of the JAX gradient on the same mesh."""
    for r in port_ranks:
        tp_index = r["rank"] % TP
        for name, full in jax_run["grads"].items():
            dim = jax_run["dims"][name]
            want = _box(full, dim, tp_index)
            got = r["arrays"]["grad." + name]
            assert got.shape == want.shape, (r["rank"], name)
            np.testing.assert_allclose(
                got, want, rtol=1e-4, atol=1e-6 * float(np.abs(full).max()),
                err_msg=f"rank {r['rank']} {name}")


def test_mesh_one_step_params_match_jax(jax_run, port_ranks):
    """Each rank's local shard of every parameter after one step."""
    for r in port_ranks:
        tp_index = r["rank"] % TP
        for name, full in jax_run["step"].items():
            dim = jax_run["dims"][name]
            g_full = jax_run["grads"][name]
            noisy = _box(np.abs(g_full) < 1e-3 * np.abs(g_full).max(), dim, tp_index)
            want = _box(full, dim, tp_index)
            got = r["arrays"]["step." + name]
            assert noisy.mean() < 0.05, f"{name}: {noisy.mean():.3%} excluded"
            np.testing.assert_allclose(got[~noisy], want[~noisy], rtol=1e-4,
                                       atol=1e-6, err_msg=f"rank {r['rank']} {name}")
            assert np.abs(got - want).max() <= 2.5 * LR


def test_mesh_1x1_is_the_unsharded_route(jax_run):
    """A (1, 1) mesh in one process issues no collective and trains exactly
    as the unsharded module: equal losses and parameters after three steps;
    its state tree holds DTensors over the live parameters."""
    from torch.distributed.tensor import DTensor

    init_distributed(device="cpu")
    mesh = make_mesh(("data", "model"), (1, 1), device="cpu")
    cfg = tt.TransformerConfig(**KW)
    runs = {}
    # the embedding's backward accumulates in a thread-dependent order
    # unless deterministic algorithms are on (the same holds on the card)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        for key, m in (("plain", None), ("mesh", mesh)):
            params = tt.params_from_jax(jax_run["tree0"], cfg, device="cpu", mesh=m)
            opt = tt.init_opt_state(params)
            batch = tt.make_batch(cfg, BATCH, SEQ, device="cpu", mesh=m)
            step = tt.make_train_step(cfg, lr=LR, mesh=m)
            losses = []
            for _ in range(3):
                params, opt, loss = step(params, opt, batch)
                losses.append(float(loss))
            runs[key] = (losses, params, opt)
    finally:
        torch.use_deterministic_algorithms(was)
    assert runs["mesh"][0] == runs["plain"][0]
    for (n, a), b in zip(runs["plain"][1].named_parameters(),
                         runs["mesh"][1].parameters()):
        assert torch.equal(a, b), n
    tree = tt.state_tree(runs["mesh"][1], runs["mesh"][2])
    embed = tree["params"]["embed"]
    assert isinstance(embed, DTensor) and embed.shape == (KW["vocab"], KW["d_model"])
    assert embed.to_local().data_ptr() == runs["mesh"][1].embed.data_ptr()
    assert not isinstance(tree["opt"]["count"], DTensor)
    # a DTensor is one leaf of the tree, under the JAX path of its leaf
    pairs = dict(ttree.flatten_with_path(tree)[0])
    assert len(pairs) == 3 * 19 + 1 and pairs["['params']['embed']"] is embed


def test_tensor_parallel_ops_over_one_rank_are_the_identity():
    """Over a group of one rank each operator returns its input itself (no
    collective, no autograd node); the (1, 1) route above rests on it."""
    init_distributed(device="cpu")
    import torch.distributed as dist

    group = dist.new_group([0])
    x = torch.randn(3, 4, requires_grad=True)
    for op in (tp_mod.copy_to_tp, tp_mod.reduce_from_tp, tp_mod.gather_from_tp,
               tp_mod.mean_over):
        assert op(x, group) is x
        assert op(x, None) is x
