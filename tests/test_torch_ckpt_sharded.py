"""Sharded async checkpoints of the port's dp x tp state against the JAX
package's, on the CPU.

The mesh and configuration are those of ``tests/test_torch_mesh.py`` (the
dryrun's, f32, mesh (2, 2)).  The JAX side stages and saves its parameters
placed on a ``("data", "model")`` mesh of four CPU devices.  The port side
is four gloo ranks (subprocesses that import only torch, numpy and the
port, spawned once for the module) holding the same weights as ``DTensor``
leaves (``state_tree`` on a mesh).  They hold:

- (i) the owned and non-owned shard counts of the port's staging, summed
  over the ranks, equal the reference ``stage_pytree``'s on the JAX mesh,
  and non-owned > 0 as the dryrun asserts for dp > 1
  (``__graft_entry__.py:88-94``);
- (ii) a params checkpoint written by the four ranks restores in the JAX
  package onto the (2, 2) template bit for bit, with equivalent shardings
  (``__graft_entry__.py:104-108``);
- (iii) the JAX package's checkpoint restores into the port's DTensor
  templates bit for bit on every rank, with the template's placements;
- (iv) the two ``metadata.json`` shard lists agree as sets of (leaf path,
  box, owner, dtype, crc), the owner being the flat mesh index (device id
  in the JAX package, rank in the port);
- (v) the commit across ranks runs over the reference store server and
  over the port's (``AsyncCheckpointer(store=...)``);
- (vi) a full train state (params and opt, after a step) saves and
  restores port to port bit for bit, the warm (shm-resident) restore of a
  checkpoint written by several processes included.

The shard owner rule's exactly-once assertion raises the reference's
error text.  Everything bitwise: no tolerance.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.tree_util as jtu
import numpy as np
import pytest

from tpu_resiliency.checkpointing.async_ckpt import checkpointer as jckpt
from tpu_resiliency.checkpointing.async_ckpt import staging as jstaging
from tpu_resiliency.models import transformer as jt
from tpu_resiliency.parallel.mesh import make_mesh as jax_make_mesh
from tpu_resiliency.store import StoreServer as JaxStoreServer
from tpu_resiliency_torch.checkpointing.async_ckpt import staging as tstaging
from tpu_resiliency_torch.store import StoreServer

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
KW = dict(vocab=512, d_model=128, n_heads=4, n_layers=2, d_ff=256, max_seq=64)
DP, TP = 2, 2
WORLD = DP * TP

# one rank of the gloo world: imports only torch, numpy and the port
_RANK_SCRIPT = r"""
import json, os, sys
import numpy as np
sys.path.insert(0, sys.argv[1])
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from tpu_resiliency_torch.checkpointing.async_ckpt.checkpointer import (
    AsyncCheckpointer, load_checkpoint)
from tpu_resiliency_torch.checkpointing.async_ckpt.staging import stage_pytree
from tpu_resiliency_torch.models import transformer as tt
from tpu_resiliency_torch.parallel import init_distributed, make_mesh
from tpu_resiliency_torch.store import StoreClient
from tpu_resiliency_torch.utils.tree import flatten_with_path, leaves
rank, world, url = int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
cfg_args = json.loads(sys.argv[5])
root = cfg_args["root"]
init_distributed(init_method=url, world_size=world, rank=rank, device="cpu")
mesh = make_mesh(("data", "model"), tuple(cfg_args["mesh"]), device="cpu")
cfg = tt.TransformerConfig(**cfg_args["kw"])
with np.load(cfg_args["src"]) as f:
    flat = dict(f)
tree = {k: flat[k] for k in ("embed", "pos", "ln_f_scale")}
tree["layers"] = [{k.split(".")[2]: v for k, v in flat.items()
                   if k.startswith(f"layers.{i}.")} for i in range(cfg.n_layers)]
params = tt.params_from_jax(tree, cfg, mesh=mesh)
opt = tt.init_opt_state(params)
ptree = tt.state_tree(params, opt)["params"]
out = {"rank": rank}

def same(a, b):
    return (isinstance(b, DTensor) and a.shape == b.shape
            and a.placements == b.placements
            and torch.equal(a.to_local(), b.to_local()))

# (i) the owner split of this rank's staging
staged = stage_pytree(ptree, process_index=rank)
out["owned"] = sum(1 for s in staged.shards if s.replica_owner)
out["non_owned"] = sum(1 for s in staged.shards if not s.replica_owner)
out["boxes"] = [[s.leaf_idx, [list(b) for b in s.index], s.replica_owner]
                for s in staged.shards]
staged.close()

# (ii, v) the params committed over each store server
cks = {}
for tag in ("ref", "port"):
    client = StoreClient("127.0.0.1", cfg_args[tag + "_port"], timeout=60.0)
    ck = cks[tag] = AsyncCheckpointer(store=client, persistent_worker=False)
    ck.async_save(ptree, os.path.join(root, "params_" + tag), {"iteration": 0})
    ck.finalize_all(timeout=120.0)
dist.barrier()

# (iii) the JAX package's checkpoint, and the port's own, into DTensors
for name in ("jax", "params_port"):
    got = load_checkpoint(os.path.join(root, name), ptree, resident=False)
    pairs = list(zip(leaves(ptree), leaves(got)))
    out["restored_" + name] = len(pairs) == 19 and all(same(a, b) for a, b in pairs)

# (vi) a full train state after one step, port to port
batch = tt.make_batch(cfg, 2 * mesh.size(0), 64, mesh=mesh)
params, opt, _ = tt.make_train_step(cfg, lr=1e-2, mesh=mesh)(params, opt, batch)
state = tt.state_tree(params, opt)
copies = [t.to_local().clone() if isinstance(t, DTensor) else t.clone()
          for t in leaves(state)]
# the same checkpointer: its commits are numbered per instance on a store
ck = cks["port"]
ck.async_save(state, os.path.join(root, "state"), {"iteration": 1})
ck.finalize_all(timeout=120.0)
dist.barrier()
stats = {}
got = load_checkpoint(os.path.join(root, "state"), state, stats=stats)
def local(t):
    return t.to_local() if isinstance(t, DTensor) else t
out["state_leaves"] = len(copies)
out["state_restored"] = all(
    torch.equal(local(g), c) and type(g) is type(t)
    for g, c, t in zip(leaves(got), copies, leaves(state)))
out["state_bytes_shm"] = stats.get("bytes_shm", 0)
with torch.no_grad():
    for t in leaves(state):
        local(t).zero_()
tt.load_state_tree(params, opt, got)
out["loaded_back"] = all(torch.equal(local(t), c)
                         for t, c in zip(leaves(tt.state_tree(params, opt)), copies))
for c in cks.values():
    c.close()
bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
       or m == "tpu_resiliency" or m.startswith("tpu_resiliency.")]
out["foreign_modules"] = bad
print(json.dumps(out), flush=True)
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _named(tree):
    out = {k: np.asarray(tree[k]) for k in ("embed", "pos", "ln_f_scale")}
    for i, layer in enumerate(tree["layers"]):
        for k, v in layer.items():
            out[f"layers.{i}.{k}"] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The JAX side, then the four port ranks, then the JAX restores of the
    port's checkpoints."""
    root = tmp_path_factory.mktemp("sharded")
    cfg = jt.TransformerConfig(**KW)
    mesh = jax_make_mesh(("data", "model"), (DP, TP), devices=jax.devices()[:WORLD])
    params = jt.init_params(cfg, mesh=mesh)
    src = root / "params0.npz"
    np.savez(src, **_named(jtu.tree_map(np.asarray, params)))
    staged = jstaging.stage_pytree(params)
    jax_counts = (sum(1 for s in staged.shards if s.replica_owner),
                  sum(1 for s in staged.shards if not s.replica_owner))
    staged.close(unlink=True)
    ck = jckpt.AsyncCheckpointer(persistent_worker=False)
    ck.save(params, str(root / "jax"), {"iteration": 0})
    ck.close()

    ref_server = JaxStoreServer(host="127.0.0.1", port=0).start_in_thread()
    port_server = StoreServer(host="127.0.0.1", port=0).start_in_thread()
    url = f"tcp://127.0.0.1:{_free_port()}"
    args = json.dumps({"root": str(root), "src": str(src), "kw": KW,
                       "mesh": [DP, TP], "ref_port": ref_server.port,
                       "port_port": port_server.port})
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _RANK_SCRIPT, REPO, str(r), str(WORLD), url, args],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO,
            env=dict(os.environ, OMP_NUM_THREADS="1"),
        )
        for r in range(WORLD)
    ]
    results = []
    try:
        for p in procs:
            stdout, err = p.communicate(timeout=240)
            assert p.returncode == 0, err[-3000:]
            results.append(json.loads(stdout.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
        ref_server.stop()
        port_server.stop()
    results.sort(key=lambda r: r["rank"])
    restored = {tag: jckpt.load_checkpoint(str(root / f"params_{tag}"), template=params,
                                           resident=False)
                for tag in ("ref", "port")}
    return {"root": root, "params": params, "jax_counts": jax_counts,
            "ranks": results, "restored": restored}


def test_owner_counts_match_the_jax_rule(run):
    """(i) Owned and non-owned shard entries: the port's four ranks
    together, the reference's one process over four devices; non-owned > 0
    for dp > 1.  The dp = 0 ranks own every box of their tp index, rank 0
    also every replicated leaf, and the dp = 1 ranks own nothing."""
    ranks = run["ranks"]
    for r in ranks:
        assert not r["foreign_modules"], r["foreign_modules"]
    owned = sum(r["owned"] for r in ranks)
    non_owned = sum(r["non_owned"] for r in ranks)
    assert (owned, non_owned) == run["jax_counts"]
    assert non_owned > 0 and owned > 0
    n_leaves = len(jtu.tree_leaves(run["params"]))
    n_split = 1 + 6 * KW["n_layers"]  # embed and the six matrices per layer
    assert [r["owned"] for r in ranks] == [n_leaves, n_split, 0, 0]
    # the boxes: the JAX array's shard indices on the same devices
    leaves = jtu.tree_leaves(run["params"])
    for r in ranks:
        for leaf_idx, box, _owner in r["boxes"]:
            shard = [s for s in leaves[leaf_idx].addressable_shards
                     if s.device.id == r["rank"]][0]
            want = jstaging._norm_box(shard.index, leaves[leaf_idx].shape)
            assert tuple(map(tuple, box)) == want, (r["rank"], leaf_idx)


def test_port_checkpoint_restores_in_jax_with_shardings(run):
    """(ii) The four-rank params checkpoint into the JAX (2, 2) template,
    bit for bit, shardings equivalent."""
    for tag, restored in run["restored"].items():
        pairs = zip(jtu.tree_flatten_with_path(run["params"])[0],
                    jtu.tree_flatten_with_path(restored)[0])
        for (path, a), (_, b) in pairs:
            assert np.array_equal(np.asarray(a), np.asarray(b)), (tag, jtu.keystr(path))
            assert a.sharding.is_equivalent_to(b.sharding, a.ndim), (tag, jtu.keystr(path))


def test_jax_checkpoint_restores_into_port_dtensors(run):
    """(iii) The JAX package's checkpoint, and the port's own, restore into
    the port's DTensor templates bit for bit on every rank."""
    for r in run["ranks"]:
        assert r["restored_jax"], r["rank"]
        assert r["restored_params_port"], r["rank"]


def _shard_set(meta, owner_of):
    return {(meta["leaf_paths"][s["leaf_idx"]], tuple(map(tuple, s["index"])),
             owner_of(s), s["dtype"], s["crc"]) for s in meta["shards"]}


def test_metadata_shard_lists_agree(run):
    """(iv) Both checkpoints list the same shards: path, box, owner, dtype
    and crc, whatever process wrote them."""
    root = run["root"]
    leaves = jtu.tree_leaves(run["params"])
    with open(root / "jax" / "metadata.json") as f:
        jmeta = json.load(f)
    with open(root / "params_port" / "metadata.json") as f:
        tmeta = json.load(f)
    jset = _shard_set(jmeta, lambda s: leaves[s["leaf_idx"]].addressable_shards[
        s["shard_idx"]].device.id)
    tset = _shard_set(tmeta, lambda s: s["process_index"])
    assert len(jset) == len(jmeta["shards"]) == 32
    assert tset == jset
    assert tmeta["leaf_paths"] == jmeta["leaf_paths"]
    assert tmeta["treedef"] == jmeta["treedef"]


def test_commit_over_both_store_servers(run):
    """(v) Each commit over a store merged all four process indices into
    one metadata.json."""
    for tag in ("ref", "port"):
        d = run["root"] / f"params_{tag}"
        with open(d / "metadata.json") as f:
            meta = json.load(f)
        assert meta["num_processes"] == WORLD, tag
        assert sorted({s["process_index"] for s in meta["shards"]}) == [0, 1], tag
        for r in range(WORLD):
            assert (d / f"process_{r}.json").exists(), (tag, r)


def test_full_train_state_round_trip(run):
    """(vi) The whole train state after a step (params, mu, nu, count: f32
    needs no master) restores port to port bit for bit; the warm restore
    of a checkpoint written by several processes reads a rank's own shards
    from shm and the rest from disk."""
    for r in run["ranks"]:
        assert r["state_leaves"] == 3 * 19 + 1
        assert r["state_restored"] and r["loaded_back"], r["rank"]
    assert run["ranks"][0]["state_bytes_shm"] > 0
    assert run["ranks"][3]["state_bytes_shm"] == 0


def test_owner_map_error_text_is_the_references(monkeypatch):
    """The exactly-once assertion raises the reference's text, for
    overlapping and for missing boxes."""

    class _Leaf:
        shape = (4, 4)

    class _Sharding:
        def __init__(self, boxes):
            self.boxes = boxes

        def devices_indices_map(self, shape):
            return {_Dev(i): tuple(slice(a, b) for a, b in box)
                    for i, box in enumerate(self.boxes)}

    class _Dev:
        def __init__(self, i):
            self.id = i

    for boxes in ([((0, 4), (0, 4)), ((0, 2), (0, 4))],   # overlap
                  [((0, 2), (0, 4)), ((2, 3), (0, 4))]):  # a hole
        leaf = _Leaf()
        leaf.sharding = _Sharding(boxes)
        with pytest.raises(ValueError) as want:
            jstaging.shard_owner_map(leaf)
        monkeypatch.setattr(tstaging, "mesh_boxes", lambda _leaf, b=boxes: b)
        with pytest.raises(ValueError) as got:
            tstaging.shard_owner_map(leaf)
        assert str(got.value) == str(want.value)
