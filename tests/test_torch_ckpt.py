"""The port's async checkpointing (``tpu_resiliency_torch/checkpointing``)
against the JAX package, on the CPU:

- the format: ``flatten_with_path`` orders and names leaves as
  ``jax.tree_util`` does, and ``chunk_grid``, ``crc32``, ``seal``/``unseal``
  and ``combine_crcs`` equal the JAX package's;
- the flagship model's train state at a small size, f32 and bf16: a
  checkpoint the port writes restores bit for bit in the JAX package and the
  reverse, and for the same tree both packages write byte-identical shard
  files and equal per-shard metadata;
- the JAX package's delta tests (``tests/test_device_digest.py``): unchanged
  shards skip the transfer, a frozen save writes nothing, a lying device
  verdict fails closed, a slow drain never reuses a live ring slot, a ring
  of depth one is the plain snapshot;
- the owner rule: with ``process_index=1`` replicated leaves give
  metadata-only entries; ``store=`` is taken and ``peers=`` raises until
  its slice.

CPU tensors take the fingerprint's plain version, so the delta path runs
here end to end; the kernel runs in ``tests/test_torch_device_digest_card.py``.
"""

import contextlib
import glob
import json
import os
import threading

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

from tpu_resiliency.checkpointing import integrity as jintegrity
from tpu_resiliency.checkpointing.async_ckpt import checkpointer as jckpt
from tpu_resiliency.checkpointing.async_ckpt import staging as jstaging
from tpu_resiliency.checkpointing.async_ckpt import writer as jwriter
from tpu_resiliency.models import transformer as jt
from tpu_resiliency.utils import dtypes as jdtypes
from tpu_resiliency_torch.checkpointing import integrity as tintegrity
from tpu_resiliency_torch.checkpointing.async_ckpt import checkpointer as ckpt_mod
from tpu_resiliency_torch.checkpointing.async_ckpt import device_digest as tdd
from tpu_resiliency_torch.checkpointing.async_ckpt import resident as resident_mod
from tpu_resiliency_torch.checkpointing.async_ckpt import staging as tstaging
from tpu_resiliency_torch.checkpointing.async_ckpt import writer as twriter
from tpu_resiliency_torch.checkpointing.async_ckpt.checkpointer import (
    AsyncCheckpointer,
    CheckpointSaveError,
    load_checkpoint,
)
from tpu_resiliency_torch.models import transformer as tt
from tpu_resiliency_torch.utils import tree as ttree
from tpu_resiliency_torch.utils.dtypes import dtype_name, to_tensor


@pytest.fixture(autouse=True)
def _fresh_registry():
    resident_mod.invalidate()
    yield
    resident_mod.invalidate()


def _bytes(leaf) -> bytes:
    if isinstance(leaf, torch.Tensor):
        return leaf.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.asarray(leaf).tobytes()


def _name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return dtype_name(leaf.dtype)
    return str(np.asarray(leaf).dtype)


def assert_trees_equal(a, b):
    """Same structure, same dtype names, the same bytes (not just ==)."""
    pa, ta = ttree.flatten_with_path(a)
    pb, tb = ttree.flatten_with_path(b)
    assert ta == tb
    for (path, x), (_, y) in zip(pa, pb):
        assert _name(x) == _name(y), path
        assert _bytes(x) == _bytes(y), path


def _to_jax(t: torch.Tensor):
    """The tensor's bytes as a CPU jax array of the same dtype."""
    raw = t.contiguous().reshape(-1).view(torch.uint8).numpy()
    return jnp.asarray(
        raw.view(jdtypes.resolve_dtype(dtype_name(t.dtype))).reshape(tuple(t.shape)))


def _from_jax(x) -> torch.Tensor:
    host = np.asarray(x)
    raw = host.reshape(-1).view(np.uint8).copy()
    return to_tensor(raw.view(np.uint16 if str(host.dtype) == "bfloat16"
                              else host.dtype).reshape(host.shape), str(host.dtype))


# -- the format --------------------------------------------------------------


_TREES = [
    {"b": [1.0, (2, None, np.ones(2))], "a": {"z": 3, "y": None}, "c": ()},
    np.ones(3),
    {"x": (1,), "y": [], "z": {}},
    {3: 1, 1: 2},
    [{"w": np.zeros(2), "v": [np.ones(1), None]}, (np.arange(3), 4.0)],
]


def test_flatten_with_path_equals_jax_tree_util():
    for i, tree in enumerate(_TREES):
        pairs, treedef = ttree.flatten_with_path(tree)
        jpairs, jtreedef = jtu.tree_flatten_with_path(tree)
        assert [p for p, _ in pairs] == [jtu.keystr(p) for p, _ in jpairs], i
        assert [id(x) for _, x in pairs] == [id(x) for _, x in jpairs], i
        assert repr(treedef) == str(jtreedef), i
        leaves = [x for _, x in pairs]
        rebuilt = ttree.unflatten(treedef, leaves)
        assert jtu.tree_structure(rebuilt) == jtreedef, i
        assert ttree.flatten(rebuilt)[0] == leaves, i
    with pytest.raises(ValueError):
        ttree.unflatten(ttree.flatten({"a": 1})[1], [1, 2])


def test_chunk_grid_and_integrity_equal_the_jax_package():
    rng = np.random.default_rng(0)
    for nbytes in (0, 1, 4095, 4096, 4097, 10_000, 65_536 + 17, 1 << 20):
        for chunk_bytes in (4096, 8192, 1 << 20, 16 << 20):
            for direct in (False, True):
                case = (nbytes, chunk_bytes, direct)
                assert twriter.chunk_grid(nbytes, chunk_bytes, direct) == \
                    jwriter.chunk_grid(nbytes, chunk_bytes, direct), case
        data = rng.integers(0, 256, size=nbytes, dtype=np.uint8).tobytes()
        assert tintegrity.crc32(data) == jintegrity.crc32(data), nbytes
        assert tintegrity.crc32(data, 7) == jintegrity.crc32(data, 7), nbytes
        sealed = tintegrity.seal(data)
        assert sealed == jintegrity.seal(data), nbytes
        assert bytes(tintegrity.unseal(jintegrity.seal(data))) == data, nbytes
        assert bytes(jintegrity.unseal(sealed)) == data, nbytes
        crcs = tintegrity.chunk_crcs(data, 4096)
        assert crcs == jintegrity.chunk_crcs(data, 4096), nbytes
        assert tintegrity.combine_crcs(crcs) == jintegrity.combine_crcs(crcs), nbytes
    assert twriter.default_chunk_bytes() == jwriter.default_chunk_bytes()
    with pytest.raises(tintegrity.CheckpointCorruptError):
        tintegrity.unseal(sealed[:-1] + bytes([sealed[-1] ^ 1]))


def test_dtype_names_are_the_jax_writers():
    for name in ("bfloat16", "float16", "float32", "float64", "int8", "uint8",
                 "int16", "int32", "int64", "bool"):
        t = torch.zeros(2, dtype=getattr(torch, name))
        with jax.enable_x64(True):
            want = str(np.asarray(jnp.zeros(2, dtype=name)).dtype)
            assert _to_jax(t).dtype == jnp.dtype(name)
            assert _from_jax(_to_jax(t)).dtype == t.dtype
        assert dtype_name(t.dtype) == want == name


# -- the flagship train state across packages --------------------------------


def _small_cfg(dtype):
    return tt.TransformerConfig(vocab=64, d_model=16, n_heads=2, n_layers=2,
                                d_ff=32, max_seq=8, dtype=dtype)


def _trained_state(dtype):
    """The port's flagship model at a small size after one step: params,
    mu, nu, count (and an fp32 master in bf16), all non-trivial."""
    cfg = _small_cfg(dtype)
    params = tt.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    opt = tt.init_opt_state(params)
    batch = tt.make_batch(cfg, 2, 8, seed=0, device="cpu")
    tt.make_train_step(cfg, lr=1e-2)(params, opt, batch)
    return cfg, params, opt


def _jax_layout(dtype):
    """Paths and shapes of the JAX package's own train state at the same
    size: {"params": init_params, "opt": init_opt_state}."""
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    cfg = jt.TransformerConfig(vocab=64, d_model=16, n_heads=2, n_layers=2,
                               d_ff=32, max_seq=8, dtype=jdt)
    p = jt.init_params(cfg)
    state = {"params": p, "opt": jt.init_opt_state(p)}
    return [(jtu.keystr(k), tuple(v.shape), str(v.dtype))
            for k, v in jtu.tree_flatten_with_path(state)[0]]


def _index_entries(meta):
    keys = ("leaf_idx", "shard_idx", "global_shape", "index", "dtype", "shape",
            "nbytes", "crc", "chunks")
    # the drain lists shards as they complete: compare them by leaf
    return sorted(({k: s.get(k) for k in keys} for s in meta["shards"]),
                  key=lambda e: (e["leaf_idx"], e["shard_idx"]))


def test_train_state_restores_across_packages(tmp_path):
    for dtype in (torch.float32, torch.bfloat16):
        d = tmp_path / str(dtype).removeprefix("torch.")
        cfg, params, opt = _trained_state(dtype)
        tree = tt.state_tree(params, opt)
        pairs, _ = ttree.flatten_with_path(tree)
        assert [(p, tuple(x.shape), _name(x)) for p, x in pairs] == _jax_layout(dtype)
        jtree = jtu.tree_map(_to_jax, tree)

        ck = AsyncCheckpointer(persistent_worker=False)
        try:
            ck.save(tree, str(d / "port"), {"iteration": 1})
        finally:
            ck.close()
        jck = jckpt.AsyncCheckpointer(persistent_worker=False)
        try:
            jck.save(jtree, str(d / "jax"), {"iteration": 1})
        finally:
            jck.close()

        # the same tree gives byte-identical shard files and equal entries
        files = sorted(os.path.basename(f)
                       for f in glob.glob(str(d / "port/process_0/*.bin")))
        assert len(files) == len(pairs) and files == sorted(
            os.path.basename(f) for f in glob.glob(str(d / "jax/process_0/*.bin")))
        for f in files:
            assert (d / "port/process_0" / f).read_bytes() == \
                (d / "jax/process_0" / f).read_bytes(), f
        pm = json.loads((d / "port/metadata.json").read_text())
        jm = json.loads((d / "jax/metadata.json").read_text())
        assert pm["leaf_paths"] == jm["leaf_paths"] == [p for p, _ in pairs]
        assert pm["treedef"] == jm["treedef"]
        assert _index_entries(pm) == _index_entries(jm)

        # the port's checkpoint restores in the JAX package, bit for bit
        jout = jckpt.load_checkpoint(str(d / "port"), jtree, resident=False)
        for (path, a), b in zip(jtu.tree_flatten_with_path(jtree)[0],
                                jtu.tree_leaves(jout)):
            assert a.dtype == b.dtype and np.asarray(a).tobytes() == \
                np.asarray(b).tobytes(), (dtype, jtu.keystr(path))
        # and the JAX package's in the port, into the live trainer state
        template = tt.state_tree(*_trained_state(dtype)[1:])
        with torch.no_grad():
            for leaf in ttree.leaves(template):
                leaf.zero_()
        tout = load_checkpoint(str(d / "jax"), template, resident=False)
        assert_trees_equal(tout, tree)
        _, params2, opt2 = _trained_state(dtype)
        with torch.no_grad():
            params2.embed.zero_()
        tt.load_state_tree(params2, opt2, tout)
        assert_trees_equal(tt.state_tree(params2, opt2), tree)


def test_flagship_state_tree_has_141_leaves_in_the_jax_layout():
    cfg = tt.TransformerConfig(vocab=64, d_model=16, n_heads=2, n_layers=4,
                               d_ff=32, max_seq=8, dtype=torch.bfloat16)
    params = tt.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    opt = tt.init_opt_state(params)
    tree = tt.state_tree(params, opt)
    leaves = ttree.leaves(tree)
    assert len(leaves) == 141
    # the live tensors, not copies
    assert tree["params"]["embed"].data_ptr() == params.embed.data_ptr()
    names = [n for n, _ in params.named_parameters()]
    assert tree["opt"]["mu"]["layers"][3]["w2"] is opt["mu"][names.index("layers.3.w2")]
    with pytest.raises(ValueError, match="leaves"):
        tt.load_state_tree(params, opt, {"params": tree["params"]})


# -- delta saves: the JAX package's device-digest tests ----------------------


def _big_tree(mutate=()):
    """~10 leaves; ``mutate`` names leaves whose values differ."""
    tree = {}
    for i in range(8):
        base = torch.full((4096 + 128 * i,), float(i + 1), dtype=torch.float32)
        if f"f{i}" in mutate:
            base[17] = -99.0
        tree[f"f{i}"] = base
    bf = torch.arange(2048, dtype=torch.float32) % 7.0
    if "bf" in mutate:
        bf[0] = 5.5
    tree["bf"] = bf.to(torch.bfloat16)
    tree["host"] = np.arange(33, dtype=np.int64)  # host leaf: never skips
    return tree


def _device_bytes(tree) -> int:
    return sum(v.numel() * v.element_size() for v in tree.values()
               if isinstance(v, torch.Tensor))


def test_unchanged_shards_skip_the_transfer(tmp_path):
    d = str(tmp_path)
    ck = AsyncCheckpointer(delta=True, digest=True, device_digest=True)
    try:
        t1 = _big_tree()
        ck.save(t1, d + "/g1", {"iteration": 1})
        assert ck.last_stage_stats["d2h_skipped_bytes"] == 0  # no baseline

        t2 = _big_tree(mutate=("f3",))  # 1 of 10 leaves changes
        ck.save(t2, d + "/g2", {"iteration": 2})
        changed = t2["f3"].numel() * 4
        skipped = _device_bytes(t2) - changed
        assert ck.last_stage_stats["d2h_skipped_bytes"] == skipped
        assert ck.last_drain_stats.get("d2h_skipped_bytes") == skipped

        # provenance rows in the committed index point at g1's files
        idx = json.load(open(d + "/g2/process_0.json"))
        skip_shards = [s for s in idx["shards"] if s.get("bases")]
        assert skip_shards, "no provenance-only shards recorded"
        assert all("g1" in b for s in skip_shards for b in s["bases"])

        warm = load_checkpoint(d + "/g2", t2, stats=(st := {}))
        assert_trees_equal(warm, t2)
        assert st.get("bytes_shm", 0) > 0
    finally:
        ck.close()
    resident_mod.invalidate()
    for g, ref in (("g1", t1), ("g2", t2)):
        assert_trees_equal(load_checkpoint(d + "/" + g, ref, resident=False), ref)
        # and the JAX package restores the delta generation too
        jref = {k: _to_jax(v) if isinstance(v, torch.Tensor) else v
                for k, v in ref.items()}
        jout = jckpt.load_checkpoint(d + "/" + g, jref, resident=False)
        for k, v in ref.items():
            assert np.asarray(jout[k]).tobytes() == _bytes(v), (g, k)


def test_fully_frozen_save_writes_nothing(tmp_path):
    d = str(tmp_path)
    ck = AsyncCheckpointer(delta=True, digest=True, device_digest=True)
    try:
        t = _big_tree()
        ck.save(t, d + "/g1", {"iteration": 1})
        ck.save(t, d + "/g2", {"iteration": 2})
        assert ck.last_stage_stats["d2h_skipped_bytes"] == _device_bytes(t)
        assert ck.last_drain_stats.get("bytes_written", 0) == 0
    finally:
        ck.close()
    resident_mod.invalidate()
    assert_trees_equal(load_checkpoint(d + "/g2", t, resident=False), t)


def test_lying_device_verdict_fails_closed(tmp_path, monkeypatch):
    d = str(tmp_path)
    ck = AsyncCheckpointer(delta=True, digest=True, device_digest=True)
    try:
        ck.save(_big_tree(), d + "/g1", {"iteration": 1})

        # the device claims every chunk unchanged while the staged bytes
        # really changed: the model of a torn D2H / stale staging buffer
        def lying_verdict(self, key, nbytes, fp):
            return None, list(twriter.chunk_grid(
                nbytes, self.chunk_bytes, self.use_direct))

        monkeypatch.setattr(tdd.DigestContext, "verdict", lying_verdict)
        with pytest.raises(CheckpointSaveError):
            ck.save(_big_tree(mutate=("f0",)), d + "/g2", {"iteration": 2})
    finally:
        with contextlib.suppress(Exception):
            ck.close()
    assert glob.glob(d + "/g2/process_0/*.corrupt")
    assert not os.path.exists(d + "/g2/metadata.json")


def test_slow_drain_never_reuses_a_live_ring_slot(tmp_path, monkeypatch):
    real_stage = ckpt_mod.stage_pytree
    release = threading.Event()

    def slow_stage(*a, **kw):
        release.wait(timeout=30.0)  # D2H stalled until the test says go
        return real_stage(*a, **kw)

    monkeypatch.setattr(ckpt_mod, "stage_pytree", slow_stage)
    d = str(tmp_path)
    ck = AsyncCheckpointer(digest=True, stage_mode="snapshot", stage_buffers=2)
    try:
        trees = [{"w": torch.full((512,), float(i)),
                  "b": torch.arange(64, dtype=torch.int32) + i}
                 for i in range(3)]
        ck.async_save(trees[0], d + "/g0", {"iteration": 0})
        ck.async_save(trees[1], d + "/g1", {"iteration": 1})
        # both issued while staging was stalled: no slot was reusable
        assert ck.snap_ring_stats == {"reused": 0, "fresh": 2}
        # the snapshot is a copy: later in-place updates do not reach it
        trees[0]["w"].add_(100.0)
        release.set()
        ck.finalize_all()
        ck.async_save(trees[2], d + "/g2", {"iteration": 2})
        ck.finalize_all()
        assert ck.snap_ring_stats["reused"] == 1
    finally:
        release.set()
        ck.close()
    resident_mod.invalidate()
    trees[0]["w"].sub_(100.0)
    for i in range(3):
        out = load_checkpoint(d + f"/g{i}", trees[0], resident=False)
        assert_trees_equal(out, trees[i])


def test_ring_depth_one_is_the_plain_snapshot(tmp_path):
    d = str(tmp_path)
    ck = AsyncCheckpointer(stage_mode="snapshot", stage_buffers=1)
    try:
        t = {"w": torch.ones(256)}
        ck.save(t, d + "/g1", {"iteration": 1})
        assert ck.snap_ring_stats == {"reused": 0, "fresh": 0}
    finally:
        ck.close()
    resident_mod.invalidate()
    assert_trees_equal(load_checkpoint(d + "/g1", t, resident=False), t)


# -- ownership and what waits for later slices -------------------------------


class _FakeSharding:
    is_fully_replicated = True


class _FakeLeaf:
    sharding = _FakeSharding()


class _FakeShard:
    replica_id = 0


def test_replicated_leaves_are_metadata_only_off_process_zero(tmp_path):
    tree = _big_tree()
    for pidx in (0, 1):
        assert tstaging._replica_owner(pidx) == jstaging._replica_owner(
            _FakeLeaf(), _FakeShard(), pidx)
    staged = tstaging.stage_pytree(tree, process_index=1)
    try:
        assert len(staged.shards) == len(tree)
        assert all(not s.replica_owner and s.nbytes == 0 and not s.shm_name
                   for s in staged.shards)
        assert staged._shms == [] and staged.bytes_allocated == 0
        assert [s.dtype for s in staged.shards] == [
            _name(tree[k]) for k in sorted(tree)]
    finally:
        staged.close()
    ck = AsyncCheckpointer(process_index=1, persistent_worker=False)
    try:
        ck.save(tree, str(tmp_path / "p1"), {"iteration": 1})
    finally:
        ck.close()
    idx = json.loads((tmp_path / "p1/process_1.json").read_text())
    assert idx["shards"] == []
    assert not glob.glob(str(tmp_path / "p1/process_1/*.bin"))


def test_store_and_peers_wait_for_their_slices(tmp_path):
    """``store=`` is taken since the store's slice (the commit across ranks
    runs in ``tests/test_torch_ckpt_sharded.py``), and a save across
    several processes without one raises; ``peers=`` still waits for
    ``peer_source.py``."""
    ck = AsyncCheckpointer(store=object(), rank=1, world_size=2,
                           persistent_worker=False)
    assert (ck.rank, ck.world_size) == (1, 2)
    ck.close()
    with pytest.raises(ValueError, match="store"):
        AsyncCheckpointer(world_size=2)
    with pytest.raises(NotImplementedError, match="peer"):
        load_checkpoint(str(tmp_path), {}, peers=object())


def test_restore_places_on_the_template_and_refuses_another_shape(tmp_path):
    t = {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
         "h": np.arange(3, dtype=np.int32)}
    ck = AsyncCheckpointer(persistent_worker=False)
    try:
        ck.save(t, str(tmp_path / "g"), {"iteration": 1})
    finally:
        ck.close()
    # the template's dtype wins, as in the JAX package's device_put
    out = load_checkpoint(str(tmp_path / "g"),
                          {"w": torch.zeros(3, 4, dtype=torch.float64),
                           "h": np.zeros(3, np.int64)}, resident=False)
    assert out["w"].dtype == torch.float64 and out["h"].dtype == np.int64
    assert torch.equal(out["w"], t["w"].double())
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(str(tmp_path / "g"),
                        {"w": torch.zeros(4, 3), "h": np.zeros(3)}, resident=False)
