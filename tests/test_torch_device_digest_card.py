"""The per-chunk change fingerprint kernel (``ops/csrc/chunk_fingerprint.cu``)
and the checkpoint path around it, on the card:

- the kernel equals the plain PyTorch version and the numpy oracle, bit for
  bit, for f32, bf16, f16, f64, int8, uint8, int32, int64 and bool, at sizes
  from 1 element to 1 GiB, start offsets 0-3 and several chunk grids, and
  with two streams launching at once;
- the batched call over the flagship's 141 train-state leaves and over a
  mixed list (every dtype, offsets 0-3, empty leaves, a scalar, more leaves
  than one launch takes) equals the plain version leaf by leaf, in one
  launch per ``LEAVES_PER_LAUNCH`` leaves, counting every leaf;
- a delta save of a small flagship model on the card: the first save
  transfers every byte into page-locked shared memory, an unchanged second
  save skips all of it, a save after one element changed transfers exactly
  that shard, and each restores bit for bit onto the card; each save
  launches the kernel once over every leaf.

Every test is marked ``cuda`` and skips without a card.  On the card, run
them with ``python -m pytest --noconftest -m cuda tests/test_torch_*card*.py``
(the repository's conftest imports JAX, which the card's machine lacks).
Tests loop over their cases, for the reason given in
``tests/test_torch_quorum_kernel.py``.
"""

import numpy as np
import pytest
import torch

from tpu_resiliency_torch.checkpointing.async_ckpt import device_digest as dd
from tpu_resiliency_torch.checkpointing.async_ckpt import resident
from tpu_resiliency_torch.checkpointing.async_ckpt.checkpointer import (
    AsyncCheckpointer,
    load_checkpoint,
)
from tpu_resiliency_torch.checkpointing.async_ckpt.writer import chunk_grid
from tpu_resiliency_torch.models import transformer as tr
from tpu_resiliency_torch.utils.tree import leaves

DTYPES = ("float32", "bfloat16", "float16", "float64", "int8", "uint8",
          "int32", "int64", "bool")
GRIDS = ((1024, False), (4096, True), (16 << 20, True))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


def _values(name: str, n: int, seed: int, device) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    host = torch.from_numpy((rng.standard_normal(n) * 100).astype(np.float32))
    return host.to(dtype=getattr(torch, name)).to(device)


def _oracle(x: torch.Tensor, chunk_bytes: int, direct: bool) -> np.ndarray:
    raw = x.cpu().reshape(-1).view(torch.uint8).numpy()
    width = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}[x.element_size()]
    return dd.host_fingerprints(raw.tobytes(), width, chunk_bytes, direct)


def _rows(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


def _counts():
    return dd.batch_fingerprints.launches, dd.batch_fingerprints.shards


def _check_batch(xs, chunk_bytes, direct, launches, label):
    """``batch_fingerprints(xs)`` against the plain version leaf by leaf,
    with ``launches`` launches and every leaf counted."""
    before = _counts()
    got = dd.batch_fingerprints(xs, chunk_bytes, direct)
    assert _counts() == (before[0] + launches, before[1] + len(xs)), label
    rows = dd.read_fingerprints(got)
    for k, (x, r) in enumerate(zip(xs, rows)):
        n = x.numel() * x.element_size()
        assert r.shape == (len(chunk_grid(n, chunk_bytes, direct)), 2), (label, k)
        np.testing.assert_array_equal(
            r, _rows(dd.fingerprint_reference(x, chunk_bytes, direct)),
            err_msg=str((label, k, x.dtype, tuple(x.shape))))


@pytest.mark.cuda
def test_card_kernel_equals_plain_and_numpy(card):
    for name in DTYPES:
        for n in (1, 3, 1000, 4097, (1 << 20) + 3):
            base = _values(name, n + 4, seed=n, device=card)
            for offset in range(4):
                x = base[offset:offset + n]
                for chunk_bytes, direct in GRIDS:
                    case = (name, n, offset, chunk_bytes, direct)
                    before = _counts()
                    got = dd.shard_fingerprints(x, chunk_bytes, direct)
                    want = dd.fingerprint_reference(x, chunk_bytes, direct)
                    assert _counts() == (before[0] + 1, before[1] + 1), case
                    np.testing.assert_array_equal(_rows(got), _rows(want),
                                                  err_msg=str(case))
                    np.testing.assert_array_equal(
                        _rows(got), _oracle(x, chunk_bytes, direct),
                        err_msg=str(case))


@pytest.mark.cuda
def test_card_kernel_at_a_gibibyte(card):
    for name, n in (("float32", 1 << 28), ("bfloat16", (1 << 29) + 1),
                    ("uint8", (1 << 30) - 3)):
        x = _values(name, 1 << 20, seed=1, device=card).repeat(n // (1 << 20) + 1)[:n]
        x[-1] = 7  # a tail chunk that differs from its neighbours
        got = dd.shard_fingerprints(x)
        want = dd.fingerprint_reference(x, dd.default_chunk_bytes(), True)
        np.testing.assert_array_equal(_rows(got), _rows(want), err_msg=name)
        if name == "float32":
            np.testing.assert_array_equal(
                _rows(got), _oracle(x, dd.default_chunk_bytes(), True))


@pytest.mark.cuda
def test_card_kernel_on_two_streams_at_once(card):
    xs = [_values("float32", (1 << 24) + 5 * i, seed=i, device=card) for i in range(2)]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(card) for _ in xs]
    outs = []
    for _ in range(4):
        for x, s in zip(xs, streams):
            with torch.cuda.stream(s):
                outs.append((x, dd.shard_fingerprints(x, 65536, True)))
                # and a batch of slices of it, on the same stream
                parts = [x[i::1][: (1 << 20) + i] for i in range(3)]
                outs.extend(zip(parts, dd.batch_fingerprints(parts, 65536, True)))
    torch.cuda.synchronize()
    for x, got in outs:
        np.testing.assert_array_equal(
            _rows(got), _rows(dd.fingerprint_reference(x, 65536, True)))


@pytest.mark.cuda
def test_card_batch_over_the_flagship_state_and_a_mixed_list(card):
    params = tr.init_params(tr.TransformerConfig(), torch.Generator(card).manual_seed(0))
    opt = tr.init_opt_state(params)
    with torch.no_grad():
        for t in opt["mu"] + opt["nu"]:
            t.normal_()
        opt["count"] += 3
    state = leaves(tr.state_tree(params, opt))
    assert (len(state), sum(t.numel() * t.element_size() for t in state)) == (
        141, 412_941_316)
    _check_batch(state, dd.default_chunk_bytes(), True, 1, "flagship")
    mixed = []
    for k, name in enumerate(DTYPES * 3):
        n = (0, 1, 4099, 70001, 9)[k % 5]
        base = _values(name, n + 4, seed=k, device=card)
        mixed.append(base[k % 4:k % 4 + n])
    mixed.append(torch.tensor(7, dtype=torch.int32, device=card))  # a scalar
    for chunk_bytes, direct in GRIDS:
        _check_batch(mixed, chunk_bytes, direct, 1, ("mixed", chunk_bytes, direct))
    many = [_values(DTYPES[k % len(DTYPES)], k % 37, seed=k, device=card)
            for k in range(dd.LEAVES_PER_LAUNCH + 45)]
    _check_batch(many, 4096, True, 2, "more leaves than one launch takes")


@pytest.mark.cuda
def test_card_delta_saves_restore_bit_for_bit(card, tmp_path):
    resident.invalidate()
    cfg = tr.TransformerConfig(vocab=512, d_model=64, n_heads=4, n_layers=2,
                               d_ff=256, max_seq=64)
    params = tr.init_params(cfg, torch.Generator(card).manual_seed(0))
    opt = tr.init_opt_state(params)
    tr.make_train_step(cfg)(params, opt, tr.make_batch(cfg, 2, 64))
    tree = tr.state_tree(params, opt)
    total = sum(t.numel() * t.element_size() for t in leaves(tree))
    ck = AsyncCheckpointer(delta=True, digest=True, device_digest=True)
    saved = {}
    try:
        for g in ("a", "b", "c"):
            if g == "c":
                with torch.no_grad():
                    params.embed[3, 5] += 1
            saved[g] = [t.clone() for t in leaves(tree)]
            before = _counts()
            ck.async_save(tree, str(tmp_path / g), {"iteration": g})
            ck.finalize_all()
            stats = ck.last_stage_stats
            # one launch per save over every leaf
            assert _counts() == (before[0] + 1, before[1] + len(saved[g])), g
            if g == "a":
                assert stats["d2h_bytes"] == total and stats["d2h_skipped_bytes"] == 0
                pooled = ck._pool[0]
                assert pooled._pinned and len(pooled._pinned) == len(saved[g])
            elif g == "b":
                assert stats["d2h_skipped_bytes"] == total and stats["d2h_bytes"] == 0
                assert ck.last_drain_stats["bytes_written"] == 0
            else:
                embed = params.embed.numel() * params.embed.element_size()
                assert stats["d2h_bytes"] == embed, stats
                assert stats["d2h_skipped_bytes"] == total - embed
    finally:
        ck.close()
    resident.invalidate()
    for g, ref in saved.items():
        out = load_checkpoint(str(tmp_path / g), tree, resident=False)
        for a, b in zip(ref, leaves(out)):
            assert b.device == card and b.dtype == a.dtype, g
            assert torch.equal(a.reshape(-1).view(torch.uint8),
                               b.reshape(-1).view(torch.uint8)), g
