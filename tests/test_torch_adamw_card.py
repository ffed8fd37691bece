"""The fused AdamW kernel (``ops/csrc/adamw.cu``, kernel 4) on the card:

- it equals the eager loop (``adamw_reference``) bit for bit in ``mu``,
  ``nu``, the master and the parameter over three consecutive steps (the
  count rising), for bf16 parameters with an f32 master, f32 parameters
  without one and bf16 parameters without one;
- over ragged and tiny leaves (1, 3, 1,600, 2^20 + 5 elements, and leaves of
  more elements than a tile), with every tensor at offsets that put the
  vectors' start anywhere or nowhere, on a list whose tiles outnumber the
  blocks the card holds, and with gradients down to where their squares
  are subnormal;
- one launch a step up to ``LEAVES_PER_LAUNCH`` leaves, two above;
- a kept leaf table takes each step's new gradients without a rebuild,
  names a gradient that does not fit, and is built again when a parameter
  moves;
- ``make_train_step`` on the card goes through the kernel, once a step,
  and trains exactly as the eager loop does.

Every test is marked ``cuda`` and skips without a card.  On the card, run
them with ``python -m pytest --noconftest -m cuda tests/test_torch_*card*.py``.
Tests loop over their cases, for the reason given in
``tests/test_torch_quorum_kernel.py``.
"""

import re

import numpy as np
import pytest
import torch

from tpu_resiliency_torch.models import transformer as tr
from tpu_resiliency_torch.ops import adamw
from tpu_resiliency_torch.utils.tree import leaves

HYPER = dict(lr=1e-3, b1=0.9, b2=0.95, eps=1e-8, wd=0.01)
RAGGED = (1, 3, 1600, (1 << 20) + 5, adamw.TILE_ELEMS + 1, 3 * adamw.TILE_ELEMS - 7)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


def _at(values: np.ndarray, dtype, offset: int, dev) -> torch.Tensor:
    """``values`` on the card as a contiguous view ``offset`` elements past
    a 512-byte aligned allocation."""
    base = torch.empty(values.size + 8, dtype=dtype, device=dev)
    x = base[offset:offset + values.size]
    x.copy_(torch.from_numpy(values).to(dtype))
    return x


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


class _State:
    """One copy of the leaves, their AdamW state and a count."""

    def __init__(self, sizes, dtype, master, offsets, seed, dev):
        rng = np.random.default_rng(seed)
        self.params, self.mu, self.nu = [], [], []
        self.masters = [] if master else None
        for i, n in enumerate(sizes):
            off = offsets(i)
            w = (rng.standard_normal(n) * 0.02).astype(np.float32)
            self.params.append(_at(w, dtype, off[1], dev))
            self.mu.append(_at(np.zeros(n, np.float32), torch.float32, off[2], dev))
            self.nu.append(_at(np.zeros(n, np.float32), torch.float32, off[3], dev))
            if master:
                self.masters.append(_at(self.params[-1].float().cpu().numpy(),
                                        torch.float32, off[4], dev))
        self.count = torch.zeros((), dtype=torch.int32, device=dev)

    def tensors(self):
        return self.params + self.mu + self.nu + (self.masters or [])


def _grads(sizes, dtype, offsets, rng, dev):
    out = []
    for i, n in enumerate(sizes):
        scale = 10.0 ** rng.integers(-22, 2, size=n)  # squares down to subnormal
        g = (rng.standard_normal(n) * scale).astype(np.float32)
        g[rng.random(n) < 0.01] = 0.0
        out.append(_at(g, dtype, offsets(i)[0], dev))
    return out


def _three_steps(sizes, dtype, master, offsets, seed, dev, launches_per_step):
    """Three steps of the kernel on one copy and of the eager loop on
    another, from the same state and gradients; every bit must agree."""
    kernel = _State(sizes, dtype, master, offsets, seed, dev)
    plain = _State(sizes, dtype, master, offsets, seed, dev)
    table = adamw.LeafTable()
    rng = np.random.default_rng(seed + 1)
    for step in range(3):
        grads = _grads(sizes, dtype, offsets, rng, dev)
        for s in (kernel, plain):
            s.count = s.count + 1
            cf = s.count.to(torch.float32)
            bc1, bc2 = 1 - HYPER["b1"] ** cf, 1 - HYPER["b2"] ** cf
            if s is kernel:
                before = (adamw.fused_adamw.launches, adamw.fused_adamw.leaves)
                adamw.fused_adamw(s.params, grads, s.mu, s.nu, s.masters, bc1, bc2,
                                  **HYPER, table=table)
                got = (adamw.fused_adamw.launches - before[0],
                       adamw.fused_adamw.leaves - before[1])
                assert got == (launches_per_step, len(sizes)), (step, got)
            else:
                adamw.adamw_reference(s.params, grads, s.mu, s.nu, s.masters, bc1,
                                      bc2, **HYPER)
        torch.cuda.synchronize()
        for k, (a, b) in enumerate(zip(kernel.tensors(), plain.tensors())):
            if not torch.equal(_bits(a), _bits(b)):
                bad = int((_bits(a) != _bits(b)).sum())
                raise AssertionError(
                    f"step {step}, tensor {k} ({a.dtype}, {a.numel()} elements): "
                    f"{bad} elements differ")
    assert table.builds == 1


@pytest.mark.cuda
def test_card_kernel_equals_the_eager_loop_bit_for_bit(card):
    # a leaf of more tiles than the card holds blocks, and many small ones
    sizes = RAGGED + ((1 << 24) + 3,) + tuple(range(1, 200, 7))
    cases = {
        "aligned": lambda i: (0, 0, 0, 0, 0),
        "one offset a leaf": lambda i: (i % 8,) * 5,
        "never together": lambda i: (1, 0, 2, 3, 1 + i % 3),
        "gradient off": lambda i: (i % 8, 0, 0, 0, 0),
    }
    for dtype, master in ((torch.bfloat16, True), (torch.float32, False),
                          (torch.bfloat16, False)):
        for label, offsets in cases.items():
            try:
                _three_steps(sizes, dtype, master, offsets, 7, card, 1)
            except AssertionError as exc:
                raise AssertionError(f"{dtype}, master {master}, {label}: {exc}")


@pytest.mark.cuda
def test_card_kernel_splits_a_long_leaf_list(card):
    n = adamw.LEAVES_PER_LAUNCH + 20
    sizes = tuple(1 + (i * 37) % 3000 for i in range(n))
    _three_steps(sizes, torch.bfloat16, True, lambda i: (0,) * 5, 3, card, 2)


@pytest.mark.cuda
def test_card_wrapper_refuses_what_the_kernel_does_not_take(card):
    p = torch.zeros(16, dtype=torch.bfloat16, device=card)
    s = [torch.zeros(16, device=card) for _ in range(3)]
    bc = torch.ones((), device=card)
    g = torch.zeros(16, dtype=torch.bfloat16, device=card)
    bad = {
        "gradient dtype": ([p], [g.float()], [s[0]], [s[1]], [s[2]], bc),
        "gradient strided": ([p], [torch.zeros(32, dtype=torch.bfloat16,
                                               device=card)[::2]],
                             [s[0]], [s[1]], [s[2]], bc),
        "gradient missing": ([p], [None], [s[0]], [s[1]], [s[2]], bc),
        "mu on the CPU": ([p], [g], [s[0].cpu()], [s[1]], [s[2]], bc),
        "f16 parameters": ([p.half()], [g.half()], [s[0]], [s[1]], None, bc),
        "bc1 on the CPU": ([p], [g], [s[0]], [s[1]], [s[2]], bc.cpu()),
    }
    before = adamw.fused_adamw.launches
    for label, (ps, gs, mu, nu, masters, bc1) in bad.items():
        with pytest.raises(ValueError):
            adamw.fused_adamw(ps, gs, mu, nu, masters, bc1, bc, **HYPER)
            pytest.fail(label)
    assert adamw.fused_adamw.launches == before


@pytest.mark.cuda
def test_card_table_checks_each_steps_gradients(card):
    """A kept table takes each step's new gradients without a rebuild, names
    a gradient that does not fit it, and is built again when a parameter
    moves."""
    s = _State(RAGGED, torch.bfloat16, True, lambda i: (0,) * 5, 5, card)
    rng = np.random.default_rng(6)
    bc = torch.ones((), device=card)
    table = adamw.LeafTable()

    def step(grads):
        adamw.fused_adamw(s.params, grads, s.mu, s.nu, s.masters, bc, bc, **HYPER,
                          table=table)

    for _ in range(2):
        step(_grads(RAGGED, torch.bfloat16, lambda i: (0,) * 5, rng, card))
    assert table.builds == 1
    good = _grads(RAGGED, torch.bfloat16, lambda i: (0,) * 5, rng, card)
    wide = torch.zeros(2 * RAGGED[2], dtype=torch.bfloat16, device=card)
    bad = {
        "leaf 2's gradient must be a contiguous torch.bfloat16": (2, wide[::2]),
        "leaf 1's gradient must be a contiguous torch.bfloat16 (3,)": (
            1, good[1].float()),
        "leaf 0's gradient must be a contiguous torch.bfloat16 (1,) on cuda": (
            0, torch.zeros(2, dtype=torch.bfloat16, device=card)),
        "leaf 3's gradient must be": (3, None),
    }
    launches = adamw.fused_adamw.launches
    for match, (i, g) in bad.items():
        with pytest.raises(ValueError, match=re.escape(match)):
            step(good[:i] + [g] + good[i + 1:])
    assert adamw.fused_adamw.launches == launches
    step(good)
    s.params[4] = s.params[4].clone()
    step(good)
    torch.cuda.synchronize()
    assert table.builds == 3  # after the refusals, and after the move
    assert table.table[4, 1] == s.params[4].data_ptr()


@pytest.mark.cuda
def test_card_train_step_goes_through_the_kernel(card):
    cfg = tr.TransformerConfig(vocab=512, d_model=128, n_heads=4, n_layers=2,
                               d_ff=512, max_seq=64)
    batch = tr.make_batch(cfg, 4, 64, seed=0, device=card)
    fused = tr.init_params(cfg, torch.Generator(card).manual_seed(0), device=card)
    plain = tr.init_params(cfg, torch.Generator(card).manual_seed(0), device=card)
    opt_f, opt_p = tr.init_opt_state(fused), tr.init_opt_state(plain)
    step = tr.make_train_step(cfg, lr=HYPER["lr"])
    n_leaves = len(list(fused.parameters()))
    for k in range(3):
        before = (adamw.fused_adamw.launches, adamw.fused_adamw.leaves)
        fused, opt_f, _ = step(fused, opt_f, batch)
        assert (adamw.fused_adamw.launches - before[0],
                adamw.fused_adamw.leaves - before[1]) == (1, n_leaves), k
        # the eager loop on the same card, fed the gradients the step left
        with torch.no_grad():
            opt_p["count"] = opt_p["count"] + 1
            cf = opt_p["count"].to(torch.float32)
            adamw.adamw_reference(
                list(plain.parameters()), [p.grad for p in fused.parameters()],
                opt_p["mu"], opt_p["nu"], opt_p["master"], 1 - 0.9 ** cf,
                1 - 0.95 ** cf, **HYPER)
        for a, b in zip(leaves(tr.state_tree(fused, opt_f)),
                        leaves(tr.state_tree(plain, opt_p))):
            assert torch.equal(_bits(a) if a.is_floating_point() else a,
                               _bits(b) if b.is_floating_point() else b), k
