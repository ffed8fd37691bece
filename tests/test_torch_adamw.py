"""The fused AdamW kernel's host side (``tpu_resiliency_torch/ops/adamw.py``
around ``ops/csrc/adamw.cu``, kernel 4), on the CPU:

- the leaf table and the tile plan: the kernel's walk over the tiles,
  replayed in numpy, updates every element of every leaf exactly once, and
  every access of four elements is aligned to its size in all five arrays;
- the wrapper refuses CPU, non-contiguous and wrong-dtype leaves before it
  loads the library or launches anything;
- ``make_train_step`` on the CPU runs the eager loop, not the kernel;
- ``init_params`` on a mesh that splits ``model`` gives every leaf as a
  dense tensor, which the kernel takes;
- the source's constants and entry agree with the wrapper's;
- the benchmark's kernel-4 readers read the kernel from a trace and nothing
  from a trace without it.

The kernel itself is held against the eager loop on the card in
``tests/test_torch_adamw_card.py``.  Tests loop over their cases, for the
reason given in ``tests/test_torch_quorum_kernel.py``.
"""

import os
import re

import numpy as np
import pytest
import torch

from portbench import adamw_counts, spec
from portbench.trace import Trace
from tpu_resiliency_torch.models import transformer as tr
from tpu_resiliency_torch.ops import adamw
from tpu_resiliency_torch.utils import cuda_build

HYPER = dict(lr=1e-3, b1=0.9, b2=0.95, eps=1e-8, wd=0.01)
SIZES = (1, 3, 1600, (1 << 20) + 5, adamw.TILE_ELEMS, adamw.TILE_ELEMS + 1, 0, 7)
H100_SMS = 132


def _pointers(n, offsets, itemsize, master=True):
    """``int64[n, 5]`` pointers on 512-byte allocations, each moved by its
    ``offsets(i)`` elements (gradient, parameter, mu, nu, master)."""
    sizes = (itemsize, itemsize, 4, 4, 4)
    ptrs = np.zeros((n, 5), dtype=np.int64)
    for i in range(n):
        off = offsets(i)
        for k in range(5 if master else 4):
            ptrs[i, k] = (1 << 30) + 512 * (5 * i + k) * 4096 + off[k] * sizes[k]
    return ptrs


def _replay(table, n_tiles, itemsize, grid):
    """The kernel's grid-stride walk in numpy: how many times each element
    of each leaf is updated; every access of four elements must be aligned
    to its size in each of the leaf's arrays."""
    seen = [np.zeros(int(n), dtype=np.int64) for n in table[:, 5]]
    sizes = np.array([itemsize, itemsize, 4, 4, 4])
    for block in range(grid):
        for t in range(block, n_tiles, grid):
            lo = int(np.searchsorted(table[:, 7], t, side="right") - 1)
            n, head, ptrs = table[lo, 5], table[lo, 6], table[lo, :5]
            ts = (t - table[lo, 7]) * adamw.TILE_ELEMS
            te = min(ts + adamw.TILE_ELEMS, n)
            vs = te if head < 0 or ts + head > te else ts + head
            nvec = (te - vs) // adamw.VEC
            ve = vs + nvec * adamw.VEC
            seen[lo][ts:vs] += 1
            seen[lo][ve:te] += 1
            # a vector is four elements at i and four at j: 128 apart in a
            # full chunk of 32 vectors (a warp's), contiguous after it
            v = np.arange(nvec)
            nfull = nvec // 32 * 32
            i = np.where(v < nfull, vs + (v >> 5) * 256 + 4 * (v & 31), vs + v * adamw.VEC)
            j = np.where(v < nfull, i + 128, i + 4)
            for half in (i, j):
                np.add.at(seen[lo], (half[:, None] + np.arange(4)).ravel(), 1)
                addr = ptrs[None, :] + half[:, None] * sizes[None, :]
                ok = (addr % (4 * sizes[None, :]) == 0) | (ptrs[None, :] == 0)
                assert ok.all(), (lo, t)
    return seen


def test_kernel_walk_replayed_in_numpy_updates_every_element_once():
    cases = {
        "aligned": lambda i: (0,) * 5,
        "one offset a leaf": lambda i: (i % 8,) * 5,
        "never together": lambda i: (1, 0, 2, 3, 1 + i % 3),
        "gradient off": lambda i: (i % 8, 0, 0, 0, 0),
    }
    for itemsize, master in ((2, True), (4, False), (2, False)):
        for label, offsets in cases.items():
            ptrs = _pointers(len(SIZES), offsets, itemsize, master)
            table, n_tiles = adamw.leaf_rows(ptrs, SIZES, itemsize)
            assert n_tiles == sum(-(-n // adamw.TILE_ELEMS) for n in SIZES)
            for grid in (1, 7, H100_SMS * 4):
                seen = _replay(table, n_tiles, itemsize, grid)
                for k, s in enumerate(seen):
                    assert (s == 1).all(), (itemsize, master, label, grid, k)


def test_vector_heads_and_tile_plan():
    # (offsets of gradient, parameter, mu, nu, master in elements, itemsize,
    # head): the first element where all five meet a 16-byte boundary
    for off, itemsize, want in (
        ((0, 0, 0, 0, 0), 2, 0),
        ((3, 3, 3, 3, 3), 2, 5),
        ((3, 3, 3, 3, 3), 4, 1),
        ((1, 1, 1, 1, 5), 2, 7),
        ((1, 0, 0, 0, 0), 2, -1),
        ((0, 0, 1, 0, 0), 4, -1),
    ):
        ptrs = _pointers(1, lambda i: off, itemsize)
        assert adamw.vector_heads(ptrs, itemsize).tolist() == [want], (off, itemsize)
    # no master: its pointer is 0 and constrains nothing
    ptrs = _pointers(1, lambda i: (3, 3, 3, 3, 1), 2, master=False)
    assert adamw.vector_heads(ptrs, 2).tolist() == [5]
    tile0, n_tiles = adamw.tile_plan([0, 1, adamw.TILE_ELEMS, adamw.TILE_ELEMS + 1, 0, 5])
    assert tile0.tolist() == [0, 0, 1, 2, 4, 4] and n_tiles == 5


def test_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch):
    def no_build(source):
        raise AssertionError(f"the wrapper loaded {source}")

    monkeypatch.setattr(adamw, "load_kernel_library", no_build)
    monkeypatch.setattr(adamw, "_entries", {})
    p = torch.zeros(4, 4, dtype=torch.bfloat16)
    g = torch.zeros(4, 4, dtype=torch.bfloat16)
    s = [torch.zeros(4, 4) for _ in range(3)]
    bc = torch.ones(())
    cases = {
        "CUDA": ([p], [g], [s[0]], [s[1]], [s[2]], bc),
        "gradient must be a contiguous torch.bfloat16": (
            [p], [g.float()], [s[0]], [s[1]], [s[2]], bc),
        "not contiguous": ([p], [g.t()], [s[0]], [s[1]], [s[2]], bc),
        "leaf 0's mu must be": ([p], [g], [s[0].double()], [s[1]], [s[2]], bc),
        "leaf 0's master must be": ([p], [g], [s[0]], [s[1]], [s[2].t()], bc),
        "leaf 0's parameter must be": ([p.t()], [g.t().contiguous()],
                                       [s[0]], [s[1]], [s[2]], bc),
        "bf16 or f32": ([p.half()], [g.half()], [s[0]], [s[1]], None, bc),
        "1 parameters but 2 gradients": ([p], [g, g], [s[0]], [s[1]], [s[2]], bc),
        "bc1 must be one f32": ([p], [g], [s[0]], [s[1]], [s[2]], bc.double()),
    }
    before = (adamw.fused_adamw.launches, adamw.fused_adamw.leaves)
    for match, (ps, gs, mu, nu, masters, bc1) in cases.items():
        with pytest.raises(ValueError, match=re.escape(match)):
            adamw.fused_adamw(ps, gs, mu, nu, masters, bc1, bc, **HYPER)
    assert (adamw.fused_adamw.launches, adamw.fused_adamw.leaves) == before


def test_cpu_train_step_runs_the_eager_loop(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the CPU step reached the kernel")

    monkeypatch.setattr(tr, "fused_adamw", refuse)
    cfg = tr.TransformerConfig(vocab=64, d_model=32, n_heads=2, n_layers=2,
                               d_ff=64, max_seq=16)
    batch = tr.make_batch(cfg, 2, 16, seed=0, device="cpu")
    stepped = tr.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    plain = tr.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    opt_s, opt_p = tr.init_opt_state(stepped), tr.init_opt_state(plain)
    step = tr.make_train_step(cfg, lr=HYPER["lr"])
    for k in range(2):
        stepped, opt_s, _ = step(stepped, opt_s, batch)
        with torch.no_grad():
            opt_p["count"] = opt_p["count"] + 1
            cf = opt_p["count"].to(torch.float32)
            ps = list(plain.parameters())
            adamw.adamw_reference(ps, [p.grad for p in stepped.parameters()],
                                  opt_p["mu"], opt_p["nu"], opt_p.get("master"),
                                  1 - 0.9 ** cf, 1 - 0.95 ** cf, **HYPER)
        for a, b in zip([*stepped.parameters(), *opt_s["mu"], *opt_s["nu"]],
                        [*plain.parameters(), *opt_p["mu"], *opt_p["nu"]]):
            assert torch.equal(a, b), k


def test_init_params_boxes_are_contiguous(monkeypatch):
    """On a mesh with ``model`` > 1 each rank keeps a box of every split
    leaf; a column box (``wq``, ``wk``, ``wv``, ``w1``) must still come out
    as a dense tensor of its own, in f32 too, where the cast copies
    nothing, or kernel 4 refuses it."""
    from tpu_resiliency_torch.parallel.mesh import DpTp

    class CpuMesh:
        device_type = "cpu"

    monkeypatch.setattr(tr, "dp_tp", lambda mesh: DpTp(1, 2, 0, 1, None, None))
    cfg = tr.TransformerConfig(vocab=64, d_model=32, n_heads=2, n_layers=2,
                               d_ff=64, max_seq=16, dtype=torch.float32)
    full = tr.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    boxed = tr.init_params(cfg, torch.Generator().manual_seed(0), mesh=CpuMesh())
    for (name, a), b in zip(full.named_parameters(), boxed.parameters()):
        dim = tr._model_dim(name)
        want = a if dim is None else a.narrow(dim, a.shape[dim] // 2, a.shape[dim] // 2)
        assert b.is_contiguous() and torch.equal(b, want), name
    assert not full.layers[0].wq.narrow(1, 16, 16).is_contiguous()


def test_kernel_source_agrees_with_the_wrapper():
    with open(os.path.join(cuda_build.CSRC_DIR, "adamw.cu")) as f:
        src = f.read()
    consts = dict(re.findall(r"constexpr (?:int|int64_t) (k\w+) = (\d+);", src))
    assert int(consts["kTileElems"]) == adamw.TILE_ELEMS
    assert int(consts["kMaxLeaves"]) == adamw.LEAVES_PER_LAUNCH
    assert int(consts["kTableCols"]) == adamw.TABLE_COLS
    assert int(consts["kVec"]) == adamw.VEC
    assert 'extern "C" int tpurx_adamw_batch(' in src
    assert "cudaGetLastError" in src and "torch" not in src
    # the table travels by value and fits the 32,764-byte parameter space
    assert "const __grid_constant__ Table table" in src
    assert 8 * adamw.LEAVES_PER_LAUNCH + 56 * adamw.LEAVES_PER_LAUNCH + 16 + 64 <= 32764
    # every operation of the update rounds on its own: nothing to contract
    update = src[src.index("__device__ __forceinline__ void update("):]
    update = update[:update.index("\n}\n")]
    for op in ("__fmul_rn", "__fadd_rn", "__fdiv_rn", "__fsqrt_rn", "__fsub_rn"):
        assert op in update, op
    body = update[update.index("{"):]
    assert not re.search(r"[^_\w][a-z_]+ [*+/-] [a-z_]", body), body


def test_kernel4_readers():
    model = spec.cell(spec.benchmark(), "gpt2xl.steady")["config"]["model"]
    assert adamw_counts.model_params(model) == 1_556_764_800
    assert adamw_counts.adamw_bytes_per_step(model) == 28 * 1_556_764_800

    class Run:
        def __init__(self, trace, steps):
            self.trace, self.steps, self.model = trace, steps, model

    name = ("void (anonymous namespace)::tpurx_adamw_kernel<__nv_bfloat16>"
            "((anonymous namespace)::Table, (anonymous namespace)::Hyper, "
            "float const*, float const*)")
    bound_ns = adamw_counts.adamw_bound_s_per_step(model) * 1e9
    ops = {name: [4, int(4 * bound_ns / 0.9)], "elementwise_kernel": [9, 10 ** 9]}
    run = Run(Trace(0, 10 ** 10, ops, [(0, 10 ** 10)]), 4)
    us = spec.reader("adamw.device_us_per_step")(run)
    assert us == pytest.approx(bound_ns / 0.9 / 1e3, rel=1e-6)
    assert spec.reader("adamw_roofline")(run) == pytest.approx(90.0, rel=1e-6)
    # the parent's program: no kernel 4 in the trace; and an untraced run
    for empty in (Run(Trace(0, 10 ** 10, {"elementwise_kernel": [9, 10 ** 9]},
                            [(0, 10 ** 10)]), 4), Run(None, 4)):
        assert spec.reader("adamw.device_us_per_step")(empty) is None
        assert spec.reader("adamw_roofline")(empty) is None
