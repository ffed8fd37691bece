"""The AdamW update of the model step: kernel 4 and its plain version.

:func:`adamw_reference` is the update as the port's eager step wrote it,
leaf by leaf: ``mu2 = b1*mu + (1-b1)*g``, ``nu2 = b2*nu + (1-b2)*g^2``, bias
correction by ``bc1`` and ``bc2``, then ``m2 = m - lr*(mu_hat/(sqrt(nu_hat)
+ eps) + wd*m)`` on the fp32 master, written back into ``mu``, ``nu``, the
master and the parameter.  It is 21 PyTorch operations a leaf, and it is
what the CPU runs.

:func:`fused_adamw` runs the same update on the card in one launch over
every leaf: the hand-written kernel ``csrc/adamw.cu`` (CUDA C++ for
``sm_90a``, built on first use and bound with ctypes like the other
kernels), which replaces no Pallas kernel but the fusion XLA makes of the
jitted JAX update (``tpu_resiliency/models/transformer.py:208-215, 243``).
It is bound by bytes, 28 a parameter (bf16 gradient and parameter, f32
``mu``, ``nu`` and master), and it applies each operation of the loop in the
loop's order with round-to-nearest intrinsics, so its results equal the
loop's bit for bit.  The source's header says how its design meets the
bound.

The kernel reads a leaf table: per leaf the gradient's, parameter's,
``mu``'s, ``nu``'s and master's pointers, the element count, the vector head
(:func:`vector_heads`) and the first tile (:func:`tile_plan`).  A
:class:`LeafTable` keeps the columns that do not change between steps, for
one set of parameters and state at a time; each step fills in only the
gradients' pointers, since ``zero_grad(set_to_none=True)`` allocates them
anew.  ``fused_adamw.launches`` counts the kernels launched and
``fused_adamw.leaves`` the leaves updated on a card.
"""

from __future__ import annotations

import ctypes
from itertools import chain
from operator import attrgetter
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.cuda_build import load_kernel_library

_SOURCE = "adamw.cu"
_entries: Dict[str, "ctypes._CFuncPtr"] = {}

TILE_ELEMS = 8192          # elements of one tile: a block's unit of work
LEAVES_PER_LAUNCH = 448    # leaves of one launch's table (kMaxLeaves)
TABLE_COLS = 8             # int64 columns of a leaf table row
VEC = 8                    # elements a thread moves at once (kVec)
_BF16 = {torch.bfloat16: 1, torch.float32: 0}  # parameter dtype -> param_bf16
_dtype = attrgetter("dtype")


def adamw_reference(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                    mu: Sequence[torch.Tensor], nu: Sequence[torch.Tensor],
                    masters: Optional[Sequence[torch.Tensor]], bc1: torch.Tensor,
                    bc2: torch.Tensor, *, lr: float, b1: float, b2: float,
                    eps: float, wd: float) -> None:
    """The plain version, in place, leaf by leaf.  ``masters`` is None when
    the parameters are their own fp32 copy."""
    if masters is None:
        masters = [None] * len(params)
    for p, g, mu_, nu_, master in zip(params, grads, mu, nu, masters):
        g32 = g.to(torch.float32)
        mu_.copy_(b1 * mu_ + (1 - b1) * g32)
        nu_.copy_(b2 * nu_ + (1 - b2) * torch.square(g32))
        mu_hat = mu_ / bc1
        nu_hat = nu_ / bc2
        # update in fp32 against the master copy; cast down only for the
        # compute params (sub-ulp updates accumulate in the master)
        m = master if master is not None else p.to(torch.float32)
        m2 = m - lr * (mu_hat / (torch.sqrt(nu_hat) + eps) + wd * m)
        if master is not None:
            master.copy_(m2)
        p.copy_(m2)


def tile_plan(numels: Sequence[int]) -> Tuple[np.ndarray, int]:
    """Each leaf's first tile (a leaf of n elements has ``ceil(n /
    TILE_ELEMS)`` tiles, after the previous leaf's) and the total."""
    n = np.asarray(numels, dtype=np.int64)
    tiles = -(-n // TILE_ELEMS)
    return np.cumsum(tiles) - tiles, int(tiles.sum())


def vector_heads(ptrs: np.ndarray, itemsize: int) -> np.ndarray:
    """For each row of ``int64[n, 5]`` pointers (gradient, parameter, mu,
    nu, master; 0 for no master), the first element ``h < VEC`` at which
    every pointer sits on a 16-byte boundary, or -1 where there is none
    (that leaf is read and written one element at a time)."""
    sizes = np.array([itemsize, itemsize, 4, 4, 4], dtype=np.int64)
    heads = np.full(len(ptrs), -1, dtype=np.int64)
    for h in range(VEC - 1, -1, -1):
        ok = ((ptrs + h * sizes) % 16 == 0) | (ptrs == 0)
        heads[ok.all(axis=1)] = h
    return heads


def leaf_rows(ptrs: np.ndarray, numels: Sequence[int], itemsize: int
              ) -> Tuple[np.ndarray, int]:
    """The kernel's leaf table, ``int64[n, TABLE_COLS]`` rows (gradient,
    parameter, mu, nu, master, elements, vector head, first tile), from the
    ``int64[n, 5]`` pointers of :func:`vector_heads`; and the total of
    tiles."""
    tile0, n_tiles = tile_plan(numels)
    table = np.zeros((len(ptrs), TABLE_COLS), dtype=np.int64)
    table[:, :5] = ptrs
    table[:, 5] = numels
    table[:, 6] = vector_heads(ptrs, itemsize)
    table[:, 7] = tile0
    return table, n_tiles


def _check(what: str, i: int, t: Optional[torch.Tensor], dtype: torch.dtype,
           device: torch.device, shape: torch.Size) -> None:
    if (t is None or t.dtype != dtype or t.device != device or t.shape != shape
            or not t.is_contiguous()):
        got = "None" if t is None else (
            f"{t.dtype} {tuple(t.shape)} on {t.device}"
            f"{'' if t.is_contiguous() else ', not contiguous'}")
        raise ValueError(f"fused_adamw: leaf {i}'s {what} must be a contiguous "
                         f"{dtype} {tuple(shape)} on {device}, not {got}")


class LeafTable:
    """The kernel's leaf table for one set of parameters and AdamW state,
    checked once and kept between steps.  A set is known by the pointers of
    its parameters and state: when any of them moves, every leaf is checked
    and the table built again.  Each step's gradients are new tensors, so
    each step gathers their pointers and holds their dtype, device, shape
    and contiguity against the set's in a few passes over the list; a
    gradient that does not fit is checked leaf by leaf, which names it."""

    def __init__(self):
        self._state: Optional[tuple] = None
        self._fit: Optional[tuple] = None
        self.table: Optional[np.ndarray] = None
        self.n_tiles = 0
        self.builds = 0

    def rows(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
             mu: Sequence[torch.Tensor], nu: Sequence[torch.Tensor],
             masters: Optional[Sequence[torch.Tensor]]) -> np.ndarray:
        """The table for these tensors with this step's gradient column;
        raises on tensors the kernel does not take."""
        state = tuple(map(torch.Tensor.data_ptr, chain(params, mu, nu, masters or ())))
        if state != self._state or not self._fits(grads):
            self._state = None
            self._build(params, grads, mu, nu, masters)
            self._state = state
        rows = self.table
        rows[:, 0] = np.fromiter(map(torch.Tensor.data_ptr, grads), np.int64, len(rows))
        return rows

    def _fits(self, grads: Sequence[torch.Tensor]) -> bool:
        dtype, devices, shapes = self._fit
        try:
            return (len(grads) == len(shapes)
                    and all(map(torch.Tensor.is_contiguous, grads))
                    and list(map(_dtype, grads)).count(dtype) == len(shapes)
                    and list(map(torch.Tensor.get_device, grads)) == devices
                    and list(map(torch.Tensor.size, grads)) == shapes)
        except TypeError:  # not a tensor: the leaf-by-leaf check names it
            return False

    def _build(self, params, grads, mu, nu, masters) -> None:
        n = len(params)
        if len(mu) != n or len(nu) != n or (masters is not None and len(masters) != n):
            raise ValueError(f"fused_adamw: {n} parameters but {len(mu)} mu, "
                             f"{len(nu)} nu, "
                             f"{'no' if masters is None else len(masters)} masters")
        device, dtype = params[0].device, params[0].dtype
        for i, (p, g) in enumerate(zip(params, grads)):
            _check("gradient", i, g, dtype, device, p.shape)
        if dtype not in _BF16:
            raise ValueError(f"fused_adamw takes bf16 or f32 parameters, not {dtype}")
        cols = [params, mu, nu] + ([masters] if masters is not None else [])
        for i in range(n):
            _check("parameter", i, params[i], dtype, device, params[i].shape)
            for what, ts in zip(("mu", "nu", "master"), cols[1:]):
                _check(what, i, ts[i], torch.float32, device, params[i].shape)
        if device.type != "cuda":
            raise ValueError(f"fused_adamw runs on CUDA tensors, not {device}; "
                             f"the CPU takes adamw_reference")
        ptrs = np.zeros((n, 5), dtype=np.int64)
        for k, ts in enumerate(cols):
            ptrs[:, k + 1] = [t.data_ptr() for t in ts]
        self.table, self.n_tiles = leaf_rows(
            ptrs, [p.numel() for p in params], params[0].element_size())
        self._fit = (dtype, [device.index] * n, [p.size() for p in params])
        self.builds += 1


def _entry():
    """The launch entry of ``csrc/adamw.cu``, built on first use (never at
    import: the CPU tests import this module without nvcc).  It keeps the
    GIL (``PyDLL``): it returns in microseconds, and giving the GIL up would
    let the lanes' threads hold it for up to a switch interval mid-step."""
    fn = _entries.get("batch")
    if fn is None:
        fn = ctypes.PyDLL(load_kernel_library(_SOURCE)._name).tpurx_adamw_batch
        vp, f32 = ctypes.c_void_p, ctypes.c_float
        fn.argtypes = [vp, ctypes.c_int, ctypes.c_int64, ctypes.c_int, vp, vp,
                       f32, f32, f32, f32, f32, f32, f32, ctypes.c_int, vp,
                       ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        _entries["batch"] = fn
    return fn


def fused_adamw(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                mu: Sequence[torch.Tensor], nu: Sequence[torch.Tensor],
                masters: Optional[Sequence[torch.Tensor]], bc1: torch.Tensor,
                bc2: torch.Tensor, *, lr: float, b1: float, b2: float, eps: float,
                wd: float, table: Optional[LeafTable] = None) -> None:
    """:func:`adamw_reference` on one card in ``ceil(n /
    LEAVES_PER_LAUNCH)`` launches of kernel 4, on the current stream, with
    no sync.  Every tensor lies on one CUDA device and is contiguous; the
    parameters are all bf16 or all f32, each gradient of its parameter's
    dtype and shape; ``mu``, ``nu``, the masters (or None) and the scalars
    ``bc1`` and ``bc2`` are f32.  Anything else raises, and so does a
    launch that CUDA refuses.  ``table`` keeps the leaf table between calls
    (a trainer passes the same one every step)."""
    if not params:
        return
    device, dtype = params[0].device, params[0].dtype
    itemsize = params[0].element_size()
    if len(grads) != len(params):
        raise ValueError(f"fused_adamw: {len(params)} parameters but "
                         f"{len(grads)} gradients")
    for what, bc in (("bc1", bc1), ("bc2", bc2)):
        if bc.dtype != torch.float32 or bc.device != device or bc.numel() != 1:
            raise ValueError(f"fused_adamw: {what} must be one f32 on {device}, "
                             f"not {bc.dtype} {tuple(bc.shape)} on {bc.device}")
    table = table if table is not None else LeafTable()
    rows = table.rows(params, grads, mu, nu, masters)
    heads = rows[:, 6]
    if ((heads < 0) | ((rows[:, 0] + heads * itemsize) % 16 != 0)).any():
        rows[:, 6] = vector_heads(rows[:, :5], itemsize)  # a gradient moved off
    index = device.index
    launched = ctypes.c_int(0)
    rc = _entry()(rows.ctypes.data, len(params), table.n_tiles, _BF16[dtype],
                  bc1.data_ptr(), bc2.data_ptr(), b1, 1 - b1, b2, 1 - b2, eps, wd,
                  lr, index, torch._C._cuda_getCurrentRawStream(index),
                  ctypes.byref(launched))
    fused_adamw.launches += launched.value
    if rc != 0:
        raise RuntimeError(f"fused AdamW launch failed: CUDA error {rc}")
    fused_adamw.leaves += len(params)


fused_adamw.launches = 0
fused_adamw.leaves = 0
