"""On-device per-chunk change fingerprints for the checkpoint drain.

The port of ``tpu_resiliency/checkpointing/async_ckpt/device_digest.py``.
A delta save that only compares host crc32s after the device-to-host copy
can skip the disk write, never the transfer.  Here every drain chunk of
every owned shard is reduced to a 64-bit fingerprint **on the card**, and
one small host readback of the rows (8 bytes per 16 MiB chunk) decides,
before any transfer, which shards cross the link at all (``staging.py``).
Chunks that transfer anyway carry their device verdicts, and the drain
cross-checks them against the host crc32.

Kernel contract (the JAX package's, bit for bit):

- The chunk layout is ``writer.chunk_grid(nbytes, chunk_bytes,
  use_direct)``, the grid the drain crcs and the delta baseline keys.
- Lanes are the shard's bytes in C order as uint32: a bitcast for 4- and
  8-byte dtypes (two lanes per 8-byte element, in byte order), a widening
  of uint16 lanes for 2-byte dtypes (bf16 included) and of uint8 lanes for
  1-byte dtypes and bool.  Every value fingerprints by its bit pattern.
- Each lane is mixed with its index over the whole shard,
  ``h = fmix32(lane ^ index * 0x9E3779B9)``, and each chunk gives
  ``(sum h, sum h * pos) mod 2^32`` with ``pos`` the 1-based position in
  the chunk.  The mix breaks the telescoping of raw Fletcher sums on a
  uniform constant change.

The kernel is ``ops/csrc/chunk_fingerprint.cu``, CUDA C++ for ``sm_90a``
with a plain C entry, built on first use by ``utils/cuda_build.py``.
:func:`batch_fingerprints` fingerprints a list of leaves: the CUDA leaves
of each card in one launch over a leaf table (:func:`batch_plan`; up to
:data:`LEAVES_PER_LAUNCH` leaves a launch), into one ``int32[rows, 2]``
buffer per card whose slices are each leaf's rows, or it raises.  It
counts the launches in ``batch_fingerprints.launches`` and the leaves
fingerprinted on a card in ``batch_fingerprints.shards``.  CPU leaves take
:func:`fingerprint_reference`, the plain PyTorch version (int64 arithmetic
masked to 32 bits, chunk by chunk).  :func:`shard_fingerprints` is the
one-leaf call of the same kernel and counters.  :func:`host_fingerprints`
is the numpy oracle over host bytes.  Complex and other dtypes without a
lane view return None: those shards stay on the host-crc path.

On a mesh the staging fingerprints each **owned local shard** (a
``DTensor`` leaf's box that this process writes), so a save launches the
kernel once per card over every owned shard, and a process that owns none
(the replicas on ``"data"`` > 0) launches it zero times.

This module and ``staging.py`` are the only device-to-host touchpoints for
checkpoint state.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from ...utils import env as _envknobs
from ...utils.cuda_build import load_kernel_library
from ...utils.dtypes import NAMES
from ...utils.logging import get_logger
from .writer import chunk_grid, default_chunk_bytes

log = get_logger("ckpt.device_digest")

_KERNEL_SOURCE = "chunk_fingerprint.cu"
_entries: Dict[str, "ctypes._CFuncPtr"] = {}

LEAVES_PER_LAUNCH = 256     # leaves of one launch's table (kMaxLeaves)
TILE_BYTES = 64 << 10       # bytes of one tile: a block's unit of work
TABLE_COLS = 8              # int64 columns of a leaf table row

# murmur3 fmix32 constants; the position multiplier is the golden-ratio
# Weyl increment (odd, so index -> index*PHI is a bijection on uint32)
_PHI = 0x9E3779B9
_MIX1 = 0x85EBCA6B
_MIX2 = 0xC2B2AE35
_M32 = 0xFFFFFFFF


def enabled() -> bool:
    """``TPURX_CKPT_DEVICE_DIGEST``."""
    try:
        return bool(_envknobs.CKPT_DEVICE_DIGEST.get())
    except ValueError:
        return False


def _entry(name: str):
    """The ctypes entry ``name`` of ``csrc/chunk_fingerprint.cu``, built on
    first use (never at import: the CPU tests import this module without
    nvcc).  The launch keeps the GIL (``PyDLL``): it returns in tens of
    microseconds, and giving the GIL up would let the training thread hold
    it for up to a switch interval before the staging thread goes on.  The
    page-locking calls release it."""
    fn = _entries.get(name)
    if fn is None:
        lib = load_kernel_library(_KERNEL_SOURCE)
        if name == "tpurx_chunk_fingerprint_batch":
            lib = ctypes.PyDLL(lib._name)
        fn = getattr(lib, name)
        vp, i64 = ctypes.c_void_p, ctypes.c_int64
        fn.argtypes = {
            "tpurx_chunk_fingerprint_batch": [vp, ctypes.c_int, i64, i64,
                                              ctypes.c_int, vp, ctypes.c_int,
                                              vp, ctypes.POINTER(ctypes.c_int)],
            "tpurx_host_register": [vp, ctypes.c_size_t],
            "tpurx_host_unregister": [vp],
        }[name]
        fn.restype = ctypes.c_int
        _entries[name] = fn
    return fn


def host_register(addr: int, nbytes: int) -> None:
    """Page-lock ``nbytes`` of host memory at ``addr`` for every CUDA
    context (``cudaHostRegister``, portable).  The call releases the GIL.
    Raises on failure: a copy into pageable memory would silently turn
    synchronous."""
    rc = _entry("tpurx_host_register")(addr, nbytes)
    if rc != 0:
        raise RuntimeError(f"cudaHostRegister of {nbytes} B failed: CUDA error {rc}")


def host_unregister(addr: int) -> None:
    rc = _entry("tpurx_host_unregister")(addr)
    if rc != 0:
        raise RuntimeError(f"cudaHostUnregister failed: CUDA error {rc}")


def lane_bytes(itemsize: int) -> int:
    """Bytes of shard data per uint32 lane: 4 for wide dtypes (a bitcast),
    the itemsize for 16- and 8-bit dtypes (widened lanes)."""
    return 4 if itemsize >= 4 else itemsize


_SUPPORTED: Dict[torch.dtype, bool] = {}


def supported(dtype: torch.dtype) -> bool:
    """Does ``dtype`` have a lane view (a real checkpoint dtype)?"""
    ok = _SUPPORTED.get(dtype)
    if ok is None:
        ok = _SUPPORTED[dtype] = (not dtype.is_complex
                                  and str(dtype).removeprefix("torch.") in NAMES)
    return ok


def _host_supported(dtype) -> bool:
    dt = np.dtype(dtype)
    if dt.kind == "c":  # complex: no uint bitcast path; fall back to host
        return False
    return dt.itemsize in (1, 2, 4, 8)


def batch_plan(nbytes: Sequence[int], itemsizes: Sequence[int],
               chunk_bytes: int, use_direct: bool,
               tile_bytes: int = TILE_BYTES) -> Tuple[np.ndarray, int, int]:
    """The kernel's leaf table for leaves of ``nbytes`` bytes of
    ``itemsizes``-byte elements: ``(table, n_rows, n_tiles)``, ``table`` an
    ``int64[n, TABLE_COLS]`` of rows (data pointer, left 0 for the caller;
    lane bytes; total lanes; chunk lanes; boundary lane; n_low; first
    output row; first tile).

    Each leaf's chunks are ``chunk_grid(nbytes, chunk_bytes, use_direct)``
    in lanes: ``n_low = ceil(boundary / chunk_lanes)`` chunks tile
    ``[0, boundary)``, the rest tile ``[boundary, total)``.  Each chunk is
    cut into tiles of ``tile_bytes`` (the last one of a chunk shorter), and
    a leaf's rows and tiles follow the previous leaf's.  ``chunk_bytes``
    must be a multiple of every leaf's lane width."""
    size = np.asarray(nbytes, dtype=np.int64)
    item = np.asarray(itemsizes, dtype=np.int64)
    lb = np.where(item >= 4, 4, item)
    bad = (chunk_bytes < lb) | (chunk_bytes % lb != 0)
    if bad.any():
        raise ValueError(
            f"chunk_bytes {chunk_bytes} is not a multiple of the "
            f"{int(lb[bad][0])}-byte lane width")
    total, chunk = size // lb, chunk_bytes // lb
    boundary = ((size // 4096) * 4096 if use_direct else 0 * size) // lb
    n_low = -(-boundary // chunk)
    n_high = -(-(total - boundary) // chunk)
    tile = tile_bytes // lb
    per_chunk = -(-chunk // tile)

    def region_tiles(n, lanes):
        # n - 1 whole chunks and the last, shorter one
        return np.where(n > 0, (n - 1) * per_chunk
                        + -(-(lanes - (n - 1) * chunk) // tile), 0)

    rows = n_low + n_high
    tiles = region_tiles(n_low, boundary) + region_tiles(n_high, total - boundary)
    table = np.zeros((len(size), TABLE_COLS), dtype=np.int64)
    table[:, 1], table[:, 2], table[:, 3] = lb, total, chunk
    table[:, 4], table[:, 5] = boundary, n_low
    table[:, 6] = np.cumsum(rows) - rows
    table[:, 7] = np.cumsum(tiles) - tiles
    return table, int(rows.sum()), int(tiles.sum())


def _lane_view(x: torch.Tensor, lb: int) -> torch.Tensor:
    """The flat lane stream of contiguous ``x`` at its width in memory
    (int32, int16 or uint8 bit patterns)."""
    raw = x.reshape(-1).view(torch.uint8)
    return raw if lb == 1 else raw.view(torch.int16 if lb == 2 else torch.int32)


def fingerprint_reference(x: torch.Tensor, chunk_bytes: int,
                          use_direct: bool) -> torch.Tensor:
    """The plain PyTorch version: ``int32[n_chunks, 2]`` holding the uint32
    rows' bits, on ``x``'s device.  Torch has no uint32 shift or sum, so
    the lanes are int64 masked to 32 bits after every multiply and shift
    (int64 products wrap, and their low 32 bits stay right), one chunk at
    a time to bound the temporaries."""
    lb = lane_bytes(x.element_size())
    if x.numel() == 0:  # no chunks (and an empty slice may have no lane view)
        return torch.zeros((0, 2), dtype=torch.int32, device=x.device)
    lanes = _lane_view(x, lb)
    mask = (1 << (8 * lb)) - 1
    rows = []
    for off, length in chunk_grid(x.numel() * x.element_size(), chunk_bytes,
                                  use_direct):
        s, e = off // lb, (off + length) // lb
        lane = lanes[s:e].to(torch.int64) & mask
        idx = torch.arange(s, e, dtype=torch.int64, device=x.device)
        h = lane ^ ((idx * _PHI) & _M32)
        h = h ^ (h >> 16)
        h = (h * _MIX1) & _M32
        h = h ^ (h >> 13)
        h = (h * _MIX2) & _M32
        h = h ^ (h >> 16)
        pos = torch.arange(1, e - s + 1, dtype=torch.int64, device=x.device)
        rows.append(torch.stack([h.sum() & _M32, ((h * pos) & _M32).sum() & _M32]))
    out = torch.stack(rows)
    # uint32 values into int32 bits
    return torch.where(out >= 1 << 31, out - (1 << 32), out).to(torch.int32)


@functools.lru_cache(maxsize=32)
def _layout(nbytes: Tuple[int, ...], itemsizes: Tuple[int, ...],
            chunk_bytes: int, use_direct: bool, tile_bytes: int):
    """:func:`batch_plan` of one save's layout, kept across saves (a steady
    state's saves repeat it), and each leaf's row count."""
    table, n_rows, n_tiles = batch_plan(nbytes, itemsizes, chunk_bytes,
                                        use_direct, tile_bytes)
    table.flags.writeable = False
    counts = np.diff(table[:, 6], append=n_rows).tolist()
    return table, n_rows, n_tiles, counts


def _launch(leaves: List[torch.Tensor], chunk_bytes: int,
            use_direct: bool) -> List[torch.Tensor]:
    """One card's leaves through the kernel on the current stream: the
    rows of each leaf, views of one ``int32[rows, 2]`` buffer."""
    layout, n_rows, n_tiles, counts = _layout(
        tuple([t.nbytes for t in leaves]), tuple([t.element_size() for t in leaves]),
        chunk_bytes, use_direct, TILE_BYTES)
    table = layout.copy()
    table[:, 0] = [t.data_ptr() for t in leaves]
    index = leaves[0].get_device()
    out = torch.empty((n_rows, 2), dtype=torch.int32, device=leaves[0].device)
    launched = ctypes.c_int(0)
    rc = _entry("tpurx_chunk_fingerprint_batch")(
        table.ctypes.data, len(leaves), n_rows, n_tiles, TILE_BYTES,
        out.data_ptr(), index, torch._C._cuda_getCurrentRawStream(index),
        ctypes.byref(launched))
    batch_fingerprints.launches += launched.value
    if rc != 0:
        raise RuntimeError(f"chunk fingerprint launch failed: CUDA error {rc}")
    batch_fingerprints.shards += len(leaves)
    return list(out.split(counts))


def batch_fingerprints(
    tensors: Sequence[torch.Tensor],
    chunk_bytes: Optional[int] = None,
    use_direct: Optional[bool] = None,
) -> List[Optional[torch.Tensor]]:
    """Fingerprint rows of many shards: for each, ``int32[n_chunks, 2]``
    holding the uint32 rows' bits, on its device, not yet read back (see
    :func:`read_fingerprints`), or None for a dtype without a lane view
    (that shard stays on the host-crc path).

    The chunk grid (``default_chunk_bytes()``, ``TPURX_CKPT_DIRECT_IO``) is
    read once per call.  The CUDA leaves of each card go through the kernel
    on that card's current stream, ``ceil(n / LEAVES_PER_LAUNCH)`` launches
    over one leaf table, counted in ``batch_fingerprints.launches`` (a
    launch that CUDA refuses raises) and their leaves in
    ``batch_fingerprints.shards``; each leaf's rows are a slice of one
    buffer per card.  CPU leaves take :func:`fingerprint_reference`, leaf
    by leaf.  Every leaf must be contiguous.  A ``DTensor`` is
    fingerprinted by its local shard, as the reference fingerprints each
    addressable shard (the staging keys the rows by (leaf, shard))."""
    if chunk_bytes is None:
        chunk_bytes = default_chunk_bytes()
    if use_direct is None:
        use_direct = _envknobs.CKPT_DIRECT_IO.get()
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    groups: Dict[int, List[int]] = {}   # device index (-1: the CPU) -> leaves
    local = [t.to_local() if isinstance(t, DTensor) else t for t in tensors]
    for i, t in enumerate(local):
        if not supported(t.dtype):
            continue
        if not t.is_contiguous():
            raise ValueError("batch_fingerprints takes contiguous tensors")
        index = t.get_device()
        if index < 0 and not t.is_cpu:
            raise ValueError(
                f"batch_fingerprints runs on CUDA or CPU tensors, not {t.device}")
        groups.setdefault(index, []).append(i)
    for index, idx in groups.items():
        ts = [local[i] for i in idx]
        if index >= 0:
            rows = _launch(ts, chunk_bytes, use_direct)
        else:
            # refuses a chunk size off the lane width, as the launch does
            batch_plan([t.nbytes for t in ts], [t.element_size() for t in ts],
                       chunk_bytes, use_direct)
            rows = [fingerprint_reference(t, chunk_bytes, use_direct) for t in ts]
        for i, r in zip(idx, rows):
            out[i] = r
    return out


batch_fingerprints.launches = 0
batch_fingerprints.shards = 0


def shard_fingerprints(
    data: torch.Tensor,
    chunk_bytes: Optional[int] = None,
    use_direct: Optional[bool] = None,
) -> Optional[torch.Tensor]:
    """The rows of one shard: :func:`batch_fingerprints` of ``[data]``, the
    same kernel and the same counters."""
    return batch_fingerprints([data], chunk_bytes, use_direct)[0]


def read_fingerprints(
    fps: Sequence[Optional[torch.Tensor]],
) -> List[Optional[np.ndarray]]:
    """The host ``uint32[n_chunks, 2]`` rows of many shards.  Rows that are
    slices of one buffer (a :func:`batch_fingerprints` call's, one per
    card) come back with ONE device-to-host copy of that buffer: about 8
    bytes cross the link per 16 MiB chunk instead of the chunk."""
    host: Dict[int, Tuple[int, np.ndarray]] = {}  # id(buffer) -> its rows
    rows: List[Optional[np.ndarray]] = []
    for f in fps:
        if f is None:
            rows.append(None)
            continue
        base = f if f._base is None else f._base
        got = host.get(id(base))
        if got is None:
            got = host[id(base)] = (
                base.storage_offset(),
                base.cpu().numpy().view(np.uint32).reshape(-1, 2))
        first = (f.storage_offset() - got[0]) // 2
        rows.append(got[1][first:first + f.shape[0]])
    return rows


def host_fingerprints(
    buf,
    dtype,
    chunk_bytes: Optional[int] = None,
    use_direct: Optional[bool] = None,
) -> Optional[np.ndarray]:
    """The numpy oracle over HOST bytes (``dtype`` a numpy dtype of the
    bytes' width): same lanes, same sums, numpy uint32 wraparound."""
    dt = np.dtype(dtype)
    if not _host_supported(dt):
        return None
    raw = np.frombuffer(buf, dtype=np.uint8)
    lb = lane_bytes(dt.itemsize)
    lanes = (
        raw.view(np.uint32) if lb == 4 else raw.view(f"u{lb}").astype(np.uint32)
    )
    if chunk_bytes is None:
        chunk_bytes = default_chunk_bytes()
    grid = chunk_grid(len(raw), chunk_bytes, use_direct)
    rows = np.empty((len(grid), 2), dtype=np.uint32)
    with np.errstate(over="ignore"):
        idx = np.arange(len(lanes), dtype=np.uint32)
        h = lanes ^ (idx * np.uint32(_PHI))
        h = h ^ (h >> np.uint32(16))
        h = h * np.uint32(_MIX1)
        h = h ^ (h >> np.uint32(13))
        h = h * np.uint32(_MIX2)
        h = h ^ (h >> np.uint32(16))
        for i, (off, length) in enumerate(grid):
            seg = h[off // lb : (off + length) // lb]
            pos = np.arange(1, len(seg) + 1, dtype=np.uint32)
            rows[i, 0] = np.uint32(seg.sum(dtype=np.uint64) & 0xFFFFFFFF)
            rows[i, 1] = np.uint32(
                (seg * pos).sum(dtype=np.uint64) & 0xFFFFFFFF
            )
    return rows


@dataclasses.dataclass
class DigestContext:
    """Everything staging needs to turn device fingerprints into per-shard
    transfer decisions.  Built by the checkpointer per save from the
    committed baseline (``_after_commit``); ``allow_skip`` additionally
    requires the pooled shm tree to HOLD the baseline generation's bytes
    (``StagedTree.content_id``) — a skipped shard's segment is published
    resident as-is, so its bytes must equal the current device bytes, which
    the fingerprint match only proves relative to the baseline."""

    # committed baseline, keyed (leaf_idx, shard_idx):
    base_rows: Dict[Tuple[int, int], Dict[Tuple[int, int], Tuple[int, str]]]
    base_fps: Dict[Tuple[int, int], np.ndarray]
    allow_skip: bool = False
    chunk_bytes: int = dataclasses.field(default_factory=default_chunk_bytes)
    use_direct: Optional[bool] = None

    def verdict(
        self, key: Tuple[int, int], nbytes: int, fp: Optional[np.ndarray]
    ) -> Tuple[Optional[List], Optional[List[Tuple[int, int]]]]:
        """Per-shard decision: ``(skip_spans, dev_unchanged)``.

        ``skip_spans`` non-None => every chunk matched AND skipping is safe:
        the full provenance row list (off, len, crc, base_path).  Otherwise
        ``dev_unchanged`` lists the (off, len) chunks whose fingerprints
        matched (the drain cross-checks them), or None when no comparable
        baseline exists for this shard."""
        base_fp = self.base_fps.get(key)
        rows = self.base_rows.get(key)
        if fp is None or base_fp is None or rows is None:
            return None, None
        grid = chunk_grid(nbytes, self.chunk_bytes, self.use_direct)
        if fp.shape != base_fp.shape or fp.shape[0] != len(grid):
            return None, None  # layout drift: not comparable
        if set(rows.keys()) != set(grid):
            return None, None  # baseline doesn't cover this exact grid
        mask = np.all(fp == base_fp, axis=1)
        if self.allow_skip and bool(mask.all()) and grid:
            return [
                (off, length, rows[(off, length)][0], rows[(off, length)][1])
                for off, length in grid
            ], None
        unchanged = [grid[i] for i in np.flatnonzero(mask)]
        return None, unchanged
