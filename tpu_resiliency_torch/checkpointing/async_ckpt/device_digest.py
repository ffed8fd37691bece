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
:func:`shard_fingerprints` launches it for a CUDA tensor (or raises) and
counts the launch in ``shard_fingerprints.launches``; for a CPU tensor it
takes :func:`fingerprint_reference`, the plain PyTorch version (int64
arithmetic masked to 32 bits, chunk by chunk).  :func:`host_fingerprints`
is the numpy oracle over host bytes.  Complex and other dtypes without a
lane view return None: those shards stay on the host-crc path.

On a mesh the staging fingerprints each **owned local shard** (a
``DTensor`` leaf's box that this process writes), so a save launches the
kernel once per owned device shard, and a process that owns none (the
replicas on ``"data"`` > 0) launches it zero times.

This module and ``staging.py`` are the only device-to-host touchpoints for
checkpoint state.
"""

from __future__ import annotations

import ctypes
import dataclasses
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

_THREADS = 256              # threads of one block (kThreads in the source)
LANES_PER_THREAD = 16       # lanes a thread sums in one chunk, at most
MAX_BLOCKS_PER_CHUNK = 65535

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
    nvcc)."""
    fn = _entries.get(name)
    if fn is None:
        fn = getattr(load_kernel_library(_KERNEL_SOURCE), name)
        vp, i64 = ctypes.c_void_p, ctypes.c_int64
        fn.argtypes = {
            "tpurx_chunk_fingerprint": [vp, ctypes.c_int, i64, i64, i64, i64,
                                        ctypes.c_int, vp, ctypes.c_int, vp],
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


def supported(dtype: torch.dtype) -> bool:
    """Does ``dtype`` have a lane view (a real checkpoint dtype)?"""
    return not dtype.is_complex and str(dtype).removeprefix("torch.") in NAMES


def _host_supported(dtype) -> bool:
    dt = np.dtype(dtype)
    if dt.kind == "c":  # complex: no uint bitcast path; fall back to host
        return False
    return dt.itemsize in (1, 2, 4, 8)


def fingerprint_plan(nbytes: int, itemsize: int, chunk_bytes: int,
                     use_direct: bool) -> Tuple[int, int, int, int, int, int]:
    """The kernel's launch for a shard of ``nbytes``: ``(lane_bytes,
    total_lanes, chunk_lanes, boundary_lane, n_chunks, blocks_per_chunk)``.

    The grid is ``chunk_grid(nbytes, chunk_bytes, use_direct)`` in lanes:
    ``n_low = ceil(boundary / chunk_lanes)`` chunks tile ``[0, boundary)``,
    the rest tile ``[boundary, total)``.  ``chunk_bytes`` must be a
    multiple of the lane width."""
    lb = lane_bytes(itemsize)
    if chunk_bytes < lb or chunk_bytes % lb:
        raise ValueError(
            f"chunk_bytes {chunk_bytes} is not a multiple of the {lb}-byte "
            "lane width")
    aligned_end = (nbytes // 4096) * 4096 if use_direct else 0
    total, chunk, boundary = nbytes // lb, chunk_bytes // lb, aligned_end // lb
    n_chunks = -(-boundary // chunk) + -(-(total - boundary) // chunk)
    blocks = min(MAX_BLOCKS_PER_CHUNK,
                 max(1, -(-min(chunk, total) // (_THREADS * LANES_PER_THREAD))))
    return lb, total, chunk, boundary, n_chunks, blocks


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
    if not rows:
        return torch.zeros((0, 2), dtype=torch.int32, device=x.device)
    out = torch.stack(rows)
    # uint32 values into int32 bits
    return torch.where(out >= 1 << 31, out - (1 << 32), out).to(torch.int32)


def shard_fingerprints(
    data: torch.Tensor,
    chunk_bytes: Optional[int] = None,
    use_direct: Optional[bool] = None,
) -> Optional[torch.Tensor]:
    """Fingerprint rows of one shard: ``int32[n_chunks, 2]`` holding the
    uint32 rows' bits, on ``data``'s device, not yet read back (the caller
    batches readbacks through :func:`read_fingerprints`).  None for a dtype
    without a lane view: that shard stays on the host-crc path.

    On a CUDA tensor this launches the kernel on the current stream and
    counts it in ``shard_fingerprints.launches`` (a launch that CUDA
    refuses raises); on a CPU tensor it takes :func:`fingerprint_reference`.
    ``data`` must be contiguous.  A ``DTensor`` is fingerprinted by its
    local shard: one launch per owned local shard, as the reference
    fingerprints each addressable shard (the staging keys the rows by
    (leaf, shard))."""
    if isinstance(data, DTensor):
        data = data.to_local()
    if not supported(data.dtype):
        return None
    if not data.is_contiguous():
        raise ValueError("shard_fingerprints takes a contiguous tensor")
    if chunk_bytes is None:
        chunk_bytes = default_chunk_bytes()
    if use_direct is None:
        use_direct = _envknobs.CKPT_DIRECT_IO.get()
    nbytes = data.numel() * data.element_size()
    lb, total, chunk, boundary, n_chunks, blocks = fingerprint_plan(
        nbytes, data.element_size(), chunk_bytes, use_direct)
    if data.is_cuda:
        out = torch.empty((n_chunks, 2), dtype=torch.int32, device=data.device)
        if n_chunks == 0:
            return out
        index = data.get_device()
        rc = _entry("tpurx_chunk_fingerprint")(
            data.data_ptr(), lb, total, chunk, boundary, n_chunks, blocks,
            out.data_ptr(), index, torch._C._cuda_getCurrentRawStream(index))
        if rc != 0:
            raise RuntimeError(f"chunk fingerprint launch failed: CUDA error {rc}")
        shard_fingerprints.launches += 1
        return out
    if data.device.type != "cpu":
        raise ValueError(f"shard_fingerprints runs on CUDA or CPU tensors, not {data.device}")
    return fingerprint_reference(data, chunk_bytes, use_direct)


shard_fingerprints.launches = 0


def read_fingerprints(
    fps: Sequence[Optional[torch.Tensor]],
) -> List[Optional[np.ndarray]]:
    """The host ``uint32[n_chunks, 2]`` rows of many shards, with ONE
    device-to-host copy of every card's rows: about 8 bytes cross the link
    per 16 MiB chunk instead of the chunk."""
    live = [f for f in fps if f is not None]
    host: Dict[int, np.ndarray] = {}
    by_dev: Dict[torch.device, List[torch.Tensor]] = {}
    for f in live:
        by_dev.setdefault(f.device, []).append(f)
    for dev, group in by_dev.items():
        flat = torch.cat([f.reshape(-1) for f in group]) if len(group) > 1 \
            else group[0].reshape(-1)
        rows = flat.cpu().numpy().view(np.uint32)
        off = 0
        for f in group:
            n = f.numel()
            host[id(f)] = rows[off:off + n].reshape(f.shape)
            off += n
    return [host[id(f)] if f is not None else None for f in fps]


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
