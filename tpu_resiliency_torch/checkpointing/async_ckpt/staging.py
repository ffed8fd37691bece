"""Pipelined device-to-host staging of tensor trees into shared memory.

The port of ``tpu_resiliency/checkpointing/async_ckpt/staging.py``.  Every
owned tensor leaf is copied, on a copy stream and without blocking the
host, straight into a page-locked POSIX shared-memory segment; the writer
process reads the same segments, so nothing is copied across the process
boundary.  The trainer pays for the enqueue; the copies run under later
steps.

- **The plan precedes the bytes.**  Every shard's size and segment is known
  from metadata alone, so ``on_plan`` fires once with the owned byte total
  before anything moves, and ``on_shard_staged`` fires per shard the moment
  its copy's event completes: the streaming writer persists the first
  shards while later ones are still in flight.
- **Segments are pooled and page-locked once.**  A steady-state save of an
  unchanged layout reuses the previous save's segments (double-buffered by
  the checkpointer): no new shm, no first-touch page faults, and no new
  ``cudaHostRegister``.  A segment that receives a device copy is
  registered when it is created and unregistered before it is closed or
  unlinked, through the C entries of the fingerprint's kernel library
  (ctypes releases the GIL while CUDA pins the pages).  A
  registration that fails raises: a copy into pageable memory would
  silently turn synchronous.
- **Ownership.**  A ``DTensor`` leaf (the sharded model's state,
  ``models/transformer.py::state_tree`` on a mesh) is this process's local
  shard, whose box in the global shape follows from the mesh and the
  placements: :func:`shard_owner_map` gives every distinct box ONE owner,
  the lowest flat mesh index holding it, so a box replicated over
  ``"data"`` (and a fully replicated leaf, whose one box is the whole
  shape) is written once; it asserts that the boxes tile the global shape
  exactly once.  A process that does not own its box records a
  metadata-only entry.  This is the JAX package's ``shard_owner_map`` /
  ``shard_is_owner`` (``staging.py:235-301`` there) over a DeviceMesh
  instead of a device map.  A plain tensor is one shard whose box is the
  whole shape, replicated across the data-parallel world: process 0 writes
  it and every other process records a metadata-only entry (the
  reference's ``_replica_owner`` rule for fully replicated leaves).  Host
  leaves (numpy arrays, scalars) follow the same rule.
- **Device-side change mask** (``device_digest.py``): with a
  :class:`~.device_digest.DigestContext`, every owned tensor shard is
  fingerprinted on its device, one launch per card over all of its shards,
  and one readback of each card's rows decides,
  before any copy is enqueued, which shards transfer at all.  A shard whose
  every chunk matches the committed baseline is recorded as skipped spans
  with their base-generation provenance (``ShardInfo.skip_spans``): no
  transfer, and its pooled segment keeps the (identical) baseline bytes for
  the resident publish.  Shards that do transfer carry their per-chunk
  device verdicts (``ShardInfo.dev_unchanged``) for the drain's crc
  cross-check.

Streams: fingerprints, their readback and the copies run on one copy
stream per device, which first waits on the caller's ``ready`` event (the
snapshot, or the live state in sync mode).  The copy stream reads tensors
allocated on the trainer's stream; they stay referenced until the staging
job's events have completed, so the caching allocator cannot hand their
memory out while a copy reads it.

This module and ``device_digest.py`` are the only device-to-host
touchpoints for checkpoint state.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import math
import threading
import time
from multiprocessing import shared_memory
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from ...parallel.mesh import flat_index
from ...utils.dtypes import dtype_name
from ...utils.logging import get_logger
from ...utils.shm import create_shm, unlink_shm
from ...utils.tree import flatten_with_path
from ..coverage import covers
from . import device_digest as dd

log = get_logger("ckpt.staging")

_copy_streams: Dict[int, "torch.cuda.Stream"] = {}
_streams_lock = threading.Lock()


def copy_stream(device: torch.device) -> "torch.cuda.Stream":
    """The checkpoint copy stream of a CUDA device (one per device)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    with _streams_lock:
        stream = _copy_streams.get(index)
        if stream is None:
            stream = _copy_streams[index] = torch.cuda.Stream(device=index)
        return stream


def pin_shm(shm: shared_memory.SharedMemory) -> int:
    """Page-lock the whole mapping of ``shm`` for CUDA copies; returns
    its address (the key for :func:`unpin`).  Raises on failure."""
    view = np.frombuffer(shm.buf, dtype=np.uint8)
    addr, size = view.ctypes.data, view.nbytes
    del view  # the address stays valid while the mapping lives
    dd.host_register(addr, size)
    return addr


def unpin(addr: int) -> None:
    dd.host_unregister(addr)


def _byte_view(t: torch.Tensor) -> torch.Tensor:
    """Contiguous ``t`` as a flat uint8 view of its bytes."""
    return t.reshape(-1).view(torch.uint8)


def async_d2h(
    pairs: Iterable[Tuple[torch.Tensor, torch.Tensor]],
) -> List[Optional["torch.cuda.Event"]]:
    """Copy each ``(host_dst, src)`` pair (flat uint8 views of equal size):
    a CUDA source is copied without blocking on the current stream, with an
    event recorded after it; a CPU source is copied at once (event None).

    The one sanctioned transfer of checkpoint bytes: every capture path
    funnels through here or through the staging pipeline itself."""
    events: List[Optional[torch.cuda.Event]] = []
    for dst, src in pairs:
        if src.is_cuda:
            dst.copy_(src, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
            events.append(ev)
        else:
            dst.copy_(src)
            events.append(None)
    return events


@dataclasses.dataclass
class ShardInfo:
    leaf_idx: int
    shard_idx: int
    global_shape: Tuple[int, ...]
    index: Tuple[Tuple[int, int], ...]   # (start, stop) per dim in the global array
    dtype: str
    shm_name: str
    nbytes: int
    replica_owner: bool                   # False -> another process owns this data
    # -- per-save device-digest annotations (reset every staging pass) ------
    d2h_skipped: bool = False             # True -> no D2H happened this save
    # full provenance rows (off, len, crc, base_path) for a skipped shard
    skip_spans: Optional[List[Tuple[int, int, int, str]]] = None
    # (off, len) chunks whose device fingerprint matched the baseline, for a
    # shard that transferred anyway (the drain cross-checks host crcs)
    dev_unchanged: Optional[List[Tuple[int, int]]] = None


@dataclasses.dataclass
class StagedTree:
    treedef_repr: str
    leaf_paths: List[str]
    shards: List[ShardInfo]
    plan_sig: str = ""
    bytes_allocated: int = 0              # shm bytes newly created this staging
    bytes_reused: int = 0                 # shm bytes reused from a pooled tree
    stage_wait_s: float = 0.0             # summed per-shard copy completion waits
    stage_copy_s: float = 0.0             # summed host-leaf memcpy into shm
    stage_overlap_pct: float = 0.0        # % of host memcpy overlapped with live D2H
    # host time to enqueue every device-to-host copy of the pass, and the
    # pass's wall time from the first fingerprint to the last shard in shm
    d2h_enqueue_s: float = 0.0
    stage_s: float = 0.0
    segment_s: float = 0.0                # creating and page-locking fresh shm
    d2h_bytes: int = 0                    # bytes copied device -> shm
    d2h_shards: int = 0                   # shards copied device -> shm
    # which save's bytes these shm segments hold (the committed-generation
    # identity the D2H-skip gate compares against the delta baseline)
    content_id: str = ""
    # device fingerprints of every owned tensor shard from the last staging
    # pass, keyed (leaf_idx, shard_idx) — the next save's skip baseline
    device_fps: Dict[Tuple[int, int], np.ndarray] = dataclasses.field(
        default_factory=dict
    )
    device_digest_s: float = 0.0          # fingerprint launch + row readback
    device_digest_launch_s: float = 0.0   # the batched launch alone (host time)
    d2h_skipped_bytes: int = 0            # bytes that never left the device
    _shms: List[shared_memory.SharedMemory] = dataclasses.field(default_factory=list)
    # addresses of the segments page-locked for device copies
    _pinned: List[int] = dataclasses.field(default_factory=list)

    def close(self, unlink: bool = True) -> None:
        for addr in self._pinned:
            try:
                unpin(addr)
            except RuntimeError as exc:  # the mapping is closed below anyway
                log.warning("cudaHostUnregister failed: %s", exc)
        self._pinned.clear()
        for shm in self._shms:
            try:
                shm.close()
                if unlink:
                    unlink_shm(shm)
            except FileNotFoundError:
                pass
        self._shms.clear()

    def shm_buffers(self) -> Dict[str, memoryview]:
        """shm segment name -> its live buffer view (resident read source)."""
        return {shm.name: shm.buf for shm in self._shms}


def _leaf_paths(tree: Any) -> Tuple[Any, List[str], List[Any]]:
    pairs, treedef = flatten_with_path(tree)
    return treedef, [p for p, _ in pairs], [leaf for _, leaf in pairs]


def _whole_box(shape: Tuple[int, ...]) -> Tuple[Tuple[int, int], ...]:
    return tuple((0, int(s)) for s in shape)


Box = Tuple[Tuple[int, int], ...]


def _norm_box(index, global_shape) -> Box:
    """Normalize a per-dim slice tuple to concrete (start, stop) bounds."""
    out = []
    for dim, sl in enumerate(index):
        start = sl.start if sl.start is not None else 0
        stop = sl.stop if sl.stop is not None else global_shape[dim]
        out.append((int(start), int(stop)))
    return tuple(out)


def _box_volume(box: Box) -> int:
    v = 1
    for a, b in box:
        v *= max(0, b - a)
    return v


def mesh_boxes(leaf: DTensor) -> List[Box]:
    """The box of ``leaf`` held at each flat mesh index, in flat order: a
    ``Shard(d)`` placement on a mesh axis of size k splits dimension d
    into k chunks of ``ceil(n / k)`` (``torch.chunk``'s rule, the DTensor
    layout; an even split where k divides n), nested in mesh-axis order;
    ``Replicate`` leaves the dimension whole.  A ``Partial`` leaf has no
    box (its shards are addends) and raises."""
    mesh = leaf.device_mesh
    shape = tuple(int(s) for s in leaf.shape)
    sizes = tuple(int(s) for s in mesh.mesh.shape)
    boxes: List[Box] = []
    for flat in range(math.prod(sizes)):
        coord = np.unravel_index(flat, sizes)
        index = [slice(0, n) for n in shape]
        for axis, pl in enumerate(leaf.placements):
            if pl.is_replicate():
                continue
            if not pl.is_shard():
                raise ValueError(f"cannot checkpoint a {pl} placement")
            d = pl.dim
            lo, hi = index[d].start, index[d].stop
            size = -(-(hi - lo) // sizes[axis])
            start = min(lo + int(coord[axis]) * size, hi)
            index[d] = slice(start, min(start + size, hi))
        boxes.append(_norm_box(index, shape))
    return boxes


def shard_owner_map(leaf: DTensor) -> Dict[Box, int]:
    """Derive the save plan's owner assignment from the placement itself:
    the box at every flat mesh index reduced to ONE owning index per
    distinct box (the lowest), so replicas, including fully replicated
    leaves, where every index holds the whole-shape box, are written
    exactly once mesh-wide.  The flat index orders owners as the device id
    does in the JAX package: every process derives the same owners without
    any exchange.

    Asserts exactly-once global coverage before returning: the distinct
    boxes must cover the global shape (interval accounting) AND their
    volumes must sum to its total element count; cover alone tolerates
    overlapping boxes, which would double-drain bytes."""
    global_shape = tuple(int(s) for s in leaf.shape)
    owners: Dict[Box, int] = {}
    for flat, box in enumerate(mesh_boxes(leaf)):
        owners.setdefault(box, flat)
    boxes = list(owners)
    total = math.prod(global_shape) if global_shape else 1
    vol = sum(_box_volume(b) for b in boxes)
    if vol != total or not covers(global_shape, boxes):
        raise ValueError(
            f"sharding does not tile the global shape exactly once: shape "
            f"{global_shape} has {total} elements but the {len(boxes)} "
            f"distinct index boxes {'cover' if vol > total else 'reach'} "
            f"{vol} — a save from this plan would "
            f"{'double-drain' if vol > total else 'lose'} data"
        )
    return owners


def local_box(leaf: DTensor) -> Box:
    """The box of ``leaf``'s local shard in its global shape (raises if
    the local tensor's shape is not the box's)."""
    box = mesh_boxes(leaf)[flat_index(leaf.device_mesh)]
    local = leaf.to_local()
    if tuple(b - a for a, b in box) != tuple(local.shape):
        raise ValueError(f"local shard {tuple(local.shape)} is not its box {box}")
    return box


def shard_is_owner(leaf: DTensor) -> bool:
    """Does THIS process drain its local shard of ``leaf``?  Yes iff its
    flat mesh index owns its box (:func:`shard_owner_map`)."""
    me = flat_index(leaf.device_mesh)
    return shard_owner_map(leaf)[local_box(leaf)] == me


def plan_signature(tree: Any, process_index: Optional[int] = None) -> str:
    """Cheap metadata-only fingerprint of a save plan: tree structure and
    per-leaf shape, dtype and placement (for a ``DTensor`` its local box,
    replica id and whether it is replicated, as the reference hashes each
    addressable shard).  Two trees with the same signature stage into
    identical shm layouts, so segments and plans are reused across saves."""
    _, paths, leaves = _leaf_paths(tree)
    h = hashlib.sha256()
    h.update(str(process_index).encode())
    for path, leaf in zip(paths, leaves):
        if isinstance(leaf, DTensor):
            shape = tuple(leaf.shape)
            boxes, me = mesh_boxes(leaf), flat_index(leaf.device_mesh)
            # the replica id: this index's rank among those holding its box
            replica = boxes[:me].count(boxes[me])
            rep = all(pl.is_replicate() for pl in leaf.placements)
            sh = f"{boxes[me]}r{replica}|rep={rep}|{leaf.to_local().device}"
            desc = f"{path}|{shape}|{leaf.dtype}|{sh}"
        elif isinstance(leaf, torch.Tensor):
            shape = tuple(leaf.shape)
            sh = f"{_whole_box(shape)}r0|rep=True|{leaf.device}"
            desc = f"{path}|{shape}|{leaf.dtype}|{sh}"
        else:
            desc = (f"{path}|{tuple(np.shape(leaf))}|"
                    f"{getattr(leaf, 'dtype', type(leaf))}|host")
        h.update(f"{desc}\n".encode())
    return h.hexdigest()[:32]


def _replica_owner(pidx: int) -> bool:
    """The ownership rule of a shard replicated across the data-parallel
    world (every plain tensor, every host leaf): process 0 writes it, so N
    processes never write N identical copies."""
    return pidx == 0


@dataclasses.dataclass
class _OwnedWork:
    """One owned shard awaiting its bytes: plan slot + data source."""

    info: ShardInfo
    source: Any          # tensor (CPU or CUDA) or host numpy array
    is_tensor: bool


def stage_pytree(
    tree: Any,
    process_index: int = 0,
    reuse: Optional[StagedTree] = None,
    plan_sig: Optional[str] = None,
    on_plan: Optional[Callable[[int], None]] = None,
    on_shard_staged: Optional[Callable[[ShardInfo], None]] = None,
    digest_ctx: Optional[Any] = None,
    ready: Optional[Dict[torch.device, "torch.cuda.Event"]] = None,
) -> StagedTree:
    """Stage all leaves of ``tree`` into shared memory.

    With ``reuse`` (a previously staged tree whose ``plan_sig`` matches this
    tree's), existing segments are rewritten in place instead of allocated.
    ``on_plan(total_owned_bytes)`` fires once before any bytes move;
    ``on_shard_staged(info)`` fires per owned shard the moment its bytes are
    in shm.  ``digest_ctx`` (a :class:`~.device_digest.DigestContext`) turns
    on the on-device change mask; skipping a shard additionally requires
    ``reuse`` (its pooled segment must keep holding the shard's bytes).
    ``ready`` maps a CUDA device to the event its copy stream waits on
    before reading any tensor (the end of the snapshot); a device without
    one waits on its current stream.  Returns when every owned shard is in shm."""
    treedef, paths, leaves = _leaf_paths(tree)
    pidx = process_index
    sig = plan_sig if plan_sig is not None else plan_signature(tree, pidx)
    reusing = reuse is not None and reuse.plan_sig == sig and bool(reuse._shms)
    if reusing:
        staged = reuse
    else:
        staged = StagedTree(
            treedef_repr=str(treedef), leaf_paths=paths, shards=[], plan_sig=sig
        )
    try:
        return _stage_pipelined(staged, leaves, pidx, reusing,
                                on_plan, on_shard_staged, digest_ctx, ready)
    except BaseException:
        if not reusing:
            staged.close(unlink=True)  # partial staging must not leak shm
        raise


def _build_plan(
    staged: StagedTree, leaves: List[Any], pidx: int, reusing: bool
) -> List[_OwnedWork]:
    """Metadata-only pass: the complete shard list (owned + non-owned)
    before a single byte moves.  Reuse carries the prior plan over verbatim;
    only the data sources are rebound."""
    work: List[_OwnedWork] = []
    if reusing:
        for info in staged.shards:
            if not info.replica_owner:
                continue
            leaf = leaves[info.leaf_idx]
            if isinstance(leaf, DTensor):
                leaf = leaf.to_local()
            if isinstance(leaf, torch.Tensor):
                nbytes = leaf.numel() * leaf.element_size()
                if nbytes != info.nbytes:
                    raise ValueError(
                        f"restage size mismatch on leaf {info.leaf_idx}: "
                        f"{nbytes} != {info.nbytes} (stale plan signature?)"
                    )
                work.append(_OwnedWork(info, leaf, True))
            else:
                work.append(_OwnedWork(info, np.asarray(leaf), False))
        return work

    owner = _replica_owner(pidx)
    for i, leaf in enumerate(leaves):
        if isinstance(leaf, DTensor):
            mine = shard_is_owner(leaf)
            local = leaf.to_local()
            info = ShardInfo(
                leaf_idx=i, shard_idx=0,
                global_shape=tuple(int(s) for s in leaf.shape),
                index=local_box(leaf), dtype=dtype_name(local.dtype),
                shm_name="",
                nbytes=local.numel() * local.element_size() if mine else 0,
                replica_owner=mine,
            )
            staged.shards.append(info)
            if mine:
                work.append(_OwnedWork(info, local, True))
            continue
        if isinstance(leaf, torch.Tensor):
            shape = tuple(int(s) for s in leaf.shape)
            info = ShardInfo(
                leaf_idx=i, shard_idx=0, global_shape=shape,
                index=_whole_box(shape), dtype=dtype_name(leaf.dtype),
                shm_name="",
                nbytes=leaf.numel() * leaf.element_size() if owner else 0,
                replica_owner=owner,
            )
            source, is_tensor = leaf, True
        else:
            arr = np.asarray(leaf)
            info = ShardInfo(
                leaf_idx=i, shard_idx=0, global_shape=tuple(arr.shape),
                index=_whole_box(arr.shape), dtype=str(arr.dtype),
                shm_name="", nbytes=arr.nbytes if owner else 0,
                replica_owner=owner,
            )
            source, is_tensor = arr, False
        staged.shards.append(info)
        if owner:
            work.append(_OwnedWork(info, source, is_tensor))
    return work


def _segment(staged: StagedTree, k: int, w: _OwnedWork, reusing: bool,
             pin: bool) -> shared_memory.SharedMemory:
    """Work item ``k``'s shm segment: the pooled one, or a fresh one
    (page-locked when a device copy lands in it)."""
    if reusing:
        return staged._shms[k]
    shm = create_shm(max(1, w.info.nbytes))
    staged._shms.append(shm)
    w.info.shm_name = shm.name
    if pin:
        staged._pinned.append(pin_shm(shm))
    return shm


def _stage_pipelined(
    staged: StagedTree,
    leaves: List[Any],
    pidx: int,
    reusing: bool,
    on_plan: Optional[Callable[[int], None]],
    on_shard_staged: Optional[Callable[[ShardInfo], None]],
    digest_ctx: Optional[Any] = None,
    ready: Optional[Dict[torch.device, "torch.cuda.Event"]] = None,
) -> StagedTree:
    t_start = time.perf_counter()
    work = _build_plan(staged, leaves, pidx, reusing)
    total = sum(w.info.nbytes for w in work)
    if on_plan is not None:
        on_plan(total)

    # per-save annotations: pooled infos persist across saves, so clear them
    for w in work:
        w.info.d2h_skipped = False
        w.info.skip_spans = None
        w.info.dev_unchanged = None
    staged.device_fps = {}
    staged.device_digest_s = staged.device_digest_launch_s = 0.0
    staged.d2h_skipped_bytes = 0

    # Tensor work by device (None: the CPU), each CUDA device's on one copy
    # stream ordered after the snapshot.
    groups: Dict[Optional[torch.device], List[int]] = {}
    for k, w in enumerate(work):
        if w.is_tensor:
            groups.setdefault(w.source.device if w.source.is_cuda else None,
                              []).append(k)
    streams: Dict[torch.device, torch.cuda.Stream] = {}
    for dev in groups:
        if dev is None:
            continue
        s = streams[dev] = copy_stream(dev)
        ev = (ready or {}).get(dev)
        if ev is not None:
            s.wait_event(ev)
        else:
            s.wait_stream(torch.cuda.current_stream(dev))

    def on_stream(dev: Optional[torch.device]):
        return torch.cuda.stream(streams[dev]) if dev is not None \
            else contextlib.nullcontext()

    if digest_ctx is not None:
        # On-device change mask BEFORE any transfer is issued: fingerprint
        # every owned tensor shard where its bytes live (one launch per card
        # over all of its shards), then one readback of each card's rows
        # decides transfer-vs-skip per shard.
        t0 = time.perf_counter()
        fps_dev: List[Optional[torch.Tensor]] = [None] * len(work)
        for dev, ks in groups.items():
            with on_stream(dev):
                rows = dd.batch_fingerprints(
                    [work[k].source for k in ks], digest_ctx.chunk_bytes,
                    digest_ctx.use_direct)
            for k, fp in zip(ks, rows):
                fps_dev[k] = fp
        staged.device_digest_launch_s = time.perf_counter() - t0
        with contextlib.ExitStack() as on_all:
            # each device's readback is ordered after its fingerprints
            for stream in streams.values():
                on_all.enter_context(torch.cuda.stream(stream))
            fps = dd.read_fingerprints(fps_dev)
        staged.device_digest_s = time.perf_counter() - t0
        for w, fp in zip(work, fps):
            if fp is None:
                continue
            key = (w.info.leaf_idx, w.info.shard_idx)
            staged.device_fps[key] = fp
            skip_rows, unchanged = digest_ctx.verdict(key, w.info.nbytes, fp)
            if skip_rows is not None and reusing:
                # pooled segment k keeps the baseline generation's bytes —
                # identical to the current ones, per the fingerprint match
                w.info.d2h_skipped = True
                w.info.skip_spans = skip_rows
                staged.d2h_skipped_bytes += w.info.nbytes
            elif unchanged is not None:
                w.info.dev_unchanged = unchanged

    # Segments in work order (a fresh plan appends them, a pooled one holds
    # them at the same positions).
    t0 = time.perf_counter()
    shms = {
        k: _segment(staged, k, w, reusing,
                    pin=w.is_tensor and w.source.is_cuda)
        for k, w in enumerate(work) if not w.info.d2h_skipped
    }
    staged.segment_s = time.perf_counter() - t0
    # Enqueue every device copy before waiting on any: all transfers are in
    # flight while the shards that landed first stream to the writer.
    t0 = time.perf_counter()
    pending: Dict[int, Tuple[Optional[torch.cuda.Event], torch.Tensor]] = {}
    d2h_bytes = d2h_shards = 0
    try:
        for dev, ks in groups.items():
            ks = [k for k in ks if not work[k].info.d2h_skipped]
            pairs = [(torch.frombuffer(shms[k].buf, dtype=torch.uint8,
                                       count=max(1, src.numel()))[:src.numel()], src)
                     for k, src in ((k, _byte_view(work[k].source)) for k in ks)]
            with on_stream(dev):
                events = async_d2h(pairs)
            for k, (dst, src), ev in zip(ks, pairs, events):
                pending[k] = (ev, dst)
                if dev is not None:
                    d2h_bytes += src.numel()
                    d2h_shards += 1
            del pairs
        staged.d2h_enqueue_s = time.perf_counter() - t0

        # skipped shards complete instantly: stream their provenance-only
        # payloads first so the drain credits their bytes before any wait
        if on_shard_staged is not None:
            for w in work:
                if w.info.d2h_skipped:
                    on_shard_staged(w.info)

        in_flight = sum(1 for ev, _ in pending.values() if ev is not None)
        wait_s = copy_s = hidden_copy_s = 0.0
        for k, w in enumerate(work):
            if w.info.d2h_skipped:
                continue  # slot k's shm keeps the (identical) baseline bytes
            t0 = time.perf_counter()
            if w.is_tensor:
                ev, dst = pending.pop(k)
                if ev is not None:
                    ev.synchronize()  # THIS shard's copy only
                    in_flight -= 1
                del dst  # release the buffer export of the segment
                wait_s += time.perf_counter() - t0
            else:
                arr = w.source
                if arr.nbytes != w.info.nbytes:
                    raise ValueError(
                        f"restage size mismatch on leaf {w.info.leaf_idx}: "
                        f"{arr.nbytes} != {w.info.nbytes} (stale plan signature?)"
                    )
                dst = np.ndarray(arr.shape, dtype=arr.dtype, buffer=shms[k].buf)
                np.copyto(dst, arr, casting="no")
                del dst
                dt = time.perf_counter() - t0
                copy_s += dt
                if in_flight > 0:  # this memcpy ran under at least one live copy
                    hidden_copy_s += dt
            if on_shard_staged is not None:
                on_shard_staged(w.info)
    except BaseException:
        # no copy may still read a snapshot slot or write a segment once the
        # caller lets go of them
        for s in streams.values():
            s.synchronize()
        pending.clear()
        raise

    owned_bytes = sum(w.info.nbytes for w in work)
    staged.bytes_allocated = 0 if reusing else owned_bytes
    staged.bytes_reused = owned_bytes if reusing else 0
    staged.stage_wait_s = wait_s
    staged.stage_copy_s = copy_s
    staged.stage_overlap_pct = 100.0 * hidden_copy_s / copy_s if copy_s > 0 else 0.0
    staged.d2h_bytes = d2h_bytes
    staged.d2h_shards = d2h_shards
    staged.stage_s = time.perf_counter() - t_start
    return staged


def shard_payload(info: ShardInfo) -> Dict[str, Any]:
    """Picklable description handed to the writer process.  Skipped shards
    travel as provenance-only payloads (``skip_spans``, no shm — the bytes
    never left the device); transferred shards under an active device
    digest carry their per-chunk verdicts (``dev_unchanged``) for the
    drain's crc cross-check."""
    shape = tuple(b - a for a, b in info.index)
    p = {
        "leaf_idx": info.leaf_idx,
        "shard_idx": info.shard_idx,
        "global_shape": list(info.global_shape),
        "index": [list(pair) for pair in info.index],
        "dtype": info.dtype,
        "shm_name": info.shm_name,
        "shape": list(shape),
        "nbytes": info.nbytes,
    }
    if info.skip_spans is not None:
        p["shm_name"] = ""
        p["skip_spans"] = [list(r) for r in info.skip_spans]
    elif info.dev_unchanged is not None:
        p["dev_unchanged"] = [list(t) for t in info.dev_unchanged]
    return p
