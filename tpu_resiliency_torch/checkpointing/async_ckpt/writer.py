"""Sharded checkpoint on-disk format + chunked multi-writer drain engine.

Reference analog: ``FileSystemWriterAsync`` (``filesystem_async.py:154``)
minus torch DCP.  Layout:

    <ckpt_dir>/
      process_<p>/shard_<leaf>_<k>.bin     per owned shard, raw little-endian
                                           bytes (shape/dtype in the index)
      process_<p>.json                     per-process shard index ("commit")
      metadata.json                        global metadata — the atomic commit
                                           marker, written at finalize by the
                                           coordinating rank

A checkpoint is valid iff ``metadata.json`` exists (written via temp-file +
rename).  The writer runs in the background worker process and reads staged
data from shared memory by name — nothing heavy crosses the queue.

Drain engine (:class:`_WriteEngine`):

- **Chunked streaming writes.**  Every shard is split into fixed
  ``TPURX_CKPT_CHUNK_BYTES`` chunks (default 16 MiB) written by ``pwrite``
  at their final offsets, so one multi-GiB shard interleaves across the
  whole thread pool instead of serializing behind a single ``f.write``.
  The byte layout of each shard file is identical to the unchunked format —
  readers (``read_leaf`` and the local-checkpoint fallback path) are
  layout-compatible by construction.
- **Direct I/O when available.**  Shm segments are page-aligned, so aligned
  chunks go down with ``O_DIRECT`` — no page-cache double copy, which cuts
  writer CPU per byte by >100x on cache-hostile hosts and keeps the niced
  drain from stealing foreground cycles.  Unaligned tails and filesystems
  without O_DIRECT support (tmpfs) fall back to buffered writes per file.
  Disable wholesale with ``TPURX_CKPT_DIRECT_IO=0``.
- **Batched durability.**  One ``fdatasync`` per shard file when its last
  chunk lands (then the tmp→final rename), plus a single directory fsync
  after the index rename — not fsync-per-temp-file.
- **Size-bucketed work stealing.**  Chunk tasks land in log2-size buckets;
  each of the ``os.cpu_count()``-sized pool's threads always takes from the
  largest non-empty bucket, so big shards never pin one thread while the
  rest idle (reference ``_split_by_size_and_type``,
  ``filesystem_async.py:1318``).
- **Streaming plan.**  ``write_process_shards_streamed`` consumes shard
  payloads as staging produces them (see ``staging.py`` ``on_shard_staged``)
  and reports drain progress (bytes written / total) through the worker
  pipe, so the drain starts persisting the first staged shards while later
  leaves are still in flight.
- **Content digests.**  Every chunk is crc32'd as it is written (the bytes
  are already in cache, and ``zlib.crc32`` releases the GIL, so the digest
  hides behind the pool's I/O waits); the per-chunk ``(off, len, crc)``
  spans plus a composed per-shard digest (``integrity.combine_crcs``) land
  in the process index and — via the metadata merge — in ``metadata.json``.
  ``read_leaf`` verifies every shard against them through the verifying
  reader before a single element reaches a template leaf.  Disable with
  ``TPURX_CKPT_DIGEST=0`` (or per-save ``digest=False``) for A/B
  measurement; readers treat digest-less shards as legacy (size check only).
- **Device-digest integration.**  When the on-device fingerprint kernel ran
  (``device_digest.py``), payloads arrive annotated: a shard every one of
  whose chunks matched the committed baseline comes as a ``skip_spans``
  payload — no shm, no D2H ever happened; the sink materializes a sparse
  file whose index rows are pure provenance, and its bytes count toward
  drain progress at ``add_payload`` time.  Shards that do transfer carry
  the per-chunk device verdicts (``dev_unchanged``) and every chunk's host
  crc verdict is cross-checked against them — disagreement is a detected
  corruption class: the save aborts and the partial file is quarantined
  ``*.corrupt``, never committed.
"""

from __future__ import annotations

import collections
import json
import mmap
import os
import queue as queue_mod
import threading
import time

from ...telemetry import BYTE_BUCKETS, counter, gauge, histogram
from ...utils import env as _envknobs
from ...utils.logging import get_logger
from ...utils.shm import attach_shm
from ..coverage import contiguous_offset, covers
from ..integrity import (
    ChunkReader,
    combine_crcs,
    crc32,
    quarantine_blob,
    read_verified_shard,
    record_corruption,
    span_plan,
    verify_chunk,
    verify_composed,
)

log = get_logger("ckpt_writer")
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np

_ALIGN = 4096  # O_DIRECT offset/length/address granularity (conservative)

# These live in whichever process runs the engine — the async worker for
# background drains, the trainer for in-process writes; each exposes its own
# endpoint, so the series never mix.
_WRITE_BYTES = counter(
    "tpurx_ckpt_write_bytes_total", "Checkpoint bytes written to disk"
)
_WRITE_CHUNKS = counter(
    "tpurx_ckpt_write_chunks_total", "Chunk writes issued by the drain engine"
)
_SHARD_BYTES = histogram(
    "tpurx_ckpt_shard_bytes", "Shard size distribution", buckets=BYTE_BUCKETS
)
_DRAIN_NS = histogram(
    "tpurx_ckpt_drain_duration_ns", "Engine lifetime: first payload to index commit"
)
_DRAIN_BPS = gauge(
    "tpurx_ckpt_drain_throughput_bps", "Last completed drain's write throughput"
)
_DRAIN_STALL_NS = histogram(
    "tpurx_ckpt_drain_stall_ns",
    "Time the drain pool spent with work pending but no chunk in flight "
    "(producer-bound staging)",
)
# restore (read-engine) series: the mirror image of the write-side drain
_RESTORE_BYTES = counter(
    "tpurx_ckpt_restore_bytes_total", "Checkpoint bytes read by the restore engine"
)
_RESTORE_CHUNKS = counter(
    "tpurx_ckpt_restore_chunks_total", "Chunk reads issued by the restore engine"
)
_RESTORE_NS = histogram(
    "tpurx_ckpt_restore_ns",
    "Restore engine lifetime: plan built to last leaf assembled",
)
_RESTORE_BPS = gauge(
    "tpurx_ckpt_restore_throughput_bps", "Last completed restore's read throughput"
)
_RESTORE_VERIFY_NS = histogram(
    "tpurx_ckpt_restore_verify_ns",
    "CPU ns spent crc-verifying chunks in-flight across one restore's "
    "reader pool",
)
_RESTORE_THREADS = gauge(
    "tpurx_ckpt_restore_threads", "Reader pool size used by the last restore"
)
_RESTORE_SOURCE = counter(
    "tpurx_ckpt_restore_source_total",
    "Restored bytes by warm-ladder rung (shm = resident generation, disk = "
    "shard files; the local-manager ladder adds its own rung labels)",
    labels=("source",),
)
_DELTA_SKIPPED_BYTES = counter(
    "tpurx_ckpt_delta_skipped_bytes_total",
    "Bytes a delta save did NOT drain because the chunk crc matched the "
    "previous committed generation",
)
_D2H_SKIPPED_BYTES = counter(
    "tpurx_ckpt_d2h_skipped_bytes_total",
    "Bytes a delta save never transferred off-device: the on-device "
    "fingerprint kernel proved every chunk of the shard unchanged against "
    "the committed baseline, so no D2H was issued at all",
)
_DIGEST_DISAGREE = counter(
    "tpurx_ckpt_device_digest_disagreements_total",
    "Transferred chunks whose on-device fingerprint verdict contradicted "
    "the host crc32 verdict against the same baseline — a detected "
    "corruption class (torn D2H or stale staging buffer); the save aborts",
)


def _join_pool(threads: List["threading.Thread"], what: str,
               timeout_s: float = 60.0) -> List[str]:
    """Join an engine's worker pool with a wall-clock bound.

    Workers exit deterministically once ``_closed``/``_error`` is set (their
    cv waits are 5s-bounded predicate loops), so a thread still alive after
    ``timeout_s`` is wedged in a syscall — return its name so the caller can
    surface that instead of parking the trainer forever."""
    deadline = time.monotonic() + timeout_s
    for t in threads:
        t.join(timeout=max(0.0, deadline - time.monotonic()))
    return [t.name for t in threads if t.is_alive()]


def default_chunk_bytes() -> int:
    try:
        n = _envknobs.CKPT_CHUNK_BYTES.get()
    except ValueError:
        n = 16 << 20
    # chunk boundaries must stay O_DIRECT-aligned; floor to the alignment
    return max(_ALIGN, (n // _ALIGN) * _ALIGN)


def resolve_write_threads(requested: Optional[int] = None) -> int:
    """Writer pool size: explicit request wins; otherwise sized from the
    host (2x cpu_count, clamped) — chunk writes are I/O-bound and release
    the GIL, so oversubscribing cores keeps the device queue full."""
    if requested:
        return max(1, int(requested))
    return min(16, max(4, 2 * (os.cpu_count() or 2)))


def resolve_restore_threads(requested: Optional[int] = None) -> int:
    """Reader pool size: explicit request, then ``TPURX_CKPT_RESTORE_THREADS``,
    then the write-engine sizing — preads and ``zlib.crc32`` both release
    the GIL, so the same oversubscription argument applies on the read
    side."""
    if requested:
        return max(1, int(requested))
    try:
        n = _envknobs.CKPT_RESTORE_THREADS.get()
    except ValueError:
        n = 0
    if n > 0:
        return n
    return resolve_write_threads(None)


def chunk_grid(
    nbytes: int,
    chunk_bytes: Optional[int] = None,
    use_direct: Optional[bool] = None,
) -> List[Tuple[int, int]]:
    """The drain engine's chunk layout for one shard: ``(off, length)``
    spans.  Chunks never straddle the direct/buffered boundary — the region
    below the O_DIRECT-aligned end splits into block-aligned chunks, the
    unaligned tail is one buffered chunk.

    This layout is a FORMAT contract, not an engine detail: the index's
    per-chunk crc rows, the delta baseline's match keys, and the on-device
    fingerprint kernel (``device_digest.py``) all address bytes by this
    grid.  It is deterministic given ``(nbytes, chunk_bytes, use_direct)``
    so the device side reproduces exactly the grid the host crcs use."""
    if chunk_bytes is None:
        chunk_bytes = default_chunk_bytes()
    if use_direct is None:
        use_direct = _envknobs.CKPT_DIRECT_IO.get()
    aligned_end = (nbytes // _ALIGN) * _ALIGN if use_direct else 0
    chunks: List[Tuple[int, int]] = []
    for lo, hi in ((0, aligned_end), (aligned_end, nbytes)):
        off = lo
        while off < hi:
            chunks.append((off, min(chunk_bytes, hi - off)))
            off += chunk_bytes
    return chunks


def shard_filename(leaf_idx: int, shard_idx: int) -> str:
    return f"shard_{leaf_idx}_{shard_idx}.bin"


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY | getattr(os, "O_DIRECTORY", 0))
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class _ShardSink:
    """One shard file being assembled from chunks (possibly by many threads)."""

    def __init__(self, pdir: str, payload: Dict[str, Any], use_direct: bool,
                 digest: bool = True):
        self.payload = payload
        self.nbytes = int(payload["nbytes"])
        self.final = os.path.join(
            pdir, shard_filename(payload["leaf_idx"], payload["shard_idx"])
        )
        self.tmp = self.final + ".tmp"
        self.shm = None
        self.lock = threading.Lock()
        self.chunks_left = 0           # set by the engine before enqueueing
        self.digest = digest
        # delta baseline: {(off, len): (crc, base_path)} from the previous
        # committed generation — chunks whose fresh crc matches skip the
        # write entirely and record provenance instead.  Requires digests
        # (the crc IS the match key); popped so the index never carries it.
        _delta = payload.pop("delta", None)
        self.delta: Optional[Dict[Tuple[int, int], Tuple[int, str]]] = (
            _delta if digest else None
        )
        self.chunk_digests: List[Tuple[int, int, int]] = []  # (off, len, crc)
        self.base_spans: List[Tuple[int, int, int, str]] = []  # + base path
        self.bytes_skipped = 0
        self.crc_ns = 0                # CPU ns spent digesting (stats)
        # device-digest cross-check: the (off, len) spans whose ON-DEVICE
        # fingerprint matched the committed baseline.  For every chunk that
        # transfers anyway, write_chunk demands the host crc verdict agree
        # — disagreement is detected corruption (torn D2H / stale staging
        # buffer) and fails the save before anything commits.
        _dev = payload.pop("dev_unchanged", None)
        self.dev_unchanged: Optional[set] = (
            {(int(a), int(b)) for a, b in _dev}
            if digest and _dev is not None else None
        )
        self.corrupt = False           # cross-check tripped: quarantine tmp
        # fully-skipped shard: the device fingerprints proved EVERY chunk
        # unchanged, so staging issued no D2H and there is no shm segment.
        # complete() materializes the sparse file + provenance rows from
        # these (off, len, crc, base_path) spans alone.
        _skip = payload.pop("skip_spans", None)
        self.skip_all = bool(_skip)
        if self.skip_all:
            if not digest:
                # the provenance rows ARE the shard's only content — without
                # digests in the index the sparse file would restore zeros
                raise ValueError(
                    "skip_spans payload requires digest=True (provenance "
                    "rows are the shard's only on-disk content)"
                )
            self.base_spans = [
                (int(o), int(ln), int(c), str(b)) for o, ln, c, b in _skip
            ]
            self.bytes_skipped = sum(s[1] for s in self.base_spans)
            self.delta = {}  # non-None: complete() must ftruncate to size
            use_direct = False  # nothing to write; one buffered fd suffices
        self.fd_direct = -1
        self.fd_buf = -1
        # the planned direct/buffered split; if the O_DIRECT open later
        # fails (tmpfs & friends), "direct" chunks just route buffered —
        # buffered pwrite accepts any offset/length
        self._want_direct = use_direct
        self.aligned_end = (self.nbytes // _ALIGN) * _ALIGN if use_direct else 0
        self._opened = False

    def _ensure_open(self) -> None:
        """fds + shm attach happen at FIRST write, not at enqueue: a
        many-shard save holds O(pool-front) descriptors, not O(shards)."""
        with self.lock:
            if self._opened:
                return
            try:
                os.unlink(self.tmp)  # stale tmp from a crashed predecessor
            except OSError:
                pass
            if not self.skip_all:
                self.shm = attach_shm(self.payload["shm_name"])
            if self._want_direct and self.aligned_end > 0:
                try:
                    self.fd_direct = os.open(
                        self.tmp, os.O_WRONLY | os.O_CREAT | os.O_DIRECT, 0o644
                    )
                    if self.delta is None:
                        # delta shards stay sparse where chunks are skipped —
                        # preallocating the full extent would pay the blocks
                        # the delta exists to avoid
                        try:
                            os.posix_fallocate(
                                self.fd_direct, 0, self.aligned_end
                            )
                        except OSError:
                            pass  # no fallocate: extending pwrites still work
                except (OSError, AttributeError):
                    self.fd_direct = -1  # tmpfs & friends: buffered fallback
            if self.fd_direct < 0 or self.aligned_end < self.nbytes or self.nbytes == 0:
                self.fd_buf = os.open(self.tmp, os.O_WRONLY | os.O_CREAT, 0o644)
            self._opened = True

    def write_chunk(self, off: int, length: int) -> bool:
        """Drain one chunk.  Returns True if bytes hit the file, False when
        a delta baseline proved the chunk unchanged (provenance recorded
        instead of a write)."""
        self._ensure_open()
        if self.skip_all:
            return False  # no shm, no bytes: the one task just opens the fd
        mv = self.shm.buf[off : off + length]
        try:
            if self.digest and length:
                t0 = time.monotonic_ns()
                c = crc32(mv)
                crc_spent = time.monotonic_ns() - t0
                base = None
                if self.delta is not None:
                    ent = self.delta.get((off, length))
                    if ent is not None and int(ent[0]) == c:
                        base = str(ent[1])
                    if self.dev_unchanged is not None:
                        self._cross_check(off, length, base is not None)
                with self.lock:
                    self.crc_ns += crc_spent
                    if base is not None:
                        self.base_spans.append((off, length, c, base))
                        self.bytes_skipped += length
                    else:
                        self.chunk_digests.append((off, length, c))
                if base is not None:
                    return False
            if self.fd_direct >= 0 and off < self.aligned_end:
                fd = self.fd_direct
            else:
                fd = self.fd_buf
            written = 0
            while written < length:
                written += os.pwrite(fd, mv[written:], off + written)
            return True
        finally:
            mv.release()

    def _cross_check(self, off: int, length: int, host_unchanged: bool) -> None:
        """Device-vs-host verdict agreement for one transferred chunk.

        Both sides judged the SAME chunk against the SAME committed
        baseline: the device fingerprint before staging, the host crc32
        after D2H.  If the staged bytes are the device bytes, the verdicts
        must agree.  Disagreement means the bytes changed in flight — a
        torn D2H, a stale staging buffer, or (device-unchanged /
        host-changed only) a fingerprint collision, which at 64 bits is
        negligible next to the corruption it would mask — so the save
        fails closed and the partial output is quarantined, never
        committed."""
        dev_unchanged = (off, length) in self.dev_unchanged
        if dev_unchanged == host_unchanged:
            return
        _DIGEST_DISAGREE.inc()
        with self.lock:
            self.corrupt = True
        raise record_corruption(
            "device_digest",
            f"device_digest: shard {os.path.basename(self.final)} chunk at "
            f"offset {off} (+{length} bytes): on-device fingerprint says "
            f"{'unchanged' if dev_unchanged else 'changed'} but host crc32 "
            f"says {'unchanged' if host_unchanged else 'changed'} against "
            f"the same baseline — staged bytes are not the device bytes; "
            f"save aborted",
        )

    def complete(self) -> None:
        """Last chunk landed: one durability pass + atomic rename; the
        chunk digests recorded along the way fold into the payload so the
        process index carries them.  Delta shards additionally extend the
        file to full logical size (skipped regions stay sparse holes) and
        record per-chunk provenance: a 4th element indexing into the
        payload's ``bases`` path list names the file physically holding
        that chunk's bytes."""
        self._ensure_open()  # zero-chunk (empty) shards still create a file
        if self.delta is not None and self.base_spans:
            fd = self.fd_buf if self.fd_buf >= 0 else self.fd_direct
            os.ftruncate(fd, self.nbytes)
        for fd in (self.fd_direct, self.fd_buf):
            if fd >= 0:
                os.fdatasync(fd)
                os.close(fd)
        self.fd_direct = self.fd_buf = -1
        if self.digest:
            bases: List[str] = []
            base_idx: Dict[str, int] = {}
            rows: List[List] = [list(s) for s in self.chunk_digests]
            for off, length, c, path in self.base_spans:
                i = base_idx.get(path)
                if i is None:
                    i = base_idx[path] = len(bases)
                    bases.append(path)
                rows.append([off, length, c, i])
            rows.sort(key=lambda r: r[0])
            self.payload["chunks"] = rows
            self.payload["crc"] = combine_crcs([r[2] for r in rows])
            if bases:
                self.payload["bases"] = bases
        os.replace(self.tmp, self.final)
        self._close_shm()

    def discard(self) -> None:
        for fd in (self.fd_direct, self.fd_buf):
            if fd >= 0:
                try:
                    os.close(fd)
                except OSError:
                    pass
        self.fd_direct = self.fd_buf = -1
        if self.corrupt:
            # keep the disagreeing bytes for post-mortem: rename to
            # *.corrupt (counted/quarantined like every other detected
            # corruption) instead of deleting the evidence
            quarantine_blob(self.tmp, site="device_digest")
        else:
            try:
                os.unlink(self.tmp)
            except OSError:
                pass
        self._close_shm()

    def _close_shm(self) -> None:
        shm, self.shm = self.shm, None
        if shm is not None:
            try:
                shm.close()
            except (OSError, BufferError):
                pass  # exported buffer views can outlive the drain


class _WriteEngine:
    """Multi-writer chunk pool: payloads in (incrementally), durable shard
    files + process index out."""

    def __init__(
        self,
        ckpt_dir: str,
        process_index: int,
        num_threads: Optional[int],
        save_id: str,
        plan_sig: str,
        progress_cb: Optional[Callable[[int, int], None]] = None,
        chunk_bytes: Optional[int] = None,
        digest: Optional[bool] = None,
    ):
        self.ckpt_dir = ckpt_dir
        self.process_index = process_index
        self.num_threads = resolve_write_threads(num_threads)
        self.save_id = save_id
        self.plan_sig = plan_sig
        self.chunk_bytes = chunk_bytes or default_chunk_bytes()
        if digest is None:
            digest = _envknobs.CKPT_DIGEST.get()
        self.digest = digest
        self.use_direct = _envknobs.CKPT_DIRECT_IO.get()
        self.pdir = os.path.join(ckpt_dir, f"process_{process_index}")
        os.makedirs(self.pdir, exist_ok=True)
        self._progress_cb = progress_cb
        self._progress_last = 0.0
        self._t0_ns = time.monotonic_ns()
        self.total_bytes: Optional[int] = None  # announced plan total, if any
        self.bytes_written = 0
        self.bytes_skipped = 0       # delta: crc-matched chunks not drained
        self.bytes_d2h_skipped = 0   # subset that never even left the device
        self.chunks_skipped = 0
        self.payloads_done: List[Dict[str, Any]] = []
        self._sinks: List[_ShardSink] = []
        self._cv = threading.Condition()
        # log2-size buckets of (sink, off, length); threads drain largest-first
        self._buckets: Dict[int, collections.deque] = {}
        self._pending_chunks = 0  # guarded-by: _cv
        self._closed = False
        self._error: Optional[BaseException] = None
        self._threads = [
            threading.Thread(
                target=self._worker, name=f"tpurx-ckpt-w{i}", daemon=True
            )
            for i in range(self.num_threads)
        ]
        for t in self._threads:
            t.start()

    # -- producer side -----------------------------------------------------

    def announce_total(self, total_bytes: int) -> None:
        self.total_bytes = total_bytes
        self._report_progress(force=True)

    def add_payload(self, payload: Dict[str, Any]) -> None:
        if not payload.get("shm_name") and not payload.get("skip_spans"):
            return  # non-owned: metadata-only entry, nothing to write
        sink = _ShardSink(self.pdir, payload, self.use_direct, self.digest)
        _SHARD_BYTES.observe(sink.nbytes)
        if sink.skip_all:
            # D2H-skipped shard: no bytes ever left the device, so there is
            # nothing for the pool to digest or write — one no-op task just
            # materializes the sparse provenance file.  Credit the skipped
            # bytes toward progress NOW, not when a pool thread reaches the
            # task: drain_progress() (and the stall/cadence telemetry built
            # on it) must see skipped bytes the moment the plan does, or a
            # mostly-frozen delta save reads as stalled below 100%.
            sink.chunks_left = 1
            with self._cv:
                if self._error is not None:
                    sink.discard()
                    return
                self._sinks.append(sink)
                self.bytes_skipped += sink.bytes_skipped
                self.bytes_d2h_skipped += sink.bytes_skipped
                self.chunks_skipped += len(sink.base_spans)
                self._buckets.setdefault(0, collections.deque()).append(
                    (sink, 0, 0)
                )
                self._pending_chunks += 1
                self._cv.notify_all()
            _DELTA_SKIPPED_BYTES.inc(sink.bytes_skipped)
            _D2H_SKIPPED_BYTES.inc(sink.bytes_skipped)
            self._report_progress(force=True)
            return
        chunks = chunk_grid(sink.nbytes, self.chunk_bytes, self.use_direct)
        if not chunks:
            chunks.append((0, 0))  # empty shard still produces its file
        sink.chunks_left = len(chunks)
        with self._cv:
            if self._error is not None:
                sink.discard()
                return
            self._sinks.append(sink)
            for off, length in chunks:
                self._buckets.setdefault(length.bit_length(), collections.deque()).append(
                    (sink, off, length)
                )
                self._pending_chunks += 1
            self._cv.notify_all()

    def finish(self) -> Dict[str, Any]:
        """Wait for every chunk, then commit the per-process index (its
        atomic rename is the per-process commit) and fsync the directory.
        Returns drain stats (bytes/chunks/digest accounting) — the worker
        reports them back to the trainer in the done frame."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
            while self._pending_chunks > 0 and self._error is None:
                # bounded wait inside a predicate loop: a lost notify (or a
                # worker dying between decrement and notify) re-checks within
                # 5s instead of parking the drain forever
                self._cv.wait(timeout=5.0)
            err = self._error
        wedged = _join_pool(self._threads, "ckpt drain")
        if err is None and wedged:
            err = TimeoutError(
                f"ckpt drain: writer thread(s) {wedged} did not exit "
                f"(wedged in I/O); save aborted"
            )
        if err is not None:
            self._discard_all()
            raise err
        index = {
            "process_index": self.process_index,
            "save_id": self.save_id,
            "plan_sig": self.plan_sig,
            "write_threads": self.num_threads,
            "chunk_bytes": self.chunk_bytes,
            "digest": self.digest,
            "shards": [
                {k: v for k, v in p.items() if k != "shm_name"}
                for p in self.payloads_done
            ],
        }
        idx_path = os.path.join(self.ckpt_dir, f"process_{self.process_index}.json")
        tmp = idx_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(index, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, idx_path)
        _fsync_dir(self.ckpt_dir)
        elapsed_ns = time.monotonic_ns() - self._t0_ns
        _DRAIN_NS.observe(elapsed_ns)
        if self.bytes_written and elapsed_ns:
            _DRAIN_BPS.set(self.bytes_written / (elapsed_ns / 1e9))
        self._report_progress(force=True)
        return {
            "bytes_written": self.bytes_written,
            "bytes_skipped": self.bytes_skipped,
            "d2h_skipped_bytes": self.bytes_d2h_skipped,
            "chunks_skipped": self.chunks_skipped,
            "shards": len(self.payloads_done),
            "drain_ns": elapsed_ns,
            "crc_ns": sum(s.crc_ns for s in self._sinks),
            "crc_chunks": sum(
                len(s.chunk_digests) + len(s.base_spans) for s in self._sinks
            ),
            "digest": self.digest,
            # resident publish frame: the sealed per-shard index rides the
            # done frame back to the trainer, which rebinds it to the staged
            # shm buffers as the warm (memory-resident) restore source
            "shards_index": index["shards"],
        }

    def abort(self, exc: Optional[BaseException] = None) -> None:
        with self._cv:
            if self._error is None:
                self._error = exc or RuntimeError("write aborted")
            self._closed = True
            self._cv.notify_all()
        wedged = _join_pool(self._threads, "ckpt drain abort")
        if wedged:
            log.warning("ckpt drain abort: thread(s) %s still wedged in I/O",
                        wedged)
        self._discard_all()

    def _discard_all(self) -> None:
        for sink in self._sinks:
            sink.discard()
        self._sinks.clear()

    # -- worker side -------------------------------------------------------

    def _take(self):
        """Largest non-empty bucket first: idle threads steal whatever chunk
        class still has work, so a late huge shard fans out immediately.
        Time spent parked before more work arrives is the drain's
        producer-bound stall (staging slower than the pool can write)."""
        waited_t0 = None
        with self._cv:
            while True:
                if self._error is not None:
                    return None
                for b in sorted(self._buckets, reverse=True):
                    dq = self._buckets[b]
                    if dq:
                        if waited_t0 is not None:
                            _DRAIN_STALL_NS.observe(
                                time.monotonic_ns() - waited_t0
                            )
                        return dq.popleft()
                if self._closed and self._pending_chunks <= 0:
                    return None
                if waited_t0 is None:
                    waited_t0 = time.monotonic_ns()
                # predicate loop re-checks every 5s: lost-notify insurance
                self._cv.wait(timeout=5.0)

    def _worker(self) -> None:
        while True:
            task = self._take()
            if task is None:
                return
            sink, off, length = task
            try:
                wrote = sink.write_chunk(off, length)
                if sink.skip_all:
                    pass  # bytes + progress credited at add_payload
                elif wrote:
                    _WRITE_BYTES.inc(length)
                    _WRITE_CHUNKS.inc()
                else:
                    _DELTA_SKIPPED_BYTES.inc(length)
                with sink.lock:
                    sink.chunks_left -= 1
                    last = sink.chunks_left == 0
                if last:
                    sink.complete()
                with self._cv:
                    if sink.skip_all:
                        pass
                    elif wrote:
                        self.bytes_written += length
                    else:
                        self.bytes_skipped += length
                        self.chunks_skipped += 1
                    self._pending_chunks -= 1
                    if last:
                        self.payloads_done.append(sink.payload)
                    if self._pending_chunks <= 0:
                        self._cv.notify_all()
                self._report_progress()
            except BaseException as exc:  # noqa: BLE001 - surfaced by finish()
                with self._cv:
                    if self._error is None:
                        self._error = exc
                    self._cv.notify_all()
                return

    def _report_progress(self, force: bool = False) -> None:
        if self._progress_cb is None:
            return
        now = time.monotonic()
        if not force and now - self._progress_last < 0.1:
            return
        self._progress_last = now
        total = self.total_bytes
        if total is None:
            total = sum(s.nbytes for s in self._sinks)
        try:
            # skipped (delta) bytes count as drained: progress must reach
            # the announced plan total for the save to read as complete
            self._progress_cb(self.bytes_written + self.bytes_skipped, total)
        except Exception as exc:  # noqa: BLE001 - progress is best-effort
            log.debug("progress callback failed: %r", exc)


def write_process_shards_streamed(
    ckpt_dir: str,
    process_index: int,
    num_threads: Optional[int],
    save_id: str,
    plan_sig: str,
    digest: Optional[bool],
    items: Iterable[Tuple[str, Any]],
    progress_cb: Optional[Callable[[int, int], None]] = None,
) -> Dict[str, Any]:
    """Worker-process entry (streamed plan): consume ``("plan", total_bytes)``
    then ``("shards", [payload, ...])`` items as the trainer stages them —
    the first shard hits disk while later leaves are still staging.  The
    item iterator raising (stream abort: staging failed trainer-side)
    aborts the engine and re-raises, leaving no committed index."""
    engine = _WriteEngine(
        ckpt_dir, process_index, num_threads, save_id, plan_sig, progress_cb,
        digest=digest,
    )
    try:
        for kind, value in items:
            if kind == "plan":
                engine.announce_total(int(value))
            elif kind == "shards":
                for payload in value:
                    engine.add_payload(payload)
            else:
                raise ValueError(f"unknown stream item kind {kind!r}")
    except BaseException as exc:
        engine.abort(exc)
        raise
    return engine.finish()


def write_metadata(
    ckpt_dir: str,
    treedef_repr: str,
    leaf_paths: List[str],
    all_shards: List[Dict[str, Any]],
    num_processes: int,
    extra: Optional[Dict[str, Any]] = None,
) -> None:
    """Finalize: the atomic global commit marker."""
    meta = {
        "format": "tpurx-ckpt-v1",
        "treedef": treedef_repr,
        "leaf_paths": leaf_paths,
        "num_processes": num_processes,
        "shards": all_shards,
        **(extra or {}),
    }
    path = os.path.join(ckpt_dir, "metadata.json")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(meta, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(ckpt_dir)


def is_committed(ckpt_dir: str) -> bool:
    return os.path.exists(os.path.join(ckpt_dir, "metadata.json"))


def read_metadata(ckpt_dir: str) -> Dict[str, Any]:
    with open(os.path.join(ckpt_dir, "metadata.json")) as f:
        return json.load(f)


def read_leaf(ckpt_dir: str, meta: Dict[str, Any], leaf_idx: int) -> np.ndarray:
    """Assemble a full global array for one leaf from its shards — the
    SERIAL reference path (one shard at a time, whole-buffer reads).  The
    parallel pipeline is :class:`_RestoreEngine`; this stays as the restore
    bench's A/B baseline and the one-leaf escape hatch.  Every shard file
    is digest-verified against the index-recorded chunk crcs before any
    element is placed — a torn or bit-flipped shard raises
    :class:`..integrity.CheckpointCorruptError` instead of restoring
    silently-wrong weights.  Coverage is proven by interval accounting over
    the shard index boxes (``coverage.covers``), not a full-size boolean
    array — the old ``np.zeros(global_shape, bool)`` added +1 byte of host
    memory per restored element."""
    from ...utils.dtypes import from_bytes, resolve_dtype

    shards = [s for s in meta["shards"] if s["leaf_idx"] == leaf_idx]
    if not shards:
        raise KeyError(f"leaf {leaf_idx} has no shards in checkpoint")
    global_shape = tuple(shards[0]["global_shape"])
    dtype = resolve_dtype(shards[0]["dtype"])
    out = np.empty(global_shape, dtype=dtype)
    for s in shards:
        pdir = os.path.join(ckpt_dir, f"process_{s['process_index']}")
        raw = _read_shard_resolved(ckpt_dir, pdir, s)
        arr = from_bytes(raw, s["dtype"], s["shape"])
        slices = tuple(slice(a, b) for a, b in s["index"])
        out[slices] = arr
    if not covers(global_shape, [s["index"] for s in shards]):
        raise ValueError(
            f"leaf {leaf_idx}: shards do not cover the full global shape "
            f"{global_shape}"
        )
    return out


def _read_shard_resolved(ckpt_dir: str, pdir: str, s: Dict[str, Any]) -> bytes:
    """Serial whole-shard read honoring delta provenance: spans whose index
    row names a base generation are read from that file, the rest from the
    shard's own file; every span is crc-verified and the composed digest
    checked, exactly like the provenance-free path."""
    path = os.path.join(pdir, shard_filename(s["leaf_idx"], s["shard_idx"]))
    bases = [
        b if os.path.isabs(b) else os.path.join(ckpt_dir, b)
        for b in (s.get("bases") or [])
    ]
    if not bases:
        return read_verified_shard(
            path,
            nbytes=s.get("nbytes"),
            crc=s.get("crc"),
            chunks=s.get("chunks"),
            site="global_shard",
        )
    name = os.path.basename(path)
    nbytes = int(s["nbytes"])
    chunks = s["chunks"]
    spans = span_plan(nbytes, chunks, site="global_shard", name=name)
    base_of = {int(c[0]): int(c[3]) for c in chunks if len(c) > 3}
    out = bytearray(nbytes)
    readers: Dict[int, ChunkReader] = {}
    try:
        crcs = []
        for off, length, want in spans:
            b = base_of.get(off, -1)
            r = readers.get(b)
            if r is None:
                r = ChunkReader(
                    path if b < 0 else bases[b], site="global_shard"
                )
                r.check_size(nbytes)
                readers[b] = r
            mv = memoryview(out)[off : off + length]
            r.pread_into(mv, off, length)
            crcs.append(
                verify_chunk(mv, want, "global_shard", name=name, off=off)
            )
        verify_composed(crcs, s.get("crc"), "global_shard", name=name)
    finally:
        for r in readers.values():
            r.close()
    return bytes(out)


# -- parallel verified restore engine ----------------------------------------


def _alloc_aligned(nbytes: int) -> np.ndarray:
    """Page-aligned writable byte buffer (anonymous mmap): a valid
    ``O_DIRECT`` destination, and pages fault in lazily so planning a
    restore costs address space, not resident memory."""
    if nbytes <= 0:
        return np.empty(0, dtype=np.uint8)
    return np.frombuffer(mmap.mmap(-1, nbytes), dtype=np.uint8)


class _LeafRestore:
    """One output leaf being assembled by the reader pool."""

    def __init__(self, leaf_idx: int, global_shape: Tuple[int, ...],
                 dtype: np.dtype):
        import math

        self.leaf_idx = leaf_idx
        self.global_shape = global_shape
        self.nbytes = math.prod(int(s) for s in global_shape) * dtype.itemsize
        self.raw = _alloc_aligned(self.nbytes)
        self.out = self.raw[: self.nbytes].view(dtype).reshape(global_shape)
        self.shards_left = 0
        self.boxes: List[Any] = []


class _ShardSource:
    """One shard being read (possibly by many threads) into its
    destination — straight into the leaf's final buffer when the shard's
    index box is C-contiguous there (whole-leaf shards, leading-axis
    sharding), else into an aligned scratch placed on completion.

    Byte sources, in warm-ladder order: a **resident shm buffer** (the
    committed generation still staged in memory — no file is opened at
    all), else the shard file — with delta-provenance spans routed to
    their recorded base files (``chunks`` rows carrying a 4th element
    index into the shard's ``bases`` path list).  Every span is crc-
    verified against the committed index regardless of source."""

    SITE = "restore_shard"

    def __init__(self, ckpt_dir: str, s: Dict[str, Any], leaf: _LeafRestore,
                 dtype: np.dtype, res_buf: Optional[memoryview] = None):
        self.meta = s
        self.leaf = leaf
        self.name = shard_filename(s["leaf_idx"], s["shard_idx"])
        self.path = os.path.join(
            ckpt_dir, f"process_{s['process_index']}", self.name
        )
        self.nbytes = int(s["nbytes"]) if s.get("nbytes") is not None else (
            int(np.prod([b - a for a, b in s["index"]], dtype=np.int64))
            * dtype.itemsize
        )
        self.dtype = dtype
        self.shape = tuple(
            s.get("shape") or [b - a for a, b in s["index"]]
        )
        self.slices = tuple(slice(a, b) for a, b in s["index"])
        self.crc = s.get("crc")
        self.chunks = s.get("chunks")
        self.bases: List[str] = [
            b if os.path.isabs(b) else os.path.join(ckpt_dir, b)
            for b in (s.get("bases") or [])
        ]
        # provenance routing: span offset -> base index (absent = own file)
        self.chunk_base: Dict[int, int] = {
            int(c[0]): int(c[3])
            for c in (self.chunks or ())
            if len(c) > 3
        }
        # the resident source must cover the shard exactly and be sealed by
        # per-chunk digests (verify-on-read needs the index crcs)
        if res_buf is not None and (
            len(res_buf) != self.nbytes or not self.chunks
        ) and self.nbytes:
            res_buf = None
        self.res_buf = res_buf
        self.from_shm = res_buf is not None
        # one lazily-opened reader per physical file: -1 is the shard's own
        # file, >=0 indexes ``bases``; none at all on the resident path
        self._readers: Dict[int, ChunkReader] = {}
        # span list: recorded write chunks when present (per-span crc);
        # one whole-file span when only the composed digest survived (a
        # sequential crc cannot be parallelized); synthesized spans with
        # no crc for digest-less legacy shards
        if self.chunks:
            self.spans = span_plan(
                self.nbytes, self.chunks, site=self.SITE, name=self.name
            )
        elif self.crc is not None:
            self.spans = (
                [(0, self.nbytes, int(self.crc))] if self.nbytes else []
            )
        else:
            self.spans = span_plan(
                self.nbytes, None, site=self.SITE,
                name=self.name, chunk_bytes=default_chunk_bytes(),
            )
        if not self.spans:
            self.spans = [(0, 0, None)]  # empty shard: one no-op task
        self.scratch: Optional[np.ndarray] = None
        co = contiguous_offset(
            leaf.global_shape, s["index"], dtype.itemsize
        )
        if co is not None and co[1] == self.nbytes:
            self.dst = leaf.raw[co[0] : co[0] + self.nbytes]
        else:
            self.scratch = _alloc_aligned(self.nbytes)
            self.dst = self.scratch
        self.lock = threading.Lock()
        self.chunks_left = len(self.spans)
        self.span_crcs: List[Tuple[int, int]] = []  # (off, crc)
        self.crc_ns = 0

    def _reader_for(self, off: int) -> ChunkReader:
        base = self.chunk_base.get(off, -1)
        with self.lock:
            r = self._readers.get(base)
            if r is None:
                path = self.path if base < 0 else self.bases[base]
                r = ChunkReader(path, site=self.SITE)
                # every source file — own shard (delta files are truncated
                # up to full size) or base generation — is full logical size
                r.check_size(self.nbytes)
                self._readers[base] = r
            return r

    def read_span(self, off: int, length: int, want: Optional[int]) -> int:
        """Worker-thread unit: read the span into its final destination and
        crc it in-flight.  Returns the verify CPU ns spent."""
        if length == 0:
            return 0
        mv = memoryview(self.dst)[off : off + length]
        if self.res_buf is not None:
            # verify the destination copy (catches the memcpy too)
            mv[:] = self.res_buf[off : off + length]
        else:
            self._reader_for(off).pread_into(mv, off, length)
        spent = 0
        if want is not None or self.chunks:
            t0 = time.monotonic_ns()
            c = verify_chunk(mv, want, self.SITE, name=self.name, off=off)
            spent = time.monotonic_ns() - t0
            with self.lock:
                self.span_crcs.append((off, c))
                self.crc_ns += spent
        return spent

    def close_readers(self) -> None:
        with self.lock:
            readers, self._readers = list(self._readers.values()), {}
        for r in readers:
            r.close()

    def complete(self) -> None:
        """Last span landed: composed-digest verdict, then placement."""
        self.close_readers()
        if self.chunks:
            crcs = [c for _off, c in sorted(self.span_crcs)]
            verify_composed(crcs, self.crc, self.SITE, name=self.name)
        else:
            # whole-span / legacy shards verified (or waived) in-flight;
            # still count the per-shard verification pass
            verify_composed([], None, self.SITE, name=self.name)
        if self.scratch is not None:
            arr = (
                self.scratch[: self.nbytes]
                .view(self.dtype)
                .reshape(self.shape)
            )
            self.leaf.out[self.slices] = arr
            self.scratch = None  # free before the next shard lands


class _RestoreEngine:
    """Multi-reader chunk pool mirroring :class:`_WriteEngine`: a restore
    plan computed from ``metadata.json`` in, fully-verified leaf arrays out
    — pushed onto :attr:`ready` the moment each leaf's shards complete, so
    the consumer's ``device_put`` H2D transfers overlap the remaining
    reads.  Size-bucketed work stealing (largest span class first) keeps a
    late huge leaf from pinning one thread; the first chunk-level crc
    failure cancels all queued work and surfaces as the terminal error."""

    def __init__(
        self,
        ckpt_dir: str,
        meta: Dict[str, Any],
        num_threads: Optional[int] = None,
        leaf_indices: Optional[Iterable[int]] = None,
        resident: Optional[Dict[Tuple[int, int, int], memoryview]] = None,
    ):
        from ...utils.dtypes import resolve_dtype

        self.ckpt_dir = ckpt_dir
        self.num_threads = resolve_restore_threads(num_threads)
        _RESTORE_THREADS.set(self.num_threads)
        # (process_index, leaf_idx, shard_idx) -> committed-generation shm
        # view; shards found here are sourced from memory, the rest from
        # disk (shard_idx alone is only unique within one process)
        self._resident = resident or {}
        self.bytes_shm = 0
        #: (leaf_idx, np.ndarray) per completed leaf, then a terminal
        #: ``(None, error-or-None)`` once the pool drains
        self.ready: "queue_mod.Queue[Tuple[Optional[int], Any]]" = (
            queue_mod.Queue()
        )
        self._cv = threading.Condition()
        self._buckets: Dict[int, collections.deque] = {}
        self._pending = 0  # guarded-by: _cv
        self._error: Optional[BaseException] = None
        self._t0_ns = time.monotonic_ns()
        self.bytes_read = 0
        self.chunks_read = 0
        self.elapsed_ns = 0
        self.total_bytes = 0
        self._sources: List[_ShardSource] = []
        self._leaves: Dict[int, _LeafRestore] = {}
        wanted = set(leaf_indices) if leaf_indices is not None else None
        by_leaf: Dict[int, List[Dict[str, Any]]] = {}
        for s in meta["shards"]:
            if wanted is None or s["leaf_idx"] in wanted:
                by_leaf.setdefault(s["leaf_idx"], []).append(s)
        if wanted is not None and (missing := wanted - set(by_leaf)):
            raise KeyError(
                f"leaves {sorted(missing)} have no shards in checkpoint"
            )
        for leaf_idx, shards in sorted(by_leaf.items()):
            dtype = resolve_dtype(shards[0]["dtype"])
            leaf = _LeafRestore(
                leaf_idx, tuple(shards[0]["global_shape"]), dtype
            )
            self._leaves[leaf_idx] = leaf
            # big shards first so the pool saturates immediately
            for s in sorted(shards, key=lambda s: -(s.get("nbytes") or 0)):
                src = _ShardSource(
                    ckpt_dir, s, leaf, dtype,
                    res_buf=self._resident.get(
                        (s["process_index"], s["leaf_idx"], s["shard_idx"])
                    ),
                )
                self._sources.append(src)
                leaf.shards_left += 1
                leaf.boxes.append(s["index"])
                self.total_bytes += src.nbytes
                for off, length, want in src.spans:
                    self._buckets.setdefault(
                        length.bit_length(), collections.deque()
                    ).append((src, off, length, want))
                    self._pending += 1
        self._leaves_left = len(self._leaves)
        if self._leaves_left == 0:
            self._live = 0
            self._threads: List[threading.Thread] = []
            self._finalize()
            return
        self._live = self.num_threads
        self._threads = [
            threading.Thread(
                target=self._worker, name=f"tpurx-ckpt-restore-{i}", daemon=True
            )
            for i in range(self.num_threads)
        ]
        for t in self._threads:
            t.start()

    # -- worker side -------------------------------------------------------

    def _take(self):
        with self._cv:
            while True:
                if self._error is not None:
                    return None
                for b in sorted(self._buckets, reverse=True):
                    dq = self._buckets[b]
                    if dq:
                        return dq.popleft()
                if self._pending <= 0:
                    return None
                # predicate loop re-checks every 5s: lost-notify insurance
                self._cv.wait(timeout=5.0)

    def _worker(self) -> None:
        try:
            while True:
                task = self._take()
                if task is None:
                    return
                src, off, length, want = task
                try:
                    src.read_span(off, length, want)
                    with src.lock:
                        src.chunks_left -= 1
                        last = src.chunks_left == 0
                    if last:
                        src.complete()
                        self._finish_shard(src)
                    _RESTORE_BYTES.inc(length)
                    _RESTORE_CHUNKS.inc()
                    _RESTORE_SOURCE.labels(
                        source="shm" if src.from_shm else "disk"
                    ).inc(length)
                    with self._cv:
                        self.bytes_read += length
                        self.chunks_read += 1
                        if src.from_shm:
                            self.bytes_shm += length
                        self._pending -= 1
                        if self._pending <= 0:
                            self._cv.notify_all()
                except BaseException as exc:  # noqa: BLE001 - terminal frame
                    with self._cv:
                        if self._error is None:
                            self._error = exc
                        self._cv.notify_all()
                    return
        finally:
            with self._cv:
                self._live -= 1
                last_out = self._live == 0
            if last_out:
                self._finalize()

    def _finish_shard(self, src: _ShardSource) -> None:
        leaf = src.leaf
        with self._cv:
            leaf.shards_left -= 1
            done = leaf.shards_left == 0
        if not done:
            return
        if not covers(leaf.global_shape, leaf.boxes):
            raise ValueError(
                f"leaf {leaf.leaf_idx}: shards do not cover the full "
                f"global shape {leaf.global_shape}"
            )
        with self._cv:
            self._leaves_left -= 1
        self.ready.put((leaf.leaf_idx, leaf.out))

    def _finalize(self) -> None:
        self.elapsed_ns = time.monotonic_ns() - self._t0_ns
        _RESTORE_NS.observe(self.elapsed_ns)
        _RESTORE_VERIFY_NS.observe(self.verify_ns)
        if self.bytes_read and self.elapsed_ns:
            _RESTORE_BPS.set(self.bytes_read / (self.elapsed_ns / 1e9))
        self.ready.put((None, self._error))

    # -- consumer side -----------------------------------------------------

    @property
    def verify_ns(self) -> int:
        return sum(s.crc_ns for s in self._sources)

    def stats(self) -> Dict[str, Any]:
        return {
            "bytes_read": self.bytes_read,
            "bytes_shm": self.bytes_shm,
            "chunks": self.chunks_read,
            "shards": len(self._sources),
            "leaves": len(self._leaves),
            "verify_ns": self.verify_ns,
            "restore_ns": self.elapsed_ns,
            "threads": self.num_threads,
        }

    def close(self, exc: Optional[BaseException] = None) -> None:
        """Cancel outstanding work (consumer bailed early or is done) and
        join the pool.  Idempotent; safe after normal completion."""
        with self._cv:
            if self._error is None and self._pending > 0:
                self._error = exc or RuntimeError("restore aborted")
            self._cv.notify_all()
        wedged = _join_pool(self._threads, "ckpt restore close")
        if wedged:
            log.warning("ckpt restore close: reader thread(s) %s still "
                        "wedged in I/O", wedged)
        for src in self._sources:
            src.close_readers()
