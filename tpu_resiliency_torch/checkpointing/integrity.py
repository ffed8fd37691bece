"""End-to-end checkpoint integrity: crc32 frames + the verifying readers.

Every byte a restart restores crosses at least one trust boundary — disk
(torn/bit-flipped blobs, truncated shards), the worker pipe, or a peer's
TCP socket — and before this module nothing ever checked them: a corrupt
blob was either a cryptic deserialize crash or silently-wrong weights
replicated to the whole clique.  This module is the single place bytes are
digested and checked:

- **Chunk digests.**  The async drain engine (``async_ckpt/writer.py``)
  crc32s every chunk as it writes it (the bytes are already in cache — the
  digest rides the write for ~free) and records the per-chunk list plus a
  composed per-shard digest in the process index; the metadata merge
  carries them into ``metadata.json``.  Chunks are written out of order by
  many threads, so the shard digest is a *digest of digests*: crc32 over
  the chunk crcs packed little-endian in offset order (:func:`combine_crcs`)
  — order-defined, composable, and verifiable at any chunk granularity.
- **Blob footer.**  Local-checkpoint blobs carry a fixed 20-byte trailer
  (:data:`FOOTER` = magic + crc32 + payload length) appended by
  :func:`seal`.  ``TensorAwareTree.from_bytes`` parses by offsets, so the
  trailer is invisible to legacy readers; :func:`verify_blob` checks it.
  A truncated blob fails the magic/length check, a bit-flip fails the crc.
- **Verifying readers.**  :func:`read_verified_blob` /
  :func:`read_verified_shard` and the chunk-level :class:`ChunkReader`
  are the ONLY sanctioned way to read checkpoint payload files
  (``tests/test_repo_hygiene.py`` bans raw ``open(..., "rb")`` AND the
  ``os.read``/``os.pread``/``os.preadv`` primitives in checkpointing
  modules outside this file).  Every verification outcome lands in
  ``tpurx_ckpt_verify_total{site}`` /
  ``tpurx_ckpt_corrupt_detected_total{site}`` so a scrub pass, a restore,
  and a peer exchange are distinguishable on a dashboard.
- **Streaming verification.**  The full-buffer readers are built on a
  chunked core: :class:`ChunkReader` preads spans straight into
  caller-owned buffers (``O_DIRECT`` when offset/length/address align,
  buffered otherwise), :func:`verify_chunk` digests a span in-flight,
  :func:`verify_composed` folds span digests into the shard verdict, and
  :func:`verify_blob_file` re-verifies a sealed blob with one bounded
  scratch buffer — the scrubber and the fallback-ladder validity rounds
  never materialize a whole GiB blob just to check its crc.  The parallel
  restore engine (``async_ckpt/writer.py``) drives the same primitives
  from many threads: ``zlib.crc32`` and ``os.preadv`` both release the
  GIL, so reads and digests overlap across the pool.

crc32 (zlib's, polynomial 0xEDB88320) is the right digest here: this is
corruption *detection* on a trusted path (torn writes, bit rot, truncated
transfers), not an adversarial boundary — and zlib.crc32 runs at memory
bandwidth in C with zero dependencies.
"""

from __future__ import annotations

import ctypes
import os
import struct
import threading
import time
import zlib
from typing import List, Optional, Sequence, Tuple, Union

from ..telemetry import counter, histogram
from ..utils import env
from ..utils.logging import get_logger

log = get_logger("ckpt.integrity")

_FOOT_MAGIC = b"TPURXCK1"
FOOTER = struct.Struct("<8sIQ")  # magic, crc32(payload), payload length
FOOTER_BYTES = FOOTER.size

# the sentinel a sender serves in place of a blob it discovered to be
# corrupt at send time — the receiver must never block on a holder that
# has nothing valid to serve (see LocalCheckpointManager._retrieve_from_peers)
CORRUPT_SENTINEL = b"TPURX-CORRUPT-SENTINEL"

#: suffix a quarantined blob is renamed to (kept for post-mortem, excluded
#: from holdings/coverage forever after)
QUARANTINE_SUFFIX = ".corrupt"

_VERIFY = counter(
    "tpurx_ckpt_verify_total",
    "Checkpoint integrity verifications performed",
    labels=("site",),
)
_VERIFY_BYTES = counter(
    "tpurx_ckpt_verify_bytes_total", "Checkpoint bytes digest-verified"
)
_VERIFY_NS = histogram(
    "tpurx_ckpt_verify_ns", "Single verification pass duration"
)
_CORRUPT = counter(
    "tpurx_ckpt_corrupt_detected_total",
    "Integrity verification failures (corrupt/truncated checkpoint data)",
    labels=("site",),
)
_QUARANTINED = counter(
    "tpurx_ckpt_quarantined_total",
    "Corrupt checkpoint blobs renamed *.corrupt and dropped from holdings",
    labels=("site",),
)

_Buf = Union[bytes, bytearray, memoryview]


class CheckpointCorruptError(RuntimeError):
    """A checkpoint payload failed integrity verification."""

    def __init__(self, msg: str, site: str = "unknown"):
        super().__init__(msg)
        self.site = site


def record_corruption(site: str, msg: str) -> CheckpointCorruptError:
    """Count a detected-corruption event under ``site`` and build (not
    raise) the error.  For verdicts reached OUTSIDE the verifying readers —
    e.g. the drain's device-digest vs host-crc cross-check — so every
    corruption class lands in the same ``tpurx_ckpt_corrupt_detected_total``
    series the dashboards already watch."""
    _CORRUPT.labels(site=site).inc()
    return CheckpointCorruptError(msg, site)


def crc32(data: _Buf, value: int = 0) -> int:
    """Running crc32 (zlib), masked to u32 — composable via the ``value``
    seed for sequential streams."""
    return zlib.crc32(data, value) & 0xFFFFFFFF


def chunk_crcs(data: _Buf, chunk_bytes: int) -> List[int]:
    """Per-chunk crc32 list at fixed ``chunk_bytes`` granularity (last chunk
    short).  Empty data digests to an empty list."""
    if chunk_bytes <= 0:
        raise ValueError(f"chunk_bytes must be positive, got {chunk_bytes}")
    view = memoryview(data)
    return [
        crc32(view[off : off + chunk_bytes])
        for off in range(0, len(view), chunk_bytes)
    ]


def combine_crcs(crcs: Sequence[int]) -> int:
    """Compose chunk digests into one shard digest: crc32 over the chunk
    crcs packed ``<u32`` in offset order.  Multi-threaded writers produce
    chunks out of order; this composition only needs each chunk's digest
    and its position, never a sequential pass over the shard."""
    return crc32(struct.pack(f"<{len(crcs)}I", *[c & 0xFFFFFFFF for c in crcs]))


# -- blob frame footer -------------------------------------------------------


def footer_bytes(crc: int, payload_len: int) -> bytes:
    """The 20-byte trailer for a payload whose crc32/length are already
    known — lets streaming serializers seal without re-buffering."""
    return FOOTER.pack(_FOOT_MAGIC, crc & 0xFFFFFFFF, payload_len)


def seal(payload: _Buf) -> bytes:
    """Append the integrity footer: ``payload + magic + crc32 + len``.
    Readers that parse by offsets (``TensorAwareTree.from_bytes``) ignore
    the trailer; :func:`verify_blob` enforces it."""
    payload = bytes(payload) if not isinstance(payload, bytes) else payload
    return payload + FOOTER.pack(_FOOT_MAGIC, crc32(payload), len(payload))


def has_footer(raw: _Buf) -> bool:
    if len(raw) < FOOTER_BYTES:
        return False
    magic, _crc, _n = FOOTER.unpack(memoryview(raw)[-FOOTER_BYTES:])
    return magic == _FOOT_MAGIC


def verify_blob(raw: _Buf, site: str = "local_blob") -> None:
    """Verify a sealed blob end-to-end.  Raises :class:`CheckpointCorruptError`
    on a missing/short footer, a length mismatch (truncation), or a crc mismatch
    (bit rot / torn write).  Unsealed legacy blobs fail — integrity is
    mandatory once the writer seals (the soak's bitflip/truncate fault
    classes prove the detection, not just the happy path)."""
    t0 = time.monotonic_ns()
    _VERIFY.labels(site=site).inc()
    view = memoryview(raw)
    if len(view) < FOOTER_BYTES:
        _CORRUPT.labels(site=site).inc()
        raise CheckpointCorruptError(
            f"{site}: blob too short for integrity footer "
            f"({len(view)} < {FOOTER_BYTES} bytes)", site)
    magic, want_crc, want_len = FOOTER.unpack(view[-FOOTER_BYTES:])
    if magic != _FOOT_MAGIC:
        _CORRUPT.labels(site=site).inc()
        raise CheckpointCorruptError(
            f"{site}: missing/corrupt integrity footer magic", site)
    payload = view[:-FOOTER_BYTES]
    if len(payload) != want_len:
        _CORRUPT.labels(site=site).inc()
        raise CheckpointCorruptError(
            f"{site}: blob truncated ({len(payload)} != {want_len} bytes)",
            site)
    got = crc32(payload)
    _VERIFY_BYTES.inc(len(payload))
    _VERIFY_NS.observe(time.monotonic_ns() - t0)
    if got != want_crc:
        _CORRUPT.labels(site=site).inc()
        raise CheckpointCorruptError(
            f"{site}: blob crc mismatch (got {got:#010x}, "
            f"want {want_crc:#010x})", site)


def unseal(raw: _Buf, site: str = "local_blob") -> memoryview:
    """Verify then strip the footer; returns the payload view."""
    verify_blob(raw, site=site)
    return memoryview(raw)[:-FOOTER_BYTES]


# -- chunked verified reads (the ONLY sanctioned byte reads of ckpt data) ----

_ALIGN = 4096  # O_DIRECT offset/length/address granularity (conservative)
_STREAM_CHUNK = 16 << 20  # scratch-buffer granularity for streaming verifies


def _buf_addr(mv: memoryview) -> int:
    """Address of a writable buffer — O_DIRECT needs the DESTINATION aligned
    too, not just the file offset/length."""
    return ctypes.addressof(ctypes.c_char.from_buffer(mv))


def verify_chunk(
    data: _Buf,
    want_crc: Optional[int],
    site: str,
    name: str = "",
    off: int = 0,
) -> int:
    """Digest one span and (when a recorded crc exists) verify it in-flight.
    The unit of the parallel restore pipeline: reader threads call this the
    moment a span's bytes land, so a flipped bit fails the restore at chunk
    granularity — naming file, offset and length — instead of after the
    whole shard materialized.  Returns the span's crc32 for composition."""
    got = crc32(data)
    _VERIFY_BYTES.inc(len(memoryview(data)))
    if want_crc is not None and got != want_crc:
        _CORRUPT.labels(site=site).inc()
        raise CheckpointCorruptError(
            f"{site}: shard {name} corrupt chunk at offset {off} "
            f"(+{len(memoryview(data))} bytes; got {got:#010x}, "
            f"want {want_crc:#010x})", site)
    return got


def verify_composed(
    got_crcs: Sequence[int],
    want_crc: Optional[int],
    site: str,
    name: str = "",
) -> int:
    """Fold span digests (offset order) into the shard verdict against the
    index-recorded composed digest.  Counts one verification under
    ``site`` — the per-shard unit the dashboards track."""
    _VERIFY.labels(site=site).inc()
    composed = combine_crcs(got_crcs) if got_crcs else 0
    if want_crc is not None and composed != want_crc:
        _CORRUPT.labels(site=site).inc()
        raise CheckpointCorruptError(
            f"{site}: shard {name} digest mismatch "
            f"(got {composed:#010x}, want {want_crc:#010x})", site)
    return composed


def span_plan(
    nbytes: int,
    chunks: Optional[Sequence[Sequence[int]]],
    site: str = "shard",
    name: str = "",
    chunk_bytes: int = _STREAM_CHUNK,
) -> List[Tuple[int, int, Optional[int]]]:
    """The read plan for one shard file: ``[(off, length, crc-or-None)]``
    spans tiling ``[0, nbytes)``.  With recorded ``chunks`` (the drain
    engine's actual write spans) the plan IS those spans, validated to tile
    the file — a gap/overlap is itself corruption of the index.  Without
    digests (legacy / digest-off saves) the plan synthesizes fixed-size
    spans with no per-span crc, so chunked readers still parallelize."""
    if chunks:
        spans: List[Tuple[int, int, Optional[int]]] = []
        end = 0
        # rows may carry a 4th element (delta provenance: index of the base
        # file holding the bytes) — tiling validation only needs the span
        for off, length, want in sorted(tuple(c)[:3] for c in chunks):
            if off != end or off + length > nbytes:
                _CORRUPT.labels(site=site).inc()
                raise CheckpointCorruptError(
                    f"{site}: shard {name} digest spans do not tile the "
                    f"file (gap/overlap at offset {off}, expected {end})",
                    site)
            end = off + length
            spans.append((off, length, int(want)))
        if end != nbytes:
            _CORRUPT.labels(site=site).inc()
            raise CheckpointCorruptError(
                f"{site}: shard {name} digest spans cover {end} of "
                f"{nbytes} bytes", site)
        return spans
    return [
        (off, min(chunk_bytes, nbytes - off), None)
        for off in range(0, nbytes, chunk_bytes)
    ]


class ChunkReader:
    """Positioned chunked reads of one checkpoint payload file into
    caller-owned buffers — the byte-level primitive under every verifying
    reader and the parallel restore engine.

    ``pread_into`` routes aligned (offset, length, destination address)
    reads through an ``O_DIRECT`` descriptor when the filesystem grants one
    — no page-cache double copy on the restore path, mirroring the write
    engine — and falls back to buffered preads for unaligned tails, tmpfs,
    and short direct reads.  Thread-safe: many reader threads pread disjoint
    spans of the same file concurrently (``os.preadv`` has no shared file
    offset and releases the GIL)."""

    def __init__(self, path: str, site: str = "shard",
                 direct: Optional[bool] = None):
        self.path = path
        self.site = site
        self.name = os.path.basename(path)
        if direct is None:
            direct = env.CKPT_DIRECT_IO.get()
        self._want_direct = direct
        self._fd_buf = -1
        self._fd_direct = -1
        self._opened = False
        self._lock = threading.Lock()

    def __enter__(self) -> "ChunkReader":
        self.open()
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def open(self) -> "ChunkReader":
        with self._lock:
            if self._opened:
                return self
            self._fd_buf = os.open(self.path, os.O_RDONLY)
            if self._want_direct:
                try:
                    self._fd_direct = os.open(
                        self.path, os.O_RDONLY | os.O_DIRECT
                    )
                except (OSError, AttributeError):
                    self._fd_direct = -1  # tmpfs & friends: buffered only
            self._opened = True
            return self

    def size(self) -> int:
        self.open()
        return os.fstat(self._fd_buf).st_size

    def check_size(self, expected: Optional[int]) -> int:
        """Size-on-disk vs the index-recorded byte count — the truncation
        guard, counted as corruption under ``site`` on mismatch."""
        size = self.size()
        if expected is not None and size != expected:
            _CORRUPT.labels(site=self.site).inc()
            raise CheckpointCorruptError(
                f"{self.site}: shard {self.name} truncated "
                f"({size} != {expected} bytes)", self.site)
        return size

    def pread_into(self, dst: _Buf, off: int, length: int) -> None:
        """Read exactly ``length`` bytes at ``off`` into the writable buffer
        ``dst``.  A short read is truncation — raises
        :class:`CheckpointCorruptError` (counted under ``site``) rather than
        returning partial bytes anyone might believe."""
        if length == 0:
            return
        self.open()
        mv = memoryview(dst)
        if mv.ndim != 1 or mv.itemsize != 1:
            mv = mv.cast("B")
        if len(mv) != length:
            mv = mv[:length]
        fd = self._fd_buf
        if (
            self._fd_direct >= 0
            and off % _ALIGN == 0
            and length % _ALIGN == 0
            and _buf_addr(mv) % _ALIGN == 0
        ):
            fd = self._fd_direct
        got = 0
        while got < length:
            try:
                n = os.preadv(fd, [mv[got:]], off + got)
            except OSError:
                if fd == self._fd_direct:
                    fd = self._fd_buf  # EINVAL et al: route buffered
                    continue
                raise
            if n <= 0:
                if fd == self._fd_direct:
                    fd = self._fd_buf  # direct EOF semantics: finish buffered
                    continue
                break
            got += n
        if got < length:
            _CORRUPT.labels(site=self.site).inc()
            raise CheckpointCorruptError(
                f"{self.site}: shard {self.name} truncated (read {got} of "
                f"{length} bytes at offset {off})", self.site)

    def close(self) -> None:
        with self._lock:
            for fd in (self._fd_buf, self._fd_direct):
                if fd >= 0:
                    try:
                        os.close(fd)
                    except OSError:
                        pass
            self._fd_buf = self._fd_direct = -1
            self._opened = False


def read_verified_blob(path: str, site: str = "local_blob") -> bytes:
    """Read a sealed local-checkpoint blob and verify it.  Returns the raw
    sealed bytes (footer included) so callers can re-serve the blob to
    peers verbatim; parse with ``TensorAwareTree.from_bytes`` (offset-based,
    footer-transparent)."""
    with open(path, "rb") as f:
        raw = f.read()
    verify_blob(raw, site=site)
    return raw


def verify_blob_file(path: str, site: str = "scrub") -> int:
    """Streaming re-verification of a sealed blob ON DISK: footer parsed
    from the tail, payload crc computed through one bounded scratch buffer
    — peak memory is one chunk, not one blob, so the scrubber and the
    fallback ladder's validity rounds can sweep multi-GiB retained
    iterations without doubling the host's memory watermark.  Returns the
    payload length; raises :class:`CheckpointCorruptError` on any mismatch
    (same failure taxonomy as :func:`verify_blob`)."""
    t0 = time.monotonic_ns()
    _VERIFY.labels(site=site).inc()
    name = os.path.basename(path)
    with ChunkReader(path, site=site) as reader:
        size = reader.size()
        if size < FOOTER_BYTES:
            _CORRUPT.labels(site=site).inc()
            raise CheckpointCorruptError(
                f"{site}: blob {name} too short for integrity footer "
                f"({size} < {FOOTER_BYTES} bytes)", site)
        foot = bytearray(FOOTER_BYTES)
        reader.pread_into(foot, size - FOOTER_BYTES, FOOTER_BYTES)
        magic, want_crc, want_len = FOOTER.unpack(bytes(foot))
        if magic != _FOOT_MAGIC:
            _CORRUPT.labels(site=site).inc()
            raise CheckpointCorruptError(
                f"{site}: blob {name} missing/corrupt integrity footer magic",
                site)
        payload_len = size - FOOTER_BYTES
        if payload_len != want_len:
            _CORRUPT.labels(site=site).inc()
            raise CheckpointCorruptError(
                f"{site}: blob {name} truncated ({payload_len} != "
                f"{want_len} bytes)", site)
        scratch = bytearray(min(_STREAM_CHUNK, max(1, payload_len)))
        got = 0
        off = 0
        while off < payload_len:
            n = min(len(scratch), payload_len - off)
            view = memoryview(scratch)[:n]
            reader.pread_into(view, off, n)
            got = crc32(view, got)
            off += n
    _VERIFY_BYTES.inc(payload_len)
    _VERIFY_NS.observe(time.monotonic_ns() - t0)
    if got != want_crc:
        _CORRUPT.labels(site=site).inc()
        raise CheckpointCorruptError(
            f"{site}: blob {name} crc mismatch (got {got:#010x}, "
            f"want {want_crc:#010x})", site)
    return payload_len


def read_verified_shard(
    path: str,
    nbytes: Optional[int] = None,
    crc: Optional[int] = None,
    chunks: Optional[Sequence[Sequence[int]]] = None,
    site: str = "shard",
) -> bytes:
    """Read a raw shard file and verify it against index-recorded digests.

    ``nbytes`` guards truncation.  ``chunks`` is the writer's recorded
    ``[(off, length, crc32), ...]`` span list (the drain engine's actual
    write chunks — whatever boundaries the O_DIRECT split produced); the
    spans must tile ``[0, len(file))`` and each span's crc must match, so a
    digest failure names the exact corrupt span.  ``crc`` is the composed
    shard digest (``combine_crcs`` over span crcs in offset order) — the
    compact cross-check carried even where the span list was dropped.  With
    no recorded digest at all (pre-integrity checkpoints) the read passes
    through with only the size check, still counted under ``site``.

    Internals are the chunked core (:class:`ChunkReader` +
    :func:`verify_chunk`): spans land in one preallocated buffer and are
    digested in-flight, so the crc of span *i* overlaps the pread of span
    *i+1* through the page cache instead of a second full pass."""
    t0 = time.monotonic_ns()
    base = os.path.basename(path)
    with ChunkReader(path, site=site) as reader:
        try:
            size = reader.check_size(nbytes)
        except CheckpointCorruptError:
            _VERIFY.labels(site=site).inc()
            raise
        raw = bytearray(size)
        view = memoryview(raw)
        if crc is None and not chunks:
            # legacy checkpoint without digests: size check only
            _VERIFY.labels(site=site).inc()
            reader.pread_into(view, 0, size)
            return bytes(raw)
        got_crcs: List[int] = []
        whole = 0  # running crc of the sequential spans == crc of the file
        for off, length, want in span_plan(size, chunks, site=site, name=base):
            span = view[off : off + length]
            reader.pread_into(span, off, length)
            if chunks:
                got_crcs.append(
                    verify_chunk(span, want, site, name=base, off=off)
                )
            else:
                whole = crc32(span, whole)
                _VERIFY_BYTES.inc(length)
    if chunks:
        verify_composed(got_crcs, crc, site, name=base)
    else:
        # no recorded span list: the digest is a plain crc over the bytes
        _VERIFY.labels(site=site).inc()
        if crc is not None and whole != crc:
            _CORRUPT.labels(site=site).inc()
            raise CheckpointCorruptError(
                f"{site}: shard {base} digest mismatch "
                f"(got {whole:#010x}, want {crc:#010x})", site)
    _VERIFY_NS.observe(time.monotonic_ns() - t0)
    return bytes(raw)


def quarantine_blob(path: str, site: str = "local_blob") -> Optional[str]:
    """Quarantine a corrupt blob: rename ``path`` -> ``path + '.corrupt'``
    and drop its ``.done`` commit marker so holdings scans never count it
    again.  Returns the quarantine path (None if the blob vanished — a
    concurrent cleanup won the race, which is fine: either way the blob is
    out of coverage)."""
    qpath = path + QUARANTINE_SUFFIX
    try:
        os.replace(path, qpath)
    except FileNotFoundError:
        qpath = None
    try:
        os.unlink(path + ".done")
    except FileNotFoundError:
        pass
    if qpath:
        # only the rename winner counts/logs: a scrubber and a concurrent
        # restore both detecting the same rot must not double-quarantine
        log.warning("quarantined corrupt checkpoint blob: %s", qpath)
        _QUARANTINED.labels(site=site).inc()
    return qpath
