"""Async call machinery: AsyncRequest / callers / AsyncCallsQueue.

Capability parity with ``checkpointing/async_ckpt/core.py`` (1054 LoC):

- :class:`AsyncRequest` — (async_fn, args, preload_fn, finalize_fns, call_idx)
  (reference ``core.py:120``).
- :class:`TemporalAsyncCaller` — process-per-save (reference ``:308``).
- :class:`PersistentAsyncCaller` — one long-lived spawned worker fed through
  queues, kept at low scheduling priority (reference ``:41-117`` uses
  nice/ionice; we renice in the worker).
- :class:`AsyncCallsQueue` — facade the trainer uses: ``schedule_async_request``
  then ``maybe_finalize_async_calls`` each step (reference ``:849``).
- Global completion consensus: every rank reports per-call done/alive state
  and finalization runs only once ALL ranks finished a call, with matching
  call_idx validation (reference all_reduce ``:279-291`` and ``:188-215``);
  here the reduction is a KV-store gather over DCN (device collectives stay
  free for training), pluggable via ``sync_fn``.

The preload (D2H staging) happens in the **trainer** process before the
worker is involved — tensors never cross the process boundary; only shm
names and numpy metadata do (see ``staging.py``).

The port's copy of ``tpu_resiliency/checkpointing/async_ckpt/core.py``: the
worker is this package's ``worker_main``.  :func:`store_sync_fn` is the
cross-rank commit of ``AsyncCheckpointer(store=...)``: over the port's
``store.StoreClient``, against the port's store server or the JAX
package's (one wire protocol).
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import struct
import subprocess
import sys
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ...store.client import StoreError
from ...telemetry import flight
from ...utils import env
from ...store.protocol import itob
from ...utils.logging import get_logger
from ...utils.profiling import ProfilingEvent, record_event

log = get_logger("async_ckpt")

# flight-recorder span pair: one drain from schedule to finalize (the
# black-box answer to "was a checkpoint in flight when the fault hit")
EV_DRAIN_BEGIN = flight.declare_event("ckpt.drain_begin", "call_idx")
EV_DRAIN_END = flight.declare_event("ckpt.drain_end", "call_idx")


@dataclasses.dataclass
class AsyncRequest:
    """A scheduled async checkpoint save.

    ``async_fn(*async_fn_args)`` runs in the background worker process; its
    args must be picklable (shm handles, paths — not tensors).
    ``preload_fn()`` runs synchronously in the trainer right before
    scheduling (D2H staging). ``finalize_fns`` run in the trainer once ALL
    ranks' async_fn completed (metadata commit). ``cleanup_fns`` run on both
    success and failure (releasing staged shm must happen even when the write
    dies, or every failed save leaks a checkpoint-sized tmpfs segment).
    """

    async_fn: Optional[Callable]
    async_fn_args: Tuple = ()
    preload_fn: Optional[Callable] = None
    finalize_fns: Sequence[Callable] = ()
    cleanup_fns: Sequence[Callable] = ()
    call_idx: int = 0

    def execute_sync(self) -> None:
        if self.preload_fn is not None:
            self.preload_fn()
        try:
            if self.async_fn is not None:
                self.async_fn(*self.async_fn_args)
            for fn in self.finalize_fns:
                fn()
        finally:
            self.run_cleanup()

    def run_cleanup(self) -> None:
        for fn in self.cleanup_fns:
            try:
                fn()
            except Exception:  # noqa: BLE001
                log.exception("checkpoint cleanup fn failed")


class _PipeWorker:
    """One worker subprocess speaking the worker_main pickle-frame protocol
    (typed request/response frames incl. streamed calls and drain progress —
    see ``worker_main.py``).

    Deliberately a plain subprocess, not multiprocessing spawn: mp-spawn
    re-imports the parent's ``__main__``, which crashes in any user script
    lacking the ``__main__`` guard — unacceptable for a sidecar library."""

    _U32 = struct.Struct("<I")

    def __init__(self):
        env = dict(os.environ)
        # propagate the parent's import paths so pickled-by-reference fns
        # from any importable module resolve in the worker
        env["PYTHONPATH"] = os.pathsep.join(
            [p for p in sys.path if p] + [env.get("PYTHONPATH", "")]
        ).rstrip(os.pathsep)
        self.proc = subprocess.Popen(
            [sys.executable, "-m",
             "tpu_resiliency_torch.checkpointing.async_ckpt.worker_main"],
            stdin=subprocess.PIPE,
            stdout=subprocess.PIPE,
            env=env,
            # stderr inherited: worker tracebacks surface in trainer logs
            start_new_session=False,
        )
        self.results: Dict[int, Tuple[Optional[str], float, Optional[dict]]] = {}
        self.progress: Dict[int, Tuple[int, int]] = {}  # call -> (written, total)
        self._cv = threading.Condition()
        # the trainer thread schedules while the stager thread streams items:
        # frame writes must not interleave
        self._wlock = threading.Lock()
        self._reader = threading.Thread(
            target=self._read_loop, name="tpurx-ckpt-reader", daemon=True
        )
        self._reader.start()

    def _read_loop(self) -> None:
        stream = self.proc.stdout
        while True:
            hdr = stream.read(4)
            if len(hdr) < 4:
                break
            (n,) = self._U32.unpack(hdr)
            raw = stream.read(n)
            if len(raw) < n:
                break
            frame = pickle.loads(raw)
            if frame[0] == "prog":
                _, call_idx, written, total = frame
                with self._cv:
                    self.progress[call_idx] = (written, total)
                continue
            _, call_idx, err, dur, *rest = frame  # "done" (+stats since v2)
            with self._cv:
                self.results[call_idx] = (err, dur, rest[0] if rest else None)
                self._cv.notify_all()
        with self._cv:
            self._cv.notify_all()

    @property
    def alive(self) -> bool:
        return self.proc.poll() is None

    def _send(self, frame) -> None:
        raw = pickle.dumps(frame)
        with self._wlock:
            self.proc.stdin.write(self._U32.pack(len(raw)) + raw)
            self.proc.stdin.flush()

    def submit(self, call_idx: int, fn: Callable, args: Tuple) -> None:
        self._send(("call", call_idx, fn, args))

    def stream_begin(self, call_idx: int, fn: Callable, args: Tuple) -> None:
        self._send(("sbegin", call_idx, fn, args))

    def stream_item(self, call_idx: int, item) -> None:
        self._send(("sitem", call_idx, item))

    def stream_end(self, call_idx: int, error: Optional[str] = None) -> None:
        self._send(("send", call_idx, error))

    def shutdown(self, timeout: float = 10.0) -> None:
        try:
            self._send(None)
        except (BrokenPipeError, OSError, ValueError):
            pass
        try:
            self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()  # tpurx: disable=TPURX005,TPURX012 -- SIGKILL just sent; exit is kernel-guaranteed, no deadline needed

    def kill(self) -> None:
        if self.alive:
            self.proc.kill()
            self.proc.wait()  # tpurx: disable=TPURX005 -- SIGKILL just sent; exit is kernel-guaranteed


class StreamHandle:
    """Trainer-side feeder for one streamed worker call.  Send failures
    (worker died mid-stream) are swallowed: the death surfaces through the
    caller's is_done/error machinery, not through the staging thread."""

    def __init__(self, worker: _PipeWorker, call_idx: int):
        self._worker = worker
        self.call_idx = call_idx
        self._dead = False
        self._ended = False

    def send(self, item) -> None:
        if self._dead or self._ended:
            return
        try:
            self._worker.stream_item(self.call_idx, item)
        except (BrokenPipeError, OSError, ValueError):
            self._dead = True

    def end(self, error: Optional[str] = None) -> None:
        if self._dead or self._ended:
            return
        self._ended = True
        try:
            self._worker.stream_end(self.call_idx, error)
        except (BrokenPipeError, OSError, ValueError):
            self._dead = True


class PersistentAsyncCaller:
    """Long-lived writer worker (reference ``core.py:380+``)."""

    def __init__(self):
        self._worker: Optional[_PipeWorker] = None
        self._inflight: Dict[int, bool] = {}
        self._failed: Dict[int, str] = {}
        self._stats: Dict[int, Optional[dict]] = {}

    def _ensure_worker(self) -> _PipeWorker:
        if self._worker is None or not self._worker.alive:
            self._worker = _PipeWorker()
        return self._worker

    def schedule(self, call_idx: int, fn: Callable, args: Tuple) -> None:
        worker = self._ensure_worker()
        self._inflight[call_idx] = True
        worker.submit(call_idx, fn, args)

    def schedule_streamed(self, call_idx: int, fn: Callable, args: Tuple) -> StreamHandle:
        worker = self._ensure_worker()
        self._inflight[call_idx] = True
        worker.stream_begin(call_idx, fn, args)
        return StreamHandle(worker, call_idx)

    def progress(self, call_idx: int) -> Optional[Tuple[int, int]]:
        if self._worker is None:
            return None
        with self._worker._cv:
            return self._worker.progress.get(call_idx)

    def _collect(self) -> None:
        if self._worker is None:
            return
        with self._worker._cv:
            done = list(self._worker.results.items())
            self._worker.results.clear()
        for call_idx, (err, dur, stats) in done:
            self._inflight.pop(call_idx, None)
            if err is not None:
                self._failed[call_idx] = err
                log.error("async checkpoint call %s failed: %s", call_idx, err)
            else:
                self._stats[call_idx] = stats
                log.debug("async call %s finished in %.2fs", call_idx, dur)
        if not self._worker.alive and self._inflight:
            for idx in list(self._inflight):
                self._failed[idx] = "checkpoint worker died"
                self._inflight.pop(idx)

    def is_done(self, call_idx: int) -> bool:
        self._collect()
        return call_idx not in self._inflight

    def error(self, call_idx: int) -> Optional[str]:
        return self._failed.get(call_idx)

    def stats(self, call_idx: int) -> Optional[dict]:
        """The completed call's reported stats dict (drain accounting), if
        the called fn returned one."""
        return self._stats.get(call_idx)

    def wait(self, call_idx: int, timeout: float = 600.0) -> None:
        deadline = time.monotonic() + timeout
        while not self.is_done(call_idx):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"async call {call_idx} still running")
            if self._worker is not None:
                with self._worker._cv:
                    self._worker._cv.wait(timeout=0.25)

    def close(self) -> None:
        if self._worker is not None:
            self._worker.shutdown()
            self._worker = None

    def abort(self) -> None:
        """Hard-kill the worker (used by in-process restart's Abort path —
        reference ``inprocess/abort.py:194`` AbortPersistentCheckpointProcesses)."""
        if self._worker is not None:
            self._worker.kill()
            self._worker = None
        for idx in list(self._inflight):
            self._failed[idx] = "aborted"
            self._inflight.pop(idx)


class TemporalAsyncCaller:
    """Process-per-save (reference ``core.py:308``): simpler isolation, pays
    worker startup per checkpoint.  One _PipeWorker per call, shut down after."""

    def __init__(self):
        self._workers: Dict[int, _PipeWorker] = {}
        self._failed: Dict[int, str] = {}
        self._stats: Dict[int, Optional[dict]] = {}

    def schedule(self, call_idx: int, fn: Callable, args: Tuple) -> None:
        worker = _PipeWorker()
        worker.submit(call_idx, fn, args)
        self._workers[call_idx] = worker

    def schedule_streamed(self, call_idx: int, fn: Callable, args: Tuple) -> StreamHandle:
        worker = _PipeWorker()
        worker.stream_begin(call_idx, fn, args)
        self._workers[call_idx] = worker
        return StreamHandle(worker, call_idx)

    def progress(self, call_idx: int) -> Optional[Tuple[int, int]]:
        worker = self._workers.get(call_idx)
        if worker is None:
            return None
        with worker._cv:
            return worker.progress.get(call_idx)

    def is_done(self, call_idx: int) -> bool:
        worker = self._workers.get(call_idx)
        if worker is None:
            return True
        with worker._cv:
            if call_idx in worker.results:
                err, _dur, stats = worker.results.pop(call_idx)
                if err is not None:
                    self._failed[call_idx] = err
                else:
                    self._stats[call_idx] = stats
                worker.shutdown(timeout=5)
                del self._workers[call_idx]
                return True
        if not worker.alive:
            self._failed[call_idx] = f"worker exitcode {worker.proc.returncode}"
            del self._workers[call_idx]
            return True
        return False

    def error(self, call_idx: int) -> Optional[str]:
        return self._failed.get(call_idx)

    def stats(self, call_idx: int) -> Optional[dict]:
        return self._stats.get(call_idx)

    def wait(self, call_idx: int, timeout: float = 600.0) -> None:
        deadline = time.monotonic() + timeout
        while not self.is_done(call_idx):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"async call {call_idx} still running")
            time.sleep(0.05)

    def close(self) -> None:
        for worker in list(self._workers.values()):
            worker.shutdown()
        self._workers.clear()

    def abort(self) -> None:
        for worker in self._workers.values():
            worker.kill()
        self._workers.clear()


class AsyncCallsQueue:
    """Trainer-facing facade (reference ``core.py:849``).

    ``sync_fn(call_idx, locally_done) -> globally_done`` implements the
    cross-rank consensus; default is local-only (single process).  Use
    :func:`store_sync_fn` for the DCN KV-store consensus.
    """

    def __init__(self, persistent: bool = True, sync_fn: Optional[Callable] = None):
        self.caller = PersistentAsyncCaller() if persistent else TemporalAsyncCaller()
        self.sync_fn = sync_fn or (lambda call_idx, done: done)
        self._call_idx = 0
        self._pending: List[AsyncRequest] = []
        # drain accounting of the most recently finalized call (the worker
        # reports it in the done frame; None for fns that return nothing)
        self.last_call_stats: Optional[dict] = None

    def schedule_async_request(self, req: AsyncRequest) -> int:
        self._call_idx += 1
        req = dataclasses.replace(req, call_idx=self._call_idx)
        record_event(ProfilingEvent.CHECKPOINT_SAVE_STARTED, call_idx=req.call_idx)
        flight.record(EV_DRAIN_BEGIN, req.call_idx)
        try:
            if req.preload_fn is not None:
                req.preload_fn()
            self.caller.schedule(req.call_idx, req.async_fn, req.async_fn_args)
        except BaseException:
            # scheduling failed: staged shm must still be released
            req.run_cleanup()
            raise
        self._pending.append(req)
        return req.call_idx

    def schedule_streamed_request(self, req: AsyncRequest) -> StreamHandle:
        """Schedule a STREAMED async call: the worker starts ``async_fn``
        immediately with an item iterator, and the returned handle feeds it
        (possibly from another thread) — the drain begins before the plan is
        fully staged.  ``finalize_fns``/``cleanup_fns`` semantics match
        :meth:`schedule_async_request`."""
        self._call_idx += 1
        req = dataclasses.replace(req, call_idx=self._call_idx)
        record_event(ProfilingEvent.CHECKPOINT_SAVE_STARTED, call_idx=req.call_idx)
        flight.record(EV_DRAIN_BEGIN, req.call_idx)
        try:
            if req.preload_fn is not None:
                req.preload_fn()
            handle = self.caller.schedule_streamed(
                req.call_idx, req.async_fn, req.async_fn_args
            )
        except BaseException:
            req.run_cleanup()
            raise
        self._pending.append(req)
        return handle

    def drain_progress(self) -> Tuple[int, int]:
        """(bytes_written, bytes_total) summed over unfinalized streamed
        calls — the worker reports through the pipe as chunks land.
        "Written" counts bytes the save no longer owes, whatever their
        route: file writes, delta-matched chunks, and D2H-skipped shards
        (credited in full the moment their provenance payload arrives, not
        when the drain gets around to them — a delta save that skips
        everything reports complete immediately)."""
        written = total = 0
        for req in self._pending:
            p = self.caller.progress(req.call_idx)
            if p is not None:
                written += p[0]
                total += p[1]
        return written, total

    @property
    def num_unfinalized_calls(self) -> int:
        return len(self._pending)

    def maybe_finalize_async_calls(self, blocking: bool = False, timeout: float = 600.0) -> List[int]:
        """Finalize (in order) every pending call that is globally done.
        Returns finalized call indices.  With ``blocking``, the timeout bounds
        the WHOLE wait including cross-rank consensus — a dead peer surfaces
        as TimeoutError instead of an infinite loop."""
        finalized = []
        deadline = time.monotonic() + timeout
        while self._pending:
            req = self._pending[0]
            if blocking:
                self.caller.wait(
                    req.call_idx, timeout=max(0.0, deadline - time.monotonic())
                )
            locally_done = self.caller.is_done(req.call_idx)
            err = self.caller.error(req.call_idx)
            if err is not None:
                self._pending.pop(0)
                req.run_cleanup()
                raise CheckpointSaveError(f"async call {req.call_idx}: {err}")
            globally_done = self.sync_fn(req.call_idx, locally_done)
            if not globally_done:
                if not blocking:
                    break
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"async call {req.call_idx}: global consensus not "
                        f"reached within {timeout}s (peer rank dead?)"
                    )
                time.sleep(0.05)
                continue
            try:
                for fn in req.finalize_fns:
                    fn()
            finally:
                req.run_cleanup()
            stats = self.caller.stats(req.call_idx)
            if stats is not None:
                self.last_call_stats = stats
            record_event(ProfilingEvent.CHECKPOINT_SAVE_FINALIZED, call_idx=req.call_idx)
            flight.record(EV_DRAIN_END, req.call_idx)
            self._pending.pop(0)
            finalized.append(req.call_idx)
        return finalized

    def close(self) -> None:
        self.maybe_finalize_async_calls(blocking=True)
        self.caller.close()

    def abort(self) -> None:
        self.caller.abort()
        for req in self._pending:
            req.run_cleanup()
        self._pending.clear()


class CheckpointSaveError(RuntimeError):
    pass


def store_sync_fn(store, rank: int, world_size: int, namespace: Optional[str] = None):
    """Cross-rank completion consensus over the KV store.

    Fast path is unchanged from the counter scheme (one ADD per (rank, call)
    + one counter read per poll — the reference burns an NCCL all_reduce per
    check, ``core.py:279-291``), but the counter is no longer trusted for
    correctness, only for speed:

    - **Over-count is impossible.**  Before bumping the counter a rank claims
      a per-(rank, call) marker key (idempotent SET, retry-safe), and the ADD
      is attempted at most once per claim — an ambiguous ADD failure (the
      client refuses to resend non-idempotent ops after the bytes left) is
      swallowed, never retried.  A recreated sync closure re-reads its own
      markers and skips the ADD for already-claimed calls, so restarted or
      re-entered loops can never inflate the counter and finalize a torn
      checkpoint.
    - **Under-count self-heals.**  The markers are the exact truth (a marker
      exists iff that rank observed the call locally done).  When the counter
      poll comes up short, a throttled LIST_KEYS over the call's marker
      prefix (one roundtrip) recounts exactly; on success the counter is
      repaired write-through so other pollers take the fast path again.

    The namespace defaults to being fenced by the restart cycle
    (``TPURX_CYCLE``): call indices reset on restart, and stale counters from
    a previous incarnation must never vouch for new calls.
    """
    if namespace is None:
        namespace = f"ckpt/c{env.CYCLE.get()}"
    last_published = -1
    # per-call poll bookkeeping for the healing scan: call_idx -> polls since
    # the last exact recount
    polls_since_scan: dict = {}
    _SCAN_EVERY = 20  # ~1s of blocking polls (0.05s cadence) between recounts

    def _vouch(idx: int) -> None:
        marker = f"{namespace}/vouch/{idx}/r{rank}"
        if store.try_get(marker) is not None:
            return  # claimed by a previous incarnation; ADD must not repeat
        store.set(marker, b"1")
        try:
            store.add(f"{namespace}/done_count/{idx}", 1)
        except StoreError:
            # Ambiguous: the ADD may or may not have applied.  Retrying risks
            # double-count (torn checkpoint); skipping risks a short counter,
            # which the marker recount in sync() heals.  Fail safe.
            pass

    def sync(call_idx: int, locally_done: bool) -> bool:
        nonlocal last_published
        if not locally_done:
            return False
        # completing call N implies calls <= N are done on this rank (the
        # async queue finalizes in order); advance after EACH call so a fault
        # mid-loop never re-claims already-vouched calls on re-entry
        for idx in range(last_published + 1, call_idx + 1):
            _vouch(idx)
            last_published = idx
        raw = store.try_get(f"{namespace}/done_count/{call_idx}")
        if raw is not None and int(raw) >= world_size:
            _done(call_idx)
            return True
        n = polls_since_scan.get(call_idx, 0) + 1
        if n >= _SCAN_EVERY:  # peers lagging ~1s past our own completion
            polls_since_scan[call_idx] = 0
            markers = store.list_keys(prefix=f"{namespace}/vouch/{call_idx}/")
            if len(markers) >= world_size:
                # exact truth says done; repair the counter for other pollers
                store.set(f"{namespace}/done_count/{call_idx}", itob(world_size))
                _done(call_idx)
                return True
        else:
            polls_since_scan[call_idx] = n
        return False

    def _done(call_idx: int) -> None:
        polls_since_scan.pop(call_idx, None)
        # Consensus is durable in the counter now; drop this rank's marker so
        # the key table doesn't grow by world_size keys per call for the life
        # of the job (the healing recount is only ever needed pre-consensus).
        try:
            store.delete(f"{namespace}/vouch/{call_idx}/r{rank}")
        except StoreError:
            pass  # litter, not corruption

    return sync
