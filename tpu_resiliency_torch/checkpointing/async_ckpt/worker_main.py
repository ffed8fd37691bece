"""Checkpoint writer worker process entrypoint.

Runs as ``python -m tpu_resiliency_torch.checkpointing.async_ckpt.worker_main`` —
a plain subprocess, NOT a multiprocessing spawn child.  mp-spawn re-imports
the parent's ``__main__`` module, which detonates in any user training script
lacking the ``if __name__ == "__main__"`` guard; a training-resiliency
library must not crash user jobs over that.  (The reference inherits this
footgun from mp.spawn, ``core.py:482-515``; this design removes it.)

Protocol over stdin/stdout pipes: u32-length-prefixed pickle frames.
Pickle is acceptable here: the pipe is a private fd pair with our own parent,
not a network surface.  Functions must be importable (not defined in the
user's ``__main__``).

Requests (trainer → worker):

    ("call",   call_idx, fn, args)   run ``fn(*args)`` in a worker thread
    ("sbegin", call_idx, fn, args)   begin a STREAMED call: run
                                     ``fn(*args, item_iter, progress_cb)``
                                     where ``item_iter`` yields subsequent
                                     stream items as they arrive
    ("sitem",  call_idx, item)       feed one item to the streamed call.
                                     For the drain, items are shard payload
                                     lists; a payload may carry delta
                                     baseline rows ("delta"), device-digest
                                     verdicts ("dev_unchanged"), or be
                                     provenance-only ("skip_spans": the
                                     shard's bytes never left the device —
                                     the writer materializes base-generation
                                     rows and credits progress immediately)
    ("send",   call_idx, err)        end the stream; ``err`` != None aborts
                                     (the iterator raises inside ``fn``)
    None                             shutdown: drain active calls and exit

Responses (worker → trainer):

    ("done", call_idx, error_str_or_None, duration_s, stats_dict_or_None)
                                     ``stats`` is the called fn's return
                                     value when it is a dict (the drain
                                     engine reports bytes/chunks/digest
                                     accounting this way)
    ("prog", call_idx, bytes_written, bytes_total)   drain progress, emitted
                                     by streamed fns through ``progress_cb``

Calls run in threads so a long drain never blocks the frame loop — stream
items for one save keep flowing while another save is still writing.

The port's copy of the JAX package's worker.  Its import chain (this
package, ``writer``, ``integrity``, ``utils``, ``telemetry``) holds no
``torch``, so a save never pays a torch import in a fresh process, and the
worker hides every CUDA device from itself.  Tagging the worker's events
with the job's fault episode waits for the store's port (``ROADMAP.md``
Queue 1 item 5).
"""

from __future__ import annotations

import os
import pickle
import queue as queue_mod
import struct
import sys
import threading
import time

from ...utils import env

_U32 = struct.Struct("<I")

_END = object()


def _read_exact(stream, n: int):
    buf = b""
    while len(buf) < n:
        chunk = stream.read(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


def _set_io_priority() -> None:
    """ionice the drain to IDLE class: checkpoint I/O runs only when nothing
    else needs the disk, so the background write never steals IOPS from the
    input pipeline (reference ``_set_process_qos`` io_priority analog,
    ``async_ckpt/core.py:41-110``).  Raw ``ioprio_set`` syscall — no
    dependency; unsupported arch/kernel is a silent no-op."""
    klass = env.CKPT_WORKER_IONICE.get()
    if klass < 0:  # negative disables
        return
    import ctypes
    import platform

    syscall_nr = {"x86_64": 251, "aarch64": 30}.get(platform.machine())
    if syscall_nr is None:
        return
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        IOPRIO_WHO_PROCESS = 1
        libc.syscall(syscall_nr, IOPRIO_WHO_PROCESS, 0, klass << 13)
    except (OSError, ValueError):
        pass


class _StreamAborted(RuntimeError):
    pass


def main() -> None:
    # The writer only touches numpy+shm; this process must never claim a
    # CUDA context on the trainer's card, whatever a pickled fn imports.
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    # QoS: deprioritize CPU (nice) and I/O (ionice idle) so the drain yields
    # to the trainer on both resources
    try:
        os.nice(env.CKPT_WORKER_NICE.get())
    except OSError:
        pass
    _set_io_priority()
    stdin = sys.stdin.buffer
    stdout = sys.stdout.buffer
    # anything the written fns print must not corrupt the response stream
    sys.stdout = sys.stderr

    out_lock = threading.Lock()

    def send(obj) -> None:
        raw = pickle.dumps(obj)
        try:
            with out_lock:
                stdout.write(_U32.pack(len(raw)) + raw)
                stdout.flush()
        except (BrokenPipeError, OSError):
            pass  # trainer died; nothing to report to

    threads: list = []
    streams: dict = {}

    def run(call_idx, fn, args, item_q=None) -> None:
        t0 = time.monotonic()
        try:
            if item_q is None:
                ret = fn(*args)
            else:
                def items():
                    while True:
                        # tpurx: disable=TPURX005 -- stream feed queue; _END/_StreamAborted sentinel always closes it
                        got = item_q.get()
                        if got is _END:
                            return
                        if isinstance(got, _StreamAborted):
                            raise got
                        yield got

                def progress(written, total):
                    send(("prog", call_idx, int(written), int(total)))

                ret = fn(*args, items(), progress)
            send(("done", call_idx, None, time.monotonic() - t0,
                  ret if isinstance(ret, dict) else None))
        except BaseException as exc:  # noqa: BLE001 - report to trainer
            send(("done", call_idx, f"{type(exc).__name__}: {exc}",
                  time.monotonic() - t0, None))

    def spawn(call_idx, fn, args, item_q=None) -> None:
        t = threading.Thread(
            target=run, args=(call_idx, fn, args, item_q),
            name=f"tpurx-ckpt-call{call_idx}", daemon=True,
        )
        threads.append(t)
        t.start()

    while True:
        hdr = _read_exact(stdin, 4)
        if hdr is None:
            break
        (n,) = _U32.unpack(hdr)
        raw = _read_exact(stdin, n)
        if raw is None:
            break
        req = pickle.loads(raw)
        if req is None:
            break
        kind = req[0]
        if kind == "call":
            _, call_idx, fn, args = req
            spawn(call_idx, fn, args)
        elif kind == "sbegin":
            _, call_idx, fn, args = req
            q: "queue_mod.Queue" = queue_mod.Queue()
            streams[call_idx] = q
            spawn(call_idx, fn, args, q)
        elif kind == "sitem":
            _, call_idx, item = req
            q = streams.get(call_idx)
            if q is not None:
                q.put(item)
        elif kind == "send":
            _, call_idx, err = req
            q = streams.pop(call_idx, None)
            if q is not None:
                q.put(_StreamAborted(err) if err else _END)

    # shutdown (explicit or trainer EOF): open streams can never complete —
    # abort them so their threads unwind and clean up tmp files, then drain
    for q in streams.values():
        q.put(_StreamAborted("stream closed before completion (trainer exit)"))
    streams.clear()
    for t in threads:
        t.join()  # tpurx: disable=TPURX005 -- every stream just got the abort sentinel; bodies unwind finite local work


if __name__ == "__main__":
    main()
