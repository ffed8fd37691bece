"""Trainer worker of the port's in-job restart ring, run by the port's
launcher (``python -m tpu_resiliency_torch.fault_tolerance.launcher``).

The port's counterpart of ``tests/workloads/toy_train.py`` and
``examples/train_with_launcher.py``, around the flagship transformer: it
heartbeats its rank monitor (``RankMonitorClient``), writes the progress
iteration the launcher's tracker reads, trains under both quorum lanes —
``FusedStepQuorum`` wraps each step and a ``QuorumMonitor`` ticks over the
world's group with ``on_stale=quorum_restart_requester(client)`` — saves with
``AsyncCheckpointer(delta=True, device_digest=True)`` every few steps, and on
start resumes from the newest committed checkpoint.  Both kernels of the
port run here on the card: the quorum local max in every fused step and
tick, the chunk fingerprint once in every save, over the rank's owned
leaves.  Each commit and the end report both kernels' counts beside the
saves made and the shards owned.

Env (besides the launcher's ``TPURX_*`` identity and sockets):
  FT_OUT      output directory: checkpoints, ``losses.r<rank>.jsonl`` (one
              line per finished step) and ``events.r<rank>.jsonl`` (spawn,
              CUDA and process-group set-up, restore, first step, each
              save's commit, fault, done, each with a CLOCK_MONOTONIC ns
              stamp, comparable with the launcher's profiling events on the
              same host)
  FT_DEVICE   the device this rank drives, given explicitly: ``cuda:0`` (every
              rank of a one-card host) or ``cpu``
  FT_BACKEND  ``nccl`` (default on the card) or ``gloo`` (ranks sharing a card)
  FT_CFG      JSON of ``TransformerConfig`` fields (default: the flagship)
  FT_MESH     ``dp_tp`` for a ("data", "model") mesh of (world, 1)
  FT_BATCH, FT_SEQ, FT_STEPS, FT_SAVE_EVERY, FT_QUORUM_BUDGET_MS
  FT_STEP_SLEEP  seconds slept after each step (default 0; losses unchanged)
  FT_STORE    ``env``: reach the store through ``store_from_env`` (the
              multiplexed, failover or sharded client the ``TPURX_STORE_*``
              knobs select) in every world size, and time each call into it
              (``store_slow`` events over 50 ms, the count and the longest
              in ``done``)
  FT_FAULTS   JSON ``{"<cycle>": [kind, step, rank]}``: ``crash`` (SIGKILL
              itself), ``heartbeat`` (stop heartbeating; the rank monitor must
              kill it), ``quorum`` (keep heartbeating, stop the quorum beats;
              the tick lane must ask the launcher for a restart), ``cuda_oom``
              (allocate until this process's allocated bytes cross the memory
              logger's ``FT_MEM_WARN_FRACTION`` of the card and sample the
              logger, whose warning lands in the log, then allocate the
              card's whole memory, more than is free: torch raises its
              ``OutOfMemoryError`` and the worker
              exits 1 with the traceback; on the CPU, which has no allocator
              to exhaust, it raises that error with a message saying so)
  FT_CALLBACKS  ``1``: drive the loop through the port's ``CallbackRunner``
              with a ``FaultToleranceCallback`` (it connects to the rank
              monitor at train start, after the restore, loading the timeouts
              an earlier cycle learned from ``ft_state.r<rank>.json``,
              heartbeats at each step's end and persists the timeouts it
              learns after 4 steps) and run a
              ``DeviceMemoryLogger`` (1 s)
  FT_MEM_WARN_FRACTION  the logger's warning fraction (default 0.92)
"""

import json
import os
import signal
import sys
import time
import traceback

T_SPAWN_NS = time.monotonic_ns()
sys.path.insert(0, os.environ["TPURX_REPO"])

RANK = int(os.environ["TPURX_RANK"])
WORLD = int(os.environ["TPURX_WORLD_SIZE"])
CYCLE = int(os.environ["TPURX_CYCLE"])
OUT = os.environ["FT_OUT"]


def emit(event, **fields):
    """One line of this rank's event log, written through to the file (a
    SIGKILL right after it loses nothing)."""
    rec = {"cycle": CYCLE, "rank": RANK, "event": event, "ns": time.monotonic_ns(), **fields}
    with open(os.path.join(OUT, f"events.r{RANK}.jsonl"), "a") as f:
        f.write(json.dumps(rec) + "\n")
    print(f"ft_worker[{RANK}] cycle={CYCLE} {event} {json.dumps(fields)}", flush=True)


def launches(q, dd):
    return {"quorum_local_max": q.local_max.launches,
            "chunk_fingerprint": dd.batch_fingerprints.launches,
            "chunk_fingerprint_shards": dd.batch_fingerprints.shards}


class TimedStore:
    """Times every call into the wrapped store client: the count, the
    longest, and a ``store_slow`` event for each call over 50 ms."""

    def __init__(self, inner):
        self._inner = inner
        self.ops = 0
        self.max_ms = 0.0

    def __getattr__(self, name):
        attr = getattr(self._inner, name)
        if not callable(attr):
            return attr

        def timed(*args, **kwargs):
            t0 = time.monotonic_ns()
            try:
                return attr(*args, **kwargs)
            finally:
                ms = (time.monotonic_ns() - t0) / 1e6
                self.ops += 1
                self.max_ms = max(self.max_ms, ms)
                if ms > 50.0:
                    emit("store_slow", op=name, t0_ns=t0, ms=ms)

        return timed


def newest_committed(root):
    """The newest checkpoint directory whose commit (``metadata.json``) landed."""
    done = []
    for name in os.listdir(root) if os.path.isdir(root) else ():
        if name.startswith("step") and os.path.exists(
                os.path.join(root, name, "metadata.json")):
            done.append(int(name[len("step"):]))
    return max(done) if done else None


def cuda_oom(torch, device, mem):
    """The ``cuda_oom`` fault: never returns."""
    if device.type != "cuda":
        emit("oom", allocated=0, warned=False)
        try:
            raise torch.OutOfMemoryError(
                "CUDA out of memory (the CPU rehearsal of the cuda_oom fault: "
                "the CPU has no caching allocator to exhaust)")
        except torch.OutOfMemoryError:
            traceback.print_exc()
            sys.stderr.flush()
            os._exit(1)
    limit = torch.cuda.get_device_properties(device).total_memory
    held = []
    while torch.cuda.memory_allocated(device) < mem.warn_fraction * limit:
        held.append(torch.empty(1 << 30, dtype=torch.uint8, device=device))
    stats = mem.sample()
    emit("oom", allocated=torch.cuda.memory_allocated(device),
         bytes_in_use=stats[0]["bytes_in_use"], limit=limit)
    try:
        # the card's whole memory: more than is free while this process
        # holds what it just allocated
        held.append(torch.empty(limit, dtype=torch.uint8, device=device))
    except torch.OutOfMemoryError:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    raise AssertionError("allocating the card's whole memory did not raise")


def main():
    from tpu_resiliency_torch.fault_tolerance import RankMonitorClient
    from tpu_resiliency_torch.fault_tolerance.progress_tracker import (
        write_progress_iteration,
    )

    emit("spawn", spawn_ns=T_SPAWN_NS)
    client = RankMonitorClient()
    runner = None
    if os.environ.get("FT_CALLBACKS") == "1":
        from tpu_resiliency_torch.integrations import (
            CallbackRunner,
            FaultToleranceCallback,
        )

        warmup = 4  # steps before the callback learns and persists timeouts
        runner = CallbackRunner([FaultToleranceCallback(
            client=client, state_path=os.path.join(OUT, f"ft_state.r{RANK}.json"),
            warmup_steps=warmup, update_interval=warmup)])
    else:
        client.init_workload_monitoring()

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    t0 = time.perf_counter()
    import torch

    from tpu_resiliency_torch.checkpointing.async_ckpt import checkpointer as ckpt_mod
    from tpu_resiliency_torch.checkpointing.async_ckpt import device_digest as dd
    from tpu_resiliency_torch.inprocess import quorum_restart_requester
    from tpu_resiliency_torch.models import transformer as tr
    from tpu_resiliency_torch.ops import quorum as q
    from tpu_resiliency_torch.parallel import init_distributed, make_mesh
    from tpu_resiliency_torch.store import StoreClient

    device = torch.device(os.environ["FT_DEVICE"])
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.set_device(device)
        torch.ones(1, device=device).sum().item()  # the CUDA context
    import_cuda_ms = (time.perf_counter() - t0) * 1e3
    # bit-for-bit losses across a restore need deterministic kernels
    torch.use_deterministic_algorithms(True, warn_only=True)

    t0 = time.perf_counter()
    backend = os.environ.get("FT_BACKEND") or ("nccl" if on_card else "gloo")
    if WORLD > 1:
        addr, port = os.environ["TPURX_STORE_ADDR"], int(os.environ["TPURX_STORE_PORT"])
        init_distributed(init_method=f"tcp://{addr}:{port + 1}", world_size=WORLD,
                         rank=RANK, device=device, backend=backend)
    else:
        init_distributed(world_size=1, rank=0, device=device, backend=backend)
    import torch.distributed as dist

    def max_over_world(n):
        t = torch.tensor([n], dtype=torch.int64,
                         device=device if backend == "nccl" else "cpu")
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return int(t.item())

    mesh_kind = os.environ.get("FT_MESH", "")
    mesh = (make_mesh(("data", "model"), (WORLD, 1), device=device)
            if mesh_kind == "dp_tp" else None)
    quorum_mesh = mesh if mesh is not None else make_mesh(("all",), device=device)
    dist_ms = (time.perf_counter() - t0) * 1e3

    cfg = tr.TransformerConfig(**json.loads(os.environ.get("FT_CFG") or "{}"))
    batch_size = int(os.environ.get("FT_BATCH", "8"))
    seq = int(os.environ.get("FT_SEQ", "1024"))
    steps = int(os.environ.get("FT_STEPS", "24"))
    save_every = int(os.environ.get("FT_SAVE_EVERY", "4"))
    faults = {int(c): v for c, v in json.loads(os.environ.get("FT_FAULTS") or "{}").items()}
    fault = faults.get(CYCLE)
    if fault is not None and fault[2] != RANK:
        fault = None

    params = tr.init_params(cfg, torch.Generator(device).manual_seed(0),
                            device=device, mesh=mesh)
    opt = tr.init_opt_state(params)
    batch = tr.make_batch(cfg, batch_size, seq, seed=0, device=device, mesh=mesh)
    root = os.path.join(OUT, "ckpt")

    def save_dir(s):
        return os.path.join(root, f"step{s:04d}")

    start = newest_committed(root)
    restore_ms = None
    if start is not None:
        t0 = time.perf_counter()
        out = ckpt_mod.load_checkpoint(save_dir(start), tr.state_tree(params, opt),
                                       resident=False)
        tr.load_state_tree(params, opt, out)
        if on_card:
            torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
    s = start or 0
    emit("ready", import_cuda_ms=import_cuda_ms, dist_ms=dist_ms,
         restore_ms=restore_ms, restored_from=start, device=str(device),
         backend=backend)

    if os.environ.get("FT_STORE") == "env":
        from tpu_resiliency_torch.store import store_from_env

        store = TimedStore(store_from_env(timeout=120.0))
        emit("store", client=type(store._inner).__name__)
    else:
        store = (StoreClient(os.environ["TPURX_STORE_ADDR"],
                             int(os.environ["TPURX_STORE_PORT"]), timeout=120.0)
                 if WORLD > 1 else None)
    step_sleep = float(os.environ.get("FT_STEP_SLEEP", "0"))
    mem = None
    if runner is not None:
        from tpu_resiliency_torch.utils.memory import DeviceMemoryLogger

        mem = DeviceMemoryLogger(
            interval=1.0, device=device,
            warn_fraction=float(os.environ.get("FT_MEM_WARN_FRACTION", "0.92"))).start()
    ck = ckpt_mod.AsyncCheckpointer(store=store, delta=True, device_digest=True)
    trips = []
    fq = q.FusedStepQuorum(quorum_mesh, budget_ms=1000.0, identify=True, device=device,
                           on_stale=lambda age, dev: trips.append(("fused", age)))
    budget = float(os.environ.get("FT_QUORUM_BUDGET_MS", "500"))
    mon = q.QuorumMonitor(quorum_mesh, budget_ms=budget, interval=0.01, identify=True,
                          auto_beat_interval=0.005, device=device,
                          on_stale=quorum_restart_requester(client))
    step = fq.fuse(tr.make_train_step(cfg, lr=1e-3, mesh=mesh))
    progress = os.environ.get("TPURX_FT_PROGRESS_ITERATION_FILE")
    mon.start()
    if runner is not None:
        # the callback connects here, at train start, loading the timeouts
        # an earlier cycle learned
        runner.on_train_start(step=s)
        emit("callbacks", hb_timeouts=client.state_dict()["hb_timeouts"])
    saved = set()
    first = True
    with open(os.path.join(OUT, f"losses.r{RANK}.jsonl"), "a") as losses:
        while s < steps:
            if s % save_every == 0 and s not in saved and s != start:
                ck.async_save(tr.state_tree(params, opt), save_dir(s), {"step": s})
                saved.add(s)
            if fault is not None and s == fault[1]:
                kind = fault[0]
                emit("fault", kind=kind, step=s, launches=launches(q, dd))
                if kind == "crash":
                    os.kill(os.getpid(), signal.SIGKILL)
                if kind == "cuda_oom":
                    cuda_oom(torch, device, mem)
                if kind == "heartbeat":
                    while True:   # no heartbeats; the quorum beats go on
                        time.sleep(0.1)
                mon.stop_auto_beat()
                while True:       # heartbeats go on; no quorum beats
                    client.send_heartbeat()
                    time.sleep(0.1)
            fq.beat()
            params, opt, loss = step(params, opt, batch)
            loss = float(loss)
            if first:
                emit("first_step", step=s)
                first = False
            losses.write(json.dumps({"cycle": CYCLE, "step": s, "loss": loss}) + "\n")
            losses.flush()
            # after the step, so that the first step's warm-up falls under the
            # initial heartbeat timeout
            if runner is not None:
                runner.on_step_end(step=s)
            else:
                client.send_heartbeat()
            if s in saved:
                ck.maybe_finalize(blocking=True)   # the save drained under step s
                emit("committed", step=s, launches=launches(q, dd), saves=len(saved),
                     owned=ck.last_stage_stats.get("shards_owned", 0))
            s += 1
            if progress and RANK == 0:
                write_progress_iteration(progress, s)
            if step_sleep:
                time.sleep(step_sleep)
    ck.finalize_all(timeout=120.0)
    owned = ck.last_stage_stats.get("shards_owned", 0)
    ck.close()
    fq.check_now()
    # the tick lane spans the world: every rank ends it after the same tick
    mon.stop(sync=max_over_world if WORLD > 1 else None)
    store_stats = ({"store_ops": store.ops, "store_max_ms": store.max_ms}
                   if isinstance(store, TimedStore) else {})
    emit("done", steps=s, launches=launches(q, dd), saves=len(saved), owned=owned,
         trips=trips, **store_stats)
    print("INJOB_LAUNCHES " + json.dumps({"rank": RANK, "cycle": CYCLE,
                                          **launches(q, dd)}), flush=True)
    if runner is not None:
        mem.stop()
        runner.on_train_end()
    else:
        client.shutdown_workload_monitoring()
    if WORLD > 1:
        dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
