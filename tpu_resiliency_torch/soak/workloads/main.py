"""The chaos soak's main workload: four random fault classes per step
under the in-process ``Wrapper`` ring, with the quorum tripwire armed.

The port of ``benchmarks/soak_launcher.py``'s ``WORKLOAD``.  Each step
pings the wrapper, heartbeats the rank monitor and records a dispatched
``soak_allreduce`` (the at-abort fingerprint feed), then draws one fault:

- ``crash`` — ``os._exit(41)`` (outer ring respawn);
- ``hang`` — a GIL-released sleep; the rank monitor's heartbeat timeout
  kills the worker (outer ring respawn);
- ``exception`` — absorbed by the in-process ring;
- ``quorum stall`` / ``collective wedge`` (with ``SOAK_QUORUM=1``) — a
  ping-less stall; the quorum tripwire's tick lane trips, every rank's
  abort ladder runs and the iteration restarts.

With ``SOAK_FAULT_SCHEDULE`` a pre-drawn per-(rank, step) schedule replaces
the draws.  With ``SOAK_SAVE_EVERY`` rank 0 runs a store-backed "save"
every that many steps.  Where the JAX workload's quorum mesh holds this
process's devices, the port's is a world of one on the worker's device
(``soak/worker.py``): on the card the tick lane launches kernel 1
(``ops/csrc/quorum_max.cu``) once per tick, and the count is written
every step.

Run by the soak as ``<launcher> .../soak/workloads/main.py``.
"""

import os
import random
import sys
import time

if __name__ == "__main__":
    sys.path[0] = os.environ["TPURX_REPO"]

from tpu_resiliency_torch.fault_tolerance import RankMonitorClient  # noqa: E402
from tpu_resiliency_torch.fault_tolerance.progress_tracker import (  # noqa: E402
    write_progress_iteration,
)
from tpu_resiliency_torch.inprocess import ShiftRanks, Wrapper, record_dispatch  # noqa: E402
from tpu_resiliency_torch.soak.worker import (  # noqa: E402
    LaunchCounts,
    claim_fault,
    quorum_mesh_factory,
    read_progress,
    worker_device,
)


def store_save(save_store, rank: int, step: int) -> None:
    """A store-backed "save": chunked marker writes, each riding the
    unified retry policy in the store client; the whole commit retried
    under the same policy — mid-save store kills must not lose a save."""
    from tpu_resiliency_torch.utils.retry import Retrier, RetryPolicy

    print(f"soak[{rank}] save start at step {step}", flush=True)
    r = Retrier("soak_save", RetryPolicy(max_attempts=None, base_delay=0.5,
                                         max_delay=3.0, deadline=60.0))
    while True:
        try:
            for i in range(8):
                save_store.set(f"soakckpt/{step}/{i}", str(step))
                time.sleep(0.08)
            save_store.set(f"soakckpt/{step}/commit", "1")
            break
        except Exception as exc:
            r.backoff(exc)
    print(f"soak[{rank}] save done at step {step}", flush=True)


def stall_forever() -> None:
    """A ping-less python loop: the quorum tripwire trips and the async
    raise lands here."""
    while True:
        time.sleep(0.02)


def main() -> None:
    rank = int(os.environ["TPURX_RANK"])
    cycle = int(os.environ["TPURX_CYCLE"])
    p_exc = float(os.environ.get("SOAK_EXC_P", "0.01"))
    p_crash = float(os.environ.get("SOAK_CRASH_P", "0.008"))
    p_hang = float(os.environ.get("SOAK_HANG_P", "0.004"))
    p_qstall = float(os.environ.get("SOAK_QSTALL_P", "0.0"))
    p_cwedge = float(os.environ.get("SOAK_CWEDGE_P", "0.0"))
    save_every = int(os.environ.get("SOAK_SAVE_EVERY", "0"))
    total = int(os.environ.get("SOAK_STEPS", "100000"))
    ckpt = os.environ["SOAK_CKPT"]
    rng = random.Random(f"{cycle}:{rank}:{os.getpid()}")
    dev = worker_device()
    counts = LaunchCounts(dev, "main")
    print(f"soak[{rank}] device={dev}", flush=True)

    # seeded replay: a pre-drawn per-(rank, step) schedule replaces the RNG
    # draws so two runs (e.g. the adaptive-vs-fixed A/B arms) see the EXACT
    # same injection timeline
    sched_path = os.environ.get("SOAK_FAULT_SCHEDULE", "")
    fired_dir = os.environ.get("SOAK_FAULT_FIRED_DIR", "")
    fault_sched = {}
    if sched_path:
        import json

        with open(sched_path) as f:
            fault_sched = json.load(f)["faults"].get(str(rank), {})

    save_store = None
    if save_every and rank == 0:
        from tpu_resiliency_torch.store.client import store_from_env

        save_store = store_from_env(timeout=10.0)

    quorum_kw = {}
    if os.environ.get("SOAK_QUORUM") == "1":
        quorum_kw = dict(
            quorum_mesh=quorum_mesh_factory(dev),
            quorum_budget_ms=float(os.environ.get("SOAK_QUORUM_BUDGET_MS", "500")),
            quorum_interval=0.05,
            quorum_auto_beat_interval=None,   # manual ping only: progress semantics
            quorum_calibrate=False,
        )

    client = RankMonitorClient()
    client.init_workload_monitoring()

    @Wrapper(
        group=f"soak-c{cycle}",
        rank_assignment=ShiftRanks(),
        soft_timeout=3600.0, hard_timeout=7200.0,   # host ring owns hang kills
        monitor_thread_interval=0.1,
        heartbeat_interval=0.2, sibling_timeout=8.0,
        last_call_wait=0.1,
        enable_monitor_process=False,  # rank monitor (launcher ring) is the backstop here
        **quorum_kw,
    )
    def run(call_wrapper=None):
        start = read_progress(ckpt)
        for step in range(start, total):
            call_wrapper.ping()
            client.send_heartbeat()
            counts.write()
            record_dispatch("soak_allreduce")   # at-abort fingerprint feed
            time.sleep(0.03)
            if save_every and save_store is not None and step and step % save_every == 0:
                store_save(save_store, rank, step)
            if sched_path:
                kind = fault_sched.get(str(step))
                if kind and claim_fault(fired_dir, rank, step):
                    print(f"soak[{rank}] {kind} at step {step}", flush=True)
                    if kind == "crash":
                        os._exit(41)
                    if kind == "hang":
                        time.sleep(3600)
                    if kind in ("quorum stall", "collective wedge"):
                        stall_forever()
                    raise RuntimeError(f"scheduled exception step {step}")
                if call_wrapper.state.active_rank == 0:
                    write_progress_iteration(ckpt, step + 1)
                continue
            r = rng.random()
            if r < p_crash:
                print(f"soak[{rank}] crash at step {step}", flush=True)
                os._exit(41)
            r -= p_crash
            if r < p_hang:
                print(f"soak[{rank}] hang at step {step}", flush=True)
                time.sleep(3600)   # GIL released; heartbeat timeout must kill us
            r -= p_hang
            if r < p_exc:
                print(f"soak[{rank}] exception at step {step}", flush=True)
                raise RuntimeError(f"injected exception step {step}")
            r -= p_exc
            if r < p_qstall and quorum_kw:
                print(f"soak[{rank}] quorum stall at step {step}", flush=True)
                stall_forever()
            r -= p_qstall
            if r < p_cwedge and quorum_kw:
                # wedged-collective injection: the collective was DISPATCHED
                # (it's in the tail) and this rank now parks "inside" it —
                # the ladder's fingerprint rung must name soak_allreduce
                print(f"soak[{rank}] collective wedge at step {step}", flush=True)
                stall_forever()
            if call_wrapper.state.active_rank == 0:
                write_progress_iteration(ckpt, step + 1)
        return "done"

    print(f"soak[{rank}] result={run()}", flush=True)
    counts.write()


if __name__ == "__main__":
    main()
