"""Toy training workload of the port's launcher tests, on the CPU.

The port's counterpart of ``tests/workloads/toy_train.py``: the same
iterations, heartbeats, progress file and injected faults, through
``tpu_resiliency_torch`` and torch only.  The quorum lane is
``QuorumMonitor(device="cpu")`` on a gloo world of one per worker (the JAX
toy's mesh holds this process's devices only), so it runs kernel 1's plain
version.

Env:
  TOY_ITERS       total iterations (default 20)
  TOY_CKPT        progress file path ("checkpoint")
  TOY_FAIL        "cycle:rank:iter" -> crash with rc 17
  TOY_HANG        "cycle:rank:iter" -> stop heartbeating forever
  TOY_QUORUM_HANG "cycle:rank:iter" -> stop quorum-beating (stall) with the
                  quorum tripwire wired to request an in-job restart
                  (WorkloadControlRequest.RestartWorkload)
  TOY_STEP_TIME   seconds per iteration (default 0.05)
  TOY_DEVICE      "cuda" or "cpu": touch that device before the first
                  iteration (unset: no device work outside the quorum lane)
"""

import os
import sys
import time

sys.path.insert(0, os.environ["TPURX_REPO"])

from tpu_resiliency_torch.fault_tolerance import RankMonitorClient  # noqa: E402
from tpu_resiliency_torch.fault_tolerance.progress_tracker import (  # noqa: E402
    write_progress_iteration,
)


def parse_spec(name):
    spec = os.environ.get(name)
    if not spec:
        return None
    return tuple(int(x) for x in spec.split(":"))


def main():
    rank = int(os.environ["TPURX_RANK"])
    cycle = int(os.environ["TPURX_CYCLE"])
    world = int(os.environ["TPURX_WORLD_SIZE"])
    total = int(os.environ.get("TOY_ITERS", "20"))
    step_time = float(os.environ.get("TOY_STEP_TIME", "0.05"))
    ckpt = os.environ.get("TOY_CKPT")
    fail = parse_spec("TOY_FAIL")
    hang = parse_spec("TOY_HANG")
    quorum_hang = parse_spec("TOY_QUORUM_HANG")

    start = 0
    if ckpt and os.path.exists(ckpt):
        with open(ckpt) as f:
            start = int(f.read().strip() or "0")

    client = RankMonitorClient()
    client.init_workload_monitoring()

    device = os.environ.get("TOY_DEVICE")
    if device:
        import torch

        from tpu_resiliency_torch.utils.device import resolve_device

        dev = resolve_device(None if device == "cuda" else device)
        torch.zeros(1, device=dev).add_(1)
        print(f"toy[{rank}] device={dev}", flush=True)

    quorum = None
    if quorum_hang:
        from tpu_resiliency_torch.inprocess import quorum_restart_requester
        from tpu_resiliency_torch.ops.quorum import QuorumMonitor
        from tpu_resiliency_torch.parallel import init_distributed, make_mesh

        init_distributed(world_size=1, rank=0, device="cpu")
        quorum = QuorumMonitor(
            make_mesh(("d",), device="cpu"),
            budget_ms=float(os.environ.get("TOY_QUORUM_BUDGET_MS", "500")),
            interval=0.02,
            auto_beat_interval=None,  # manual beats: progress semantics
            on_stale=quorum_restart_requester(client),
            identify=True,
            device="cpu",
        )
        quorum.start()

    print(f"toy[{rank}/{world}] cycle={cycle} starting at iter {start}", flush=True)

    for it in range(start, total):
        client.send_heartbeat()
        if quorum is not None:
            quorum.beat()
        time.sleep(step_time)
        if fail and (cycle, rank, it) == fail:
            fail_msg = os.environ.get("TOY_FAIL_MSG")
            if fail_msg:
                print(fail_msg, flush=True)
            print(f"toy[{rank}] injecting crash at iter {it}", flush=True)
            os._exit(17)
        if hang and (cycle, rank, it) == hang:
            print(f"toy[{rank}] injecting hang at iter {it}", flush=True)
            time.sleep(3600)
        if quorum_hang and (cycle, rank, it) == quorum_hang:
            # keep heartbeating the host monitor (its timeout is huge in the
            # test) but stall the quorum beats: only the quorum tripwire can
            # name this hang and request the cycle restart
            print(f"toy[{rank}] injecting quorum-stall at iter {it}", flush=True)
            while True:
                client.send_heartbeat()
                time.sleep(0.1)
        if rank == 0 and ckpt:
            write_progress_iteration(ckpt, it + 1)
    if quorum is not None:
        quorum.stop()
    print(f"toy[{rank}] done ({total} iters)", flush=True)


if __name__ == "__main__":
    main()
