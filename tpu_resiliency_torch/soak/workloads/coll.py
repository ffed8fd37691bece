"""The chaos soak's collective workload: the ``--link-degrade`` campaign.

The port of ``benchmarks/soak_launcher.py``'s ``WORKLOAD_COLL``.  Every
step runs one wrapped collective, ``parallel.collectives.device_max_reduce``;
on the fault-armed rank (``TPURX_FAULT=coll_stall``) its primary lane
stalls past the deadline and the wrapper must degrade (retry ->
re-layout) in process: the launcher ring must never see a restart.

``device_max_reduce`` reduces over the default process group.  Where the
JAX workload's reduce spans this process's devices, the port's default
group is the worker's own world of one (``soak/worker.py``): NCCL on the
card, so the all-reduce MAX and its operand live there, gloo on the CPU.
"""

import os
import sys
import time

if __name__ == "__main__":
    sys.path[0] = os.environ["TPURX_REPO"]

from tpu_resiliency_torch.fault_tolerance import RankMonitorClient  # noqa: E402
from tpu_resiliency_torch.fault_tolerance.progress_tracker import (  # noqa: E402
    write_progress_iteration,
)
from tpu_resiliency_torch.parallel import device_max_reduce  # noqa: E402
from tpu_resiliency_torch.soak.worker import (  # noqa: E402
    LaunchCounts,
    metric_sum,
    worker_device,
    world_of_one,
)
from tpu_resiliency_torch.store.client import store_from_env  # noqa: E402


def main() -> None:
    rank = int(os.environ["TPURX_RANK"])
    world = int(os.environ["TPURX_WORLD_SIZE"])
    total = int(os.environ.get("SOAK_COLL_STEPS", "25"))
    ckpt = os.environ["SOAK_CKPT"]
    dev = worker_device()
    world_of_one(dev)
    counts = LaunchCounts(dev, "coll")
    print(f"soakcoll[{rank}] device={dev}", flush=True)

    client = RankMonitorClient()
    client.init_workload_monitoring()
    store = store_from_env(timeout=10.0)
    for step in range(total):
        client.send_heartbeat()
        # every step runs one wrapped collective; on the fault-armed rank
        # (TPURX_FAULT=coll_stall) the primary lane stalls past its deadline
        # and the wrapper must degrade (retry -> re-layout) IN PROCESS — the
        # launcher ring must never see a restart
        got = device_max_reduce([float(step)])
        assert got and got[0] >= float(step), (got, step)
        time.sleep(0.02)
        if rank == 0:
            write_progress_iteration(ckpt, step + 1)
        counts.write()
    # gang-synchronized exit: a rank exiting while the degraded rank is still
    # grinding reads as a failure to the launcher ring, which would restart
    # the gang and mask the zero-restart assertion
    store.set(f"soakcoll/done/r{rank}", "1")
    t_barrier = time.monotonic()
    while time.monotonic() - t_barrier < 120.0:
        client.send_heartbeat()
        if all(store.try_get(f"soakcoll/done/r{r}") is not None
               for r in range(world)):
            break
        time.sleep(0.2)
    print(f"soakcoll[{rank}] result=done "
          f"degrades={int(metric_sum('tpurx_collective_degrades_total'))} "
          f"timeouts={int(metric_sum('tpurx_collective_timeouts_total'))}",
          flush=True)


if __name__ == "__main__":
    main()
