"""The chaos soak's long-poll workload: the ``--store-longpoll-abort``
campaign.

The port of ``benchmarks/soak_launcher.py``'s ``WORKLOAD_LONGPOLL``.  One
fault episode per restart iteration: active rank 0 parks deep in a
server-held store ``wait()``, active rank 1 raises after
``SOAK_LP_INJECT_DELAY``.  The in-process ring's async abort must land on
the parked rank between poll-quantum slices.  Both sides print
CLOCK_MONOTONIC stamps (system-wide on Linux) so the report can compute
injection->landing latency across processes.
"""

import os
import sys
import time

if __name__ == "__main__":
    sys.path[0] = os.environ["TPURX_REPO"]

from tpu_resiliency_torch.fault_tolerance import RankMonitorClient  # noqa: E402
from tpu_resiliency_torch.inprocess import ShiftRanks, Wrapper  # noqa: E402
from tpu_resiliency_torch.soak.worker import LaunchCounts, worker_device  # noqa: E402
from tpu_resiliency_torch.store.client import StoreTimeout, store_from_env  # noqa: E402


def main() -> None:
    rank = int(os.environ["TPURX_RANK"])
    cycle = int(os.environ["TPURX_CYCLE"])
    inject_delay = float(os.environ.get("SOAK_LP_INJECT_DELAY", "2.0"))
    dev = worker_device()
    counts = LaunchCounts(dev, "longpoll")
    print(f"soaklp[{rank}] device={dev}", flush=True)

    client = RankMonitorClient()
    client.init_workload_monitoring()
    store = store_from_env(timeout=30.0)

    @Wrapper(
        group=f"soaklp-c{cycle}",
        rank_assignment=ShiftRanks(),
        soft_timeout=3600.0, hard_timeout=7200.0,
        monitor_thread_interval=0.05,
        heartbeat_interval=0.1, sibling_timeout=5.0,
        last_call_wait=0.1,
        enable_monitor_process=False,
    )
    def run(call_wrapper=None):
        while True:
            call_wrapper.ping()
            client.send_heartbeat()
            counts.write()
            ep = call_wrapper.state.iteration
            me = call_wrapper.state.active_rank
            if me == 0:
                print(f"soaklp[{rank}] park ep={ep} t={time.monotonic():.6f}",
                      flush=True)
                try:
                    store.wait([f"soaklp/never/c{cycle}/ep{ep}"], timeout=120.0)
                except StoreTimeout:
                    pass  # episode fizzled (injector restarted first); re-park
                except BaseException:
                    print(f"soaklp[{rank}] landed ep={ep} "
                          f"t={time.monotonic():.6f}", flush=True)
                    raise
            elif me == 1:
                # stay live for the heartbeat ring while the victim parks
                t0 = time.monotonic()
                while time.monotonic() - t0 < inject_delay:
                    call_wrapper.ping()
                    client.send_heartbeat()
                    time.sleep(0.05)
                print(f"soaklp[{rank}] inject ep={ep} t={time.monotonic():.6f}",
                      flush=True)
                raise RuntimeError(f"soaklp scheduled abort ep={ep}")
            else:
                # spectator ranks idle-heartbeat until the episode's abort lands
                while True:
                    call_wrapper.ping()
                    client.send_heartbeat()
                    time.sleep(0.05)

    print(f"soaklp[{rank}] result={run()}", flush=True)


if __name__ == "__main__":
    main()
