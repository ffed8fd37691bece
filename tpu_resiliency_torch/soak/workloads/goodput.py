"""The chaos soak's goodput workload: one arm of the ``--fault-shift``
adaptive-vs-fixed A/B (``--goodput-arm``).

The port of ``benchmarks/soak_launcher.py``'s ``WORKLOAD_GOODPUT``.  Both
arms replay one seeded fault schedule; each step does ``SOAK_STEP_S`` of
useful work, a ``SaveScheduler`` (which re-reads ``TPURX_CKPT_INTERVAL_S``)
decides when a save of ``SOAK_SAVE_COST_S`` runs, and durable progress is
the step of the last save.  The adaptive arm (``TPURX_POLICY=1``) runs a
``PolicyController`` over this rank's own telemetry, which retunes the
cadence toward Young/Daly through the actuator; the fixed arm runs the
same workload with the policy off.
"""

import json
import os
import sys
import time

if __name__ == "__main__":
    sys.path[0] = os.environ["TPURX_REPO"]

from tpu_resiliency_torch.checkpointing.async_ckpt.checkpointer import SaveScheduler  # noqa: E402
from tpu_resiliency_torch.fault_tolerance import RankMonitorClient  # noqa: E402
from tpu_resiliency_torch.fault_tolerance.progress_tracker import (  # noqa: E402
    write_progress_iteration,
)
from tpu_resiliency_torch.inprocess import ShiftRanks, Wrapper, record_dispatch  # noqa: E402
from tpu_resiliency_torch.soak.worker import (  # noqa: E402
    LaunchCounts,
    claim_fault,
    read_progress,
    worker_device,
)
from tpu_resiliency_torch.telemetry import get_registry  # noqa: E402


def main() -> None:
    rank = int(os.environ["TPURX_RANK"])
    cycle = int(os.environ["TPURX_CYCLE"])
    ckpt = os.environ["SOAK_CKPT"]
    step_s = float(os.environ.get("SOAK_STEP_S", "0.02"))
    save_cost_s = float(os.environ.get("SOAK_SAVE_COST_S", "0.4"))
    fixed_interval_s = float(os.environ.get("SOAK_SAVE_INTERVAL_S", "4.0"))
    total = int(os.environ.get("SOAK_STEPS", "100000"))
    with open(os.environ["SOAK_FAULT_SCHEDULE"]) as f:
        faults = json.load(f)["faults"].get(str(rank), {})
    fired_dir = os.environ["SOAK_FAULT_FIRED_DIR"]
    dev = worker_device()
    counts = LaunchCounts(dev, "goodput")
    print(f"soak[{rank}] device={dev}", flush=True)

    client = RankMonitorClient()
    client.init_workload_monitoring()

    # the adaptive arm: a per-rank closed loop over this rank's own telemetry
    # — the estimator measures MTBF / C / R from the SAME counters the real
    # stack records (interruptions, save-call latency, restart latency) and
    # retunes TPURX_CKPT_INTERVAL_S through the actuator; the fixed arm runs
    # the identical workload with the policy off
    if os.environ.get("TPURX_POLICY", "0") == "1":
        from tpu_resiliency_torch.policy import PolicyController

        policy_ctl = PolicyController()
        policy_ctl.start(
            interval_s=float(os.environ.get("TPURX_POLICY_INTERVAL_S", "2.0")))

    scheduler = SaveScheduler(default_interval_s=fixed_interval_s)
    save_ns = get_registry().get("tpurx_ckpt_save_call_ns")

    @Wrapper(
        group=f"goodput-c{cycle}",
        rank_assignment=ShiftRanks(),
        soft_timeout=3600.0, hard_timeout=7200.0,
        monitor_thread_interval=0.1,
        heartbeat_interval=0.2, sibling_timeout=8.0,
        last_call_wait=0.1,
        enable_monitor_process=False,
    )
    def run(call_wrapper=None):
        start = read_progress(ckpt)
        for step in range(start, total):
            call_wrapper.ping()
            client.send_heartbeat()
            counts.write()
            record_dispatch("goodput_allreduce")
            time.sleep(step_s)           # the useful work
            if scheduler.due():          # re-reads TPURX_CKPT_INTERVAL_S
                t0 = time.monotonic_ns()
                time.sleep(save_cost_s)  # the checkpoint cost C
                scheduler.note_saved()
                if save_ns is not None:
                    save_ns.observe(time.monotonic_ns() - t0)
                if call_wrapper.state.active_rank == 0:
                    # durable progress == last save: a fault rewinds to here
                    write_progress_iteration(ckpt, step + 1)
            kind = faults.get(str(step))
            if kind and claim_fault(fired_dir, rank, step):
                print(f"soak[{rank}] {kind} at step {step}", flush=True)
                if kind == "crash":
                    os._exit(41)
                if kind == "hang":
                    time.sleep(3600)
                raise RuntimeError(f"scheduled exception step {step}")
        return "done"

    print(f"soak[{rank}] result={run()}", flush=True)


if __name__ == "__main__":
    main()
