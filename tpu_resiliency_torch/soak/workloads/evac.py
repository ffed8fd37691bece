"""The chaos soak's predict-and-evacuate workload: the ``--ramp-degrade``
campaign.

The port of ``benchmarks/soak_launcher.py``'s ``WORKLOAD_EVAC``.  One
rank's health and straggler scores ramp worse round by round
(``soak/ramp.py``) while rank 0 hosts a ``PolicyController`` over the
tree-gathered snapshot feed with ``TPURX_EVAC=1``.  The fused rank risk
must evacuate the victim (checkpoint-ahead and a published ``evac/``
record) before its hard-fault deadline, and the evacuated slot must
warm-join chunk-granular off peer holders' resident copies.  The trees
are torch tensors on the worker's device; the warm join is checked bit
for bit against the tree saved at its iteration.
"""

import json
import os
import sys
import time

if __name__ == "__main__":
    sys.path[0] = os.environ["TPURX_REPO"]

from tpu_resiliency_torch.checkpointing.local.manager import LocalCheckpointManager  # noqa: E402
from tpu_resiliency_torch.checkpointing.local.replication import (  # noqa: E402
    CliqueReplication,
    PeerExchange,
)
from tpu_resiliency_torch.fault_tolerance import RankMonitorClient  # noqa: E402
from tpu_resiliency_torch.policy import (  # noqa: E402
    EvacuationPipeline,
    PolicyController,
    SnapshotFeed,
    set_evacuation_handler,
)
from tpu_resiliency_torch.soak.ramp import publish_ramp  # noqa: E402
from tpu_resiliency_torch.soak.worker import (  # noqa: E402
    LaunchCounts,
    source_bytes,
    worker_device,
)
from tpu_resiliency_torch.soak.workloads.lckpt import make_tree, same_bits  # noqa: E402
from tpu_resiliency_torch.store.client import store_from_env  # noqa: E402
from tpu_resiliency_torch.telemetry import get_registry  # noqa: E402
from tpu_resiliency_torch.telemetry.aggregate import (  # noqa: E402
    CrossRankAggregator,
    read_latest_snapshots,
)


def main() -> None:
    rank = int(os.environ["TPURX_RANK"])
    world = int(os.environ["TPURX_WORLD_SIZE"])
    cycle = int(os.environ["TPURX_CYCLE"])
    victim = int(os.environ.get("SOAK_EVAC_VICTIM", "1"))
    ramp_rounds = int(os.environ.get("SOAK_EVAC_RAMP_ROUNDS", "12"))
    deadline_step = int(os.environ.get("SOAK_EVAC_DEADLINE", "45"))
    root = os.environ["SOAK_CKPT_ROOT"]
    save_every = int(os.environ.get("SOAK_LCKPT_EVERY", "5"))
    total = int(os.environ.get("SOAK_STEPS", "200"))
    dev = worker_device()
    counts = LaunchCounts(dev, "evac")
    print(f"soakev[{rank}] device={dev}", flush=True)

    client = RankMonitorClient()
    client.init_workload_monitoring()
    store = store_from_env(timeout=15.0)
    ex = PeerExchange(store, rank, namespace=f"soakev-c{cycle}")
    repl = CliqueReplication(ex, world, replication_factor=min(2, world))
    mgr = LocalCheckpointManager(
        os.path.join(root, f"n{rank}"), rank, world, store=store,
        replication=repl, keep_last=8, peer_timeout=30.0,
        store_namespace=f"localckpt/c{cycle}",
    )
    agg = CrossRankAggregator(store, rank, world)
    reg = get_registry()

    pipe = EvacuationPipeline(store=store, rank=rank,
                              shrink_fn=lambda victim_rank: None)
    ctl = None
    step_box = {"step": 0}
    if rank == 0:
        # job-level controller over the tree-gathered snapshot feed; the
        # handler runs the real pipeline (checkpoint-ahead + record publish)
        # and announces a future JOIN step every rank will reach in lockstep
        def on_evacuate(victim_rank, reason):
            join_step = step_box["step"] + 10
            pipe.evacuate(victim_rank, reason=reason)
            store.set(f"soakev/c{cycle}/evacuate", json.dumps(
                {"victim": victim_rank, "join_step": join_step}))
            print(f"soakev[0] EVACUATE rank={victim_rank} "
                  f"at step={step_box['step']} join_step={join_step}",
                  flush=True)

        set_evacuation_handler(on_evacuate)
        ctl = PolicyController(
            feed=SnapshotFeed(lambda: read_latest_snapshots(store)),
            store=store)

    joined = False
    for step in range(total):
        client.send_heartbeat()
        counts.write()
        time.sleep(0.05)
        if step and step % save_every == 0 and not joined:
            mgr.save(make_tree(step, rank, dev), iteration=step, is_async=False)
        publish_ramp(reg, rank, world, step, victim, ramp_rounds, "soak_ramp")
        agg.round(reg, timeout=60.0)
        if ctl is not None:
            step_box["step"] = step
            ctl.tick()
        plan_raw = store.try_get(f"soakev/c{cycle}/evacuate")
        if plan_raw is not None and not joined:
            plan = json.loads(plan_raw.decode()
                              if isinstance(plan_raw, bytes) else plan_raw)
            if step >= int(plan["join_step"]):
                # the handoff: every rank joins the collective restore round;
                # the evacuated slot drops its resident copy first, so its
                # bytes must come CHUNK-GRANULAR off peer holders' memory —
                # never a disk rung, never a global restore
                it = mgr.find_latest()
                peer0 = source_bytes("peer_memory")
                disk0 = source_bytes("local_disk") + source_bytes("peer_disk")
                if rank == int(plan["victim"]):
                    mgr.drop_resident()
                    out = pipe.warm_join(mgr, make_tree(0, rank, dev), iteration=it)
                    peer_b = int(source_bytes("peer_memory") - peer0)
                    disk_b = int(source_bytes("local_disk")
                                 + source_bytes("peer_disk") - disk0)
                    assert int(out["tree"]["rank_marker"][0]) == rank
                    assert same_bits(out["tree"], make_tree(it, rank, dev)), \
                        "warm join not bit for bit"
                    print(f"soakev[{rank}] JOIN warm={out['warm']} "
                          f"iter={out['iteration']} peer_b={peer_b} "
                          f"disk_b={disk_b} "
                          f"dur_ms={out['dur_ms']:.1f}", flush=True)
                else:
                    mgr.load(make_tree(0, rank, dev), iteration=it)
                joined = True
                break  # every rank leaves at the SAME plan step
        if rank == victim and step >= deadline_step and not joined:
            print(f"soakev[{rank}] HARD FAULT at step {step}", flush=True)
            os._exit(41)
    # gang-synchronized exit (a lone early exit reads as a failure to the
    # launcher ring and would restart the gang)
    store.set(f"soakev/c{cycle}/done/r{rank}", "1")
    t_barrier = time.monotonic()
    while time.monotonic() - t_barrier < 120.0:
        client.send_heartbeat()
        if all(store.try_get(f"soakev/c{cycle}/done/r{r}") is not None
               for r in range(world)):
            break
        time.sleep(0.2)
    print(f"soakev[{rank}] result=done joined={joined}", flush=True)


if __name__ == "__main__":
    main()
