"""The chaos soak's local-checkpoint workload: the ``--corrupt-blob`` and
``--peer-mem-kill`` campaigns.

The port of ``benchmarks/soak_launcher.py``'s ``WORKLOAD_LCKPT``.  Every
rank runs a ``LocalCheckpointManager`` (sealed blobs, clique replication
over TCP) and saves every ``SOAK_LCKPT_EVERY`` steps.

- ``--corrupt-blob``: in cycle 0, at ``SOAK_CORRUPT_STEP``, rank 0
  corrupts every copy of the newest committed iteration
  (``corrupt_checkpoint``) and hard-exits; the restarted gang must
  ``load(fallback=True)`` its way down the ladder.
- ``--peer-mem-kill``: at ``SOAK_PEER_DRILL_STEP`` every non-serving rank
  drops its resident copy and reloads the newest iteration while the
  serving rank (``TPURX_FAULT=peer_mem_stall``) drops every peer-memory
  chunk request.

Where the JAX workload's trees are numpy arrays, these are torch tensors on
the worker's device (the card unless ``SOAK_DEVICE=cpu``), and every
restore is checked bit for bit against the tree of the iteration it names,
on that device.
"""

import glob
import os
import sys
import time

if __name__ == "__main__":
    sys.path[0] = os.environ["TPURX_REPO"]

import torch  # noqa: E402

from tpu_resiliency_torch.checkpointing.local.manager import LocalCheckpointManager  # noqa: E402
from tpu_resiliency_torch.checkpointing.local.replication import (  # noqa: E402
    CliqueReplication,
    PeerExchange,
)
from tpu_resiliency_torch.fault_tolerance import RankMonitorClient  # noqa: E402
from tpu_resiliency_torch.soak.worker import (  # noqa: E402
    LaunchCounts,
    metric_sum,
    source_bytes,
    worker_device,
)
from tpu_resiliency_torch.store.client import store_from_env  # noqa: E402
from tpu_resiliency_torch.telemetry import get_registry  # noqa: E402
from tpu_resiliency_torch.utils.inject_fault import Fault, corrupt_checkpoint  # noqa: E402


def make_tree(step: int, rank: int, dev) -> dict:
    """The saved state of ``step``: the JAX workload's tree as tensors."""
    return {"w": torch.full((4096,), float(step), dtype=torch.float32, device=dev),
            "step": torch.tensor(step, dtype=torch.int64, device=dev),
            "rank_marker": torch.tensor([rank], dtype=torch.int32, device=dev)}


def same_bits(got: dict, want: dict) -> bool:
    """Every leaf of ``got`` equals ``want``'s bit for bit, on its device."""
    def raw(t):
        return t.reshape(-1).view(torch.uint8)

    return all(
        got[k].device == want[k].device and got[k].dtype == want[k].dtype
        and got[k].shape == want[k].shape and torch.equal(raw(got[k]), raw(want[k]))
        for k in want)


def main() -> None:
    rank = int(os.environ["TPURX_RANK"])
    world = int(os.environ["TPURX_WORLD_SIZE"])
    cycle = int(os.environ["TPURX_CYCLE"])
    root = os.environ["SOAK_CKPT_ROOT"]
    save_every = int(os.environ.get("SOAK_LCKPT_EVERY", "10"))
    corrupt_step = int(os.environ.get("SOAK_CORRUPT_STEP", "35"))
    drill_step = int(os.environ.get("SOAK_PEER_DRILL_STEP", "0"))
    mode = os.environ.get("SOAK_CORRUPT_MODE", "bitflip")
    total = int(os.environ.get("SOAK_STEPS", "100000"))
    dev = worker_device()
    counts = LaunchCounts(dev, "lckpt")
    print(f"soaklc[{rank}] device={dev}", flush=True)

    client = RankMonitorClient()
    client.init_workload_monitoring()
    store = store_from_env(timeout=15.0)
    ex = PeerExchange(store, rank, namespace=f"soaklc-c{cycle}")
    repl = CliqueReplication(ex, world, replication_factor=min(2, world))
    mgr = LocalCheckpointManager(
        os.path.join(root, f"n{rank}"), rank, world, store=store,
        replication=repl, keep_last=8, peer_timeout=30.0,
        store_namespace=f"localckpt/c{cycle}",
    )

    start = 0
    if mgr.find_latest() is not None:
        tree, it = mgr.load(make_tree(0, rank, dev), fallback=True)
        depth = int(get_registry().get("tpurx_ckpt_fallback_depth").value)
        assert int(tree["step"]) == it, (int(tree["step"]), it)
        assert int(tree["rank_marker"][0]) == rank, "restored ANOTHER rank's data"
        assert same_bits(tree, make_tree(it, rank, dev)), "restore not bit for bit"
        debris = len(glob.glob(
            os.path.join(root, f"n{rank}", "**", "*.corrupt"), recursive=True))
        print(f"soaklc[{rank}] restored iter={it} depth={depth} "
              f"corrupt={int(metric_sum('tpurx_ckpt_corrupt_detected_total'))} "
              f"quarantined={int(metric_sum('tpurx_ckpt_quarantined_total'))} "
              f"debris={debris}",
              flush=True)
        start = it + 1
    else:
        print(f"soaklc[{rank}] fresh start (no checkpoint)", flush=True)

    for step in range(start, total):
        client.send_heartbeat()
        counts.write()
        time.sleep(0.05)
        if step and step % save_every == 0:
            mgr.save(make_tree(step, rank, dev), iteration=step, is_async=False)
            print(f"soaklc[{rank}] saved iter={step}", flush=True)
        if drill_step and step == drill_step and mgr.find_latest() is not None:
            # peer-memory stall drill: the serving peer (TPURX_FAULT_RANKS)
            # silently drops chunk requests, so every other rank — having
            # shed its own resident copy — must try the peer-memory rung,
            # time out, and fall through to its own disk blob WITHOUT burning
            # a fallback rung (depth stays 0: same iteration, colder source)
            it = mgr.find_latest()
            peer0, disk0 = source_bytes("peer_memory"), source_bytes("local_disk")
            if rank != 0:
                mgr.drop_resident()
            t0 = time.time()
            tree2, it2 = mgr.load(make_tree(0, rank, dev), iteration=it)
            depth = int(get_registry().get("tpurx_ckpt_fallback_depth").value)
            assert int(tree2["rank_marker"][0]) == rank, "restored ANOTHER rank's data"
            assert same_bits(tree2, make_tree(it2, rank, dev)), "restore not bit for bit"
            print(f"soaklc[{rank}] peer-drill it={it2} "
                  f"disk_b={int(source_bytes('local_disk') - disk0)} "
                  f"peer_b={int(source_bytes('peer_memory') - peer0)} "
                  f"depth={depth} s={time.time() - t0:.2f}", flush=True)
        if cycle == 0 and rank == 0 and step == corrupt_step:
            mutated = corrupt_checkpoint(root, Fault(mode))
            its = sorted({os.path.basename(os.path.dirname(p)) for p in mutated})
            print(f"soaklc[{rank}] corrupted newest mode={mode} "
                  f"files={len(mutated)} iters={','.join(its)}", flush=True)
            time.sleep(0.3)
            os._exit(41)
    print(f"soaklc[{rank}] result=done", flush=True)


if __name__ == "__main__":
    main()
