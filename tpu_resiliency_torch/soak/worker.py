"""What every soak workload shares: its device, its launch counts, the
one-shot claim of a scheduled fault, and metric reads.

- :func:`worker_device` is the device a worker runs on: ``SOAK_DEVICE=cuda``
  (the soak's default) is the card of this local rank (ranks share the one
  card of a one-card host), ``cpu`` the CPU.  A card that is not there
  raises; a worker never drifts to the CPU.
- :func:`world_of_one` is the worker's own process group: one rank over
  NCCL on the card (gloo on the CPU) with an in-memory rendezvous, apart
  from the job's store, so that two workers sharing a card never form one
  NCCL communicator.  It is the counterpart of the JAX soak's process-local
  mesh (``Mesh(np.array(jax.devices()))``): the quorum tripwire's lanes and
  ``device_max_reduce`` run over it.
- :class:`LaunchCounts` writes this process's kernel-1 launches, device
  and rank to ``$SOAK_COUNTS_DIR/<pid>.json`` at every call of
  :meth:`LaunchCounts.write`.  Workers die by ``os._exit``, SIGKILL and
  hard-timeout kills, so the workloads write at every step, not at exit;
  the soak sums the files into its report.
"""

from __future__ import annotations

import json
import os


def worker_device():
    """This worker's device from ``SOAK_DEVICE`` (``cuda`` or ``cpu``),
    touched once so the card's context exists before the first step."""
    import torch

    from ..utils.device import resolve_device

    name = os.environ.get("SOAK_DEVICE", "cuda")
    if name == "cpu":
        return resolve_device("cpu")
    if name != "cuda":
        raise ValueError(f"SOAK_DEVICE must be 'cuda' or 'cpu', not {name!r}")
    resolve_device(None)  # raises without a card
    local = int(os.environ.get("TPURX_LOCAL_RANK", "0"))
    dev = torch.device("cuda", local % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    torch.zeros(1, device=dev).add_(1)
    torch.cuda.synchronize(dev)
    return dev


def world_of_one(dev):
    """This process's own world of one on ``dev`` (idempotent; rebuilt after
    the abort ladder destroyed it)."""
    from ..parallel import init_distributed

    return init_distributed(world_size=1, rank=0, device=dev)


def quorum_mesh_factory(dev):
    """The ``Wrapper``'s ``quorum_mesh=``: a callable resolved at every
    start of the lanes, over this iteration's world of one."""
    from ..parallel import make_mesh

    def mesh():
        world_of_one(dev)
        return make_mesh(("d",), device=dev)

    return mesh


class LaunchCounts:
    """Kernel-1 launches of this process, written per step to a per-pid
    file under ``$SOAK_COUNTS_DIR`` (nothing is written when it is unset)."""

    def __init__(self, dev, script: str):
        self.dev = dev
        self.script = script
        d = os.environ.get("SOAK_COUNTS_DIR", "")
        self.path = os.path.join(d, f"{os.getpid()}.json") if d else ""
        self.write()

    def write(self) -> None:
        if not self.path:
            return
        from ..ops import quorum as q

        rec = {
            "pid": os.getpid(),
            "rank": int(os.environ.get("TPURX_RANK", "-1")),
            "cycle": int(os.environ.get("TPURX_CYCLE", "-1")),
            "script": self.script,
            "device": str(self.dev),
            "quorum_local_max": q.local_max.launches,
        }
        tmp = f"{self.path}.tmp"
        with open(tmp, "w") as f:
            json.dump(rec, f)
        os.replace(tmp, self.path)


def read_counts(counts_dir: str) -> list:
    """Every worker's last counts record under ``counts_dir``."""
    recs = []
    try:
        names = sorted(os.listdir(counts_dir))
    except OSError:
        return recs
    for fn in names:
        if not fn.endswith(".json"):
            continue
        try:
            with open(os.path.join(counts_dir, fn)) as f:
                recs.append(json.load(f))
        except (OSError, ValueError):
            continue
    return recs


def claim_fault(fired_dir: str, rank: int, step: int) -> bool:
    """One-shot gate: restarts rewind the loop over already-run steps, so
    each scheduled injection fires exactly once via an O_EXCL marker."""
    try:
        fd = os.open(os.path.join(fired_dir, f"r{rank}_s{step}"),
                     os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        os.close(fd)
        return True
    except OSError:
        return False


def metric_sum(name: str) -> float:
    """Sum of every labelled row of the metric ``name`` (0 when absent)."""
    from ..telemetry import get_registry

    m = get_registry().get(name)
    if m is None:
        return 0.0
    return sum(v.get("value", 0.0) for _l, v in m._sample_rows())


def source_bytes(src: str) -> float:
    """Bytes restored from rung ``src`` so far."""
    from ..telemetry import get_registry

    return get_registry().value_of(
        "tpurx_ckpt_restore_source_total", {"source": src})


def read_progress(path: str) -> int:
    """The progress file's iteration (0 when absent or empty)."""
    if os.path.exists(path):
        try:
            with open(path) as f:
                return int(f.read().strip() or 0)
        except ValueError:
            return 0
    return 0
