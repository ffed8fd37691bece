"""The port's multi-rank dryrun: the five stages of the north star's main path.

The port of ``__graft_entry__.py::dryrun_multichip`` and its three stage
helpers (``_dryrun_async_ckpt``, ``_dryrun_ici_replication``,
``_dryrun_straggler``), with the reference's tiny configuration and its
assertions, stage by stage.  Ranks are processes: :func:`dryrun_multichip`
runs the port's store server in a thread and spawns ``n`` ranks
(``python -m tpu_resiliency_torch.dryrun --rank <r> ...``), each of which
runs

1. the (dp, tp) sharded train step on a ``("data", "model")`` mesh, tp = 2
   when n is even; the loss must be finite;
2. ``quorum_reduce`` over ns stamps (``now_stamp_ns``): 0 <= age < 60 s;
3. the sharded async-checkpoint round trip of the stepped parameters
   (on the card with ``device_digest=True``: the fingerprint kernel runs),
   committed over the store: owned shard entries > 0 summed over the ranks,
   non-owned ones > 0 when dp > 1, and the restore bit for bit with the
   template's placements;
4. ``IciReplication`` of unequal blobs (``bytes([r]) * (17 + 13 * r)``),
   factor 2, jump 1: every rank gets its own blob and its left
   neighbour's;
5. the straggler report gathered over the store, which must name rank
   n - 1 worst.

Rank 0 prints the reference's summary line, with the same tokens; the
parent relays it.  Each rank also prints one JSON line with its counts and
the launches of the two kernels on the path (the quorum local max in stage
2, the chunk fingerprint in stage 3, one launch over the rank's owned
shards, with the shards it covered; all count only launches on the card).

The reference's dryrun imports ``now_stamp_ms``, which its package no longer
has, and hands ms stamps to a ``quorum_reduce`` that reads ns: it cannot
run.  This one uses ns stamps.  On the CPU the ranks run over gloo; on the
card a world of one runs over NCCL, and several ranks share the card over
gloo (NCCL refuses two ranks on one GPU).

    python -m tpu_resiliency_torch.dryrun --n 4 --device cpu
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional

import numpy as np

CFG = dict(vocab=512, d_model=128, n_heads=4, n_layers=2, d_ff=256, max_seq=64)
SEQ = 64
STRAGGLER_STEPS = 4
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mesh_shape(n: int):
    tp = 2 if n % 2 == 0 else 1
    return n // tp, tp


# -- stages (run in each rank) ----------------------------------------------


def _stage_async_ckpt(rank: int, params, root: str, store,
                      expect_non_owned: bool) -> Dict[str, Any]:
    """Stage 3: the sharded save and restore of the stepped parameters."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from .checkpointing.async_ckpt import device_digest as dd
    from .checkpointing.async_ckpt.checkpointer import (
        AsyncCheckpointer,
        load_checkpoint,
    )
    from .checkpointing.async_ckpt.staging import stage_pytree
    from .utils.tree import flatten_with_path

    staged = stage_pytree(params, process_index=rank)
    mine = [sum(1 for s in staged.shards if s.replica_owner),
            sum(1 for s in staged.shards if not s.replica_owner)]
    staged.close(unlink=True)
    leaf0 = next(leaf for _, leaf in flatten_with_path(params)[0])
    counts = torch.tensor(mine, dtype=torch.int64, device=leaf0.device)
    dist.all_reduce(counts)
    owned, non_owned = (int(v) for v in counts.cpu())
    assert owned > 0, "no owned shards staged"
    if expect_non_owned:
        # params replicated over the data axis must stage replica-owner
        # shards once and record the rest as metadata-only entries
        assert non_owned > 0, (
            "replicated params produced no non-owner shard entries "
            "(owner/non-owner split not exercised)"
        )

    ckpt_dir = os.path.join(root, "ckpt")
    dd.batch_fingerprints.launches = dd.batch_fingerprints.shards = 0
    # the fingerprint kernel runs on the card; the CPU's sync staging hands
    # the live (possibly strided) local shards to the stager, which the
    # fingerprint refuses
    ckpt = AsyncCheckpointer(store=store, persistent_worker=False,
                             device_digest=leaf0.is_cuda)
    try:
        ckpt.async_save(params, ckpt_dir, extra_metadata={"iteration": 0})
        ckpt.finalize_all(timeout=300.0)
    finally:
        ckpt.close()
    fp_launches = dd.batch_fingerprints.launches
    fp_shards = dd.batch_fingerprints.shards
    dist.barrier()  # rank 0 commits after every rank has written
    restored = load_checkpoint(ckpt_dir, template=params)
    for (path, a), (_, b) in zip(flatten_with_path(params)[0],
                                 flatten_with_path(restored)[0]):
        if isinstance(a, DTensor):
            assert isinstance(b, DTensor) and a.placements == b.placements \
                and a.device_mesh == b.device_mesh, f"sharding not restored at {path}"
            a, b = a.to_local(), b.to_local()
        assert a.dtype == b.dtype and torch.equal(a, b), (
            f"ckpt roundtrip mismatch at {path}")
    return {"owned": owned, "non_owned": non_owned,
            "owned_here": mine[0], "non_owned_here": mine[1],
            "fp_launches": fp_launches, "fp_shards": fp_shards,
            "token": f"ckpt_roundtrip_ok owned={owned} non_owned={non_owned}"}


def _stage_ici_replication(rank: int, n: int, store) -> str:
    """Stage 4: the ring-shift replication of unequal blobs."""
    from .checkpointing.local.ici_replication import IciReplication

    blobs = {r: bytes([r]) * (17 + 13 * r) for r in range(n)}  # unequal
    repl = IciReplication(None, store, rank=rank, world_size=n,
                          replication_factor=2, replication_jump=1)
    try:
        got = repl.replicate(blobs[rank], tag=0)
    finally:
        repl.close()
    src = (rank - 1) % n
    assert got[rank] == blobs[rank]
    assert got[src] == blobs[src], f"rank {rank} received wrong replica from {src}"
    return "ici_replication_ok"


def _stage_straggler(rank: int, n: int, store, device) -> Optional[str]:
    """Stage 5: every rank publishes its section stats; rank 0 assembles
    the report and must flag the slow rank."""
    from .straggler.detector import Detector

    slow_rank = n - 1
    det = Detector(store=store, rank=rank, world_size=n, gather_on_rank0=True,
                   device=device)
    try:
        base = 0.02 if rank == slow_rank else 0.004
        for _ in range(STRAGGLER_STEPS):
            with det.detection_section("step"):
                time.sleep(base)
        report = det.generate_report(timeout=120.0)
    finally:
        det.shutdown()
    if rank != 0:
        return None
    assert report is not None
    scores = report.relative_section_scores()
    assert len(scores) == n, scores
    worst = min(scores, key=scores.get)
    assert worst == slow_rank, f"expected rank {slow_rank} flagged, got {scores}"
    return "straggler_gather_ok"


def run_rank(rank: int, n: int, url: str, store_port: int, root: str,
             device: Optional[str]) -> Dict[str, Any]:
    """One rank of the dryrun: the five stages in order."""
    import torch
    import torch.distributed as dist

    from .models import transformer as tt
    from .ops import quorum as q
    from .parallel import init_distributed, make_mesh
    from .store import StoreClient

    dp, tp = _mesh_shape(n)
    on_card = device != "cpu"
    backend = "gloo" if (not on_card or n > 1) else "nccl"
    dev = init_distributed(init_method=url, world_size=n, rank=rank,
                           device=device, backend=backend)
    store = StoreClient("127.0.0.1", store_port, timeout=120.0)
    try:
        # 1. the (dp, tp) sharded train step
        mesh = make_mesh(("data", "model"), (dp, tp), device=dev)
        cfg = tt.TransformerConfig(**CFG)
        params = tt.init_params(cfg, torch.Generator(dev).manual_seed(0),
                                device=dev, mesh=mesh)
        opt = tt.init_opt_state(params)
        batch = tt.make_batch(cfg, 2 * dp, SEQ, device=dev, mesh=mesh)
        step = tt.make_train_step(cfg, mesh=mesh)
        params, opt, loss = step(params, opt, batch)
        loss_val = float(loss)
        assert np.isfinite(loss_val), f"non-finite loss {loss_val}"

        # 2. the quorum collective over ns stamps
        q.local_max.launches = 0
        age = q.quorum_reduce(mesh, np.full(1, q.now_stamp_ns(), dtype=np.int64),
                              device=dev)
        assert 0 <= age < 60_000_000_000, age
        qm_launches = q.local_max.launches

        # 3-5
        ckpt = _stage_async_ckpt(rank, tt.state_tree(params, opt)["params"],
                                 root, store, expect_non_owned=dp > 1)
        ici = _stage_ici_replication(rank, n, store)
        straggler = _stage_straggler(rank, n, store, dev)
        dist.barrier()
    finally:
        store.close()
    shape = collections.OrderedDict(zip(("data", "model"), (dp, tp)))
    out = {"rank": rank, "loss": loss_val, "age_ns": int(age),
           "backend": backend, "device": str(dev),
           "launches": {"quorum_local_max": qm_launches,
                        "chunk_fingerprint": ckpt["fp_launches"],
                        "chunk_fingerprint_shards": ckpt["fp_shards"]},
           "owned": ckpt["owned_here"], "non_owned": ckpt["non_owned_here"]}
    if rank == 0:
        stages = [ckpt["token"], ici, straggler]
        out["summary"] = (
            f"dryrun_multichip({n}): loss={loss_val:.4f} quorum_ok "
            f"mesh={shape!r} " + " ".join(stages)
        )
    dist.destroy_process_group()
    return out


# -- the parent ---------------------------------------------------------------


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dryrun_multichip(n: int, device: Optional[str] = None,
                     timeout_s: float = 600.0) -> Dict[str, Any]:
    """Run the five stages on ``n`` rank processes and print rank 0's
    summary line.  ``device=None`` runs on the card (and raises without
    one); ``"cpu"`` runs gloo ranks on the CPU.  Returns ``{"summary":
    line, "ranks": [each rank's JSON line]}``.  A rank that fails, or the
    ranks not finishing within ``timeout_s``, raises."""
    from .store import StoreServer
    from .utils.device import resolve_device

    dev = resolve_device(device)
    root = tempfile.mkdtemp(prefix="tpurx_dryrun_")
    server = StoreServer(host="127.0.0.1", port=0).start_in_thread()
    url = f"tcp://127.0.0.1:{_free_port()}"
    procs: List[subprocess.Popen] = []
    try:
        for r in range(n):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "tpu_resiliency_torch.dryrun",
                 "--rank", str(r), "--n", str(n), "--url", url,
                 "--store-port", str(server.port), "--root", root,
                 "--device", dev.type],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                cwd=REPO_ROOT,  # ``-m`` finds the package from here
            ))
        results = _wait_ranks(procs, timeout_s)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
        server.stop()
        shutil.rmtree(root, ignore_errors=True)
    summary = results[0]["summary"]
    print(summary, flush=True)
    return {"summary": summary, "ranks": results}


def _wait_ranks(procs: List[subprocess.Popen], timeout_s: float) -> List[Dict]:
    """Each rank's JSON line; the first rank to fail (or the deadline)
    raises with its standard error."""
    import threading

    outs: Dict[int, tuple] = {}

    def drain(r: int, p: subprocess.Popen) -> None:
        outs[r] = p.communicate()

    threads = [threading.Thread(target=drain, args=(r, p), daemon=True)
               for r, p in enumerate(procs)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + timeout_s
    while any(t.is_alive() for t in threads):
        failed = [r for r, p in enumerate(procs)
                  if p.poll() is not None and p.returncode != 0]
        if failed or time.monotonic() > deadline:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for t in threads:
                t.join(timeout=30)
            r = failed[0] if failed else 0
            what = (f"exited {procs[r].returncode}" if failed
                    else f"did not finish within {timeout_s} s")
            err = outs.get(r, ("", ""))[1]
            raise RuntimeError(f"dryrun rank {r} {what}:\n{err[-4000:]}")
        time.sleep(0.05)
    results = []
    for r, p in enumerate(procs):
        stdout, err = outs[r]
        if p.returncode != 0:
            raise RuntimeError(f"dryrun rank {r} exited {p.returncode}:\n{err[-4000:]}")
        results.append(json.loads(stdout.strip().splitlines()[-1]))
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, required=True, help="number of ranks")
    ap.add_argument("--device", choices=("cpu", "cuda"), default=None,
                    help="cpu, or cuda (the default: the card)")
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--url", help=argparse.SUPPRESS)
    ap.add_argument("--store-port", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--root", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is None:
        dryrun_multichip(args.n, device=args.device)
        return 0
    out = run_rank(args.rank, args.n, args.url, args.store_port, args.root,
                   args.device)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
