#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``tpu_resiliency_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (the run then exits non-zero):

1. setup — print the card's name and power limit, build every CUDA kernel
   from ``tpu_resiliency_torch/ops/csrc/`` (one ``nvcc`` per source, all
   started together) and print the build time and ``ptxas`` report;
2. kernel — hold both quorum local max entries against their plain
   PyTorch versions and numpy on the card, exactly: the pointer entry at
   sizes 1 .. 2^24 and start offsets 0-3, the by-value entry at n <= 32, on
   random, packed and all-negative ages.  Then time, in turns on the card,
   each entry beside an empty launch through the same binding (the launch
   floor), the plain version and ``torch.amax`` at n = 1, 2^20 and 2^24,
   and the lane's route from host ages to the send buffer at n_local = 1:
   the old pinned copy + kernel, the by-value launch, and pinned copy +
   ``torch.amax``;
3. digest — hold the checkpoint fingerprint kernel
   (``ops/csrc/chunk_fingerprint.cu``) against its plain PyTorch version
   and the numpy oracle, bit for bit, in every dtype the checkpoint
   fingerprints, at start offsets 0-3 on several chunk grids; then time it
   in turns with the plain version at the flagship's largest leaf (the f32
   ``embed``, 65,536,000 B) and at 1 GiB, beside the bytes bound;
4. check — the port's model on the card in f32 against the same model on
   the CPU, at a small size (loss before and after one step);
5. train — the main path: the flagship ``TransformerConfig()`` at full
   width (batch 8 x seq 1024, bf16 with an fp32 master) trained for 3 + 10
   steps in a world of one process over NCCL, each step wrapped by
   ``FusedStepQuorum(identify=True)`` while ``QuorumMonitor(identify=True)``
   ticks from its thread.  The kernel's launch counts are zeroed just
   before and read just after: every fused step and every tick must have
   launched it exactly once, all by value.  The loss must be finite and
   fall, with zero trips;
6. ckpt — the checkpoint path on the same full-width train state (141
   leaves, about 413 MB), both quorum lanes still on, through
   ``AsyncCheckpointer(delta=True, device_digest=True)``.  First one
   256 MiB copy into a registered shm segment must read as pinned and
   return to the host well before the transfer ends.  Then save A with
   three fused steps run while it drains; save A2 of the state those steps
   left (every leaf changed, so every byte transfers); save B with no step
   since A2 (every owned byte skipped); save C after one element of one
   leaf changed (exactly that shard transfers), with three more steps run
   while it drains, on the steady-state path.  Each save launches the
   fingerprint once per leaf, and each is restored onto the card and
   compared bit for bit with a device copy taken at its save.  The
   fingerprint's launch count is zeroed just before save A and read just
   after save C;
7. hang — freeze both heartbeats with a 50 ms budget: the monitor must trip
   naming device 0, and the fused lane must trip on the next step;
8. wrap — the in-process restart ring around the same full-width trainer.
   First an uninterrupted run of 24 steps from the seed-0 state gives the
   reference losses.  Then the port's store server starts on 127.0.0.1 and
   the trainer, rebuilt from the same seed, runs under the port's
   ``Wrapper``: ``initialize`` builds the NCCL world of one, the quorum
   tripwire runs both lanes over it (budget 500 ms), the async
   checkpointer saves the state every 4 steps (committed one step later),
   the health check is ``DeviceProbeHealthCheck`` and the abort ladder is
   ``default_ladder`` with ``AbortCheckpointWorkers`` and
   ``AbortQuorumMonitor`` (then ``AbortTorchDistributed`` and
   ``ClearCudaCaches``).  Three faults, one per iteration: an exception at
   step 6; at step 11 a stall of the main thread in 4 s sleeps with no
   pings, which the monitor process's 3 s soft timeout catches; at step 17
   a frozen quorum heartbeat (beater stopped, no pings, the main thread
   still running bytecode so the soft timeout cannot fire), which the tick
   lane catches.  Each next iteration rebuilds its groups, restores the
   last committed save onto the card (compared bit for bit with a device
   copy taken at the save) and trains on; the last one runs to step 24.
   Every loss of the wrapped run, replayed steps included, must equal the
   reference's bit for bit (deterministic algorithms on).  Printed per
   fault: detection time, the ladder's time per stage, the health probe's
   time, restore time, restart latency (fault to the first finished step
   of the next iteration), steps lost; and the launches of kernels 1 and 2
   in the wrapped run;
9. mesh — the dp x tp sharded step (``mesh=``) and its sharded save.
   (a) A world of one over NCCL on a ``("data", "model")`` mesh of (1, 1):
   the unsharded route and the mesh route each train 3 + 10 steps from the
   seed-0 state with deterministic algorithms on, the mesh route under
   ``FusedStepQuorum(identify=True)``; the losses must be equal bit for bit
   and the local max must launch once per fused step.  Then one save of the
   mesh route's state (``DTensor`` leaves) with ``delta=True,
   device_digest=True``, the fingerprint launched once per owned shard and
   the restore compared bit for bit with a device copy taken at the save;
   then both routes' step times, in turns.  (b) Four processes share the
   card over gloo on a (2, 2) mesh: each is exec'd as ``python3
   chip_smoke.py --mesh-child <rank> <world> <url>`` (the kernels were built
   above), trains 3 steps from the same seed-0 weights (its box of each)
   and saves once, committed across the four over the port's store server
   run here.  Their losses must be finite, fall, and agree with (a)'s first
   three within 2e-2; the owned shard entries must be the JAX rule's (the
   "data" = 0 ranks own every box of their "model" index, rank 0 the
   replicated leaves, ranks 2 and 3 nothing), each rank must launch the
   fingerprint once per owned shard, and every rank must restore its boxes
   bit for bit.  A child that fails, or does not finish in 300 s, fails the
   phase.  The gloo times are host-staged collectives on one card, not a
   tensor-parallel speed;
10. wedge — a child process (``python3 chip_smoke.py --wedge-child``, exec'd,
   not forked) trains a small model under the port's ``Wrapper`` with the
   monitor process on (soft timeout 3 s, hard 6 s), then fires
   ``Fault.DEVICE_HANG``: the spin kernel (``ops/csrc/device_spin.cu``)
   runs on its own stream and the main thread blocks on it in C.  The
   child's exit must be SIGKILL, its log must say ``killing`` and
   ``abort ladder: fingerprint=released``, and the store's interruption
   records must name the soft timeout.  Then kernels 1 and 2 are launched
   again and held against their plain versions, to show the card still
   serves.  Printed: spin launch to soft timeout, and to the kill.

Informational lines come first; the line before the last holds the card's
name and power limit, and the last line is one JSON object
``{"ok": true, "device": {"platform": "gpu", ...}}``.  Without a CUDA card,
or without the rest of the repository beside it, the script exits non-zero
and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bandwidth, and the
# non-tensor-core f32 rate, used for the int32 compares of the local max
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12

KERNEL_SIZES = (1, 8, 31, 32, 33, 1000, 1024, 1025, 65536, 1 << 20,
                (1 << 20) + 3, 1 << 24)
TRAIN_BATCH, TRAIN_SEQ = 8, 1024
WARMUP_STEPS, TIMED_STEPS = 3, 10
HANG_BUDGET_MS = 50.0
DIGEST_DTYPES = ("float32", "bfloat16", "float16", "float64", "int8", "uint8",
                 "int32", "int64", "bool")
# (elements, chunk grids): the plain version loops over chunks in Python,
# so the finest grid is kept to the smaller sizes
DIGEST_CASES = (
    (1, ((1024, False), (4096, True), (16 << 20, True))),
    (1000, ((1024, False), (4096, True), (16 << 20, True))),
    (4097, ((1024, False), (4096, True), (16 << 20, True))),
    ((1 << 20) + 3, ((65536, True), (16 << 20, True))),
    ((1 << 23) + 1, ((1 << 20, False), (16 << 20, True))),
)
EMBED_F32_ELEMS = 32000 * 512  # the flagship's largest leaf: f32 embed
DRAIN_STEPS = 3
SAVES = ("A", "A2", "B", "C")
# saves with fused steps run while they drain: A on fresh shm, C in the
# steady state (no save follows C, so its steps change nothing checked)
DRAIN_STEP_SAVES = ("A", "C")
# wrap phase: the fault schedule, iteration -> (kind, step it fires before)
WRAP_STEPS = 24
WRAP_SAVE_EVERY = 4
WRAP_FAULTS = {0: ("exception", 6), 1: ("stall", 11), 2: ("quorum_freeze", 17)}
WRAP_SOFT_TIMEOUT_S = 3.0
WRAP_STALL_SLEEP_S = 4.0      # one C-level sleep of the stall: > soft timeout
WRAP_QUORUM_BUDGET_MS = 500.0
# mesh phase: (b)'s mesh of four gloo processes on the one card, the steps
# each trains, and how far its losses may sit from (a)'s first ones.  (b)
# splits each bf16 matmul of the step over two "model" ranks and sums the
# halves after each is rounded to bf16 (one more rounding, 2^-9 relative,
# per summed activation), and averages the loss over two "data" ranks; the
# loss of the random-init flagship is about 10.4, so these move it in its
# third or fourth digit, and 2e-2 (0.2% of it) bounds that with room
MESH_SHAPE = (2, 2)
MESH_STEPS = 3
MESH_LOSS_TOL = 2e-2
MESH_CHILD_TIMEOUT_S = 300.0
MESH_TIME_ROUNDS, MESH_TIME_STEPS = 6, 5
# wedge phase: the child's monitor-process timeouts
WEDGE_SOFT_TIMEOUT_S = 3.0
WEDGE_HARD_TIMEOUT_S = 6.0


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, torch) -> float:
    """Mean ms per call of ``fn`` on the card, by CUDA events around
    ``iters`` calls after a warm-up."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_in_turns(fns: dict, iters: int, rounds: int, torch) -> dict:
    """Median ms per call of each of ``fns``, timed in turns on one card:
    forward then backward order (kernel, amax, amax, kernel), ``rounds``
    times."""
    names = list(fns)
    samples = {name: [] for name in names}
    for r in range(rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            samples[name].append(time_ms(fns[name], iters, torch))
    return {name: sorted(v)[len(v) // 2] for name, v in samples.items()}


def local_max_bound_ms(n: int) -> tuple:
    """Least time for the local max of n int32: read 4n bytes, write 4, and
    n - 1 compares."""
    by_bytes = (4 * n + 4) / HBM_BYTES_PER_S * 1e3
    by_ops = max(n - 1, 0) / SCALAR_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def train_step_flops(cfg, batch: int, seq: int) -> int:
    """Matmul FLOPs of one train step from the shapes: forward per token
    2(4d^2 + 2df) + 4Td per layer (projections, MLP, QK^T and PV over the
    full T x T) and 2dV for the tied logits; backward twice the forward."""
    d, f, T = cfg.d_model, cfg.d_ff, seq
    per_token = cfg.n_layers * (8 * d * d + 4 * d * f + 4 * T * d) + 2 * d * cfg.vocab
    return 3 * batch * seq * per_token


def _ages(np, rng, kind: str, n: int, q):
    if kind == "random":
        return rng.integers(0, 2 ** 31 - 1, size=n, dtype=np.int64).astype(np.int32)
    if kind == "packed":
        return q.pack_age_device(rng.integers(0, 2 ** 17, size=n),
                                 rng.integers(0, 1 << 16, size=n))
    return rng.integers(-2 ** 31, 0, size=n, dtype=np.int64).astype(np.int32)


def _at_offset(torch, values, offset: int, dev):
    """``values`` on the card as a contiguous view ``offset`` int32 elements
    past a 16-byte boundary."""
    base = torch.empty(values.size + 8, dtype=torch.int32, device=dev)
    lead = (-(base.data_ptr() >> 2)) % 4
    x = base[lead + offset:lead + offset + values.size]
    x.copy_(torch.from_numpy(values))
    return x


def kernel_phase(torch, np, q) -> dict:
    """Both entries against their plain versions at every size and offset;
    times in turns at n = 1 (the path's shape), 2^20 and 2^24, and the
    lane's route at n_local = 1."""
    dev = torch.device("cuda", torch.cuda.current_device())
    index = dev.index
    rng = np.random.default_rng(0)
    worst = 0
    out = torch.empty(1, dtype=torch.int32, device=dev)
    for n in KERNEL_SIZES:
        for kind in ("random", "packed", "negative"):
            values = _ages(np, rng, kind, n, q)
            want_np = int(values.max())
            checks = []
            for offset in range(4):
                x = _at_offset(torch, values, offset, dev)
                checks.append((f"pointer entry, offset {offset}",
                               q.local_max(x), q.local_max_reference(x)))
            if n <= q.BY_VALUE_MAX:
                checks.append(("by-value entry",
                               q.local_max_host(values, torch.empty_like(out)),
                               q.local_max_host_reference(values)))
            torch.cuda.synchronize()
            for what, got, want in checks:
                err = abs(int(got[0]) - int(want[0]))
                if err != 0 or int(got[0]) != want_np:
                    raise AssertionError(
                        f"local max {what} disagrees at n={n} ({kind}): kernel "
                        f"{int(got[0])}, plain {int(want[0])}, numpy {want_np}"
                    )
                worst = max(worst, err)
    print(f"kernel phase: quorum local max equals the plain version and numpy "
          f"at n in {list(KERNEL_SIZES)}: pointer entry at offsets 0-3, "
          f"by-value entry at n <= {q.BY_VALUE_MAX} (random, packed and "
          f"all-negative ages)")

    empty = q._kernel("tpurx_empty_launch")

    def floor():
        if empty(index, q._raw_stream(index)) != 0:
            raise RuntimeError("empty launch failed")

    timings = {}
    for n, iters in ((1, 2000), (1 << 20, 200), (1 << 24, 50)):
        values = rng.integers(0, 2 ** 31 - 1, size=n, dtype=np.int64).astype(np.int32)
        x = torch.from_numpy(values).to(dev)
        fns = {"ms": lambda: q.local_max(x, out),
               "library_ms": lambda: torch.amax(x),
               "plain_ms": lambda: q.local_max_reference(x)}
        if n == 1:
            fns["by_value_ms"] = lambda: q.local_max_host(values, out)
            fns["launch_floor_ms"] = floor
        rec = time_in_turns(fns, iters, 4, torch)
        rec["bound_ms"], rec["bound_by"] = local_max_bound_ms(n)
        rec["bound_share"] = rec["bound_ms"] / rec["ms"]
        timings[n] = rec
        extra = (f", by value {rec['by_value_ms'] * 1e3:.2f} us, empty launch "
                 f"{rec['launch_floor_ms'] * 1e3:.2f} us" if n == 1 else "")
        print(f"kernel phase: n={n}: kernel {rec['ms'] * 1e3:.2f} us, "
              f"plain {rec['plain_ms'] * 1e3:.2f} us, torch.amax "
              f"{rec['library_ms'] * 1e3:.2f} us{extra}, bound "
              f"{rec['bound_ms'] * 1e3:.6f} us ({rec['bound_by']}, "
              f"{100 * rec['bound_share']:.1f}% of it)")

    ages = q.pack_age_device(np.array([1234]), np.array([0]))
    host = torch.from_numpy(ages)
    lane = time_in_turns({
        "old_ms": lambda: q.local_max(
            host.pin_memory().to(dev, non_blocking=True), out),
        "new_ms": lambda: q.local_max_host(ages, out),
        "library_ms": lambda: torch.amax(
            host.pin_memory().to(dev, non_blocking=True)),
    }, 1000, 4, torch)
    print(f"kernel phase: lane route at n_local=1 (host ages to send buffer): "
          f"pinned copy + kernel {lane['old_ms'] * 1e3:.2f} us, by value "
          f"{lane['new_ms'] * 1e3:.2f} us, pinned copy + torch.amax "
          f"{lane['library_ms'] * 1e3:.2f} us")
    t1, t24 = timings[1], timings[1 << 24]
    for claim, met in (
        ("n=1 tensor entry no slower than torch.amax", t1["ms"] <= t1["library_ms"]),
        ("by-value lane route no slower than pinned copy + kernel",
         lane["new_ms"] <= lane["old_ms"]),
        ("n=2^24 at least 50% of the bytes bound", t24["bound_share"] >= 0.5),
        ("n=2^24 no slower than torch.amax", t24["ms"] <= t24["library_ms"]),
        ("n=2^20 no slower than torch.amax",
         timings[1 << 20]["ms"] <= timings[1 << 20]["library_ms"]),
    ):
        print(f"kernel phase: {claim}: {'met' if met else 'NOT met'}")
    return {"max_abs_err": worst, "timings": timings, "lane": lane}


def fingerprint_bound_ms(nbytes: int, lane_bytes: int, n_chunks: int) -> tuple:
    """Least time for the fingerprint of ``nbytes``: read them once and
    write 8 bytes per chunk, or 14 integer operations per lane (mix 11,
    two adds, one multiply) at the scalar rate, whichever is larger."""
    by_bytes = (nbytes + 8 * n_chunks) / HBM_BYTES_PER_S * 1e3
    by_ops = 14 * (nbytes // lane_bytes) / SCALAR_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def digest_phase(torch, np, dd, dev) -> dict:
    """The fingerprint kernel against its plain version and the numpy
    oracle, bit for bit; times in turns at the embed leaf and at 1 GiB."""
    rng = np.random.default_rng(0)
    widths = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}
    checked = mismatched = worst = 0
    for name in DIGEST_DTYPES:
        for n, grids in DIGEST_CASES:
            host = (rng.standard_normal(n + 4) * 100).astype(np.float32)
            base = torch.from_numpy(host).to(getattr(torch, name)).to(dev)
            for offset in range(4):
                x = base[offset:offset + n]
                raw = x.cpu().reshape(-1).view(torch.uint8).numpy().tobytes()
                for chunk_bytes, direct in grids:
                    got = dd.shard_fingerprints(x, chunk_bytes, direct)
                    want = dd.fingerprint_reference(x, chunk_bytes, direct)
                    oracle = dd.host_fingerprints(
                        raw, widths[x.element_size()], chunk_bytes, direct)
                    g = got.cpu().numpy().view(np.uint32).astype(np.int64)
                    for ref in (want.cpu().numpy().view(np.uint32), oracle):
                        if g.size:
                            worst = max(worst, int(np.abs(g - ref).max()))
                    if not (np.array_equal(g, want.cpu().numpy().view(np.uint32))
                            and np.array_equal(g, oracle)):
                        mismatched += 1
                        print(f"digest phase: MISMATCH {name} n={n} offset={offset} "
                              f"grid=({chunk_bytes}, {direct})")
                    checked += 1
    if mismatched:
        raise AssertionError(f"fingerprint kernel disagrees in {mismatched} of "
                             f"{checked} cases")
    print(f"digest phase: chunk fingerprint equals the plain version and numpy "
          f"bit for bit in {checked} cases: {list(DIGEST_DTYPES)}, "
          f"n in {[n for n, _ in DIGEST_CASES]}, offsets 0-3, chunk grids "
          f"1 KiB to 16 MiB, direct and buffered")

    timings = {}
    chunk_bytes = dd.default_chunk_bytes()
    for label, n, iters, plain_iters in (("embed", EMBED_F32_ELEMS, 100, 5),
                                         ("1GiB", 1 << 28, 20, 2)):
        x = torch.randn(n, device=dev)
        nbytes = n * 4
        n_chunks = dd.fingerprint_plan(nbytes, 4, chunk_bytes, True)[4]
        rec = time_in_turns({"ms": lambda: dd.shard_fingerprints(x)},
                            iters, 4, torch)
        rec.update(time_in_turns(
            {"plain_ms": lambda: dd.fingerprint_reference(x, chunk_bytes, True)},
            plain_iters, 2, torch))
        rec["bound_ms"], rec["bound_by"] = fingerprint_bound_ms(nbytes, 4, n_chunks)
        rec["bound_share"] = rec["bound_ms"] / rec["ms"]
        rec["nbytes"] = nbytes
        timings[label] = rec
        print(f"digest phase: {label} ({nbytes} B f32, {n_chunks} chunks): kernel "
              f"{rec['ms'] * 1e3:.2f} us, plain {rec['plain_ms'] * 1e3:.2f} us, "
              f"bound {rec['bound_ms'] * 1e3:.2f} us ({rec['bound_by']}, "
              f"{100 * rec['bound_share']:.1f}% of it); no single PyTorch call "
              f"computes it")
        del x
    return {"checked": checked, "timings": timings, "max_abs_err": worst}


def _same_bytes(torch, a, b) -> bool:
    return torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def pinned_copy_check(torch, staging, nbytes: int) -> dict:
    """One device-to-host copy of ``nbytes`` into a registered shm segment,
    as staging makes it: the segment must read as pinned, and the copy's
    enqueue must return well before the transfer ends (a copy into
    pageable memory would block for all of it).  Returns the times and
    the rate."""
    from tpu_resiliency_torch.utils.shm import create_shm, unlink_shm

    dev = torch.device("cuda", torch.cuda.current_device())
    src = torch.randint(0, 256, (nbytes,), dtype=torch.uint8, device=dev)
    shm = create_shm(nbytes)
    addr = staging.pin_shm(shm)
    try:
        dst = torch.frombuffer(shm.buf, dtype=torch.uint8, count=nbytes)
        pinned = dst.is_pinned()
        runs = []
        for _ in range(5):
            torch.cuda.synchronize()
            with torch.cuda.stream(staging.copy_stream(dev)):
                t0 = time.perf_counter()
                (ev,) = staging.async_d2h([(dst, src)])
                t1 = time.perf_counter()
                ev.synchronize()
                t2 = time.perf_counter()
            runs.append((t1 - t0, t2 - t0))
        same = torch.equal(dst, src.cpu())
        del dst
    finally:
        staging.unpin(addr)
        shm.close()
        unlink_shm(shm)
    enqueue_s, total_s = sorted(runs, key=lambda r: r[1])[len(runs) // 2]
    rec = {"nbytes": nbytes, "pinned": pinned, "enqueue_ms": enqueue_s * 1e3,
           "total_ms": total_s * 1e3, "gb_per_s": nbytes / total_s / 1e9}
    print(f"ckpt phase: {nbytes} B device-to-host into registered shm: pinned "
          f"{pinned}, enqueue {rec['enqueue_ms']:.3f} ms, done after "
          f"{rec['total_ms']:.3f} ms, {rec['gb_per_s']:.2f} GB/s (median of 5)")
    if not (pinned and same and enqueue_s < 0.5 * total_s):
        raise AssertionError(f"the copy into registered shm is not asynchronous "
                             f"or not right: {rec}, equal {same}")
    return rec


def ckpt_phase(torch, tr, dd, ckpt_mod, tree_mod, params, opt, step, fq, batch,
               train_step_ms: float) -> dict:
    """Four saves of the full-width train state through the async
    checkpointer, each restored onto the card and compared bit for bit."""
    leaves = tree_mod.leaves
    root = tempfile.mkdtemp(prefix="tpurx_ckpt_")
    ck = ckpt_mod.AsyncCheckpointer(delta=True, digest=True, device_digest=True)
    tree = tr.state_tree(params, opt)
    total = sum(t.numel() * t.element_size() for t in leaves(tree))
    n_leaves = len(leaves(tree))
    print(f"ckpt phase: train state {n_leaves} leaves, {total} B, "
          f"{sum(t.is_cuda for t in leaves(tree))} on the card")
    from tpu_resiliency_torch.checkpointing.async_ckpt import staging

    pinned = pinned_copy_check(torch, staging, 1 << 28)
    saves = {}
    copies = {}
    try:
        dd.shard_fingerprints.launches = 0
        for g in SAVES:
            if g == "C":
                with torch.no_grad():
                    params.embed[0, 0] += 1.0
            tree = tr.state_tree(params, opt)
            copies[g] = [t.clone() for t in leaves(tree)]
            torch.cuda.synchronize()
            launches0 = dd.shard_fingerprints.launches
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            ck.async_save(tree, os.path.join(root, g), {"iteration": g})
            call_s = time.perf_counter() - t0
            end.record()
            rec = {"call_ms": call_s * 1e3}
            if g in DRAIN_STEP_SAVES:
                step_s = []
                for _ in range(DRAIN_STEPS):
                    t1 = time.perf_counter()
                    fq.beat()
                    params, opt, _loss = step(params, opt, batch)
                    torch.cuda.synchronize()
                    step_s.append(time.perf_counter() - t1)
                written, owed = ck.drain_progress()
                rec["steps_during_drain_ms"] = [v * 1e3 for v in step_s]
                rec["drain_progress_after_steps"] = [written, owed]
            t1 = time.perf_counter()
            ck.finalize_all()
            rec["finalize_wait_ms"] = (time.perf_counter() - t1) * 1e3
            end.synchronize()
            rec["snapshot_span_ms"] = start.elapsed_time(end)
            rec["launches"] = dd.shard_fingerprints.launches - launches0
            rec.update(ck.last_stage_stats)
            drain = ck.last_drain_stats
            rec["drain_ms"] = drain.get("drain_ns", 0) / 1e6
            rec["bytes_written"] = drain.get("bytes_written")
            rec["drain_d2h_skipped_bytes"] = drain.get("d2h_skipped_bytes")
            saves[g] = rec
            print(f"ckpt phase: save {g}: async_save {rec['call_ms']:.2f} ms of "
                  f"host time, snapshot span {rec['snapshot_span_ms']:.3f} ms on "
                  f"the stream, fingerprints {rec['launches']} launches in "
                  f"{rec['device_digest_launch_s'] * 1e3:.2f} ms + readback: "
                  f"{rec['device_digest_s'] * 1e3:.2f} ms, D2H {rec['d2h_bytes']} B "
                  f"in {rec['d2h_shards']} shards (enqueue "
                  f"{rec['d2h_enqueue_s'] * 1e3:.3f} ms), skipped "
                  f"{rec['d2h_skipped_bytes']} B, staging {rec['stage_s'] * 1e3:.2f} "
                  f"ms ({rec['segment_s'] * 1e3:.2f} ms creating and registering "
                  f"shm), drain {rec['drain_ms']:.1f} ms, {rec['bytes_written']} B "
                  f"written, finalize wait {rec['finalize_wait_ms']:.1f} ms")
            if g in DRAIN_STEP_SAVES:
                print(f"ckpt phase: steps while save {g} drained: "
                      f"{[round(v, 2) for v in rec['steps_during_drain_ms']]} ms "
                      f"(train phase mean {train_step_ms:.2f} ms); drain progress "
                      f"after them {rec['drain_progress_after_steps']}")
        dd_launches = dd.shard_fingerprints.launches
        a, a2, b, c = (saves[g] for g in SAVES)
        embed_bytes = params.embed.numel() * params.embed.element_size()
        for claim, met in (
            ("A transfers every byte", a["d2h_bytes"] == total
             and a["d2h_skipped_bytes"] == 0),
            ("A2, after three steps, transfers every byte",
             a2["d2h_bytes"] == total and a2["d2h_skipped_bytes"] == 0),
            ("B skips every owned byte", b["d2h_skipped_bytes"] == total
             and b["d2h_bytes"] == 0 and b["bytes_written"] == 0),
            ("C transfers exactly the changed shard", c["d2h_shards"] == 1
             and c["d2h_bytes"] == embed_bytes
             and c["d2h_skipped_bytes"] == total - embed_bytes),
            ("one fingerprint launch per device leaf per save",
             all(saves[g]["launches"] == n_leaves for g in saves)
             and dd_launches == len(SAVES) * n_leaves),
        ):
            print(f"ckpt phase: {claim}: {'met' if met else 'NOT met'}")
            if not met:
                raise AssertionError(f"ckpt phase: {claim} failed: {saves}")
    finally:
        ck.close()
    # every save restored onto the card from its files (no resident copy)
    restore = {}
    for g in SAVES:
        t0 = time.perf_counter()
        out = ckpt_mod.load_checkpoint(os.path.join(root, g),
                                       tr.state_tree(params, opt), resident=False)
        torch.cuda.synchronize()
        restore[g] = (time.perf_counter() - t0) * 1e3
        got = leaves(out)
        if len(got) != n_leaves or not all(
                x.device == y.device and x.dtype == y.dtype
                and _same_bytes(torch, x, y) for x, y in zip(got, copies[g])):
            raise AssertionError(f"ckpt phase: save {g} does not restore bit for bit")
    print(f"ckpt phase: saves {', '.join(SAVES)} restored onto the card bit for "
          f"bit in {' / '.join(f'{restore[g]:.0f}' for g in SAVES)} ms")
    shutil.rmtree(root, ignore_errors=True)
    return {"saves": saves, "launches": dd_launches, "restore_ms": restore,
            "total_bytes": total, "n_leaves": n_leaves, "pinned_copy": pinned}


def _shm_segments() -> set:
    try:
        return set(os.listdir("/dev/shm"))
    except OSError:
        return set()


def wrap_phase(torch, cfg, batch_size: int, seq: int, device=None) -> dict:
    """The in-process restart ring around the trainer (phase 8).  On the
    card with ``device=None``; ``device="cpu"`` rehearses it on the CPU at a
    small ``cfg`` (kernels then take their plain versions)."""
    from tpu_resiliency_torch.checkpointing.async_ckpt import checkpointer as ckpt_mod
    from tpu_resiliency_torch.checkpointing.async_ckpt import device_digest as dd
    from tpu_resiliency_torch.checkpointing.async_ckpt import resident
    from tpu_resiliency_torch.inprocess import (
        AbortCheckpointWorkers,
        AbortQuorumMonitor,
        DeviceProbeHealthCheck,
        Wrapper,
        default_ladder,
    )
    from tpu_resiliency_torch.models import transformer as tr
    from tpu_resiliency_torch.ops import quorum as q
    from tpu_resiliency_torch.parallel import init_distributed, make_mesh
    from tpu_resiliency_torch.store import StoreFactory, StoreServer
    from tpu_resiliency_torch.utils.tree import leaves

    on_card = device is None
    dev = (torch.device("cuda", torch.cuda.current_device()) if on_card
           else torch.device("cpu"))

    def sync():
        if on_card:
            torch.cuda.synchronize()

    # bit-for-bit losses across a restore need deterministic kernels (the
    # embedding's backward accumulates); cuBLAS asks for a fixed workspace
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True, warn_only=True)
    batch = tr.make_batch(cfg, batch_size, seq, seed=0, device=device)
    plain_step = tr.make_train_step(cfg, lr=1e-3)

    def fresh_state():
        params = tr.init_params(cfg, torch.Generator(dev).manual_seed(0),
                                device=device)
        return {"params": params, "opt": tr.init_opt_state(params)}

    st = fresh_state()
    reference = []
    for _ in range(WRAP_STEPS):
        st["params"], st["opt"], loss = plain_step(st["params"], st["opt"], batch)
        reference.append(float(loss))
    print(f"wrap phase: reference run, {WRAP_STEPS} steps uninterrupted: losses "
          f"{[round(v, 4) for v in reference]}")

    shm_before = _shm_segments()
    root = tempfile.mkdtemp(prefix="tpurx_wrap_")
    server = StoreServer(host="127.0.0.1", port=0).start_in_thread()
    ck = ckpt_mod.AsyncCheckpointer(delta=True, digest=True, device_digest=True)
    probe = DeviceProbeHealthCheck(device=device)
    st = fresh_state()
    run = {"s": 0, "saved": {}, "committed": [], "faults": [], "losses": [],
           "init_ms": [], "records": {}}

    def initialize(state):
        t0 = time.perf_counter()
        init_distributed(device=device)
        run["init_ms"].append((time.perf_counter() - t0) * 1e3)

    def save_dir(s):
        return os.path.join(root, f"step{s:04d}")

    def restore(cw):
        it = cw.iteration
        fault = run["faults"][-1]
        fault["trip_ms"] = (cw.trip_ns[it - 1] - fault["t_ns"]) / 1e6
        fault["records"] = [(r.rank, r.interruption.value)
                            for r in cw.ops.get_interruptions(it - 1)]
        fault["ladder_ms"] = {r.stage: round(r.duration_ms, 3)
                              for r in cw.last_ladder_results}
        fault["ladder_outcomes"] = {r.stage: r.outcome
                                    for r in cw.last_ladder_results}
        fault["probe_ms"] = probe.last_probe_s * 1e3
        fault["init_ms"] = run["init_ms"][-1]
        if cw.quorum.trip_time is not None and fault["kind"] == "quorum_freeze":
            fault["lane_trip_ms"] = (cw.quorum.trip_time * 1e9 - fault["t_ns"]) / 1e6
        s = max(run["committed"])
        t0 = time.perf_counter()
        out = ckpt_mod.load_checkpoint(
            save_dir(s), tr.state_tree(st["params"], st["opt"]), resident=False)
        sync()
        fault["restore_ms"] = (time.perf_counter() - t0) * 1e3
        got, want = leaves(out), run["saved"][s]
        if len(got) != len(want) or not all(
                x.device == y.device and x.dtype == y.dtype
                and _same_bytes(torch, x, y) for x, y in zip(got, want)):
            raise AssertionError(f"wrap phase: save {s} does not restore bit for bit")
        tr.load_state_tree(st["params"], st["opt"], out)
        fault["restored_from"] = s
        fault["steps_lost"] = fault["step"] - s
        run["s"] = s

    def train(call_wrapper=None):
        cw = call_wrapper
        it = cw.iteration
        if it > 0:
            restore(cw)
        step = cw.quorum.fuse(plain_step)
        fault = WRAP_FAULTS.get(it)
        first = it > 0
        while run["s"] < WRAP_STEPS:
            s = run["s"]
            if s % WRAP_SAVE_EVERY == 0 and s not in run["saved"]:
                tree = tr.state_tree(st["params"], st["opt"])
                run["saved"][s] = [t.clone() for t in leaves(tree)]
                ck.async_save(tree, save_dir(s), {"step": s})
            cw.ping()
            if fault is not None and s == fault[1]:
                kind = fault[0]
                run["faults"].append({
                    "iteration": it, "kind": kind, "step": s,
                    "t_ns": time.monotonic_ns(),
                    # kernel launches of the wrapped run up to this fault
                    "launches": {"quorum_local_max": q.local_max.launches,
                                 "chunk_fingerprint": dd.shard_fingerprints.launches}})
                print(f"wrap phase: iteration {it}: {kind} at step {s}", flush=True)
                if kind == "exception":
                    raise RuntimeError(f"injected exception at step {s}")
                if kind == "stall":
                    while True:       # no pings; C-level sleeps past the soft timeout
                        time.sleep(WRAP_STALL_SLEEP_S)
                cw.quorum.monitor.stop_auto_beat()
                while True:           # no pings, no beats; bytecode keeps running
                    time.sleep(0.05)
            st["params"], st["opt"], loss = step(st["params"], st["opt"], batch)
            loss = float(loss)
            run["losses"].append((it, s, loss))
            run["s"] = s + 1
            if first:
                run["faults"][-1]["restart_ms"] = (
                    time.monotonic_ns() - run["faults"][-1]["t_ns"]) / 1e6
                first = False
            if s % WRAP_SAVE_EVERY == 0 and s in run["saved"] and s not in run["committed"]:
                ck.maybe_finalize(blocking=True)   # the save drained under step s
                run["committed"].append(s)
        step.check_now()
        return f"done@{it}"

    ladder = default_ladder(None, None, None, AbortCheckpointWorkers(ck.queue),
                            AbortQuorumMonitor())
    wrapper = Wrapper(
        store_factory=StoreFactory("127.0.0.1", server.port, timeout=60.0),
        initialize=initialize, abort=ladder, health_check=probe,
        soft_timeout=WRAP_SOFT_TIMEOUT_S, hard_timeout=300.0,
        monitor_process_interval=0.1, monitor_thread_interval=0.05,
        last_call_wait=0.05, barrier_timeout=120.0,
        quorum_mesh=lambda: make_mesh(("all",), device=device),
        quorum_budget_ms=WRAP_QUORUM_BUDGET_MS, quorum_interval=0.01,
        quorum_auto_beat_interval=0.005, quorum_calibrate=False,
    )
    q.local_max.launches = 0
    dd.shard_fingerprints.launches = 0
    os.environ["TPURX_RANK"], os.environ["TPURX_WORLD_SIZE"] = "0", "1"
    t0 = time.perf_counter()
    try:
        ret = wrapper(train)()
    finally:
        ck.close()
        resident.invalidate()  # the last save's warm-restore copy in shm
        import torch.distributed as dist

        from tpu_resiliency_torch.parallel import distributed as dist_mod

        if dist.is_initialized():
            dist.destroy_process_group()
        dist_mod.reset()
        server.stop()
        torch.use_deterministic_algorithms(False)
    wall_s = time.perf_counter() - t0
    launches = {"quorum_local_max": q.local_max.launches,
                "chunk_fingerprint": dd.shard_fingerprints.launches}
    shutil.rmtree(root, ignore_errors=True)
    leaked = sorted(_shm_segments() - shm_before)

    faults = run["faults"]
    print(f"wrap phase: wrapper returned {ret!r} after {wall_s:.2f} s; "
          f"{len(run['losses'])} steps run, saves {sorted(run['saved'])} "
          f"(committed {sorted(run['committed'])}); kernel launches in the "
          f"wrapped run {launches}")
    want_records = {"exception": "exception", "stall": "soft_timeout",
                    "quorum_freeze": "quorum_stale"}
    for f in faults:
        print(f"wrap phase: fault {f['kind']} (iteration {f['iteration']}, step "
              f"{f['step']}): records {f.get('records')}; detection "
              f"{f.get('trip_ms', float('nan')):.2f} ms"
              + (f" (tick lane {f['lane_trip_ms']:.2f} ms)" if "lane_trip_ms" in f else "")
              + f"; ladder {f.get('ladder_ms')} ms "
              f"{f.get('ladder_outcomes')}; process group rebuilt in "
              f"{f.get('init_ms', float('nan')):.2f} ms; health probe "
              f"{f.get('probe_ms', float('nan')):.2f} ms; restore from step "
              f"{f.get('restored_from')} in {f.get('restore_ms', float('nan')):.2f} "
              f"ms; restart latency {f.get('restart_ms', float('nan')):.2f} ms; "
              f"steps lost {f.get('steps_lost')}; kernel launches before it "
              f"{f['launches']}")
    mismatched = [(it, s, v, reference[s]) for it, s, v in run["losses"]
                  if v != reference[s]]
    for claim, met in (
        ("the wrapper returned from the fourth iteration", ret == "done@3"),
        ("three faults, each restored", len(faults) == 3
         and all("restore_ms" in f and "restart_ms" in f for f in faults)),
        ("each fault detected by its own detector", all(
            (0, want_records[f["kind"]]) in f.get("records", ()) for f in faults)),
        ("every loss equals the uninterrupted run's bit for bit",
         not mismatched and run["s"] == WRAP_STEPS),
        ("every abort stage released", all(
            set(f["ladder_outcomes"].values()) == {"released"} for f in faults)),
        ("the local max and the fingerprint ran in the wrapped run", not on_card
         or (launches["quorum_local_max"] > 0 and launches["chunk_fingerprint"] > 0)),
        ("no shared-memory segment leaked", not leaked),
    ):
        print(f"wrap phase: {claim}: {'met' if met else 'NOT met'}")
        if not met:
            raise AssertionError(
                f"wrap phase: {claim} failed: faults {faults}, mismatched "
                f"losses {mismatched[:5]}, leaked {leaked}")
    return {"faults": faults, "launches": launches, "steps": len(run["losses"]),
            "wall_s": wall_s}


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _local_copies(torch, tree_leaves, tree) -> list:
    """A device copy of every leaf's local data (a DTensor's local shard)."""
    from torch.distributed.tensor import DTensor

    return [(t.to_local() if isinstance(t, DTensor) else t).clone()
            for t in tree_leaves(tree)]


def _restored_bit_for_bit(torch, tree_leaves, out, copies) -> bool:
    from torch.distributed.tensor import DTensor

    got = [t.to_local() if isinstance(t, DTensor) else t for t in tree_leaves(out)]
    return len(got) == len(copies) and all(
        x.device == y.device and x.dtype == y.dtype and _same_bytes(torch, x, y)
        for x, y in zip(got, copies))


def mesh_expected_owned(cfg, n_opt_groups: int) -> list:
    """Owned shard entries per rank of a (2, 2) save of the train state by
    the JAX package's rule: one owner per distinct box, the lowest flat
    index.  The split leaves (embed and six matrices per layer, in each of
    params, mu, nu and master) have one box per "model" index, owned by the
    "data" = 0 ranks 0 and 1; the replicated ones (pos and the norm scales)
    and the scalar count are rank 0's; ranks 2 and 3 own nothing."""
    split = (1 + 6 * cfg.n_layers) * n_opt_groups
    replicated = (2 + 2 * cfg.n_layers) * n_opt_groups + 1
    return [split + replicated, split, 0, 0]


def mesh_phase(torch, cfg, batch_size: int, seq: int, device=None) -> dict:
    """Phase 9: the dp x tp sharded step and its sharded save.  (a) a world
    of one over NCCL on a (1, 1) mesh; (b) four gloo processes sharing the
    card on a (2, 2) mesh.  ``device="cpu"`` rehearses both on the CPU
    (gloo throughout; the launch claims are waived off the card)."""
    a = mesh_world_one(torch, cfg, batch_size, seq, device)
    b = mesh_gloo_four(torch, cfg, batch_size, seq, a["losses"][:MESH_STEPS], device)
    return {"a": a, "b": b}


def mesh_world_one(torch, cfg, batch_size: int, seq: int, device=None) -> dict:
    """Part (a): the sharded route on a (1, 1) mesh equals the unsharded
    route bit for bit, under the fused quorum lane; then one sharded save
    and restore."""
    import torch.distributed as dist

    from tpu_resiliency_torch.checkpointing.async_ckpt import checkpointer as ckpt_mod
    from tpu_resiliency_torch.checkpointing.async_ckpt import device_digest as dd
    from tpu_resiliency_torch.models import transformer as tr
    from tpu_resiliency_torch.ops import quorum as q
    from tpu_resiliency_torch.parallel import distributed as dist_mod
    from tpu_resiliency_torch.parallel import init_distributed, make_mesh
    from tpu_resiliency_torch.utils.tree import leaves

    on_card = device is None
    dev = (torch.device("cuda", torch.cuda.current_device()) if on_card
           else torch.device("cpu"))

    def sync():
        if on_card:
            torch.cuda.synchronize()

    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True, warn_only=True)
    init_distributed(device=device)
    mesh = make_mesh(("data", "model"), (1, 1), device=device)
    root = tempfile.mkdtemp(prefix="tpurx_mesh_")
    try:
        routes = {}
        for name, m in (("unsharded", None), ("mesh", mesh)):
            params = tr.init_params(cfg, torch.Generator(dev).manual_seed(0),
                                    device=device, mesh=m)
            routes[name] = {
                "params": params, "opt": tr.init_opt_state(params),
                "batch": tr.make_batch(cfg, batch_size, seq, seed=0,
                                       device=device, mesh=m),
                "step": tr.make_train_step(cfg, lr=1e-3, mesh=m),
            }
        trips = []
        fq = q.FusedStepQuorum(mesh, budget_ms=1000.0, identify=True, device=device,
                               on_stale=lambda age, d: trips.append((age, d)))
        routes["mesh"]["fused"] = fq.fuse(routes["mesh"]["step"])

        def run(name, n, fused=True):
            r = routes[name]
            step = r.get("fused", r["step"]) if fused else r["step"]
            out = []
            for _ in range(n):
                if name == "mesh":
                    fq.beat()
                r["params"], r["opt"], loss = step(r["params"], r["opt"], r["batch"])
                out.append(loss)
            return [float(v) for v in out]

        n_steps = WARMUP_STEPS + TIMED_STEPS
        plain = run("unsharded", n_steps)
        q.local_max.launches = 0
        q.local_max.launches_by_value = 0
        q.local_max.launches_pointer = 0
        losses = run("mesh", n_steps)
        sync()
        fq.check_now()
        lm_launches = q.local_max.launches
        print(f"mesh phase (a): {n_steps} steps on the (1, 1) mesh: losses "
              f"{[round(v, 4) for v in losses]}; unsharded route "
              f"{[round(v, 4) for v in plain]}; local max launches {lm_launches}")

        # one sharded save of the train state, restored bit for bit
        r = routes["mesh"]
        tree = tr.state_tree(r["params"], r["opt"])
        copies = _local_copies(torch, leaves, tree)
        ck = ckpt_mod.AsyncCheckpointer(delta=True, digest=True, device_digest=True)
        try:
            dd.shard_fingerprints.launches = 0
            t0 = time.perf_counter()
            ck.async_save(tree, os.path.join(root, "a"), {"iteration": 0})
            call_ms = (time.perf_counter() - t0) * 1e3
            ck.finalize_all()
            fp_launches = dd.shard_fingerprints.launches
            save_ms = (time.perf_counter() - t0) * 1e3
            owned = ck.last_stage_stats["shards_owned"]
        finally:
            ck.close()
        t0 = time.perf_counter()
        out = ckpt_mod.load_checkpoint(os.path.join(root, "a"), tree, resident=False)
        sync()
        restore_ms = (time.perf_counter() - t0) * 1e3
        restored = _restored_bit_for_bit(torch, leaves, out, copies)
        n_leaves = len(copies)
        print(f"mesh phase (a): save of {n_leaves} DTensor and plain leaves: "
              f"async_save {call_ms:.2f} ms, committed after {save_ms:.1f} ms, "
              f"{owned} owned shards, fingerprint launches {fp_launches}; "
              f"restored in {restore_ms:.1f} ms, bit for bit: {restored}")

        # step time, in turns: the mesh step under the fused lane and bare,
        # and the unsharded step (bare)
        turns = {"mesh_fused": ("mesh", True), "mesh": ("mesh", False),
                 "unsharded": ("unsharded", False)}
        samples = {k: [] for k in turns}
        for rnd in range(MESH_TIME_ROUNDS):
            for key in (list(turns) if rnd % 2 == 0 else list(turns)[::-1]):
                sync()
                t0 = time.perf_counter()
                run(*turns[key][:1], MESH_TIME_STEPS, fused=turns[key][1])
                sync()
                samples[key].append((time.perf_counter() - t0) / MESH_TIME_STEPS * 1e3)
        step_ms = {k: sorted(v)[len(v) // 2] for k, v in samples.items()}
        print(f"mesh phase (a): step ms, median of {MESH_TIME_ROUNDS} rounds of "
              f"{MESH_TIME_STEPS} in turns: (1, 1) mesh under the fused lane "
              f"{step_ms['mesh_fused']:.2f}, (1, 1) mesh bare {step_ms['mesh']:.2f}, "
              f"unsharded {step_ms['unsharded']:.2f} (all rounds {samples})")
        for claim, met in (
            ("every loss equals the unsharded route's bit for bit", losses == plain),
            ("the losses are finite and fall",
             all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]),
            ("no trip", not trips),
            ("the local max launched once per fused step",
             not on_card or lm_launches == n_steps),
            ("the fingerprint launched once per owned shard",
             owned == n_leaves and (not on_card or fp_launches == owned)),
            ("the sharded save restored bit for bit", restored),
        ):
            print(f"mesh phase (a): {claim}: {'met' if met else 'NOT met'}")
            if not met:
                raise AssertionError(f"mesh phase (a): {claim} failed")
        return {"losses": losses, "unsharded_losses": plain,
                "local_max_launches": lm_launches, "fingerprint_launches": fp_launches,
                "owned": owned, "leaves": n_leaves, "step_ms": step_ms,
                "step_ms_rounds": samples, "save_call_ms": call_ms,
                "save_ms": save_ms, "restore_ms": restore_ms}
    finally:
        shutil.rmtree(root, ignore_errors=True)
        if dist.is_initialized():
            dist.destroy_process_group()
        dist_mod.reset()
        torch.use_deterministic_algorithms(False)


def mesh_gloo_four(torch, cfg, batch_size: int, seq: int, a_losses: list,
                   device=None) -> dict:
    """Part (b): four exec'd children (``chip_smoke.py --mesh-child``) on a
    (2, 2) gloo mesh over the one card, committing one save over the port's
    store server run here."""
    from tpu_resiliency_torch.store import StoreServer

    world = MESH_SHAPE[0] * MESH_SHAPE[1]
    root = tempfile.mkdtemp(prefix="tpurx_mesh4_")
    server = StoreServer(host="127.0.0.1", port=0).start_in_thread()
    spec = {"root": root, "store_port": server.port, "batch": batch_size,
            "seq": seq, "steps": MESH_STEPS, "device": device,
            "cfg": {k: getattr(cfg, k) for k in (
                "vocab", "d_model", "n_heads", "n_layers", "d_ff", "max_seq")},
            "dtype": None if cfg.dtype is None else str(cfg.dtype).split(".")[-1]}
    env = dict(os.environ, CHIP_SMOKE_MESH=json.dumps(spec), OMP_NUM_THREADS="2")
    url = f"tcp://127.0.0.1:{_free_port()}"
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--mesh-child", str(r),
         str(world), url],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=HERE) for r in range(world)]
    outs, ranks = [], []
    try:
        deadline = time.monotonic() + MESH_CHILD_TIMEOUT_S
        for r, p in enumerate(procs):
            try:
                out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"mesh phase (b): rank {r} did not finish in "
                                     f"{MESH_CHILD_TIMEOUT_S:.0f} s")
            outs.append(out)
            if p.returncode != 0:
                raise AssertionError(
                    f"mesh phase (b): rank {r} exited {p.returncode}:\n{out[-4000:]}")
            ranks.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
        server.stop()
        shutil.rmtree(root, ignore_errors=True)
    wall_s = time.perf_counter() - t0
    n_groups = 4 if ranks[0]["master"] else 3
    want = mesh_expected_owned(cfg, n_groups)
    n_leaves = ranks[0]["leaves"]
    for rk in ranks:
        print(f"mesh phase (b): rank {rk['rank']} at {rk['coord']}: losses "
              f"{[round(v, 5) for v in rk['losses']]}, step ms "
              f"{[round(v, 1) for v in rk['step_ms']]}; save: {rk['owned']} owned "
              f"and {rk['non_owned']} non-owned entries, fingerprint launches "
              f"{rk['fp_launches']}, committed in {rk['save_ms']:.0f} ms; "
              f"restored bit for bit: {rk['restored']} in {rk['restore_ms']:.0f} ms")
    diffs = [abs(x - y) for rk in ranks for x, y in zip(rk["losses"], a_losses)]
    print(f"mesh phase (b): four gloo processes on one card (host-staged "
          f"collectives, not a tensor-parallel speed): wall {wall_s:.1f} s; "
          f"largest loss difference to (a)'s first {MESH_STEPS} steps "
          f"{max(diffs):.6f} (tolerance {MESH_LOSS_TOL})")
    on_card = device is None
    for claim, met in (
        ("every rank's losses are finite and fall", all(
            all(math.isfinite(v) for v in rk["losses"])
            and rk["losses"][-1] < rk["losses"][0] for rk in ranks)),
        (f"the losses agree with (a)'s within {MESH_LOSS_TOL}",
         max(diffs) <= MESH_LOSS_TOL),
        ("the owned entries are the JAX rule's for (2, 2)",
         [rk["owned"] for rk in ranks] == want
         and all(rk["owned"] + rk["non_owned"] == n_leaves
                 and rk["written"] == rk["owned"] for rk in ranks)),
        ("the fingerprint launched once per owned device shard",
         not on_card or all(rk["fp_launches"] == rk["owned"] for rk in ranks)),
        ("every rank restored its boxes bit for bit",
         all(rk["restored"] for rk in ranks)),
    ):
        print(f"mesh phase (b): {claim}: {'met' if met else 'NOT met'}")
        if not met:
            raise AssertionError(f"mesh phase (b): {claim} failed: {ranks}")
    return {"ranks": ranks, "wall_s": wall_s, "expected_owned": want,
            "max_loss_diff": max(diffs)}


def mesh_child(rank: int, world: int, url: str) -> int:
    """Part (b)'s child: one rank of the (2, 2) gloo mesh on the card."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, HERE)
    from tpu_resiliency_torch.checkpointing.async_ckpt import checkpointer as ckpt_mod
    from tpu_resiliency_torch.checkpointing.async_ckpt import device_digest as dd
    from tpu_resiliency_torch.models import transformer as tr
    from tpu_resiliency_torch.parallel import dp_tp, init_distributed, make_mesh
    from tpu_resiliency_torch.store import StoreClient
    from tpu_resiliency_torch.utils.tree import leaves

    spec = json.loads(os.environ["CHIP_SMOKE_MESH"])
    device = spec["device"]
    on_card = device is None
    dev = init_distributed(init_method=url, world_size=world, rank=rank,
                           device=device, backend="gloo")
    mesh = make_mesh(("data", "model"), MESH_SHAPE, device=device)
    ax = dp_tp(mesh)
    dtype = getattr(torch, spec["dtype"]) if spec["dtype"] else None
    cfg = tr.TransformerConfig(**spec["cfg"], dtype=dtype)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    params = tr.init_params(cfg, torch.Generator(dev).manual_seed(0),
                            device=device, mesh=mesh)
    opt = tr.init_opt_state(params)
    batch = tr.make_batch(cfg, spec["batch"], spec["seq"], seed=0, device=device,
                          mesh=mesh)
    step = tr.make_train_step(cfg, lr=1e-3, mesh=mesh)
    losses, step_ms = [], []
    for _ in range(spec["steps"]):
        sync()
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, batch)
        losses.append(float(loss))
        step_ms.append((time.perf_counter() - t0) * 1e3)

    tree = tr.state_tree(params, opt)
    copies = _local_copies(torch, leaves, tree)
    store = StoreClient("127.0.0.1", spec["store_port"], timeout=120.0)
    ck = ckpt_mod.AsyncCheckpointer(store=store, delta=True, digest=True,
                                    device_digest=True)
    path = os.path.join(spec["root"], "state")
    try:
        dd.shard_fingerprints.launches = 0
        t0 = time.perf_counter()
        ck.async_save(tree, path, {"iteration": 0})
        ck.finalize_all(timeout=MESH_CHILD_TIMEOUT_S)
        save_ms = (time.perf_counter() - t0) * 1e3
        fp_launches = dd.shard_fingerprints.launches
    finally:
        ck.close()
    dist.barrier()  # rank 0's commit lands after the others' finalize
    owned = ck.last_stage_stats["shards_owned"]
    non_owned = ck.last_stage_stats["shards_not_owned"]
    with open(os.path.join(path, f"process_{rank}.json")) as f:
        written = len(json.load(f)["shards"])
    t0 = time.perf_counter()
    out = ckpt_mod.load_checkpoint(path, tree, resident=False)
    sync()
    restore_ms = (time.perf_counter() - t0) * 1e3
    restored = _restored_bit_for_bit(torch, leaves, out, copies)
    print(json.dumps({
        "rank": rank, "coord": [ax.dp_index, ax.tp_index], "losses": losses,
        "step_ms": step_ms, "leaves": len(copies), "master": "master" in opt,
        "owned": owned, "non_owned": non_owned, "written": written,
        "fp_launches": fp_launches, "save_ms": save_ms,
        "restore_ms": restore_ms, "restored": restored,
    }), flush=True)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def wedge_child() -> int:
    """Phase 10's child: a small trainer under the port's Wrapper (monitor
    process on) that wedges itself in the spin kernel.  Never returns on
    the card: its monitor process kills it."""
    import signal
    import threading

    import torch

    sys.path.insert(0, HERE)
    from tpu_resiliency_torch.inprocess import (
        AbortLadder,
        AbortTorchDistributed,
        ClearCudaCaches,
        FingerprintStage,
        Wrapper,
    )
    from tpu_resiliency_torch.inprocess.fingerprint import record_dispatch
    from tpu_resiliency_torch.models import transformer as tr
    from tpu_resiliency_torch.ops import device_spin
    from tpu_resiliency_torch.parallel import init_distributed
    from tpu_resiliency_torch.utils.inject_fault import Fault, fire

    # a trainer's own SIGTERM handler (a save on preemption, say) runs only
    # at a bytecode boundary, which the wedged main thread never reaches:
    # the monitor's SIGTERM goes unanswered and its SIGKILL follows
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    cfg = tr.TransformerConfig(vocab=256, d_model=64, n_heads=4, n_layers=2,
                               d_ff=128, max_seq=32)

    def report_launch():
        while device_spin.device_spin.launches == 0:
            time.sleep(0.001)
        print(f"wedge child: spin launches={device_spin.device_spin.launches} "
              f"launched_ns={time.time_ns()}", flush=True)

    def train(call_wrapper=None):
        if call_wrapper.iteration > 0:
            return "restarted"  # the ring must never get here
        params = tr.init_params(cfg, torch.Generator("cuda").manual_seed(0))
        opt = tr.init_opt_state(params)
        batch = tr.make_batch(cfg, 2, 32, seed=0)
        step = tr.make_train_step(cfg)
        for _ in range(5):
            call_wrapper.ping()
            params, opt, loss = step(params, opt, batch)
        print(f"wedge child: trained 5 steps, loss {float(loss):.4f}; "
              f"wedging in a device program", flush=True)
        threading.Thread(target=report_launch, daemon=True).start()
        record_dispatch("device_spin")
        fire(Fault.DEVICE_HANG)
        return "unwedged"

    wrapper = Wrapper(
        group="wedge",
        initialize=lambda state: init_distributed(),
        abort=AbortLadder(FingerprintStage(), AbortTorchDistributed(timeout=2.0),
                          ClearCudaCaches(timeout=2.0)),
        soft_timeout=WEDGE_SOFT_TIMEOUT_S, hard_timeout=WEDGE_HARD_TIMEOUT_S,
        monitor_process_interval=0.1, monitor_thread_interval=0.05,
        last_call_wait=0.05,
    )
    ret = wrapper(train)()
    print(f"wedge child: wrapper returned {ret!r}", flush=True)
    return 3


def wedge_phase(torch, np, q, dd) -> dict:
    """Phase 10: a child wedged in the spin kernel is hard-killed by its
    monitor process, and the card serves afterwards."""
    import signal

    from tpu_resiliency_torch.inprocess.attribution import InterruptionRecord
    from tpu_resiliency_torch.store import StoreClient, StoreServer, StoreTimeout

    server = StoreServer(host="127.0.0.1", port=0).start_in_thread()
    client = StoreClient("127.0.0.1", server.port, timeout=30.0)
    env = dict(os.environ, TPURX_STORE_ADDR="127.0.0.1",
               TPURX_STORE_PORT=str(server.port), TPURX_RANK="0",
               TPURX_WORLD_SIZE="1")
    key = "inproc/wedge/iter/0/interruptions"
    t_start = time.time_ns()
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--wedge-child"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=HERE,
    )
    try:
        try:
            client.wait([key], timeout=120.0)
            t_soft = time.time_ns()
        except StoreTimeout:
            t_soft = None
        out, _ = proc.communicate(timeout=120)
        t_exit = time.time_ns()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    records = [InterruptionRecord.from_json(line).interruption.value
               for line in (client.try_get(key) or b"").decode().splitlines()
               if line.strip()]
    client.close()
    server.stop()
    print("wedge phase: child output:\n" + "\n".join(
        "  | " + line for line in out.strip().splitlines()[-40:]))
    launched = [line for line in out.splitlines()
                if line.startswith("wedge child: spin launches=")]
    spin_launches = int(launched[0].split("launches=")[1].split()[0]) if launched else 0
    t_launch = int(launched[0].split("launched_ns=")[1]) if launched else None
    rec = {"rc": proc.returncode, "records": records, "spin_launches": spin_launches,
           "child_wall_ms": (t_exit - t_start) / 1e6}
    if t_launch is not None and t_soft is not None:
        rec["launch_to_soft_timeout_ms"] = (t_soft - t_launch) / 1e6
        rec["launch_to_kill_ms"] = (t_exit - t_launch) / 1e6
    # the card still serves: both kernels against their plain versions
    dev = torch.device("cuda", torch.cuda.current_device())
    x = torch.randint(0, 2 ** 31 - 1, (1 << 20,), dtype=torch.int32, device=dev)
    lm_ok = torch.equal(q.local_max(x), q.local_max_reference(x))
    y = torch.randn(EMBED_F32_ELEMS, device=dev)
    fp_ok = torch.equal(dd.shard_fingerprints(y),
                        dd.fingerprint_reference(y, dd.default_chunk_bytes(), True))
    torch.cuda.synchronize()
    rec["card_serves"] = bool(lm_ok and fp_ok)
    print(f"wedge phase: child exit {proc.returncode}, spin launches "
          f"{spin_launches}, interruption records {records}; spin launch to "
          f"soft timeout {rec.get('launch_to_soft_timeout_ms', float('nan')):.1f} "
          f"ms, to the kill {rec.get('launch_to_kill_ms', float('nan')):.1f} ms; "
          f"afterwards the local max and the fingerprint equal their plain "
          f"versions: {rec['card_serves']}")
    for claim, met in (
        ("the child was SIGKILLed", proc.returncode == -signal.SIGKILL),
        ("its monitor process logged the kill", "killing" in out),
        ("the ladder released the fingerprint",
         "abort ladder: fingerprint=released" in out),
        ("the records name the soft timeout", "soft_timeout" in records),
        ("the spin kernel launched once", spin_launches == 1),
        ("the card serves afterwards", rec["card_serves"]),
    ):
        print(f"wedge phase: {claim}: {'met' if met else 'NOT met'}")
        if not met:
            raise AssertionError(f"wedge phase: {claim} failed: {rec}")
    return rec


def check_phase(torch, tr) -> None:
    """The model on the card (f32, no TF32) against the CPU at a small size."""
    cfg = tr.TransformerConfig(vocab=256, d_model=64, n_heads=4, n_layers=2,
                               d_ff=128, max_seq=32, dtype=torch.float32)
    losses = {}
    for device in ("cpu", None):
        params = tr.init_params(cfg, torch.Generator("cpu").manual_seed(1),
                                device=device)
        opt = tr.init_opt_state(params)
        batch = tr.make_batch(cfg, 2, 32, seed=1, device=device)
        step = tr.make_train_step(cfg, lr=1e-2)
        _, _, first = step(params, opt, batch)
        second = tr.loss_fn(params, batch, cfg).detach()
        losses[device] = (float(first), float(second))
    cpu, card = losses["cpu"], losses[None]
    # f32 sums in another order on the card: 1e-4 relative is ~1000 ulp
    for a, b in zip(cpu, card):
        if not math.isfinite(b) or abs(a - b) > 1e-4 * abs(a):
            raise AssertionError(f"card loss {card} disagrees with CPU {cpu}")
    print(f"check phase: small model, loss before/after one step: card "
          f"{card[0]:.6f}/{card[1]:.6f}, CPU {cpu[0]:.6f}/{cpu[1]:.6f}")


def main() -> int:
    import torch

    if sys.argv[1:] == ["--wedge-child"]:
        return wedge_child()
    if sys.argv[1:2] == ["--mesh-child"] and len(sys.argv) == 5:
        return mesh_child(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import numpy as np

    from tpu_resiliency_torch.checkpointing.async_ckpt import checkpointer as ckpt_mod
    from tpu_resiliency_torch.checkpointing.async_ckpt import device_digest as dd
    from tpu_resiliency_torch.models import transformer as tr
    from tpu_resiliency_torch.ops import quorum as q
    from tpu_resiliency_torch.parallel import init_distributed, make_mesh
    from tpu_resiliency_torch.utils import cuda_build
    from tpu_resiliency_torch.utils import tree as tree_mod

    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    t0 = time.monotonic()
    info = cuda_build.build_all()
    print(f"setup: built {sorted(info)} in {time.monotonic() - t0:.2f}s")
    for src, rec in info.items():
        print(f"setup: {src}: nvcc {rec['seconds']:.2f}s\n{rec['log']}")

    kernel = kernel_phase(torch, np, q)
    digest = digest_phase(torch, np, dd,
                          torch.device("cuda", torch.cuda.current_device()))
    check_phase(torch, tr)

    # -- train phase: the main path -----------------------------------------
    device = init_distributed()
    mesh = make_mesh(("all",))
    cfg = tr.TransformerConfig()
    params = tr.init_params(cfg, torch.Generator(device).manual_seed(0))
    opt = tr.init_opt_state(params)
    batch = tr.make_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    n_params = sum(p.numel() for p in params.parameters())
    opt_bytes = sum(t.numel() * t.element_size()
                    for key in ("mu", "nu", "master") for t in opt[key])
    print(f"train phase: {cfg}, {n_params} params, optimizer state "
          f"{opt_bytes / 1e9:.3f} GB, batch {TRAIN_BATCH}x{TRAIN_SEQ}, "
          f"{params.embed.dtype} with fp32 master")

    fused_trips, mon_trips = [], []
    fq = q.FusedStepQuorum(
        mesh, budget_ms=1000.0, identify=True,
        on_stale=lambda age, dev: fused_trips.append((time.monotonic(), age, dev)),
    )
    mon = q.QuorumMonitor(
        mesh, budget_ms=1000.0, interval=0.01, identify=True,
        auto_beat_interval=0.005,
        on_stale=lambda age, dev: mon_trips.append((time.monotonic(), age, dev)),
    )
    step = fq.fuse(tr.make_train_step(cfg, lr=1e-3))
    torch.cuda.reset_peak_memory_stats()

    q.local_max.launches = 0
    q.local_max.launches_by_value = 0
    q.local_max.launches_pointer = 0
    mon.start()
    losses = []
    for i in range(WARMUP_STEPS + TIMED_STEPS):
        if i == WARMUP_STEPS:
            torch.cuda.synchronize()
            t_start = time.monotonic()
        fq.beat()
        params, opt, loss = step(params, opt, batch)
        losses.append(loss)
    torch.cuda.synchronize()
    elapsed = time.monotonic() - t_start
    fq.check_now()
    n_steps = WARMUP_STEPS + TIMED_STEPS
    # the tick thread counts a tick just before its launch: read when no
    # tick is between the two (a tick takes microseconds, the interval 10 ms)
    for _ in range(1000):
        ticks = mon.tick_count
        counts = (q.local_max.launches, q.local_max.launches_by_value,
                  q.local_max.launches_pointer)
        if ticks == mon.tick_count and counts[0] == n_steps + ticks:
            break
        time.sleep(0.0005)
    train_launches, by_value, pointer = counts

    losses = [float(v) for v in losses]
    step_ms = elapsed / TIMED_STEPS * 1e3
    print(f"train phase: losses {[round(v, 4) for v in losses]}")
    flops = train_step_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    print(f"train phase: {flops / 1e12:.3f} TFLOP of matmul per step by the "
          f"shapes, {flops / BF16_FLOPS_PER_S * 1e3:.3f} ms at the bf16 dense peak")
    print(f"train phase: {step_ms:.2f} ms/step, "
          f"{TRAIN_BATCH * TRAIN_SEQ * TIMED_STEPS / elapsed:.0f} tokens/s over "
          f"{TIMED_STEPS} steps after {WARMUP_STEPS} warm-up; peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    print(f"train phase: local max launches {train_launches} "
          f"({n_steps} fused steps + {ticks} monitor ticks), {by_value} by "
          f"value, {pointer} by pointer; fused max age "
          f"{fq.last_max_age_ms} ms, monitor max age {mon.last_max_age} ms")
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"loss not finite and falling: {losses}")
    if fused_trips or mon_trips:
        raise AssertionError(f"healthy trips: fused {fused_trips}, monitor {mon_trips}")
    if ticks < 1 or train_launches != n_steps + ticks or by_value != train_launches:
        raise AssertionError(
            f"local max kernel launched {train_launches} times ({by_value} by "
            f"value, {pointer} by pointer) for {n_steps} fused steps and "
            f"{ticks} ticks"
        )

    # -- ckpt phase: the checkpoint path on the same train state ------------
    ckpt = ckpt_phase(torch, tr, dd, ckpt_mod, tree_mod, params, opt, step, fq,
                      batch, step_ms)
    if fused_trips or mon_trips:
        raise AssertionError(f"trips during the ckpt phase: fused {fused_trips}, "
                             f"monitor {mon_trips}")

    # -- hang phase: freeze both heartbeats ----------------------------------
    mon.budget_ms = HANG_BUDGET_MS
    fq.budget_ms = HANG_BUDGET_MS
    t_freeze = time.monotonic()
    mon.stop_auto_beat()            # and fq.beat() is no longer called
    while not mon_trips and time.monotonic() - t_freeze < 10.0:
        time.sleep(0.001)
    time.sleep(max(0.0, t_freeze + 4 * HANG_BUDGET_MS / 1e3 - time.monotonic()))
    params, opt, loss = step(params, opt, batch)
    fq.check_now()
    mon.stop()
    if not mon_trips or not fused_trips:
        raise AssertionError(f"hang not detected: monitor {mon_trips}, fused {fused_trips}")
    for name, trips in (("monitor", mon_trips), ("fused", fused_trips)):
        t_trip, age, dev = trips[0]
        if t_trip < t_freeze or dev != 0 or age <= HANG_BUDGET_MS:
            raise AssertionError(f"{name} trip wrong: {trips[0]} (freeze at {t_freeze})")
        print(f"hang phase: {name} lane tripped {(t_trip - t_freeze) * 1e3:.2f} ms "
              f"after the freeze, age {age:.3f} ms, device {dev}")

    import torch.distributed as dist

    from tpu_resiliency_torch.parallel import distributed as dist_mod

    dist.destroy_process_group()
    dist_mod.reset()
    del params, opt, step, fq, mon

    # -- wrap phase: the in-process restart ring -----------------------------
    wrap = wrap_phase(torch, cfg, TRAIN_BATCH, TRAIN_SEQ)

    # -- mesh phase: the dp x tp sharded step and its sharded save -----------
    mesh = mesh_phase(torch, cfg, TRAIN_BATCH, TRAIN_SEQ)

    # -- wedge phase: the spin kernel in a child the monitor must kill --------
    wedge = wedge_phase(torch, np, q, dd)

    t1 = kernel["timings"][1]

    def at(n):
        return {k: kernel["timings"][n][k] for k in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "bound_share")}

    entry = {
        "name": "quorum_local_max",
        "route": "cuda",
        "source": "tpu_resiliency_torch/ops/csrc/quorum_max.cu",
        "replaces": "tpu_resiliency/ops/quorum.py:203",
        "launches": train_launches,
        "launches_by_value": by_value,
        "launches_pointer": pointer,
        "max_abs_err": kernel["max_abs_err"],
        "ms": t1["ms"],
        "plain_ms": t1["plain_ms"],
        "bound_ms": t1["bound_ms"],
        "bound_by": t1["bound_by"],
        "library_ms": t1["library_ms"],
        "by_value_ms": t1["by_value_ms"],
        "launch_floor_ms": t1["launch_floor_ms"],
        "kernel_us": t1["ms"] * 1e3,
        "library_us": t1["library_ms"] * 1e3,
        "bound_us": t1["bound_ms"] * 1e3,
        "shape": [1],
        "at_n_1048576": at(1 << 20),
        "at_n_16777216": at(1 << 24),
        "lane_n_local_1": kernel["lane"],
    }
    emb, gib = digest["timings"]["embed"], digest["timings"]["1GiB"]
    saves = ckpt["saves"]
    fp_entry = {
        "name": "chunk_fingerprint",
        "route": "cuda",
        "source": "tpu_resiliency_torch/ops/csrc/chunk_fingerprint.cu",
        "replaces": "tpu_resiliency/checkpointing/async_ckpt/device_digest.py:129",
        "launches": ckpt["launches"],
        "max_abs_err": digest["max_abs_err"],
        "ms": emb["ms"],
        "plain_ms": emb["plain_ms"],
        "bound_ms": emb["bound_ms"],
        "bound_by": emb["bound_by"],
        "library_ms": None,
        "shape": [EMBED_F32_ELEMS],
        "dtype": "float32",
        "cases_checked": digest["checked"],
        "at_1GiB": {k: gib[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                        "bound_share")},
        "ckpt": {
            "leaves": ckpt["n_leaves"],
            "state_bytes": ckpt["total_bytes"],
            "restore_ms": ckpt["restore_ms"],
            "pinned_copy": ckpt["pinned_copy"],
            "saves": {g: {k: saves[g][k] for k in (
                "call_ms", "snapshot_span_ms", "device_digest_s",
                "device_digest_launch_s", "d2h_bytes",
                "d2h_shards", "d2h_skipped_bytes", "d2h_enqueue_s", "stage_s",
                "segment_s",
                "drain_ms", "bytes_written", "launches")} for g in saves},
            "steps_during_drain_ms": {
                g: saves[g]["steps_during_drain_ms"] for g in DRAIN_STEP_SAVES},
        },
    }
    fp_entry["wrap_launches"] = wrap["launches"]["chunk_fingerprint"]
    entry["wrap_launches"] = wrap["launches"]["quorum_local_max"]
    # the mesh phase's own runs: (a)'s fused steps and save, (b)'s save per rank
    entry["mesh_launches"] = mesh["a"]["local_max_launches"]
    fp_entry["mesh_launches"] = mesh["a"]["fingerprint_launches"]
    fp_entry["mesh_2x2_launches_per_rank"] = [
        rk["fp_launches"] for rk in mesh["b"]["ranks"]]
    spin_entry = {
        "name": "device_spin",
        "route": "cuda",
        "source": "tpu_resiliency_torch/ops/csrc/device_spin.cu",
        "replaces": "tpu_resiliency/utils/inject_fault.py:100",
        "launches": wedge["spin_launches"],
        # a program that never ends has no result, no time and no bound:
        # what is measured is the ring around it
        "max_abs_err": None,
        "ms": None,
        "plain_ms": None,
        "bound_ms": None,
        "bound_by": None,
        "library_ms": None,
        "launch_to_soft_timeout_ms": wedge.get("launch_to_soft_timeout_ms"),
        "launch_to_kill_ms": wedge.get("launch_to_kill_ms"),
        "child_exit": wedge["rc"],
    }
    print(json.dumps({"wrap": {k: wrap[k] for k in ("faults", "launches", "steps",
                                                     "wall_s")}}))
    print(json.dumps({"mesh": mesh}))
    print(json.dumps({"kernels": [entry, fp_entry, spin_entry]}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
