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
   naming device 0, and the fused lane must trip on the next step.

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
    import torch.distributed as dist

    dist.destroy_process_group()
    print(json.dumps({"kernels": [entry, fp_entry]}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
