#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``tpu_resiliency_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (the run then exits non-zero):

1. setup — print the card's name and power limit, build every CUDA kernel
   from ``tpu_resiliency_torch/ops/csrc/`` (one ``nvcc`` per source, all
   started together) and print the build time and ``ptxas`` report;
2. kernel — hold the quorum local max kernel against its plain PyTorch
   version on the card, exactly, at sizes 1 .. 2^20 on random and packed
   ages, and time it beside the plain version and ``torch.amax``;
3. check — the port's model on the card in f32 against the same model on
   the CPU, at a small size (loss before and after one step);
4. train — the main path: the flagship ``TransformerConfig()`` at full
   width (batch 8 x seq 1024, bf16 with an fp32 master) trained for 3 + 10
   steps in a world of one process over NCCL, each step wrapped by
   ``FusedStepQuorum(identify=True)`` while ``QuorumMonitor(identify=True)``
   ticks from its thread.  The kernel's launch count is zeroed just before
   and read just after: every fused step and every tick must have launched
   it.  The loss must be finite and fall, with zero trips;
5. hang — freeze both heartbeats with a 50 ms budget: the monitor must trip
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
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bandwidth, and the
# non-tensor-core f32 rate, used for the int32 compares of the local max
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12

KERNEL_SIZES = (1, 8, 1000, 1024, 1025, 65536, 1 << 20)
TRAIN_BATCH, TRAIN_SEQ = 8, 1024
WARMUP_STEPS, TIMED_STEPS = 3, 10
HANG_BUDGET_MS = 50.0


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


def kernel_phase(torch, np, q) -> dict:
    """The kernel against its plain version at every size; times at the
    path's shape (n = 1) and at n = 2^20."""
    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(0)
    worst = 0
    for n in KERNEL_SIZES:
        ages = rng.integers(0, 2 ** 31 - 1, size=n, dtype=np.int64).astype(np.int32)
        packed = q.pack_age_device(
            rng.integers(0, 2 ** 17, size=n), rng.integers(0, 1 << 16, size=n)
        )
        for values in (ages, packed):
            x = torch.from_numpy(values).to(dev)
            got = q.local_max(x)
            want = q.local_max_reference(x)
            torch.cuda.synchronize()
            err = abs(int(got[0]) - int(want[0]))
            if err != 0 or int(got[0]) != int(values.max()):
                raise AssertionError(
                    f"local max kernel disagrees at n={n}: kernel {int(got[0])}, "
                    f"plain {int(want[0])}, numpy {int(values.max())}"
                )
            worst = max(worst, err)
    print(f"kernel phase: quorum local max equals the plain version at n in "
          f"{list(KERNEL_SIZES)} (random and packed ages)")

    timings = {}
    for n, iters in ((1, 2000), (1 << 20, 200)):
        x = torch.from_numpy(
            rng.integers(0, 2 ** 31 - 1, size=n, dtype=np.int64).astype(np.int32)
        ).to(dev)
        out = torch.empty(1, dtype=torch.int32, device=dev)
        bound, bound_by = local_max_bound_ms(n)
        timings[n] = {
            "ms": time_ms(lambda: q.local_max(x, out), iters, torch),
            "plain_ms": time_ms(lambda: q.local_max_reference(x), iters, torch),
            "library_ms": time_ms(lambda: torch.amax(x), iters, torch),
            "bound_ms": bound,
            "bound_by": bound_by,
        }
        print(f"kernel phase: n={n}: kernel {timings[n]['ms'] * 1e3:.2f} us, "
              f"plain {timings[n]['plain_ms'] * 1e3:.2f} us, torch.amax "
              f"{timings[n]['library_ms'] * 1e3:.2f} us, bound "
              f"{bound * 1e3:.6f} us ({bound_by})")
    return {"max_abs_err": worst, "timings": timings}


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

    from tpu_resiliency_torch.models import transformer as tr
    from tpu_resiliency_torch.ops import quorum as q
    from tpu_resiliency_torch.parallel import init_distributed, make_mesh
    from tpu_resiliency_torch.utils import cuda_build

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
    train_launches = q.local_max.launches
    ticks = mon.tick_count
    n_steps = WARMUP_STEPS + TIMED_STEPS

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
          f"({n_steps} fused steps + {ticks} monitor ticks); fused max age "
          f"{fq.last_max_age_ms} ms, monitor max age {mon.last_max_age} ms")
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"loss not finite and falling: {losses}")
    if fused_trips or mon_trips:
        raise AssertionError(f"healthy trips: fused {fused_trips}, monitor {mon_trips}")
    if ticks < 1 or train_launches < n_steps + ticks:
        raise AssertionError(
            f"local max kernel launched {train_launches} times for {n_steps} "
            f"fused steps and {ticks} ticks"
        )

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
    big = kernel["timings"][1 << 20]
    entry = {
        "name": "quorum_local_max",
        "route": "cuda",
        "source": "tpu_resiliency_torch/ops/csrc/quorum_max.cu",
        "replaces": "tpu_resiliency/ops/quorum.py:203",
        "launches": train_launches,
        "max_abs_err": kernel["max_abs_err"],
        "ms": t1["ms"],
        "plain_ms": t1["plain_ms"],
        "bound_ms": t1["bound_ms"],
        "bound_by": t1["bound_by"],
        "library_ms": t1["library_ms"],
        "kernel_us": t1["ms"] * 1e3,
        "library_us": t1["library_ms"] * 1e3,
        "bound_us": t1["bound_ms"] * 1e3,
        "shape": [1],
        "at_n_1048576": {k: big[k] for k in ("ms", "plain_ms", "library_ms",
                                             "bound_ms", "bound_by")},
    }
    import torch.distributed as dist

    dist.destroy_process_group()
    print(json.dumps({"kernels": [entry]}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
