"""Run one cell of the port's benchmark once and print its result.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds the port (``tpu_resiliency_torch``)
beside ``BENCHMARK.json``.  Set-up, then a window of ``--seconds``, then
the check against the plain float32 reference.  The last line of standard
output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device`` and, traced, ``breakdown``; last in it,
``compared`` holds each number the check compared beside its limit, which
also end standard error.  With no CUDA card, fewer cards than the cell
asks for, or JAX or the JAX package loaded by the time the window has
closed, the run exits non-zero and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_resiliency")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``tpu_resiliency_torch`` is the port, not the package)."""
    return sorted({m for m in sys.modules if m.split(".", 1)[0] in FORBIDDEN})


def _caches(root: str) -> None:
    """Build and kernel caches at fixed paths inside the checkout.  The port
    builds its CUDA kernels into ``tpu_resiliency_torch/_build/``; these
    catch a Triton kernel or a PyTorch extension the port may add later,
    since a later change cannot edit the harness."""
    base = os.path.join(root, ".portbench_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = os.path.join(base, sub)


def stop_helpers() -> None:
    """Stop the helper process that ``multiprocessing`` starts for the
    port's shared memory (its resource tracker) and wait for it, so that no
    process of the run outlives the run."""
    from multiprocessing import resource_tracker

    tracker = resource_tracker._resource_tracker
    if hasattr(tracker, "_stop"):
        tracker._stop()
    elif tracker._pid is not None:
        os.close(tracker._fd)
        os.waitpid(tracker._pid, 0)
        tracker._fd = tracker._pid = None


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def result(cell: dict, run, ref: dict, trace: bool, kind: str) -> dict:
    from . import check, spec, weights

    worst: dict = {}
    correct, compared = check.judge(check.numbers(run, ref, worst),
                                    cell["config"]["limits"])
    names = weights.names(run.model)
    print("worst leaf " + " ".join(f"{k}={names[i] if i >= 0 else None}"
                                   for k, i in worst.items()), file=sys.stderr)
    injected = [f for f in run.faults if f["injected"]]
    failed = (len(run.errors) + run.false_trips + (run.aborted is not None)
              + sum(1 for f in injected if not f.get("restarted")))
    metrics = spec.read_metrics(cell["per_layer" if trace else "end_to_end"], run)
    device = {"platform": "gpu", "kind": kind, "count": cell["chips"],
              "memory_peak_bytes": run.memory_peak_bytes}
    out = {"correct": correct, "attempted": run.steps + len(injected),
           "failed": failed, "metrics": metrics, "device": device}
    if trace and run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        out["breakdown"] = {"device_ops": run.trace.top_ops(10),
                            "idle_gaps": run.trace.top_gaps(run.spans, 10)}
    out["compared"] = compared
    return out


def main(argv=None) -> int:
    args = parse(argv)
    from . import spec

    _caches(spec.ROOT)
    import torch

    cell = spec.cell(spec.benchmark(), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA card(s); "
              f"this machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    from . import driver

    run = driver.run(cell["config"], cell["traffic"], args.seed, args.seconds,
                     bool(args.trace), "cuda", T_START)
    print("setup " + " ".join(f"{k}={v}" for k, v in run.marks), file=sys.stderr)
    for f in run.faults:
        print("fault " + " ".join(f"{k}={f[k]!r}" for k in (
            "class", "detect_ms", "abort_ms", "init_ms", "load_ms", "ladder")
            if k in f), file=sys.stderr)
    if run.window_s is None:
        print(f"portbench: the window did not close: {run.aborted} "
              f"{run.errors}", file=sys.stderr)
        return 1
    ref = spec.reference(cell["config"]).train(
        cell["config"], args.seed, device="cuda", against=run.grad_first)
    out = result(cell, run, ref, bool(args.trace), torch.cuda.get_device_name(0))
    loaded = forbidden_modules()
    if loaded:
        print(f"portbench: JAX or the JAX package was loaded: {loaded}",
              file=sys.stderr)
        return 3
    if run.trace is not None:
        print("device seconds by kind " + " ".join(
            f"{k}={v:.4f}" for k, v in sorted(run.trace.families().items())),
            file=sys.stderr)
    for name, c in out["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    rc = main()
    stop_helpers()
    sys.exit(rc)
