"""Attribution accuracy scoring over an injected-fault batch, for the
PyTorch port.

The port's copy of ``skills/scripts/score_attribution.py``: run a matrix of
KNOWN faults through the port's launcher (``python -m
tpu_resiliency_torch.fault_tolerance.launcher``), attribute each failed
cycle's log with the port's ``LogAnalyzer`` (the path the restart gate
uses), and score category accuracy against the injected ground truth.  The
signatures are the card's (a CUDA out-of-memory error, an uncorrectable ECC
error, an NCCL error) where the JAX script prints XLA's and the TPU's.

    python skills/torch/score_attribution.py [--quick] [--device cpu]

Each scenario launches ``tests/workloads/torch_toy_train.py`` with a fault
injected at a known (cycle, rank, iter) and a signature line printed before
death.  The workers touch the CUDA card unless ``--device cpu`` is given;
without a card and without that flag the script exits non-zero before it
launches anything.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, REPO)

SCENARIOS = [
    # (name, fail_msg, expected_category, expected_resume)
    ("oom_hbm",
     "torch.OutOfMemoryError: CUDA out of memory. Tried to allocate 20.00 GiB. "
     "GPU 0 has a total capacity of 79.19 GiB of which 11.06 GiB is free. "
     "Including non-PyTorch memory, this process has 68.12 GiB memory in use.",
     "oom_hbm", False),
    ("oom_host", "MemoryError: cannot allocate 64GiB on host",
     "oom_host", False),
    ("numerics", "training diverged: loss is nan at step 1200",
     "numerics", False),
    ("device", "RuntimeError: CUDA error: uncorrectable ECC error encountered",
     "device_error", True),
    ("data", "FileNotFoundError: /data/shard-00042.arrayrecord",
     "data", False),
    ("network",
     "torch.distributed.DistBackendError: NCCL error in: "
     "../torch/csrc/distributed/c10d/NCCLUtils.hpp:317, remote process exited "
     "or there was a network error, NCCL version 2.21.5",
     "network", True),
]


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_scenario(name: str, fail_msg: str, log_root: str, device: str) -> str:
    env = dict(os.environ)
    env.update({
        "TPURX_REPO": REPO,
        "TOY_ITERS": "8",
        "TOY_FAIL": "0:1:3",
        "TOY_FAIL_MSG": fail_msg,
        "TOY_CKPT": os.path.join(log_root, f"{name}.progress"),
        "TOY_DEVICE": device,
        "TPURX_FT_ENABLE_DEVICE_HEALTH_CHECK": "0",
        "TPURX_FT_WORKLOAD_CHECK_INTERVAL": "0.1",
        "TPURX_FT_WORKERS_STOP_TIMEOUT": "3.0",
    })
    log_dir = os.path.join(log_root, name)
    try:
        subprocess.run(
            [
                sys.executable, "-m", "tpu_resiliency_torch.fault_tolerance.launcher",
                "--nnodes", "1", "--nproc-per-node", "2",
                "--rdzv-endpoint", f"127.0.0.1:{free_port()}",
                "--host-store", "--max-restarts", "1",
                "--log-dir", log_dir,
                "--monitor-interval", "0.05",
                os.path.join(REPO, "tests", "workloads", "torch_toy_train.py"),
            ],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
        )
    except subprocess.TimeoutExpired:
        # one wedged scenario must not lose the whole batch's score — the
        # cycle log (if any) is still attributable
        print(f"[WARN] {name}: launcher run timed out; scoring whatever "
              "log exists", file=sys.stderr)
    return os.path.join(log_dir, "cycle_0.log")


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--quick", action="store_true",
                   help="first 3 scenarios only")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the workers run (default: the CUDA card)")
    args = p.parse_args()
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("no CUDA device is available; pass --device cpu", file=sys.stderr)
            return 2

    from tpu_resiliency_torch.attribution import LogAnalyzer

    scenarios = SCENARIOS[:3] if args.quick else SCENARIOS
    root = tempfile.mkdtemp(prefix="tpurx-score-")
    analyzer = LogAnalyzer()
    results = []
    for name, msg, want_cat, want_resume in scenarios:
        log_path = run_scenario(name, msg, root, args.device)
        if not os.path.exists(log_path):
            results.append({"scenario": name, "ok": False,
                            "error": "no cycle log produced"})
            continue
        v = analyzer.analyze_file(log_path)
        got_cat = v.category.value if hasattr(v.category, "value") else v.category
        ok = got_cat == want_cat and v.should_resume == want_resume
        results.append({
            "scenario": name, "ok": ok,
            "expected": {"category": want_cat, "resume": want_resume},
            "got": {"category": got_cat, "resume": v.should_resume,
                    "confidence": round(v.confidence, 2),
                    "culprits": v.culprit_ranks},
        })
        mark = "PASS" if ok else "FAIL"
        print(f"[{mark}] {name}: expected {want_cat}/resume={want_resume} "
              f"got {got_cat}/resume={v.should_resume} "
              f"(conf {v.confidence:.2f}, culprits {v.culprit_ranks})")
    correct = sum(1 for r in results if r.get("ok"))
    print(json.dumps({
        "metric": "attribution_accuracy",
        "value": round(correct / len(results), 3),
        "correct": correct, "total": len(results),
        "device": args.device,
        "log_root": root,
    }))
    return 0 if correct == len(results) else 1


if __name__ == "__main__":
    sys.exit(main())
