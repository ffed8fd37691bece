"""Import hygiene and the device rule of the port (``tpu_resiliency_torch``).

- Every port module imports in a fresh interpreter without pulling in JAX or
  the JAX package (this test process has both loaded by ``conftest.py``, so
  the check runs in a subprocess), and the checkpoint writer process's
  import chain loads without torch.  The port's own name starts with
  ``tpu_resiliency``, so the check is for the exact name ``tpu_resiliency``
  and the ``tpu_resiliency.`` prefix.
- Entry points run on the CUDA card by default and raise without one; they
  never drift to the CPU unless asked.
- The knobs, metric names and flight events the port declares are the JAX
  package's, so one environment and one dashboard serve both (compared
  with the JAX counterpart of every port module loaded in the process, so
  that what other tests imported first does not matter).
- The control plane, the multiplexed and sharded store clients and every
  passive health check load without torch in a fresh interpreter.
- The policy loop (``policy/``), the rest of ``telemetry/`` (exporter,
  aggregate, trace, clock) and the lock-order sanitizer load without torch
  in a fresh interpreter too, and the checkpoint worker's chain stays
  torch-free with its episode adoption (store client, ``telemetry.episode``).
- The attribution plane (the log analyzer the launcher's gate runs inline,
  the LLM backend, the engine, the MCP server), the services (attrsvc,
  smonsvc) and the training-loop callbacks load without torch as well;
  ``utils/memory.py`` and ``checkpointing/dcp_compat.py`` are covered by the
  fresh-interpreter check for JAX.
"""

import importlib
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import tpu_resiliency_torch
from tpu_resiliency_torch.models import transformer as tt
from tpu_resiliency_torch.ops import quorum as tq
from tpu_resiliency_torch.parallel import init_distributed, make_mesh
from tpu_resiliency_torch.utils import cuda_build
from tpu_resiliency_torch.utils.device import resolve_device

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PKG = os.path.dirname(tpu_resiliency_torch.__file__)


def _port_modules():
    mods = []
    for root, _dirs, files in os.walk(PKG):
        for fn in sorted(files):
            if fn.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, fn), REPO)[: -len(".py")]
                mod = rel.replace(os.sep, ".")
                mods.append(mod[: -len(".__init__")] if mod.endswith(".__init__") else mod)
    return sorted(mods)


_HYGIENE_SCRIPT = r"""
import importlib, json, sys
sys.path.insert(0, sys.argv[1])
for mod in json.loads(sys.argv[2]):
    importlib.import_module(mod)
foreign = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
                 or m == "tpu_resiliency" or m.startswith("tpu_resiliency."))
print(json.dumps(foreign))
"""


def test_port_imports_without_jax_or_the_jax_package():
    mods = _port_modules()
    assert "tpu_resiliency_torch.ops.quorum" in mods and len(mods) >= 20
    proc = subprocess.run(
        [sys.executable, "-c", _HYGIENE_SCRIPT, REPO, json.dumps(mods)],
        capture_output=True, text=True, timeout=120, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []

    # The checkpoint writer process runs ``python -m ...async_ckpt.
    # worker_main``: its import chain (the package ``__init__`` files
    # included) holds no torch either.  The checkpointer, which imports
    # torch, loads from the package on first use.
    proc = subprocess.run(
        [sys.executable, "-c", _NO_TORCH_SCRIPT, REPO, json.dumps(_WORKER_CHAIN)],
        capture_output=True, text=True, timeout=120, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
    import tpu_resiliency_torch.checkpointing as ckpt

    assert ckpt.AsyncCheckpointer.__module__.endswith("async_ckpt.checkpointer")
    with pytest.raises(AttributeError):
        ckpt.no_such_name  # noqa: B018


_WORKER_CHAIN = [
    "tpu_resiliency_torch.checkpointing",
    "tpu_resiliency_torch.checkpointing.async_ckpt.worker_main",
    "tpu_resiliency_torch.checkpointing.async_ckpt.writer",
    "tpu_resiliency_torch.checkpointing.async_ckpt.core",
    "tpu_resiliency_torch.checkpointing.async_ckpt.resident",
    "tpu_resiliency_torch.checkpointing.integrity",
    "tpu_resiliency_torch.checkpointing.coverage",
    "tpu_resiliency_torch.utils.dtypes",
    "tpu_resiliency_torch.utils.shm",
    # the worker's episode adoption (a plain store client on every call)
    "tpu_resiliency_torch.store.client",
    "tpu_resiliency_torch.telemetry.episode",
]

_NO_TORCH_SCRIPT = r"""
import importlib, json, sys
sys.path.insert(0, sys.argv[1])
for mod in json.loads(sys.argv[2]):
    importlib.import_module(mod)
print(json.dumps(sorted(m for m in sys.modules if m == "torch"
                        or m.startswith("torch.") or m == "jax"
                        or m.startswith("jax.") or m == "tpu_resiliency"
                        or m.startswith("tpu_resiliency."))))
"""


# the policy loop and the telemetry it reads: pure Python, loaded by a
# job-level controller or a per-rank client beside a live worker
_POLICY_CHAIN = [
    "tpu_resiliency_torch.utils.sanitize",
    *(f"tpu_resiliency_torch.telemetry.{m}" for m in (
        "exporter", "aggregate", "trace", "clock", "registry", "flight",
        "episode")),
    "tpu_resiliency_torch.policy",
    *(f"tpu_resiliency_torch.policy.{m}" for m in (
        "risk", "estimator", "actuator", "evacuation", "controller", "ledger")),
]


# the attribution plane, the operator services and the loop callbacks:
# pure Python beside a live job (the gate's analyzer runs in the launcher)
_ATTRIBUTION_CHAIN = [
    "tpu_resiliency_torch.attribution",
    *(f"tpu_resiliency_torch.attribution.{m}" for m in (
        "base", "combined", "engine", "llm", "log_analyzer", "mcp_server",
        "notify", "trace_analyzer")),
    "tpu_resiliency_torch.services",
    "tpu_resiliency_torch.services.attrsvc",
    "tpu_resiliency_torch.services.smonsvc",
    "tpu_resiliency_torch.integrations",
    "tpu_resiliency_torch.integrations.callbacks",
    "tpu_resiliency_torch.utils.memory",
]


_MONITOR_CHAIN = [
    # the shell reader of a wedged trainer's op rings, and the tree gather
    "tpu_resiliency_torch.straggler",
    "tpu_resiliency_torch.straggler.inspect",
    "tpu_resiliency_torch.store.tree",
    "tpu_resiliency_torch.inprocess",
    "tpu_resiliency_torch.inprocess.monitor_main",
    "tpu_resiliency_torch.inprocess.monitor_process",
    "tpu_resiliency_torch.inprocess.fingerprint",
    "tpu_resiliency_torch.inprocess.store_ops",
    "tpu_resiliency_torch.inprocess.attribution",
    "tpu_resiliency_torch.store",
    "tpu_resiliency_torch.store.server",
]


_LAUNCHER_CHAIN = [
    *(f"tpu_resiliency_torch.fault_tolerance.{m}" for m in (
        "attribution_manager", "config", "cycle_info", "data", "health_gate",
        "per_cycle_logs", "progress_tracker", "rank_monitor_server",
        "rendezvous", "state_machine")),
    "tpu_resiliency_torch.health",
    "tpu_resiliency_torch.store.native",
    "tpu_resiliency_torch.utils.ipc",
    "tpu_resiliency_torch.utils.shm_janitor",
    "tpu_resiliency_torch.utils.log_funnel",
]

# the job-level control plane, the store clients it and the workers use,
# and every passive health check (they run in the launcher and the rank
# monitor beside a live worker: no torch, no CUDA context, no NVML)
_CONTROL_CHAIN = [
    "tpu_resiliency_torch.fault_tolerance.control_plane",
    "tpu_resiliency_torch.store.mux",
    "tpu_resiliency_torch.store.sharding",
    *(f"tpu_resiliency_torch.health.{m}" for m in (
        "base", "daemon", "gpu", "kmsg", "node", "storage", "window")),
]


def test_monitor_process_and_chip_smoke_import_chains():
    """The exec'd monitor process (``python -m ...inprocess.monitor_main``),
    the store server and tree gather, and the straggler package with its
    op-ring reader load without torch, JAX or the JAX package (torch loads
    where a device is resolved); importing ``chip_smoke.py`` pulls in
    neither JAX nor the JAX package."""
    mods = _port_modules()
    for new in ("tpu_resiliency_torch.inprocess.wrap",
                "tpu_resiliency_torch.inprocess.abort",
                "tpu_resiliency_torch.inprocess.rank_assignment",
                "tpu_resiliency_torch.inprocess.quorum_tripwire",
                "tpu_resiliency_torch.store.client",
                "tpu_resiliency_torch.store.server",
                "tpu_resiliency_torch.utils.native",
                "tpu_resiliency_torch.utils.inject_fault",
                "tpu_resiliency_torch.ops.device_spin",
                "tpu_resiliency_torch.policy.ledger",
                "tpu_resiliency_torch.telemetry.episode",
                "tpu_resiliency_torch.attribution.trace_analyzer",
                "tpu_resiliency_torch.parallel.tensor_parallel",
                "tpu_resiliency_torch.parallel.mesh",
                "tpu_resiliency_torch.models.transformer",
                "tpu_resiliency_torch.checkpointing.async_ckpt.staging",
                "tpu_resiliency_torch.checkpointing.async_ckpt.checkpointer",
                "tpu_resiliency_torch.store.tree",
                "tpu_resiliency_torch.checkpointing.local.state_dict",
                "tpu_resiliency_torch.checkpointing.local.replication",
                "tpu_resiliency_torch.checkpointing.local.ici_replication",
                "tpu_resiliency_torch.checkpointing.local.manager",
                "tpu_resiliency_torch.checkpointing.async_ckpt.peer_source",
                "tpu_resiliency_torch.dryrun",
                *(f"tpu_resiliency_torch.fault_tolerance.{m}" for m in (
                    "attribution_manager", "config", "cycle_info", "data",
                    "health_gate", "launcher", "per_cycle_logs",
                    "progress_tracker", "rank_monitor_client",
                    "rank_monitor_server", "rendezvous", "state_machine",
                    "timeouts")),
                "tpu_resiliency_torch.inprocess.nested_restarter",
                "tpu_resiliency_torch.health.base",
                "tpu_resiliency_torch.health.device",
                "tpu_resiliency_torch.health.storage",
                *_CONTROL_CHAIN,
                *_POLICY_CHAIN,
                *_ATTRIBUTION_CHAIN,
                "tpu_resiliency_torch.checkpointing.dcp_compat",
                "tpu_resiliency_torch.store.native",
                "tpu_resiliency_torch.utils.ipc",
                "tpu_resiliency_torch.utils.shm_janitor",
                "tpu_resiliency_torch.utils.log_funnel",
                *(f"tpu_resiliency_torch.straggler.{m}" for m in (
                    "collector", "detector", "inspect", "interval_tracker",
                    "name_mapper", "reporting", "timers", "xla_profile"))):
        assert new in mods, new  # so the fresh-interpreter check covers it
    # the in-job ring's launcher side: the launcher (its first import alone,
    # then the rest), its rank monitors, rendezvous, store, probes and the
    # sweep hold no torch — a CUDA context there would pin card memory for
    # the whole job
    for chain in (["tpu_resiliency_torch.fault_tolerance.launcher"],
                  _MONITOR_CHAIN + _LAUNCHER_CHAIN, _CONTROL_CHAIN,
                  _POLICY_CHAIN, _ATTRIBUTION_CHAIN):
        proc = subprocess.run(
            [sys.executable, "-c", _NO_TORCH_SCRIPT, REPO, json.dumps(chain)],
            capture_output=True, text=True, timeout=120, cwd=REPO,
        )
        assert proc.returncode == 0, proc.stderr[-3000:]
        assert json.loads(proc.stdout.strip().splitlines()[-1]) == [], chain
    proc = subprocess.run(
        [sys.executable, "-c", _HYGIENE_SCRIPT, REPO, json.dumps(["chip_smoke"])],
        capture_output=True, text=True, timeout=120, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        src = f.read()
    assert "import jax" not in src and "from jax" not in src
    assert "from tpu_resiliency." not in src and "import tpu_resiliency." not in src


def test_port_sources_name_no_jax_module():
    """No port source imports JAX or names a JAX-package module path."""
    offenders = []
    for root, _dirs, files in os.walk(PKG):
        for fn in files:
            if not fn.endswith(".py"):
                continue
            path = os.path.join(root, fn)
            with open(path) as f:
                for i, line in enumerate(f, 1):
                    if ("import jax" in line or "from jax" in line
                            or "tpu_resiliency." in line
                            or "from tpu_resiliency " in line):
                        offenders.append(f"{os.path.relpath(path, REPO)}:{i}")
    assert not offenders, offenders


# -- the device rule ---------------------------------------------------------


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture(scope="module")
def cpu_mesh():
    init_distributed(device="cpu")
    return make_mesh(("all",), device="cpu")


CFG = tt.TransformerConfig(vocab=64, d_model=16, n_heads=2, n_layers=1,
                           d_ff=32, max_seq=8)


@pytest.mark.parametrize("entry", [
    "make_mesh", "init_params", "params_from_jax", "make_batch",
    "make_quorum_fn", "FusedStepQuorum", "QuorumMonitor", "quorum_reduce",
])
def test_default_device_entry_points_raise_without_cuda(no_cuda, cpu_mesh, entry):
    calls = {
        "make_mesh": lambda: make_mesh(("all",)),
        "init_params": lambda: tt.init_params(CFG),
        "params_from_jax": lambda: tt.params_from_jax({}, CFG),
        "make_batch": lambda: tt.make_batch(CFG, 1, 4),
        "make_quorum_fn": lambda: tq.make_quorum_fn(cpu_mesh),
        "FusedStepQuorum": lambda: tq.FusedStepQuorum(cpu_mesh),
        "QuorumMonitor": lambda: tq.QuorumMonitor(cpu_mesh),
        "quorum_reduce": lambda: tq.quorum_reduce(cpu_mesh, np.zeros(1, np.int64)),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


def test_resolve_device_rules(no_cuda, cpu_mesh):
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError):
        resolve_device()
    with pytest.raises(ValueError):
        resolve_device("meta")
    # a mesh= entry over a CUDA mesh this process cannot reach raises; it
    # never runs the step on the CPU instead
    from torch.distributed.device_mesh import DeviceMesh

    cuda_mesh = DeviceMesh("cuda", torch.zeros((1, 1), dtype=torch.int64),
                           mesh_dim_names=("data", "model"))
    for call in (lambda: tt.make_train_step(CFG, mesh=cuda_mesh),
                 lambda: tt.init_params(CFG, mesh=cuda_mesh),
                 lambda: tt.make_batch(CFG, 1, 4, mesh=cuda_mesh)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    with pytest.raises(ValueError, match="does not match the cuda mesh"):
        tt.init_params(CFG, device="cpu", mesh=cuda_mesh)
    # a local rank past the host's cards (ranks sharing one card) names no
    # card: init_distributed raises and asks for device=, never cuda:1 or
    # the CPU (a fresh process: this one already has its default group)
    proc = subprocess.run(
        [sys.executable, "-c", _LOCAL_RANK_SCRIPT, REPO],
        capture_output=True, text=True, timeout=120, cwd=REPO,
        env={**os.environ, "TPURX_LOCAL_RANK": "1", "TPURX_WORLD_SIZE": "1"},
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "RAISED TPURX_LOCAL_RANK=1 names no card" in proc.stdout
    # the dryrun spawns no rank without a card unless asked for the CPU
    from tpu_resiliency_torch import dryrun

    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.dryrun_multichip(2)


_LOCAL_RANK_SCRIPT = r"""
import sys
sys.path.insert(0, sys.argv[1])
import torch
torch.cuda.is_available = lambda: True
torch.cuda.device_count = lambda: 1
from tpu_resiliency_torch.parallel import init_distributed
try:
    init_distributed()
except RuntimeError as exc:
    print("RAISED", exc)
"""


# -- the kernel build --------------------------------------------------------


def test_kernel_library_path_keyed_by_source_and_flags(monkeypatch):
    path = cuda_build.library_path("quorum_max.cu")
    assert path.startswith(cuda_build.BUILD_DIR)
    assert path == cuda_build.library_path("quorum_max.cu")
    monkeypatch.setattr(cuda_build, "NVCC_FLAGS", cuda_build.NVCC_FLAGS + ("-g",))
    assert cuda_build.library_path("quorum_max.cu") != path


def test_kernel_build_fails_loudly_without_nvcc(monkeypatch):
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    real_exists = os.path.exists
    monkeypatch.setattr(cuda_build.os.path, "exists",
                        lambda p: False if p.endswith("nvcc") else real_exists(p))
    with pytest.raises(cuda_build.KernelBuildError, match="nvcc not found"):
        cuda_build.find_nvcc()


def test_build_output_is_gitignored():
    rc = subprocess.run(
        ["git", "check-ignore", "-q", "tpu_resiliency_torch/_build/libx.so"],
        cwd=REPO, timeout=30,
    ).returncode
    assert rc == 0


def test_kernel_source_has_plain_c_entry_point():
    with open(os.path.join(cuda_build.CSRC_DIR, "quorum_max.cu")) as f:
        src = f.read()
    for entry in ("tpurx_local_max_i32(", "tpurx_local_max_i32_args(",
                  "tpurx_empty_launch("):
        assert f'extern "C" int {entry}' in src
    assert "cudaGetLastError" in src
    # an integer atomic max is order-independent; blocks combine with it
    # only after a grid barrier has set out[0] to INT_MIN
    assert "cudaLaunchCooperativeKernel(" in src and "this_grid().sync()" in src

    with open(os.path.join(cuda_build.CSRC_DIR, "chunk_fingerprint.cu")) as f:
        src = f.read()
    assert 'extern "C" int tpurx_chunk_fingerprint_batch(' in src
    assert "cudaGetLastError" in src and src.count("cudaMemsetAsync(") == 1
    # the leaf table travels by value, read in place from the parameters
    assert "const __grid_constant__ Table<kRows> table" in src
    # one unsigned atomicAdd per tile and sum: order-independent mod 2^32
    assert src.count("atomicAdd(") == 2
    assert "torch" not in src

    with open(os.path.join(cuda_build.CSRC_DIR, "device_spin.cu")) as f:
        src = f.read()
    for entry in ("tpurx_device_spin_launch(", "tpurx_stream_synchronize("):
        assert f'extern "C" int {entry}' in src
    # the loop condition reads a volatile flag nothing writes: never hoisted
    assert "const volatile int32_t* flag" in src and "while (*flag >= 0)" in src
    assert "cudaGetLastError" in src and "torch" not in src


# -- shared vocabulary with the JAX package ----------------------------------


def test_knobs_match_the_jax_registry():
    from tpu_resiliency.utils import env as jenv
    from tpu_resiliency_torch.utils import env as tenv

    knobs = tenv.all_knobs()
    assert len(knobs) >= 20
    names = {getattr(k, "name", None) or k.prefix for k in knobs}
    # the node-local checkpoint slice's knobs
    assert {"TPURX_CKPT_PEER_TIMEOUT", "TPURX_CKPT_PEER_MEM_TIMEOUT",
            "TPURX_CKPT_PEER_STREAMS", "TPURX_CKPT_SCRUB_INTERVAL",
            "TPURX_LCKPT_REPLICATION", "TPURX_PEER_ADDR"} <= names
    # the in-job ring's knobs, and the TPURX_FT_<FIELD> family
    assert {"TPURX_FT_", "TPURX_NATIVE_STORE", "TPURX_INJECT_NODE_FAILURE",
            "TPURX_RANK_MONITOR_SOCKET", "TPURX_LAUNCHER_IPC_SOCKET",
            "TPURX_LOG_FUNNEL"} <= names
    # the control plane's store clients and the passive health loop
    assert {"TPURX_STORE_SHARDS", "TPURX_STORE_ENDPOINTS", "TPURX_STORE_MUX",
            "TPURX_STORE_AFFINITY", "TPURX_STORE_SPARES",
            "TPURX_NODE_HEALTH_ENDPOINT"} <= names
    # the policy loop, the mesh-shrink rung, the clock and the sanitizer
    assert {"TPURX_SHRINK_MESH", "TPURX_SANITIZE", "TPURX_SANITIZE_WITNESS_PATH",
            "TPURX_CLOCK_CAL_ROUNDS", "TPURX_EVAC", "TPURX_EVAC_RISK_THRESHOLD",
            "TPURX_EVAC_HYSTERESIS_PCT", "TPURX_EVAC_JOIN_TIMEOUT",
            "TPURX_POLICY_INTERVAL_S", "TPURX_POLICY_WINDOW_S",
            "TPURX_POLICY_CADENCE_MIN_S", "TPURX_POLICY_CADENCE_MAX_S",
            "TPURX_POLICY_HYSTERESIS_PCT", "TPURX_POLICY_RISK_THRESHOLD"} <= names
    # the attribution LLM's endpoint
    assert {"TPURX_LLM_BASE_URL", "TPURX_LLM_API_KEY", "TPURX_LLM_MODEL",
            "TPURX_LLM_TIMEOUT_S"} <= names
    # every knob the port's policy and attribution packages read or write is
    # declared
    import re

    for sub in ("policy", "attribution"):
        sub_dir = os.path.join(PKG, sub)
        for fn in os.listdir(sub_dir):
            if fn.endswith(".py"):
                with open(os.path.join(sub_dir, fn)) as f:
                    for attr in re.findall(r"\benv\.([A-Z][A-Z0-9_]+)\b", f.read()):
                        assert isinstance(getattr(tenv, attr), tenv.Knob), (fn, attr)
    for knob in knobs:
        if isinstance(knob, tenv.KnobFamily):
            ref = jenv.lookup(knob.prefix)
            assert isinstance(ref, jenv.KnobFamily), knob.prefix
            assert (knob.doc, knob.group) == (ref.doc, ref.group), knob.prefix
            continue
        ref = jenv.lookup(knob.name)
        assert ref is not None, knob.name
        assert (knob.type, knob.default, knob.doc, knob.fallback) == (
            ref.type, ref.default, ref.doc, ref.fallback), knob.name


def _import_jax_counterparts():
    """Import the JAX package's module of the same path as each port module
    loaded here: registries filled at import time then compare like for
    like."""
    for name in sorted(m for m in sys.modules if m.startswith("tpu_resiliency_torch.")):
        ref = "tpu_resiliency" + name[len("tpu_resiliency_torch"):]
        try:
            found = importlib.util.find_spec(ref) is not None
        except ModuleNotFoundError:
            found = False
        if found:
            importlib.import_module(ref)


def test_metric_names_are_the_jax_package_names():
    import tpu_resiliency.checkpointing.async_ckpt.checkpointer  # noqa: F401
    import tpu_resiliency.parallel.collectives  # noqa: F401
    import tpu_resiliency.ops.quorum  # noqa: F401
    import tpu_resiliency.straggler.detector  # noqa: F401
    import tpu_resiliency.checkpointing.local.manager  # noqa: F401
    import tpu_resiliency_torch.checkpointing.async_ckpt.checkpointer  # noqa: F401
    import tpu_resiliency_torch.checkpointing.local.manager  # noqa: F401
    import tpu_resiliency_torch.straggler.detector  # noqa: F401
    import tpu_resiliency.store.sharding  # noqa: F401
    import tpu_resiliency.health  # noqa: F401
    import tpu_resiliency_torch.store.sharding  # noqa: F401
    import tpu_resiliency_torch.health  # noqa: F401
    import tpu_resiliency.policy  # noqa: F401
    import tpu_resiliency_torch.policy  # noqa: F401
    import tpu_resiliency.services.smonsvc  # noqa: F401
    import tpu_resiliency_torch.services.smonsvc  # noqa: F401
    from tpu_resiliency.telemetry import get_registry as jax_registry
    from tpu_resiliency_torch.telemetry import get_registry

    _import_jax_counterparts()
    port = set(get_registry().names())
    assert {"tpurx_quorum_detect_ns", "tpurx_collective_latency_ns",
            "tpurx_ckpt_saves_total", "tpurx_ckpt_d2h_skipped_bytes_total",
            "tpurx_ckpt_verify_total", "tpurx_beat_jitter_p99_us",
            "tpurx_straggler_report_rounds_total", "tpurx_straggler_score",
            "tpurx_tree_rounds_total", "tpurx_tree_payload_bytes",
            "tpurx_ckpt_restore_source_total", "tpurx_ckpt_fallback_depth",
            "tpurx_ckpt_fallback_loads_total", "tpurx_ckpt_scrub_passes_total",
            "tpurx_ckpt_quarantined_total", "tpurx_store_shard_ops_total",
            "tpurx_store_shard_failovers_total", "tpurx_store_shard_count",
            "tpurx_health_score", "tpurx_kmsg_faults_total",
            "tpurx_health_daemon_unreachable_total",
            "tpurx_health_daemon_unhealthy_total", "tpurx_policy_ticks_total",
            "tpurx_policy_decisions_total", "tpurx_policy_tau_opt_s",
            "tpurx_policy_cadence_s", "tpurx_policy_mtbf_s",
            "tpurx_policy_node_risk", "tpurx_policy_rank_risk",
            "tpurx_policy_goodput_est", "tpurx_evac_stage_ns",
            "tpurx_evac_ranks_total", "tpurx_smonsvc_polls_total",
            "tpurx_smonsvc_poll_errors_total",
            "tpurx_smonsvc_cycles_observed_total", "tpurx_smonsvc_jobs_tracked",
            "tpurx_smonsvc_crash_looping"} <= port
    assert port <= set(jax_registry().names())


def test_flight_events_are_the_jax_package_events():
    import tpu_resiliency.checkpointing.async_ckpt.core  # noqa: F401
    import tpu_resiliency.checkpointing.local.manager  # noqa: F401
    import tpu_resiliency.parallel.collectives  # noqa: F401
    import tpu_resiliency_torch.checkpointing.async_ckpt.core  # noqa: F401
    import tpu_resiliency_torch.checkpointing.local.manager  # noqa: F401
    import tpu_resiliency.store.mux  # noqa: F401
    import tpu_resiliency_torch.store.mux  # noqa: F401
    import tpu_resiliency.policy  # noqa: F401
    import tpu_resiliency_torch.policy  # noqa: F401
    from tpu_resiliency.telemetry import flight as jflight
    from tpu_resiliency_torch.telemetry import flight as tflight

    _import_jax_counterparts()
    names = tflight.event_names()
    assert {"collective.dispatch", "ckpt.drain_begin", "ckpt.drain_end",
            "ckpt.restore_begin", "ckpt.restore_end", "store.failover",
            "policy.decision", "evac.risk_cross", "evac.ckpt_ahead",
            "evac.promote", "evac.join"} <= set(names)
    for name in names:
        assert tflight.event_fields(name) == jflight.event_fields(name), name
