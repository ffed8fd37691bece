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
  package's, so one environment and one dashboard serve both.
"""

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


_MONITOR_CHAIN = [
    "tpu_resiliency_torch.inprocess",
    "tpu_resiliency_torch.inprocess.monitor_main",
    "tpu_resiliency_torch.inprocess.monitor_process",
    "tpu_resiliency_torch.inprocess.fingerprint",
    "tpu_resiliency_torch.inprocess.store_ops",
    "tpu_resiliency_torch.inprocess.attribution",
    "tpu_resiliency_torch.store",
    "tpu_resiliency_torch.store.server",
]


def test_monitor_process_and_chip_smoke_import_chains():
    """The exec'd monitor process (``python -m ...inprocess.monitor_main``)
    and the store server load without torch, JAX or the JAX package (the
    in-process ring's names load their modules on first use); importing
    ``chip_smoke.py`` pulls in neither JAX nor the JAX package."""
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
                "tpu_resiliency_torch.checkpointing.async_ckpt.checkpointer"):
        assert new in mods, new  # so the fresh-interpreter check covers it
    proc = subprocess.run(
        [sys.executable, "-c", _NO_TORCH_SCRIPT, REPO, json.dumps(_MONITOR_CHAIN)],
        capture_output=True, text=True, timeout=120, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
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
    assert 'extern "C" int tpurx_chunk_fingerprint(' in src
    assert "cudaGetLastError" in src and "cudaMemsetAsync" in src
    # one unsigned atomicAdd per block and sum: order-independent mod 2^32
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
    for knob in knobs:
        ref = jenv.lookup(knob.name)
        assert ref is not None, knob.name
        assert (knob.type, knob.default, knob.doc, knob.fallback) == (
            ref.type, ref.default, ref.doc, ref.fallback), knob.name


def test_metric_names_are_the_jax_package_names():
    import tpu_resiliency.checkpointing.async_ckpt.checkpointer  # noqa: F401
    import tpu_resiliency.parallel.collectives  # noqa: F401
    import tpu_resiliency.ops.quorum  # noqa: F401
    import tpu_resiliency_torch.checkpointing.async_ckpt.checkpointer  # noqa: F401
    from tpu_resiliency.telemetry import get_registry as jax_registry
    from tpu_resiliency_torch.telemetry import get_registry

    port = set(get_registry().names())
    assert {"tpurx_quorum_detect_ns", "tpurx_collective_latency_ns",
            "tpurx_ckpt_saves_total", "tpurx_ckpt_d2h_skipped_bytes_total",
            "tpurx_ckpt_verify_total"} <= port
    assert port <= set(jax_registry().names())


def test_flight_events_are_the_jax_package_events():
    import tpu_resiliency.checkpointing.async_ckpt.core  # noqa: F401
    import tpu_resiliency.parallel.collectives  # noqa: F401
    import tpu_resiliency_torch.checkpointing.async_ckpt.core  # noqa: F401
    from tpu_resiliency.telemetry import flight as jflight
    from tpu_resiliency_torch.telemetry import flight as tflight

    names = tflight.event_names()
    assert {"collective.dispatch", "ckpt.drain_begin", "ckpt.drain_end"} <= set(names)
    for name in names:
        assert tflight.event_fields(name) == jflight.event_fields(name), name
