"""Build-on-first-use loader for the port's hand-written CUDA kernels.

Each kernel is a ``.cu`` file under ``ops/csrc/`` with a plain C entry point.
It is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library and
loaded with ctypes; nothing includes PyTorch's headers, so a build takes
seconds.  The library's file name carries a hash of the source and flags, so
an edited source is rebuilt and a stale library is never loaded.  Outputs go
to ``tpu_resiliency_torch/_build/``, which git ignores.

As in ``tpu_resiliency/utils/native.py``, the compiler writes to a
process-unique temporary path that is loaded and then atomically renamed
into place: ranks on one host may build at the same moment, and a
half-written library must never be opened.  Unlike that loader there is no
fallback: a kernel that does not build raises :class:`KernelBuildError`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

from .logging import get_logger

log = get_logger("cuda_build")

PKG_DIR = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
CSRC_DIR = os.path.join(PKG_DIR, "ops", "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# source name -> {"seconds": build time or 0.0 when cached, "log": ptxas output}
build_info: Dict[str, dict] = {}


class KernelBuildError(RuntimeError):
    """A kernel source did not compile or its library did not load."""


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise KernelBuildError("nvcc not found on PATH or in the CUDA toolkit")
    return nvcc


def library_path(source: str) -> str:
    """Where ``ops/csrc/<source>`` builds to, keyed by source and flags."""
    with open(os.path.join(CSRC_DIR, source), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{digest.hexdigest()[:16]}.so")


def _compile(source: str, path: str) -> str:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.build.{os.getpid()}.{threading.get_ident()}"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, source)]
    try:
        proc = subprocess.run(
            cmd, capture_output=True, text=True, timeout=600, check=False
        )
        if proc.returncode != 0:
            raise KernelBuildError(
                f"nvcc failed on {source} (exit {proc.returncode}):\n"
                f"{proc.stderr.strip()}"
            )
        ctypes.CDLL(tmp)  # refuse to publish a library that does not load
        os.replace(tmp, path)
        return proc.stderr.strip()
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _ensure_built(source: str) -> str:
    """Path of the library for ``source``, compiling it when absent."""
    path = library_path(source)
    if not os.path.exists(path):
        t0 = time.monotonic()
        ptxas = _compile(source, path)
        seconds = time.monotonic() - t0
        build_info[source] = {"seconds": seconds, "log": ptxas}
        log.info("built %s in %.1fs", os.path.basename(path), seconds)
    build_info.setdefault(source, {"seconds": 0.0, "log": ""})
    return path


def load_kernel_library(source: str) -> ctypes.CDLL:
    """Load the library built from ``ops/csrc/<source>``, compiling it on
    first use.  Raises :class:`KernelBuildError` when it cannot."""
    with _lock:
        lib = _loaded.get(source)
        if lib is None:
            path = _ensure_built(source)
            try:
                lib = _loaded[source] = ctypes.CDLL(path)
            except OSError as exc:
                raise KernelBuildError(f"cannot load {path}: {exc}") from exc
        return lib


def build_all(sources: Optional[List[str]] = None) -> Dict[str, dict]:
    """Build every kernel source under ``ops/csrc/`` (or ``sources``): one
    ``nvcc`` each, all started together.  Returns :data:`build_info`."""
    if sources is None:
        sources = sorted(s for s in os.listdir(CSRC_DIR) if s.endswith(".cu"))
    with ThreadPoolExecutor(max_workers=max(1, len(sources))) as pool:
        for future in [pool.submit(_ensure_built, s) for s in sources]:
            future.result()
    for source in sources:
        load_kernel_library(source)
    return build_info
