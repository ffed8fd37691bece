"""Device quorum heartbeat: the hang-detection collective on the card.

The port of ``tpu_resiliency/ops/quorum.py``.  Every rank contributes a
heartbeat *age* (now - last beat, wrap-safe on a shared wall-clock epoch);
one all-reduce MAX over the mesh returns the staleness of the oldest
heartbeat anywhere in the job, and any rank observing ``max_age > budget``
knows some rank stalled.  One collective, no host round trip between ranks.

Stamp contract (v3, unchanged from the JAX package; see
``docs/detection.md``):

- **Host domain**: stamps are ``CLOCK_REALTIME`` nanoseconds folded into
  ``[0, 2^63)`` (:func:`now_stamp_ns`).  Age math is wrap-safe mod 2^63
  (:func:`stamp_age_ns`), and any age past the half-wrap horizon can only
  be a FUTURE stamp, so it clamps to 0: future == fresh.  All of it is
  numpy on the host, bit-exact with the JAX package.
- **Device domain**: the collective reduces int32 *ages* quantized to the
  device quantum ``2^15 ns`` (:data:`DEV_QUANTUM_NS`).  The host computes
  the wrap-safe ns age, shifts and clips, so the device only ever compares
  saturating non-negative int32 units.

Layers:

- :func:`local_max_host` and :func:`local_max` — the local reduce, the
  hand-written kernels of ``csrc/quorum_max.cu`` (the counterpart of the
  Pallas kernel of ``make_local_max``).  ``local_max_host`` takes up to
  :data:`BY_VALUE_MAX` ages from the host in the launch itself;
  ``local_max`` takes a tensor already on the card, of any size.  For CPU
  tensors each takes its plain version; nothing else chooses between
  kernel and plain version.
- :func:`make_quorum_fn` — per-rank ages → job-wide max age: the local max
  kernel writes the all-reduce send buffer and one ``all_reduce(MAX)`` over
  the mesh axis follows (:func:`local_max_route` picks the entry).
  Identify mode packs the device index into the same int32
  (:func:`pack_age_device`).
- :class:`FusedStepQuorum` — the same packed reduce issued right after
  every training step on the step's stream, read back one step late.
- :class:`StampTripwire` — event-driven staleness watcher (event mode).
- :class:`QuorumMonitor` — host-side driver: publishes this process's
  stamp, runs the collective on a cadence from a tick thread, reports
  stale devices.

One process drives one card, so ``n_local`` is 1 and the device index a
rank packs is its flat position in the mesh.  Each lane (every quorum fn,
every fused quorum) owns its own process group: the tick thread and the
step thread both issue all-reduces, and on one shared group their order
could differ between ranks, which hangs NCCL and gloo alike.

The native C beater and the futex tripwire (``NativeBeater``, futex mode of
:class:`StampTripwire`) come with a later slice that loads
``native/beat_thread.c`` unchanged.
"""

from __future__ import annotations

import ctypes
import math
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..telemetry import counter, histogram
from ..utils.cuda_build import load_kernel_library
from ..utils.device import DeviceLike, resolve_device
from ..utils.logging import get_logger

log = get_logger("quorum")

_NATIVE_SLICE = (
    "the native beater and the futex tripwire come with the NativeBeater "
    "slice of the port (native/beat_thread.c through utils/native.py)"
)


# -- stamp contract (host ns domain / device quantum) -----------------------

_WRAP_BITS = 63
_WRAP_NS = 1 << _WRAP_BITS          # host epoch fold (int64-safe)
_HALF_NS = 1 << (_WRAP_BITS - 1)    # future==fresh horizon
_MASK_NS = np.uint64(_WRAP_NS - 1)

DEV_SHIFT = 15                      # device quantum: 2^15 ns = 32.768 µs
DEV_QUANTUM_NS = 1 << DEV_SHIFT
_I32_MAX = 2 ** 31 - 1

# identify-mode packing: i32 = clamp(age_units, 0, 2^15-1) << 16 | dev_idx.
# A max over packed values sorts lexicographically by (age, device), so ONE
# collective — the same single int32 all-reduce as the age-only path —
# yields both the job-wide max age AND which device holds it.  16 bits of
# device index covers 65k devices; 15 bits of age in device-quantum units
# saturates at (2^15-1) * 2^15 ns ≈ 1.073 s — identify-mode budgets must sit
# below AGE_CAP_MS (saturated ages still compare correctly, they lose
# magnitude, not ordering).
_AGE_CAP = (1 << 15) - 1            # identify-mode age cap, in quantum units
_AGE_CAP_NS = _AGE_CAP << DEV_SHIFT
AGE_CAP_MS = _AGE_CAP_NS / 1e6      # ≈ 1073.7 ms


def now_stamp_ns() -> int:
    """Wall-clock ns folded into ``[0, 2^63)`` — wall clock so every process
    shares the epoch.  The fold is an identity until year ~2262; the age
    math stays wrap-safe regardless.  Callers look this name up at call
    time, so tests can patch it on the module."""
    return time.time_ns() % _WRAP_NS


def stamp_age_ns(now: int, then: int) -> int:
    """Wrap-safe ns age of ``then`` as seen at ``now`` (both folded)."""
    return (now - then) % _WRAP_NS


def clamp_future_ns(age_ns: int) -> int:
    """future == fresh: an age past the half-wrap horizon can only be a
    stamp from the future (clock skew across processes) — a genuinely stale
    stamp would have tripped eons earlier."""
    return 0 if age_ns > _HALF_NS else age_ns


def ages_ns_from_stamps(now_ns: int, stamps_ns: "np.ndarray") -> "np.ndarray":
    """Vector wrap-safe ages (uint64 ns) with the future==fresh clamp.

    The mod-2^63 subtraction runs in uint64 with a mask — numpy int64 can
    hold neither the 2^63 modulus nor the intermediate difference."""
    local = np.asarray(stamps_ns).astype(np.uint64)
    age = (np.uint64(now_ns) - local) & _MASK_NS
    return np.where(age > np.uint64(_HALF_NS), np.uint64(0), age)


def age_units(age_ns) -> "np.ndarray":
    """ns age → saturating int32 device units (quantum ``2^15 ns``)."""
    units = np.asarray(age_ns).astype(np.uint64) >> np.uint64(DEV_SHIFT)
    return np.minimum(units, np.uint64(_I32_MAX)).astype(np.int32)


def units_to_ns(units: int) -> int:
    return int(units) << DEV_SHIFT


def pack_age_device(age_units_arr: "np.ndarray", device_idx: "np.ndarray") -> "np.ndarray":
    """Pack (age in device-quantum units, device index) into one int32 whose
    max sorts lexicographically by (age, device)."""
    return (
        (np.minimum(np.asarray(age_units_arr, dtype=np.int64), _AGE_CAP)
         .astype(np.int32) << 16)
        | np.asarray(device_idx).astype(np.int32)
    )


def unpack_age_device(packed: int) -> tuple:
    """packed int32 → (age in quantum units, device index)."""
    return packed >> 16, packed & 0xFFFF


# -- telemetry (single declaration site for the detection plane) ------------

_DETECT_NS = histogram(
    "tpurx_quorum_detect_ns",
    "Staleness age observed at trip time (ns), per detection lane "
    "(collective / futex / fused)",
    labels=("lane",),
)
_TRIPWIRE_WAITS = counter(
    "tpurx_quorum_futex_waits_total",
    "Stamp-tripwire wait outcomes (fresh = woken by a beat, stale = "
    "budget elapsed with no beat, error = futex unavailable)",
    labels=("outcome",),
)


# -- the local max kernels ---------------------------------------------------

_KERNEL_SOURCE = "quorum_max.cu"
_kernels: dict = {}

BY_VALUE_MAX = 32       # ages that travel in the launch's parameters
_THREADS = 256          # threads of one block of the pointer kernel
PER_BLOCK = _THREADS * 4 * 4  # elements one block reads per grid pass
_sm_counts: dict = {}   # device index -> SM count


def _kernel(name: str):
    """The ctypes entry point ``name`` of ``csrc/quorum_max.cu``, built on
    first use (never at import: the CPU tests import this module without
    nvcc)."""
    fn = _kernels.get(name)
    if fn is None:
        fn = getattr(load_kernel_library(_KERNEL_SOURCE), name)
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
        fn.argtypes = {
            "tpurx_local_max_i32": [vp, i64, i64, i64, ctypes.c_int, vp,
                                    ctypes.c_int, vp],
            # host ages as bytes: ctypes hands over the buffer's address
            "tpurx_local_max_i32_args": [ctypes.c_char_p, i32, vp,
                                         ctypes.c_int, vp],
            "tpurx_empty_launch": [ctypes.c_int, vp],
        }[name]
        fn.restype = ctypes.c_int
        _kernels[name] = fn
    return fn


def _raw_stream(device_index: int) -> int:
    """The current CUDA stream of a device as a raw handle, without building
    a ``torch.cuda.Stream``."""
    return torch._C._cuda_getCurrentRawStream(device_index)


def _sm_count(device_index: int) -> int:
    count = _sm_counts.get(device_index)
    if count is None:
        count = _sm_counts[device_index] = torch.cuda.get_device_properties(
            device_index).multi_processor_count
    return count


def local_max_route(n: int) -> str:
    """Which entry reduces ``n`` host ages: ``"by_value"`` (they travel in
    the launch, :func:`local_max_host`) for ``n <= BY_VALUE_MAX``, else
    ``"pointer"`` (copied to the card, :func:`local_max`)."""
    return "by_value" if n <= BY_VALUE_MAX else "pointer"


def local_max_plan(n: int, data_ptr: int, sm_count: int) -> tuple:
    """Launch plan of the pointer kernel for ``n`` int32 values at address
    ``data_ptr``: ``(grid, head, nvec)``.  The kernel reads ``head`` scalars
    up to the first 16-byte boundary, ``nvec`` 16-byte vectors, then the
    ``n - head - 4 * nvec < 4`` scalars of the tail.  The grid is
    ``min(ceil(n / PER_BLOCK), 2 * sm_count)`` blocks (``sm_count`` is read
    only when ``n > PER_BLOCK``); more than one block is a cooperative
    launch, so every block must be resident at once."""
    head = min(n, -(data_ptr >> 2) % 4)
    nvec = (n - head) // 4
    grid = 1 if n <= PER_BLOCK else min(-(-n // PER_BLOCK), 2 * sm_count)
    return grid, head, nvec


def local_max_reference(x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the local max: ``int32[1]``."""
    return torch.amax(x).reshape(1)


def local_max_host_reference(ages: np.ndarray) -> torch.Tensor:
    """The plain version of :func:`local_max_host`: ``int32[1]``."""
    return torch.from_numpy(ages).amax().reshape(1)


def _check_out(out: torch.Tensor, device: torch.device) -> None:
    if out.device != device or out.dtype != torch.int32 or out.numel() < 1:
        raise ValueError(
            f"out must be a non-empty int32 tensor on {device}, got "
            f"{out.dtype} on {out.device}"
        )


def local_max(x: torch.Tensor, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Max of the 1-D int32 tensor ``x`` into ``out`` (``int32[1]``, made
    when not given); returns ``out``.

    On a CUDA tensor this launches the pointer kernel on the current stream
    (one launch, planned by :func:`local_max_plan`) and counts it in
    ``local_max.launches`` and ``local_max.launches_pointer``; a launch
    that CUDA refuses raises.  On a CPU tensor it takes
    :func:`local_max_reference`.  The kernel computes
    ``max(x)``; the Pallas kernel it replaces computes ``max(max(x), 0)``
    over its zero padding, the same value for the non-negative ages and
    packed ages the quorum feeds it."""
    if x.dtype != torch.int32:
        raise TypeError(f"local_max takes int32, got {x.dtype}")
    if x.ndim != 1 or not x.is_contiguous():
        raise ValueError(
            f"local_max takes a contiguous 1-D tensor, got {tuple(x.shape)}")
    n = x.numel()
    if n == 0:
        raise ValueError("local_max takes a non-empty tensor")
    if x.is_cuda:
        index = x.get_device()
        if out is None:
            out = torch.empty(1, dtype=torch.int32, device=x.device)
        elif not (out.is_cuda and out.get_device() == index
                  and out.dtype == torch.int32 and out.numel() >= 1):
            _check_out(out, x.device)
        ptr = x.data_ptr()
        grid, head, nvec = local_max_plan(
            n, ptr, _sm_count(index) if n > PER_BLOCK else 0)
        rc = _kernel("tpurx_local_max_i32")(
            ptr, n, head, nvec, grid, out.data_ptr(), index, _raw_stream(index))
        if rc != 0:
            raise RuntimeError(f"quorum local max launch failed: CUDA error {rc}")
        local_max.launches += 1
        local_max.launches_pointer += 1
        return out
    if x.device.type != "cpu":
        raise ValueError(f"local_max runs on CUDA or CPU tensors, not {x.device}")
    if out is None:
        out = torch.empty(1, dtype=torch.int32)
    else:
        _check_out(out, x.device)
    out[:1].copy_(local_max_reference(x))
    return out


local_max.launches = 0           # both routes
local_max.launches_by_value = 0  # local_max_host
local_max.launches_pointer = 0   # local_max


def local_max_host(ages: np.ndarray, out: torch.Tensor) -> torch.Tensor:
    """Max of the 1-D int32 host array ``ages`` (``1 <= n <=
    BY_VALUE_MAX``) into ``out[0]``; returns ``out``.

    For a CUDA ``out`` the values travel in the kernel's launch parameters,
    so this is the one launch between ages on the host and the all-reduce
    send buffer: no pinned staging, no host-to-device copy, and ``ages``
    may change as soon as the call returns.  The call is counted in
    ``local_max.launches`` and ``local_max.launches_by_value``.  For a CPU
    ``out`` it takes :func:`local_max_host_reference`."""
    if not isinstance(ages, np.ndarray) or ages.dtype != np.int32:
        raise TypeError(f"local_max_host takes an int32 numpy array, got {ages!r}")
    n = ages.size
    if ages.ndim != 1 or not 1 <= n <= BY_VALUE_MAX:
        raise ValueError(
            f"local_max_host takes 1..{BY_VALUE_MAX} ages in a 1-D array, got "
            f"shape {ages.shape}")
    if out.is_cuda:
        if out.dtype != torch.int32 or out.numel() < 1:
            _check_out(out, out.device)
        index = out.get_device()
        rc = _kernel("tpurx_local_max_i32_args")(
            ages.tobytes(), n, out.data_ptr(), index, _raw_stream(index))
        if rc != 0:
            raise RuntimeError(f"quorum local max launch failed: CUDA error {rc}")
        local_max.launches += 1
        local_max.launches_by_value += 1
        return out
    if out.device.type != "cpu":
        raise ValueError(f"local_max_host writes CUDA or CPU tensors, not {out.device}")
    _check_out(out, out.device)
    out[:1].copy_(local_max_host_reference(ages))
    return out


def make_local_max() -> Callable:
    """The local reduce the quorum collective runs before its all-reduce.
    Unlike the JAX package there is no flag: :func:`local_max` takes the
    kernel for CUDA tensors and the plain version for CPU tensors."""
    return local_max


# -- per-lane collective plumbing -------------------------------------------


def _mesh_axis_group(mesh, axis: str):
    """A NEW process group over this rank's slice of ``axis`` (every rank
    must call this in the same order — it is a collective)."""
    d = mesh.mesh_dim_names.index(axis)
    ranks = mesh.mesh.movedim(d, -1).reshape(-1, mesh.mesh.shape[d]).tolist()
    group, _ = dist.new_subgroups_by_enumeration(ranks)
    return group


class _Readback:
    """The job-wide packed max of one lane call, materialized by ``int()``.

    On CUDA the value was copied ``non_blocking`` into pinned host memory
    behind a recorded event, so ``int()`` waits for that event only — never
    for work enqueued after it."""

    __slots__ = ("_host", "_event", "_value")

    def __init__(self, out: torch.Tensor):
        if out.device.type == "cuda":
            self._host = torch.empty(1, dtype=torch.int32, pin_memory=True)
            self._host.copy_(out, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
            self._value = None
        else:
            self._host = self._event = None
            self._value = int(out[0])

    def __int__(self) -> int:
        if self._value is None:
            self._event.synchronize()
            self._value = int(self._host[0])
        return self._value


class _QuorumLane:
    """One lane's device, process group and (optionally) private stream."""

    def __init__(self, mesh, axis: str, device: DeviceLike, own_stream: bool):
        self.device = resolve_device(device)
        if self.device.type != mesh.device_type:
            raise ValueError(
                f"device {self.device} does not match the {mesh.device_type} mesh"
            )
        self.axis = axis
        self.group = _mesh_axis_group(mesh, axis)
        flat = mesh.mesh.flatten().tolist()
        self.n_total = len(flat)
        self.n_local = 1  # one process drives one device
        self.local_idx = np.asarray([flat.index(mesh.get_rank())], dtype=np.int32)
        self.stream = (
            torch.cuda.Stream(self.device)
            if own_stream and self.device.type == "cuda" else None
        )

    def to_device(self, ages: np.ndarray) -> torch.Tensor:
        host = torch.from_numpy(np.ascontiguousarray(ages, dtype=np.int32))
        if self.device.type == "cpu":
            return host
        # pinned + non_blocking: the copy never waits for queued work
        return host.pin_memory().to(self.device, non_blocking=True)

    def reduce(self, ages: np.ndarray) -> _Readback:
        """Host ages → local max → all-reduce MAX, on the current stream.
        Up to ``BY_VALUE_MAX`` ages ride the kernel's launch (one launch
        before the all-reduce); more are copied to the card first."""
        ages = np.ascontiguousarray(ages, dtype=np.int32)
        if local_max_route(ages.size) == "by_value":
            out = local_max_host(
                ages, torch.empty(1, dtype=torch.int32, device=self.device))
        else:
            out = local_max(self.to_device(ages))
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=self.group)
        return _Readback(out)

    def run(self, ages: np.ndarray) -> _Readback:
        if self.stream is None:
            return self.reduce(ages)
        with torch.cuda.stream(self.stream):
            return self.reduce(ages)


def _axis_of(mesh, axis_name: Optional[str]) -> str:
    return axis_name or mesh.mesh_dim_names[0]


def make_quorum_fn(
    mesh,
    axis_name: Optional[str] = None,
    blocking: bool = True,
    identify: bool = False,
    device: DeviceLike = None,
) -> Callable:
    """Build the quorum collective over ``mesh`` (a DeviceMesh from
    :func:`~tpu_resiliency_torch.parallel.mesh.make_mesh`).

    Returns fn(local_stamps_ns: int64[n_local]) -> max_age_ns (int): the
    staleness of the OLDEST heartbeat anywhere on the mesh axis, quantized
    to the device quantum (``2^15 ns``).  The reduction runs over wrap-safe
    *ages*, not raw stamps — a min over raw wrapped stamps would let a fresh
    post-wrap stamp mask a pre-wrap hung rank.

    With ``identify=True`` the ages are packed with each device's flat mesh
    index before the reduce and the fn returns ``(max_age_ns,
    stale_device_idx)``.  Identify-mode ages saturate at
    :data:`AGE_CAP_MS` (~1.07 s) — budgets must sit below it.

    On CUDA the fn runs on a stream of its own, so a tick is not queued
    behind the training step the caller's stream is busy with, and on a
    process group of its own (see the module docstring).  ``blocking=False``
    returns the in-flight readback instead of the value; ``int()`` on it
    (or ``fn.finish(int(r))``) completes it.  All ranks must build and call
    the fn together (collective)."""
    lane = _QuorumLane(mesh, _axis_of(mesh, axis_name), device, own_stream=True)

    def _finish(packed: int):
        if not identify:
            return units_to_ns(packed)
        units, dev = unpack_age_device(packed)
        return units_to_ns(units), dev

    def run(local_stamps_ns):
        now = now_stamp_ns()
        ages = age_units(
            ages_ns_from_stamps(now, local_stamps_ns).reshape(lane.n_local)
        )
        if identify:
            ages = pack_age_device(ages, lane.local_idx)
        pending = lane.run(ages)
        if blocking:
            return _finish(int(pending))
        return pending

    run.finish = _finish  # for pipelined callers materializing later
    run.n_local = lane.n_local
    run.lane = lane
    return run


# -- event-driven staleness watcher -----------------------------------------


class StampTripwire:
    """Event-driven staleness watcher on the liveness beat.

    The watcher thread parks in ``threading.Event.wait`` with the detection
    budget as the wait timeout.  A beat wakes it (re-arm); a timeout IS the
    detection — staleness is observed at wake latency, not poll-interval
    granularity.  The wait loop contains **no polling sleep**.  The budget
    is read through ``budget_ms_fn`` every wait, so budget updates and
    suspensions (budget=inf) apply to the *next* wait without restarting
    the thread.

    Only event mode is ported; ``beater=`` (the futex mode over the native
    beater) raises until the NativeBeater slice lands.
    """

    REARM_MS = 200.0  # chunked re-arm wait while suppressed or post-trip

    def __init__(
        self,
        on_stale: Callable[[float], None],
        budget_ms: float = 50.0,
        budget_ms_fn: Optional[Callable[[], float]] = None,
        beater=None,
        event: Optional[threading.Event] = None,
        age_ns_fn: Optional[Callable[[], int]] = None,
        name: str = "tpurx-stamp-tripwire",
    ):
        if beater is not None:
            raise NotImplementedError(_NATIVE_SLICE)
        if event is None:
            raise ValueError("event= is required")
        if age_ns_fn is None:
            raise ValueError("event mode requires age_ns_fn")
        self.on_stale = on_stale
        self._budget_fn = budget_ms_fn or (lambda: budget_ms)
        self.event = event
        self._age_ns_fn = age_ns_fn
        self._stop = False
        self.trip_count = 0
        self.last_trip_age_ms: Optional[float] = None
        self._thread = threading.Thread(target=self._loop, name=name, daemon=True)

    def start(self) -> "StampTripwire":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop = True
        # wake the parked waiter so stop() returns at wake latency too
        self.event.set()
        if self._thread.is_alive():
            self._thread.join(timeout=2)

    def _fire(self, age_ns: int) -> None:
        age_ms = age_ns / 1e6
        self.trip_count += 1
        self.last_trip_age_ms = age_ms
        _TRIPWIRE_WAITS.labels("stale").inc()
        _DETECT_NS.labels("futex").observe(age_ns)
        try:
            self.on_stale(age_ms)
        except Exception:  # noqa: BLE001 - the watcher must survive
            log.exception("stamp tripwire on_stale failed")

    def _loop(self) -> None:
        rearm_s = self.REARM_MS / 1e3
        while not self._stop:
            budget_ms = self._budget_fn()
            finite = math.isfinite(budget_ms)
            beat = self.event.wait(budget_ms / 1e3 if finite else rearm_s)
            if self._stop:
                return
            if beat:
                self.event.clear()
                _TRIPWIRE_WAITS.labels("fresh").inc()
                continue
            if not finite:
                continue
            age_ns = self._age_ns_fn()
            if age_ns / 1e6 <= budget_ms:
                _TRIPWIRE_WAITS.labels("fresh").inc()
                continue
            self._fire(age_ns)
            # re-arm: park until the beat stream resumes
            while not self._stop and not self.event.wait(rearm_s):
                pass
            self.event.clear()


# -- the fused lane ---------------------------------------------------------


class FusedStepQuorum:
    """Job-wide oldest-stamp detection issued with the training step — one
    all-reduce per step, so detection cost is a single collective
    independent of rank count and needs no tick thread.  The tick-thread
    :class:`QuorumMonitor` remains the backstop.

    ``fuse(step_fn)`` returns a step that takes the packed ages on the host
    *before* it dispatches ``step_fn``, runs ``step_fn``, then enqueues the
    local max kernel (the ages ride its launch) and the all-reduce MAX on
    the step's stream and copies the result ``non_blocking`` into pinned
    host memory behind a CUDA event.  Each call materializes the PREVIOUS
    step's result by waiting on that event (one-step result lag, bounded by
    step time): nothing syncs the step just enqueued, so the host stays one
    step ahead of the card as it would without the quorum.

    Budgets must sit below :data:`AGE_CAP_MS` (~1.07 s): the packed age
    saturates there (it loses magnitude, not ordering)."""

    def __init__(
        self,
        mesh,
        axis_name: Optional[str] = None,
        budget_ms: float = 1000.0,
        on_stale: Optional[Callable[[float, int], None]] = None,
        identify: bool = True,
        device: DeviceLike = None,
    ):
        self.axis = _axis_of(mesh, axis_name)
        self.budget_ms = budget_ms
        if identify and math.isfinite(budget_ms) and budget_ms > AGE_CAP_MS:
            # packed ages saturate at the cap: a finite budget above it
            # could never trip — clamp so "stale beyond representable"
            # still fires (inf stays inf: lane-disabled sentinel)
            log.warning(
                "fused-quorum budget %.0fms exceeds the packed age cap; "
                "clamped to %.0fms", budget_ms, AGE_CAP_MS,
            )
            self.budget_ms = AGE_CAP_MS
        self.on_stale = on_stale
        self.identify = identify
        # the step's own stream: the reduce follows the step it rides
        self._lane = _QuorumLane(mesh, self.axis, device, own_stream=False)
        self.n_total = self._lane.n_total
        self.n_local = self._lane.n_local
        self._local_idx = self._lane.local_idx
        self._last_beat_ns = now_stamp_ns()
        self._pending: Optional[_Readback] = None
        self._readback = None  # lazy ResilientCollective (parallel layer)
        self.last_max_age_ms: Optional[float] = None
        self.last_stale_device: Optional[int] = None
        self.trip_count = 0

    def beat(self) -> None:
        self._last_beat_ns = now_stamp_ns()

    # -- host side ---------------------------------------------------------

    def local_ages(self) -> np.ndarray:
        ages_ns = ages_ns_from_stamps(
            now_stamp_ns(),
            np.full(self.n_local, self._last_beat_ns, dtype=np.int64),
        )
        units = age_units(ages_ns)
        if self.identify:
            return pack_age_device(units, self._local_idx)
        return units

    def device_ages(self) -> torch.Tensor:
        return self._lane.to_device(self.local_ages())

    # -- fused step --------------------------------------------------------

    def fuse(self, step_fn: Callable) -> Callable:
        """Wrap ``step_fn`` with the fused quorum reduce.  The returned
        callable has ``step_fn``'s signature; quorum age injection, the
        one-step-lagged check, and trip firing are internal."""

        def run(*args, **kwargs):
            ages = self.local_ages()  # sampled before the step is dispatched
            out = step_fn(*args, **kwargs)
            packed = self._lane.reduce(ages)
            previous, self._pending = self._pending, packed
            if previous is not None:
                # materialize LAST step's reduce — the host readback is THE
                # blockable point of the fused lane, so it rides the
                # resilient-collective deadline lane: a wedged fabric trips
                # CollectiveTimeout (folded into the staleness path below)
                # instead of wedging the step thread
                self._materialize_check(previous)
            return out

        run.check_now = self.check_now
        run.quorum = self
        return run

    def _materialize_check(self, packed: _Readback) -> float:
        rc = self._readback
        if rc is None:
            # lazy: parallel.collectives imports this module (stamp/tripwire
            # machinery), so the wrapper must be built at call time
            from ..parallel.collectives import ResilientCollective
            from ..parallel.degrade import DegradePolicy

            budget = (
                max(self.budget_ms * 4.0, 50.0)
                if math.isfinite(self.budget_ms) else 0.0
            )
            rc = self._readback = ResilientCollective(
                "fused_quorum_readback",
                lambda p: int(p),
                axis=self.axis,
                deadline_ms=budget,  # 0 (budget inf) = inline fast path
                # retry/relayout cannot help a readback: the value either
                # materializes or the fabric is wedged — fail fast into the
                # staleness trip below
                policy=DegradePolicy(rungs=(), retries=0),
            )
        from ..parallel.deadline import CollectiveTimeout

        try:
            value = rc(packed)
        except CollectiveTimeout:
            # the readback itself wedged: that IS the staleness signal —
            # report the saturated age (magnitude lost, ordering correct)
            self.trip_count += 1
            self.last_max_age_ms = AGE_CAP_MS
            self.last_stale_device = None
            _DETECT_NS.labels("fused").observe(int(_AGE_CAP_NS))
            if self.on_stale is not None:
                try:
                    self.on_stale(AGE_CAP_MS, None)
                except Exception:  # noqa: BLE001
                    log.exception("fused-quorum on_stale failed")
            else:
                log.error(
                    "fused quorum: readback wedged past %.0fms deadline "
                    "(axis %s)", rc.budget_ms(), self.axis,
                )
            return AGE_CAP_MS
        return self._check(value)

    def check_now(self) -> Optional[float]:
        """Materialize and check the in-flight packed result (end-of-loop
        drain; also lets tests assert synchronously).  Returns age_ms."""
        if self._pending is None:
            return None
        pending, self._pending = self._pending, None
        return self._materialize_check(pending)

    def _check(self, packed: int) -> float:
        if self.identify:
            units, dev = unpack_age_device(packed)
        else:
            units, dev = packed, None
        age_ns = units_to_ns(units)
        age_ms = age_ns / 1e6
        self.last_max_age_ms = age_ms
        self.last_stale_device = dev
        if age_ms > self.budget_ms:
            self.trip_count += 1
            _DETECT_NS.labels("fused").observe(age_ns)
            if self.on_stale is not None:
                try:
                    self.on_stale(age_ms, dev)
                except Exception:  # noqa: BLE001
                    log.exception("fused-quorum on_stale failed")
            else:
                log.error(
                    "fused quorum: job heartbeat stale by %.3fms (device %s)",
                    age_ms, dev,
                )
        return age_ms


# -- the tick-thread lane ---------------------------------------------------


class QuorumMonitor:
    """Host driver for the device quorum tripwire.

    The workload calls :meth:`beat` every step (a host int write), or an
    auto-beat thread stamps at ``auto_beat_interval``.  A daemon thread
    ticks the collective every ``interval`` seconds and calls
    ``on_stale(age_ms)`` (``on_stale(age_ms, device)`` in identify mode
    when the callback takes two arguments) when the job-wide oldest stamp
    exceeds ``budget_ms``.  Ticks run on the quorum fn's own CUDA stream,
    so they are not queued behind the training step.

    ``native_beat=True`` and ``futex_tripwire=True`` raise until the
    NativeBeater slice lands.
    """

    def __init__(
        self,
        mesh,
        budget_ms: float = 1000.0,
        interval: float = 0.1,
        on_stale: Optional[Callable] = None,
        auto_beat_interval: Optional[float] = None,
        fetch_workers: int = 0,
        identify: bool = False,
        online_recalibrate_after: Optional[int] = None,
        online_min_budget_ms: float = 2.0,
        native_beat: bool = False,
        futex_tripwire: bool = False,
        device: DeviceLike = None,
    ):
        if native_beat or futex_tripwire:
            raise NotImplementedError(_NATIVE_SLICE)
        self.mesh = mesh
        self.device = device
        self.budget_ms = budget_ms
        self.interval = interval
        self.auto_beat_interval = auto_beat_interval
        # >0 enables the overlapped loop: collectives dispatch every
        # ``interval`` and results are evaluated by a fetch thread pool, so
        # detection latency is budget + interval/2 + ONE readback even when
        # the readback round trip dwarfs the interval
        self.fetch_workers = fetch_workers
        self.identify = identify
        self._last_seq = 0

        def _default_on_stale(age):
            from ..utils.profiling import ProfilingEvent, record_event

            log.error("job heartbeat stale by %.1fms", age)
            record_event(ProfilingEvent.HANG_DETECTED, source="quorum", age_ms=age)

        self.on_stale = on_stale or _default_on_stale
        # tripwire callbacks may accept (age_ms, stale_device_idx); plain
        # age-only callbacks keep working
        try:
            import inspect

            n_params = len([
                p for p in inspect.signature(self.on_stale).parameters.values()
                if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
                or p.kind == p.VAR_POSITIONAL
            ])
        except (TypeError, ValueError):
            n_params = 1
        self._on_stale_wants_device = identify and n_params >= 2
        self._fn = make_quorum_fn(mesh, identify=identify, device=device)
        self._fn_async = None
        self._pending = None  # (dispatch_t, readback) in-flight slot
        # results DISPATCHED at or before this fence never fire on_stale —
        # they observed a hang era that a restart has since resolved
        self._fence_t = float("-inf")
        self._last_beat_ns = now_stamp_ns()
        self.beat_event = threading.Event()
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="tpurx-quorum", daemon=True
        )
        self._beater_stop = threading.Event()
        self._beater: Optional[threading.Thread] = None
        self.last_max_age: Optional[float] = None       # ms
        self.last_max_age_ns: Optional[int] = None
        self.last_stale_device: Optional[int] = None
        self.last_calibration_p99_ms: Optional[float] = None
        # Online recalibration: a pre-start calibrate() can only sample an
        # IDLE interpreter, and an idle-calibrated budget undershoots the
        # stamp lateness real training produces (false trips) — so after
        # ``online_recalibrate_after`` healthy ages observed by the RUNNING
        # loop (i.e. under the actual workload), the budget is recomputed
        # once from those in-vivo samples: safety*p99 + margin, floored at
        # ``online_min_budget_ms``.  Tripping ages are excluded (a real
        # hang must not inflate its own detection budget).
        self._recal_after = online_recalibrate_after
        self._recal_min_budget = online_min_budget_ms
        self._recal_ages: list = []
        self._recal_done = False
        self.tick_count = 0  # collectives this monitor dispatched

    def beat(self) -> None:
        self._last_beat_ns = now_stamp_ns()
        self.beat_event.set()

    # -- liveness auto-beat: a daemon thread stamping at
    # ``auto_beat_interval`` proves the interpreter schedules threads —
    # detects process death / GIL-holding wedges independent of step
    # cadence.  Manual ``beat()`` remains the progress signal.
    def _beater_loop(self) -> None:
        while not self._beater_stop.is_set():
            self.beat()
            self._beater_stop.wait(self.auto_beat_interval)

    def _current_stamp(self) -> int:
        """Freshest liveness stamp (ns).  With only the Python beater in
        this slice, that is the last :meth:`beat`."""
        return self._last_beat_ns

    def _start_beater(self) -> None:
        if self.auto_beat_interval is None:
            return
        if self._beater is None or not self._beater.is_alive():
            self._beater_stop.clear()  # un-latch a previous stop_auto_beat
            self._beater = threading.Thread(
                target=self._beater_loop, name="tpurx-quorum-beat", daemon=True
            )
            self._beater.start()

    def stop_auto_beat(self) -> None:
        """Stop the liveness beater (tests and the smoke run simulate a
        wedged process this way — stamps freeze while the tick loop,
        playing the healthy peers' role, keeps reducing)."""
        self._beater_stop.set()
        if self._beater is not None:
            self._beater.join(timeout=2)

    def resume_auto_beat(self) -> None:
        """Re-arm the liveness beater (a rank recovered by the restart ring
        is alive again; its silence must stop reading as a job hang).
        In-flight collectives dispatched during the hang era are fenced:
        their (stale-by-construction) results must not re-trip the ring."""
        self.beat()
        self._fence_t = time.monotonic()
        self._start_beater()

    def calibrate(self, n_ticks: int = 20, safety: float = 3.0,
                  margin_ms: float = 2.0, min_budget_ms: float = 5.0,
                  load_fn: Optional[Callable] = None) -> float:
        """Derive the detection budget from OBSERVED healthy tick ages
        (beat jitter + scheduling noise) instead of a safety factor over the
        beat period alone.  Runs ``n_ticks`` blocking ticks, sets and
        returns ``budget_ms``.

        ``load_fn`` (e.g. one training-step dispatch) runs before each
        calibration tick so the sampled ages embed the GIL/scheduler
        contention of REAL training — a budget calibrated on an idle
        interpreter undershoots the stamp lateness a busy one produces and
        then false-trips.  End-to-end detection = budget + tick cadence +
        one readback; the budget cannot go below the observed p99 healthy
        age times ``safety`` without false positives.  ``min_budget_ms`` is
        an operator floor (the measured p99 is kept in
        ``last_calibration_p99_ms``)."""
        self._start_beater()
        ages = []
        for _ in range(max(3, n_ticks)):
            if load_fn is not None:
                load_fn()
            saved = self.budget_ms
            self.budget_ms = float("inf")  # no trips during calibration
            try:
                ages.append(self.tick())
            finally:
                self.budget_ms = saved
        ages_arr = np.asarray(sorted(ages), dtype=np.float64)
        p99 = float(ages_arr[min(len(ages_arr) - 1, int(0.99 * len(ages_arr)))])
        self.last_calibration_p99_ms = p99
        self.budget_ms = max(min_budget_ms, safety * p99 + margin_ms)
        return self.budget_ms

    def _observe_healthy_age(self, age: float) -> None:
        """Feed the online recalibration with an under-load healthy age."""
        if self._recal_after is None or self._recal_done or age > self.budget_ms:
            return
        self._recal_ages.append(float(age))
        if len(self._recal_ages) < self._recal_after:
            return
        ages = sorted(self._recal_ages)
        p99 = ages[min(len(ages) - 1, int(0.99 * len(ages)))]
        new_budget = max(self._recal_min_budget, 3.0 * p99 + 2.0)
        log.info(
            "quorum online recalibration: budget %.1fms -> %.1fms "
            "(p99 under load %.2fms over %d ticks)",
            self.budget_ms, new_budget, p99, len(ages),
        )
        self.last_calibration_p99_ms = p99
        self.budget_ms = new_budget
        self._recal_done = True
        self._recal_ages = []

    def _split(self, result):
        if self.identify:
            return result
        return result, None

    def _fire(self, age_ms: float, dev: Optional[int], lane: str = "collective") -> None:
        if lane is not None:
            _DETECT_NS.labels(lane).observe(int(age_ms * 1e6))
        if self._on_stale_wants_device:
            self.on_stale(age_ms, dev)
        else:
            self.on_stale(age_ms)

    def _record(self, age_ns: int, dev: Optional[int]) -> float:
        age_ms = age_ns / 1e6
        self.last_max_age = age_ms
        self.last_max_age_ns = age_ns
        self.last_stale_device = dev
        return age_ms

    def _dispatch_stamps(self) -> np.ndarray:
        """This process's stamps for the collective about to be dispatched
        (each call is one dispatch, counted in ``tick_count``)."""
        self.tick_count += 1
        return np.full(self._fn.n_local, self._current_stamp(), dtype=np.int64)

    def tick(self) -> float:
        """One collective; returns the job-wide max heartbeat age (ms,
        quantized to the device quantum)."""
        age_ns, dev = self._split(self._fn(self._dispatch_stamps()))
        age = self._record(age_ns, dev)
        self._observe_healthy_age(age)
        if age > self.budget_ms:
            self._fire(age, dev)
        return age

    def _async_fn(self) -> Callable:
        if self._fn_async is None:
            self._fn_async = make_quorum_fn(
                self.mesh, blocking=False, identify=self.identify,
                device=self.device,
            )
        return self._fn_async

    def tick_pipelined(self) -> Optional[float]:
        """Pipelined variant: dispatch this tick's collective without blocking
        and evaluate the PREVIOUS tick's result.  Hides the device round-trip
        behind the tick interval, at the cost of results lagging one tick
        (bounded, and far under any budget).  Returns the previous age (ms),
        or None on the first call."""
        fn = self._async_fn()
        pending = fn(self._dispatch_stamps())
        previous, self._pending = self._pending, (time.monotonic(), pending)
        if previous is None:
            return None
        t_disp, value = previous
        # int() materializes the already-dispatched result
        age_ns, dev = self._split(fn.finish(int(value)))
        age = self._record(age_ns, dev)
        self._observe_healthy_age(age)
        if age > self.budget_ms and t_disp > self._fence_t:
            self._fire(age, dev)
        return age

    def warmup(self) -> None:
        """Run both collective variants once (communicator set-up, kernel
        build) so the monitor loop's first iteration does not spend that
        time while hangs go unobserved."""
        saved = self.budget_ms
        self.budget_ms = float("inf")
        try:
            self.tick()
            self.tick_pipelined()
            self.tick_pipelined()
            # drain the in-flight dispatch: its host-side age includes the
            # set-up time above and would trip a spurious on_stale as the
            # loop's first evaluated result
            if self._pending is not None:
                int(self._pending[1])
                self._pending = None
        finally:
            self.budget_ms = saved

    def start(self) -> "QuorumMonitor":
        self.beat()
        self._start_beater()
        if self._fn_async is None:
            self.warmup()
        self.beat()
        self._thread.start()
        return self

    def _loop(self) -> None:
        if self.fetch_workers > 0:
            self._loop_overlapped()
            return
        # pipelined ticks: the device round-trip hides behind the interval,
        # so the effective detection cadence is ~interval instead of
        # interval + round-trip (documented one-tick result lag)
        while not self._stop.is_set():
            try:
                self.tick_pipelined()
            except Exception as exc:  # noqa: BLE001
                log.warning("quorum tick failed: %s", exc)
                return
            self._stop.wait(self.interval)

    def _loop_overlapped(self) -> None:
        from concurrent.futures import ThreadPoolExecutor

        fn = self._async_fn()
        lock = threading.Lock()
        inflight = [0]

        def evaluate(seq, t_disp, pending):
            try:
                age_ns, dev = self._split(fn.finish(int(pending)))
            except Exception as exc:  # noqa: BLE001
                log.warning("quorum fetch failed: %s", exc)
                return
            finally:
                with lock:
                    inflight[0] -= 1
            # on_stale stays serialized and at-most-once per dispatch seq
            # (monotonic), matching the single-threaded tick loop's contract
            # — restart machinery wired to it need not be re-entrant
            fire = False
            age = age_ns / 1e6
            with lock:
                if seq > self._last_seq:
                    self._last_seq = seq
                    self._record(age_ns, dev)
                    self._observe_healthy_age(age)
                    fire = age > self.budget_ms and t_disp > self._fence_t
                if fire:
                    self._fire(age, dev)

        # interval == 0 is the DENSE RE-DISPATCHED CHAIN: the next collective
        # dispatches the moment a slot frees, so the cadence term of the
        # detection floor (budget + cadence + readback) collapses from a
        # polling interval to the dispatch cost itself.  The in-flight cap
        # keeps the chain bounded; evaluation stays on the fetch pool.
        seq = 0
        with ThreadPoolExecutor(
            max_workers=self.fetch_workers, thread_name_prefix="tpurx-quorum-fetch"
        ) as pool:
            while not self._stop.is_set():
                with lock:
                    free = inflight[0] < self.fetch_workers
                if free:
                    try:
                        pending = fn(self._dispatch_stamps())
                    except Exception as exc:  # noqa: BLE001
                        log.warning("quorum dispatch failed: %s", exc)
                        return
                    seq += 1
                    with lock:
                        inflight[0] += 1
                    pool.submit(evaluate, seq, time.monotonic(), pending)
                    if self.interval > 0:
                        self._stop.wait(self.interval)
                else:
                    # all slots busy: yield briefly instead of spinning
                    self._stop.wait(self.interval or 0.0002)

    def stop(self) -> None:
        self._stop.set()
        self.stop_auto_beat()
        if self._thread.is_alive():
            self._thread.join(timeout=5)


def quorum_reduce(mesh, stamps_ns, device: DeviceLike = None) -> int:
    """One-shot quorum collective: max heartbeat age (ns) across the mesh
    (builds + caches the fn per mesh)."""
    key = id(mesh)
    fn = _FN_CACHE.get(key)
    if fn is None:
        fn = make_quorum_fn(mesh, device=device)
        _FN_CACHE[key] = fn
    return fn(stamps_ns)


_FN_CACHE: dict = {}
