"""The port's quorum lane (``tpu_resiliency_torch/ops/quorum.py``) against
the JAX package, on the CPU.

- The stamp contract is host numpy in both packages: compared bit for bit.
- The local max: on a CPU tensor the port takes its plain version, held
  exactly (int32) against the JAX package's ``jnp.max`` oracle
  (``make_local_max(False)``), which is what the JAX tests run on the CPU.
- The lanes (fused step, tick monitor, tripwire) run on a world-1 gloo
  group and mirror the JAX package's lane tests.
"""

import threading
import time

import numpy as np
import pytest
import torch

import tpu_resiliency_torch.ops.quorum as tq
from tpu_resiliency_torch.parallel import init_distributed, make_mesh

# the reference; absent where only the port is installed (the card's machine
# runs just the ``cuda``-marked tests of tests/test_torch_quorum_kernel.py)
jq = pytest.importorskip("tpu_resiliency.ops.quorum")


@pytest.fixture(scope="module")
def mesh1():
    init_distributed(device="cpu")
    return make_mesh(("all",), device="cpu")


# -- stamp contract: bit-exact ------------------------------------------------

_NOW = 1_760_000_000_123_456_789  # a realistic folded wall-clock stamp


def _stamp_cases():
    rng = np.random.default_rng(1234)
    yield "random", _NOW, rng.integers(0, 2 ** 63 - 1, size=4096, dtype=np.int64)
    yield "recent", _NOW, _NOW - rng.integers(0, 5_000_000_000, size=512)
    # 100 ms after the 2^63 wrap: pre-wrap stamps must read as old, not future
    yield "wrap", 100_000_000, np.array(
        [2 ** 63 - 400_000_000, 99_000_000, 2 ** 63 - 1, 0], dtype=np.int64)
    # future stamps past the half-wrap horizon clamp to 0 (future == fresh)
    yield "future", _NOW, np.array(
        [_NOW + 1, _NOW + 2 ** 62 + 5, _NOW + 1_000_000_000], dtype=np.int64)
    # ages beyond the int32 unit range and the 15-bit identify cap
    yield "saturation", _NOW, np.array(
        [_NOW - (2 ** 31) * tq.DEV_QUANTUM_NS * 4, _NOW - 10_000_000_000,
         _NOW - (tq._AGE_CAP << tq.DEV_SHIFT), _NOW], dtype=np.int64)


@pytest.mark.parametrize(
    "name,now,stamps", list(_stamp_cases()), ids=[c[0] for c in _stamp_cases()]
)
def test_stamp_contract_bit_exact(name, now, stamps):
    """ages, units, packing and unpacking equal the JAX package's, bit for
    bit (tolerance: none — integer math)."""
    ages_j = jq.ages_ns_from_stamps(now, stamps)
    ages_t = tq.ages_ns_from_stamps(now, stamps)
    assert ages_t.dtype == ages_j.dtype == np.uint64
    np.testing.assert_array_equal(ages_t, ages_j)
    units_j, units_t = jq.age_units(ages_j), tq.age_units(ages_t)
    assert units_t.dtype == units_j.dtype == np.int32
    np.testing.assert_array_equal(units_t, units_j)
    devs = np.arange(len(stamps)) % 0x10000
    devs[-1] = 0xFFFF
    packed_j = jq.pack_age_device(units_j, devs)
    packed_t = tq.pack_age_device(units_t, devs)
    assert packed_t.dtype == packed_j.dtype == np.int32
    np.testing.assert_array_equal(packed_t, packed_j)
    for p in packed_t:
        assert tq.unpack_age_device(int(p)) == jq.unpack_age_device(int(p))
    for s in stamps[:64]:
        a_t = tq.clamp_future_ns(tq.stamp_age_ns(now, int(s)))
        assert a_t == jq.clamp_future_ns(jq.stamp_age_ns(now, int(s)))
    assert tq.units_to_ns(int(units_t[0])) == jq.units_to_ns(int(units_j[0]))


def test_stamp_constants_match():
    for name in ("_WRAP_NS", "_HALF_NS", "DEV_SHIFT", "DEV_QUANTUM_NS",
                 "_AGE_CAP", "_AGE_CAP_NS", "AGE_CAP_MS"):
        assert getattr(tq, name) == getattr(jq, name), name


def test_identify_packing_orders_by_age_then_device():
    units = np.array([5, 5, 7, 2], dtype=np.int32)
    packed = tq.pack_age_device(units, np.array([3, 9, 1, 0xFFFF]))
    assert tq.unpack_age_device(int(packed.max())) == (7, 1)
    packed[2] = tq.pack_age_device(np.array([5]), np.array([1]))[0]
    assert tq.unpack_age_device(int(packed.max())) == (5, 9)


# -- local max: plain version against the jnp.max oracle ----------------------

_SIZES = (1, 7, 1023, 1024, 1025, 5000)


@pytest.mark.parametrize("n", _SIZES)
@pytest.mark.parametrize("kind", ["random", "packed", "zeros", "int_max"])
def test_local_max_matches_jax_oracle(n, kind):
    """On a CPU tensor the port's local max equals ``jnp.max`` exactly."""
    rng = np.random.default_rng(n)
    if kind == "random":
        x = rng.integers(0, 2 ** 31 - 1, size=n, dtype=np.int64).astype(np.int32)
    elif kind == "packed":
        x = tq.pack_age_device(rng.integers(0, 2 ** 16, size=n),
                               rng.integers(0, 0x10000, size=n))
    elif kind == "zeros":
        x = np.zeros(n, dtype=np.int32)
    else:
        x = rng.integers(0, 1000, size=n, dtype=np.int64).astype(np.int32)
        x[n // 2] = 2 ** 31 - 1
    oracle = int(jq.make_local_max(False)(x))
    before = tq.local_max.launches
    got = tq.make_local_max()(torch.from_numpy(x))
    assert got.dtype == torch.int32 and got.shape == (1,)
    assert int(got[0]) == oracle == int(tq.local_max_reference(torch.from_numpy(x))[0])
    assert tq.local_max.launches == before  # CPU tensors launch nothing


def test_local_max_writes_given_out_buffer():
    out = torch.full((1,), -1, dtype=torch.int32)
    x = torch.tensor([3, 11, 2], dtype=torch.int32)
    assert tq.local_max(x, out) is out
    assert int(out[0]) == 11


@pytest.mark.parametrize("bad", ["empty", "int64", "2d", "strided", "meta", "out_device"])
def test_local_max_refuses_bad_input(bad):
    x = torch.arange(8, dtype=torch.int32)
    kwargs = {}
    err = ValueError
    if bad == "empty":
        x = torch.empty(0, dtype=torch.int32)
    elif bad == "int64":
        x, err = x.long(), TypeError
    elif bad == "2d":
        x = x.reshape(2, 4)
    elif bad == "strided":
        x = x[::2]
    elif bad == "meta":
        x = torch.empty(8, dtype=torch.int32, device="meta")
    else:
        kwargs["out"] = torch.empty(1, dtype=torch.int32, device="meta")
    with pytest.raises(err):
        tq.local_max(x, **kwargs)


# -- collective fn on a world-1 gloo group -------------------------------------


def test_quorum_fn_identify_and_age_only(mesh1):
    now = tq.now_stamp_ns()
    age_ns, dev = tq.make_quorum_fn(mesh1, identify=True, device="cpu")(
        np.array([now - 500_000_000], dtype=np.int64))
    assert 500_000_000 <= age_ns < 2_000_000_000 and dev == 0
    age_only = tq.make_quorum_fn(mesh1, device="cpu")(
        np.array([now - 300_000_000], dtype=np.int64))
    assert 300_000_000 <= age_only < 2_000_000_000


def test_quorum_fn_wrap_safe_with_patched_clock(mesh1, monkeypatch):
    """A hung rank's pre-wrap stamp dominates; ``now_stamp_ns`` is looked up
    at call time, so patching the module global steers the fn."""
    now = 100_000_000
    monkeypatch.setattr(tq, "now_stamp_ns", lambda: now)
    fn = tq.make_quorum_fn(mesh1, device="cpu")
    assert 400_000_000 <= fn(np.array([tq._WRAP_NS - 400_000_000])) < 800_000_000
    assert fn(np.array([now + 5], dtype=np.int64)) == 0  # future == fresh


def test_quorum_fn_non_blocking_readback(mesh1):
    fn = tq.make_quorum_fn(mesh1, blocking=False, identify=True, device="cpu")
    pending = fn(np.array([tq.now_stamp_ns()], dtype=np.int64))
    age_ns, dev = fn.finish(int(pending))
    assert age_ns < 1_000_000_000 and dev == 0
    assert fn.n_local == 1


def test_quorum_reduce_caches_fn_per_mesh(mesh1):
    now = tq.now_stamp_ns()
    assert tq.quorum_reduce(mesh1, np.array([now - 200_000_000]), device="cpu") >= 200_000_000
    fn = tq._FN_CACHE[id(mesh1)]
    tq.quorum_reduce(mesh1, np.array([now]), device="cpu")
    assert tq._FN_CACHE[id(mesh1)] is fn


def test_quorum_fn_refuses_device_mismatch(mesh1, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(ValueError, match="does not match"):
        tq.make_quorum_fn(mesh1, device="cuda")


# -- FusedStepQuorum: mirrors tests/test_detection.py ------------------------


def test_fused_step_quorum_healthy_and_stale(mesh1):
    trips = []
    fq = tq.FusedStepQuorum(mesh1, budget_ms=100.0, device="cpu",
                            on_stale=lambda a, d: trips.append((a, d)))
    run = fq.fuse(lambda x: x * 2 + 1)
    x = torch.ones(8)
    for _ in range(4):
        fq.beat()
        x = run(x)
    assert fq.check_now() is not None
    assert not trips, trips
    assert fq.last_max_age_ms < 100.0
    # freeze the stamp: the NEXT fused step's reduce carries the stale age
    fq._last_beat_ns = (tq.now_stamp_ns() - 500_000_000) % tq._WRAP_NS
    x = run(x)
    fq.check_now()
    assert trips and trips[0][0] > 100.0
    assert trips[0][1] == 0
    assert float(x[0]) > 0  # step outputs still flow


def test_fused_step_quorum_one_step_lag(mesh1):
    fq = tq.FusedStepQuorum(mesh1, budget_ms=float("inf"), device="cpu")
    run = fq.fuse(lambda x: x + 1)
    fq.beat()
    run(torch.zeros(4))
    assert fq.last_max_age_ms is None      # nothing evaluated yet
    run(torch.zeros(4))
    assert fq.last_max_age_ms is not None  # step 2 evaluated step 1's reduce
    assert fq.check_now() is not None      # drain the in-flight one
    assert fq.check_now() is None


def test_fused_step_quorum_budget_clamped_to_cap(mesh1):
    fq = tq.FusedStepQuorum(mesh1, budget_ms=5000.0, device="cpu")
    assert fq.budget_ms == pytest.approx(tq.AGE_CAP_MS)
    fq_inf = tq.FusedStepQuorum(mesh1, budget_ms=float("inf"), device="cpu")
    assert fq_inf.budget_ms == float("inf")  # disabled-lane sentinel kept


def test_fused_matches_collective_fn(mesh1):
    stale_ns = 300_000_000
    fq = tq.FusedStepQuorum(mesh1, budget_ms=float("inf"), device="cpu")
    fq._last_beat_ns = (tq.now_stamp_ns() - stale_ns) % tq._WRAP_NS
    fq.fuse(lambda x: x)(torch.zeros(2))
    age_fused = fq.check_now()
    fn = tq.make_quorum_fn(mesh1, identify=True, device="cpu")
    age_ns, dev = fn(np.full(1, (tq.now_stamp_ns() - stale_ns) % tq._WRAP_NS,
                             dtype=np.int64))
    assert abs(age_fused - age_ns / 1e6) < 250.0  # same stamp, ~same age
    assert dev == fq.last_stale_device == 0


def test_fused_readback_timeout_trips_as_saturated_age(mesh1):
    """A readback that never settles is the staleness signal itself."""
    trips = []
    fq = tq.FusedStepQuorum(mesh1, budget_ms=10.0, device="cpu",
                            on_stale=lambda a, d: trips.append((a, d)))
    gate = threading.Event()

    class Wedged:
        def __int__(self):
            gate.wait(5.0)
            return 0

    try:
        assert fq._materialize_check(Wedged()) == tq.AGE_CAP_MS
    finally:
        gate.set()
    assert trips == [(tq.AGE_CAP_MS, None)]
    assert fq.trip_count == 1


# -- QuorumMonitor: mirrors tests/test_model_and_ops.py -----------------------


def _wait_for(pred, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.005)
    return pred()


def test_quorum_monitor_detects_stale(mesh1):
    hits = []
    mon = tq.QuorumMonitor(mesh1, budget_ms=100.0, interval=0.01, device="cpu",
                           on_stale=lambda age: hits.append(age))
    mon.start()
    try:
        for _ in range(10):
            mon.beat()
            time.sleep(0.02)
        assert not hits
        t0 = time.monotonic()
        assert _wait_for(lambda: hits)
        assert (time.monotonic() - t0) * 1000 < 2000
    finally:
        mon.stop()
    assert mon.tick_count > 10


def test_quorum_monitor_identify_passes_device_to_on_stale(mesh1):
    hits = []
    mon = tq.QuorumMonitor(mesh1, budget_ms=100.0, interval=0.01, device="cpu",
                           identify=True,
                           on_stale=lambda age, dev: hits.append((age, dev)))
    mon.start()
    try:
        assert _wait_for(lambda: hits)
    finally:
        mon.stop()
    age, dev = hits[0]
    assert age > 100 and dev == 0
    assert mon.last_stale_device == 0


def test_quorum_tick_pipelined(mesh1):
    hits = []
    mon = tq.QuorumMonitor(mesh1, budget_ms=100.0, interval=0.01, device="cpu",
                           on_stale=lambda age: hits.append(age))
    mon.beat()
    assert mon.tick_pipelined() is None      # first call primes the pipe
    age1 = mon.tick_pipelined()
    assert age1 is not None and age1 < 100
    time.sleep(0.15)
    mon.tick_pipelined()
    age = mon.tick_pipelined()
    assert age is not None and age >= 100
    assert hits


def test_quorum_overlapped_loop_and_calibrate(mesh1):
    hits = []
    mon = tq.QuorumMonitor(mesh1, budget_ms=1e9, interval=0.005, device="cpu",
                           on_stale=lambda age: hits.append(age),
                           auto_beat_interval=0.002, fetch_workers=4)
    budget = mon.calibrate(n_ticks=8)
    assert budget >= 5.0
    assert mon.last_calibration_p99_ms is not None
    mon.start()
    try:
        time.sleep(0.3)
        assert not hits, f"false trip on healthy job: {hits}"
        assert mon.last_max_age is not None  # overlapped loop is evaluating
        mon.stop_auto_beat()
        t0 = time.monotonic()
        assert _wait_for(lambda: hits)
        assert (time.monotonic() - t0) * 1000 < 2000
    finally:
        mon.stop()


def test_quorum_online_recalibration(mesh1):
    mon = tq.QuorumMonitor(mesh1, budget_ms=1e9, interval=0.01, device="cpu",
                           online_recalibrate_after=5, online_min_budget_ms=7.0,
                           on_stale=lambda age: None)
    for _ in range(5):
        mon.beat()
        mon.tick()
    assert mon.budget_ms == pytest.approx(
        max(7.0, 3.0 * mon.last_calibration_p99_ms + 2.0))


def test_resume_fences_hang_era_results(mesh1):
    hits = []
    mon = tq.QuorumMonitor(mesh1, budget_ms=50.0, interval=0.01, device="cpu",
                           on_stale=lambda age: hits.append(age))
    mon._last_beat_ns = (tq.now_stamp_ns() - 500_000_000) % tq._WRAP_NS
    mon.tick_pipelined()              # dispatched in the hang era
    mon.resume_auto_beat()            # fence after the dispatch
    mon.tick_pipelined()              # evaluates the fenced result
    assert not hits


def test_quorum_monitor_default_on_stale_records_hang(mesh1):
    from tpu_resiliency_torch.utils.profiling import get_recorder

    mon = tq.QuorumMonitor(mesh1, budget_ms=10.0, device="cpu")
    mon._last_beat_ns = (tq.now_stamp_ns() - 500_000_000) % tq._WRAP_NS
    mon.tick()
    assert get_recorder().events[-1]["event"] == "hang_detected"


@pytest.mark.parametrize("flag", ["native_beat", "futex_tripwire"])
def test_native_lanes_raise_until_their_slice(mesh1, flag):
    with pytest.raises(NotImplementedError, match="NativeBeater"):
        tq.QuorumMonitor(mesh1, device="cpu", **{flag: True})


# -- StampTripwire (event mode) ----------------------------------------------


def test_stamp_tripwire_event_mode_fires_and_rearms():
    ev = threading.Event()
    stamp = [tq.now_stamp_ns()]
    hits = []
    trip = tq.StampTripwire(
        on_stale=hits.append, budget_ms=60.0, event=ev,
        age_ns_fn=lambda: tq.clamp_future_ns(
            tq.stamp_age_ns(tq.now_stamp_ns(), stamp[0])),
    ).start()
    try:
        for _ in range(5):
            stamp[0] = tq.now_stamp_ns()
            ev.set()
            time.sleep(0.02)
        assert not hits
        assert _wait_for(lambda: hits, timeout=3.0)
        assert hits[0] >= 60.0 and trip.trip_count == 1
    finally:
        trip.stop()


def test_stamp_tripwire_requires_event_mode():
    with pytest.raises(NotImplementedError):
        tq.StampTripwire(on_stale=print, beater=object())
    with pytest.raises(ValueError):
        tq.StampTripwire(on_stale=print, event=threading.Event())
