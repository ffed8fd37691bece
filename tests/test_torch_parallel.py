"""The port's parallel layer (``tpu_resiliency_torch/parallel``) on the CPU.

- Quorum collective parity: four gloo ranks (subprocesses that import only
  torch and the port) against the JAX package's quorum fn on a 4-device CPU
  mesh, on the same stamps with a patched clock.  Integer math end to end,
  so the results must be equal (tolerance: none).
- The collective wrapper's contract on a world-1 gloo group: deadline trips
  typed with op and axis, retry then success, the relayout fallback, the
  shrink rung's refusal until the in-process slice, and the wrapped
  all-reduce MAX.
"""

import json
import os
import socket
import subprocess
import sys
import time

import jax
import numpy as np
import pytest

import tpu_resiliency.ops.quorum as jq
from tpu_resiliency.parallel.degrade import DegradePolicy as JaxDegradePolicy
from tpu_resiliency.parallel.mesh import make_mesh as jax_make_mesh
from tpu_resiliency_torch.inprocess.fingerprint import snapshot_tail
from tpu_resiliency_torch.parallel import collectives as coll_mod
from tpu_resiliency_torch.parallel import init_distributed, make_mesh, mesh_axis_sizes
from tpu_resiliency_torch.parallel.collectives import (
    ResilientCollective,
    device_max_reduce,
    make_timeouts_reduce_fn,
    wrap_collective,
)
from tpu_resiliency_torch.parallel.deadline import CollectiveTimeout, DeadlineLane
from tpu_resiliency_torch.parallel.degrade import DegradePolicy
from tpu_resiliency_torch.parallel.health import SUSPECT_AFTER, health

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
WORLD = 4
NOW = 1_760_000_000_123_456_789

# (name, now, per-rank stamps, identify)
CASES = [
    ("age_only", NOW, [NOW, NOW - 1_000_000, NOW - 500_000_000, NOW - 2_000_000], False),
    ("identify", NOW, [NOW, NOW - 1_000_000, NOW - 500_000_000, NOW - 2_000_000], True),
    ("wrap", 100_000_000, [99_000_000, 2 ** 63 - 400_000_000, 99_000_000, 0], True),
    ("saturation", NOW, [NOW, NOW - 1_000_000, NOW - 2_000_000, NOW - 10_000_000_000], True),
    # stamps ahead of now by less than the half-wrap horizon: future == fresh
    ("future", NOW, [NOW + 5_000_000_000, NOW - 3_000_000, NOW + 1, NOW], False),
    # an age just under the horizon saturates the int32 units
    ("age_saturation", NOW, [NOW - 2 ** 62 + 5, NOW, NOW, NOW], False),
]

# one rank of the gloo world: imports only torch, numpy and the port
_RANK_SCRIPT = r"""
import json, sys
import numpy as np
sys.path.insert(0, sys.argv[1])
import tpu_resiliency_torch.ops.quorum as q
from tpu_resiliency_torch.parallel import init_distributed, make_mesh
rank, world, url = int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
cases = json.loads(sys.argv[5])
init_distributed(init_method=url, world_size=world, rank=rank, device="cpu")
mesh = make_mesh(("all",), (world,), device="cpu")
out = {}
for name, now, stamps, identify in cases:
    q.now_stamp_ns = lambda now=now: now
    fn = q.make_quorum_fn(mesh, identify=identify, device="cpu")
    out[name] = fn(np.array([stamps[rank]], dtype=np.int64))
bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
       or m == "tpu_resiliency" or m.startswith("tpu_resiliency.")]
print(json.dumps({"rank": rank, "out": out, "foreign_modules": bad}), flush=True)
# tear the groups down before exit: left to interpreter shutdown, a gloo
# group's threads are sometimes destroyed while joinable (abort, rc -6)
import torch.distributed as dist
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def gloo_results():
    url = f"tcp://127.0.0.1:{_free_port()}"
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _RANK_SCRIPT, REPO, str(r), str(WORLD), url,
             json.dumps(CASES)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO,
        )
        for r in range(WORLD)
    ]
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-3000:]
            results.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    return sorted(results, key=lambda r: r["rank"])


def _jax_quorum(now, stamps, identify, monkeypatch):
    mesh = jax_make_mesh(("all",), (WORLD,), devices=jax.devices()[:WORLD])
    monkeypatch.setattr(jq, "now_stamp_ns", lambda: now)
    fn = jq.make_quorum_fn(mesh, use_pallas=False, identify=identify)
    return fn(np.asarray(stamps, dtype=np.int64))


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_gloo_quorum_matches_jax_mesh(gloo_results, case, monkeypatch):
    name, now, stamps, identify = case
    want = _jax_quorum(now, stamps, identify, monkeypatch)
    want = list(want) if identify else want
    for res in gloo_results:
        assert not res["foreign_modules"], res["foreign_modules"]
        assert res["out"][name] == want, (res["rank"], name)


def test_gloo_quorum_names_the_stale_rank(gloo_results):
    """The same assertions as the JAX package's own mesh tests."""
    def quantized(ns):
        return (ns >> jq.DEV_SHIFT) << jq.DEV_SHIFT

    out = gloo_results[0]["out"]
    assert out["age_only"] == quantized(500_000_000)
    assert out["identify"] == [quantized(500_000_000), 2]
    assert out["wrap"] == [quantized(500_000_000), 1]
    assert out["saturation"] == [jq.units_to_ns(jq._AGE_CAP), 3]
    assert out["future"] == quantized(3_000_000)
    assert out["age_saturation"] == jq.units_to_ns(2 ** 31 - 1)


# -- the collective wrapper on a world-1 gloo group ---------------------------


@pytest.fixture(scope="module")
def world1():
    return init_distributed(device="cpu")


@pytest.fixture(autouse=True)
def fresh_collective_plane():
    coll_mod._reset_for_tests()
    yield
    coll_mod._reset_for_tests()


def sleeper(seconds, value):
    def fn(*args, **kwargs):
        time.sleep(seconds)
        return value

    return fn


def test_init_distributed_idempotent(world1):
    assert world1.type == "cpu"
    assert init_distributed(device="cpu") is world1


@pytest.mark.parametrize("sizes,want", [((1, 1), (1, 1)), ((-1, 1), (1, 1)), (None, (1, 1))])
def test_make_mesh_shapes(world1, sizes, want):
    mesh = make_mesh(("data", "model"), sizes, device="cpu")
    assert mesh_axis_sizes(mesh) == want
    assert mesh.mesh_dim_names == ("data", "model")


@pytest.mark.parametrize("sizes", [(3,), (2, -1, -1)])
def test_make_mesh_rejects_bad_sizes(world1, sizes):
    with pytest.raises(ValueError):
        make_mesh(tuple("abc"[: len(sizes)]), sizes, device="cpu")


def test_wrapped_op_returns_result_and_stamps_fingerprint():
    calls = []

    def op(a, b, *, k=0):
        calls.append((a, b, k))
        return a + b + k

    c = wrap_collective(op, "add_op", axis="data", deadline_ms=5000.0)
    assert c(1, 2, k=3) == 6
    assert calls == [(1, 2, 3)]
    st = health().route("add_op", "data")
    assert st.ok_count == 1 and st.timeout_count == 0
    assert snapshot_tail()[-1]["op"] == "add_op"


def test_zero_budget_runs_inline():
    import threading

    seen = {}

    def op():
        seen["thread"] = threading.current_thread()
        return 42

    assert ResilientCollective("inline_op", op, deadline_ms=0.0)() == 42
    assert seen["thread"] is threading.current_thread()


def test_op_exception_propagates_untouched():
    def op():
        raise ValueError("not a hang")

    c = ResilientCollective("raiser", op, deadline_ms=5000.0,
                            policy=DegradePolicy(rungs=(), retries=0))
    with pytest.raises(ValueError, match="not a hang"):
        c()
    assert health().route("raiser", "").timeout_count == 0


def test_deadline_trip_raises_typed_timeout_naming_op_and_axis():
    c = ResilientCollective(
        "slow_gather", sleeper(0.6, "late"), axis="model",
        deadline_ms=100.0, policy=DegradePolicy(rungs=(), retries=0),
    )
    with pytest.raises(CollectiveTimeout) as ei:
        c()
    exc = ei.value
    assert (exc.op, exc.axis, exc.budget_ms) == ("slow_gather", "model", 100.0)
    assert "collective 'slow_gather' exceeded its 100ms deadline" in str(exc)
    assert "mesh axis 'model'" in str(exc)
    st = health().route("slow_gather", "model")
    assert st.timeout_count == 1 and st.consecutive_timeouts == 1


def test_lane_abandons_worker_and_serves_next_op():
    lane = DeadlineLane("t-abandon")
    try:
        with pytest.raises(CollectiveTimeout):
            lane.run(sleeper(0.6, None), op="wedged", budget_ms=80.0)
        assert lane.abandoned == 1
        assert lane.run(lambda: "ok", op="next", budget_ms=2000.0) == "ok"
    finally:
        lane.stop()


def test_retry_rung_absorbs_transient_stall():
    attempts = []

    def flaky():
        attempts.append(time.monotonic())
        if len(attempts) == 1:
            time.sleep(0.5)  # first call blows the budget (transient)
        return "recovered"

    c = ResilientCollective("flaky_op", flaky, deadline_ms=120.0,
                            policy=DegradePolicy(rungs=("retry",), retries=2))
    assert c() == "recovered"
    assert len(attempts) == 2
    assert health().route("flaky_op", "").consecutive_timeouts == 0
    assert health().start_rung("flaky_op", "") == ""


def test_relayout_rung_lands_on_fallback_and_biases_route():
    c = ResilientCollective(
        "dead_link", sleeper(0.5, "primary"), axis="data",
        fallback=lambda: "fallback", deadline_ms=80.0,
        policy=DegradePolicy(rungs=("relayout",), retries=0),
    )
    assert c() == "fallback"
    assert health().start_rung("dead_link", "data") == "relayout"


def test_consecutive_timeouts_arm_relayout_bias():
    for _ in range(SUSPECT_AFTER):
        health().note_timeout("flappy", "x")
    assert health().start_rung("flappy", "x") == "relayout"


def test_shrink_rung_raises_until_the_inprocess_slice():
    c = ResilientCollective(
        "wedged_op", sleeper(0.5, None), deadline_ms=60.0,
        policy=DegradePolicy(rungs=("shrink",), retries=0),
    )
    with pytest.raises(NotImplementedError, match="in-process slice"):
        c()


def test_exhausted_ladder_reraises_last_timeout():
    c = ResilientCollective(
        "doomed", sleeper(0.5, None), deadline_ms=60.0,
        policy=DegradePolicy(rungs=("retry",), retries=1),
    )
    with pytest.raises(CollectiveTimeout):
        c()
    assert health().route("doomed", "").timeout_count == 2


@pytest.mark.parametrize("spec,retries", [
    ("retry,shrink,bogus", "7"), ("", "0"), ("relayout", "3"),
])
def test_degrade_policy_from_env_matches_jax(monkeypatch, spec, retries):
    monkeypatch.setenv("TPURX_COLL_DEGRADE", spec)
    monkeypatch.setenv("TPURX_COLL_RETRIES", retries)
    port, ref = DegradePolicy.from_env(), JaxDegradePolicy.from_env()
    assert (port.rungs, port.retries) == (ref.rungs, ref.retries)
    assert port.rungs_from("shrink") == ref.rungs_from("shrink")


def test_env_knobs_read_at_call_time(monkeypatch):
    c = ResilientCollective("knobbed", lambda: 1)
    monkeypatch.setenv("TPURX_COLL_DEADLINE_MS", "123.5")
    assert c.budget_ms() == 123.5


def test_device_max_reduce_world1(world1):
    assert device_max_reduce([1.0, 5.0, -2.0]) == [1.0, 5.0, -2.0]
    fn = make_timeouts_reduce_fn()
    assert fn({"a": 3.0, "b": 7.0}) == {"a": 3.0, "b": 7.0}
    assert health().route("device_max_reduce", "processes").ok_count == 2
