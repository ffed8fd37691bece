"""The quorum local max kernels of the port (``ops/csrc/quorum_max.cu``
behind ``tpu_resiliency_torch/ops/quorum.py``), on the CPU:

- the by-value entry's plain version (``local_max_host`` on a CPU ``out``)
  equals the JAX package's ``jnp.max`` oracle, ``make_local_max(False)``,
  exactly (int32, no tolerance);
- the route choice and the pointer kernel's launch plan (grid, scalar head
  up to the 16-byte boundary, vectors, scalar tail) are plain Python,
  checked here by replaying the kernel's partition in numpy;
- a world-1 gloo lane and a fused step reduce through the new entry.

The kernels themselves are held against their plain versions on the card
in ``tests/test_torch_quorum_card.py``.

Each test walks its cases in a loop and names the case in its assertion
messages.  The file holds few test items on purpose: tier-1's
``--dist loadfile`` queues files by item count, so a file this size is
queued near the end and leaves the schedule of the files ahead of it as it
was.  A larger one moved ``tests/test_detection.py``'s timing tests beside
heavier neighbours, where they false-tripped.
"""

import itertools

import numpy as np
import pytest
import torch

import tpu_resiliency_torch.ops.quorum as tq
from tpu_resiliency_torch.parallel import init_distributed, make_mesh

K = tq.BY_VALUE_MAX
H100_SMS = 132


@pytest.fixture(scope="module")
def jq():
    return pytest.importorskip("tpu_resiliency.ops.quorum")


@pytest.fixture(scope="module")
def mesh1():
    init_distributed(device="cpu")
    return make_mesh(("all",), device="cpu")


def _ages(kind: str, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.integers(0, 2 ** 31 - 1, size=n, dtype=np.int64).astype(np.int32)
    if kind == "packed":
        return tq.pack_age_device(rng.integers(0, 2 ** 16, size=n),
                                  rng.integers(0, 0x10000, size=n))
    if kind == "zeros":
        return np.zeros(n, dtype=np.int32)
    if kind == "int_max":
        x = rng.integers(0, 1000, size=n, dtype=np.int64).astype(np.int32)
        x[n // 2] = 2 ** 31 - 1
        return x
    # all negative: the kernels compute max(x), not max(max(x), 0)
    return rng.integers(-2 ** 31, 0, size=n, dtype=np.int64).astype(np.int32)


# -- by-value entry: plain version against the jnp.max oracle -----------------


def test_host_entry_matches_jax_oracle(jq):
    for kind in ("random", "packed", "zeros", "int_max"):
        for n in (1, 2, K - 1, K):
            ages = _ages(kind, n, seed=n)
            oracle = int(jq.make_local_max(False)(ages))
            out = torch.full((1,), -1, dtype=torch.int32)
            before = tq.local_max.launches
            assert tq.local_max_host(ages, out) is out, (kind, n)
            assert int(out[0]) == oracle == int(
                tq.local_max_host_reference(ages)[0]), (kind, n)
            # a CPU out launches nothing
            assert tq.local_max.launches == before, (kind, n)


def test_host_entry_refuses_bad_input():
    ages = np.arange(4, dtype=np.int32)
    out = torch.empty(1, dtype=torch.int32)
    cases = {
        "int64": (ages.astype(np.int64), out, TypeError),
        "list": ([1, 2], out, TypeError),
        "empty": (ages[:0], out, ValueError),
        "too_many": (np.arange(K + 1, dtype=np.int32), out, ValueError),
        "2d": (ages.reshape(2, 2), out, ValueError),
        "out_int64": (ages, out.long(), ValueError),
        "out_meta": (ages, torch.empty(1, dtype=torch.int32, device="meta"),
                     ValueError),
    }
    for bad, (a, o, err) in cases.items():
        with pytest.raises(err):
            tq.local_max_host(a, o)
            pytest.fail(f"accepted {bad}")


# -- route choice and launch plan: plain Python --------------------------------

_PLAN_SIZES = (1, K, K + 1, 1025, (1 << 20) + 3)


def test_route_by_value_up_to_k():
    for n in _PLAN_SIZES:
        assert tq.local_max_route(n) == ("by_value" if n <= K else "pointer"), n


def _replay_plan(values: np.ndarray, grid: int, head: int, nvec: int) -> tuple:
    """The kernel's partition in numpy: which elements each part reads, and
    the max over the grid-stride loop's per-block maxima."""
    n = values.size
    threads = tq._THREADS
    stride = grid * threads
    seen = np.zeros(n, dtype=np.int64)
    seen[:head] += 1
    vec = np.arange(nvec)
    for lane in range(4):
        seen[head + 4 * vec + lane] += 1
    seen[head + 4 * nvec:] += 1
    # thread t reads vectors t, t + stride, ...; block b holds threads
    # b*threads .. (b+1)*threads - 1: vector v goes to block
    # (v % stride) // threads, so rows of (rounds, grid, threads) are blocks
    lo = np.iinfo(np.int32).min
    vec_max = np.full(-(-nvec // stride) * stride, lo, dtype=np.int64)
    vec_max[:nvec] = values[head:head + 4 * nvec].reshape(-1, 4).max(axis=1)
    block_max = vec_max.reshape(-1, grid, threads).max(axis=(0, 2), initial=lo)
    scalars = np.r_[np.arange(head), np.arange(head + 4 * nvec, n)]
    np.maximum.at(block_max, (scalars % stride) // threads, values[scalars])
    return seen, int(block_max.max())


def test_plan_reads_every_element_once_at_alignment():
    """At each start offset of an int32 view, the head reaches the 16-byte
    boundary, the vectors are aligned, the tail is under one vector, and
    the grid-stride partition reads every element exactly once."""
    for n, offset in itertools.product(_PLAN_SIZES, range(4)):
        base = torch.arange(n + 8, dtype=torch.int32)
        lead = (-(base.data_ptr() >> 2)) % 4  # elements up to a 16-byte boundary
        x = base[lead + offset:lead + offset + n]
        assert x.is_contiguous() and (x.data_ptr() >> 2) % 4 == offset
        grid, head, nvec = tq.local_max_plan(n, x.data_ptr(), H100_SMS)
        assert head == min(n, (4 - offset) % 4), (n, offset)
        tail = n - head - 4 * nvec
        assert 0 <= tail < 4 and nvec >= 0, (n, offset)
        if nvec:
            assert (x.data_ptr() + 4 * head) % 16 == 0, (n, offset)
        assert grid == max(1, min(-(-n // tq.PER_BLOCK), 2 * H100_SMS)), (n, offset)
        values = np.random.default_rng(n + offset).integers(
            -2 ** 31, 2 ** 31 - 1, size=n, dtype=np.int64).astype(np.int32)
        seen, got = _replay_plan(values, grid, head, nvec)
        assert (seen == 1).all(), (n, offset)
        assert got == int(values.max()), (n, offset)


def test_plan_grid_caps_at_two_blocks_per_sm():
    assert tq.local_max_plan(1 << 24, 0, H100_SMS)[0] == 2 * H100_SMS
    assert tq.local_max_plan(tq.PER_BLOCK, 0, 0)[0] == 1  # SM count unread
    assert tq.local_max_plan(tq.PER_BLOCK + 1, 0, H100_SMS)[0] == 2


# -- the lanes through the new entry, world-1 gloo ------------------------------


def test_lane_reduce_takes_the_route_and_equals_numpy(mesh1, monkeypatch):
    calls = []
    real_host, real_ptr = tq.local_max_host, tq.local_max
    monkeypatch.setattr(tq, "local_max_host",
                        lambda *a: calls.append("by_value") or real_host(*a))
    monkeypatch.setattr(tq, "local_max",
                        lambda *a: calls.append("pointer") or real_ptr(*a))
    lane = tq._QuorumLane(mesh1, "all", "cpu", own_stream=False)
    for kind in ("random", "packed"):
        for n in (1, K, K + 1):
            calls.clear()
            ages = _ages(kind, n, seed=7 * n)
            assert int(lane.run(ages)) == int(np.max(ages)), (kind, n)
            assert calls == [tq.local_max_route(n)], (kind, n)


def test_fused_step_reduces_packed_ages_through_host_entry(mesh1, monkeypatch):
    calls = []
    real_host = tq.local_max_host
    monkeypatch.setattr(tq, "local_max_host",
                        lambda *a: calls.append(a[0].copy()) or real_host(*a))
    fq = tq.FusedStepQuorum(mesh1, budget_ms=float("inf"), device="cpu")
    stale_units = 3000  # ~98 ms in device quanta
    packed = tq.pack_age_device(np.array([stale_units]), fq._local_idx)
    monkeypatch.setattr(fq, "local_ages", lambda: packed)
    run = fq.fuse(lambda x: x + 1)
    assert float(run(torch.zeros(2))[0]) == 1.0
    fq.check_now()
    units, dev = tq.unpack_age_device(int(np.max(packed)))
    assert fq.last_max_age_ms == tq.units_to_ns(units) / 1e6
    assert fq.last_stale_device == dev == 0
    assert len(calls) == 1 and (calls[0] == packed).all()


def test_fused_step_samples_ages_before_the_step(mesh1, monkeypatch):
    """The ages a fused step reduces are taken before ``step_fn`` runs: a
    step that takes 60 ms leaves no trace in the age it reports."""
    now = [tq.now_stamp_ns()]
    monkeypatch.setattr(tq, "now_stamp_ns", lambda: now[0])
    fq = tq.FusedStepQuorum(mesh1, budget_ms=float("inf"), device="cpu")

    def step(x):
        now[0] += 60_000_000
        return x

    fq.fuse(step)(torch.zeros(1))
    assert fq.check_now() == 0.0
