"""BENCHMARK.json against the files the harness finds by name, the trace
reduction, and the fault timeline (CPU)."""

import importlib
import json
import os
import re

import pytest

from portbench import schedule, spec
from portbench.trace import Trace

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
BENCH = spec.benchmark()


def test_every_name_finds_its_files():
    for conf in BENCH["configs"]:
        assert NAME.match(conf["name"])
        cfg = spec.config(conf)
        assert set(cfg["limits"]) >= {"loss_gap", "grad_gap", "grad_diff", "change_gap"}
    for cell in BENCH["workloads"]:
        assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
        got = spec.cell(BENCH, cell["name"])
        assert got["end_to_end"] and got["per_layer"]
        assert any(m["name"] == "setup_s" for m in got["end_to_end"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"])
        assert os.path.exists(os.path.join(spec.HERE, "metrics", m["name"] + ".py"))
        assert callable(spec.reader(m["name"]))


def test_readers_find_nothing_in_an_empty_run():
    class Empty:
        trace, steps, window_s, setup_s = None, 0, None, None
        faults, step_gaps_ms = [], []

    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert spec.reader(m["name"])(Empty()) is None, m["name"]


def test_trace_union_gaps_and_names():
    t = Trace(0, 100, {"gemm": [2, 30], "copy": [1, 50]},
              [(10, 20), (15, 40), (60, 70), (90, 120)])
    assert t.busy_s * 1e9 == pytest.approx(50)
    assert t.gaps == [(0, 10), (40, 60), (70, 90)]
    assert t.idle_share() == pytest.approx(50.0)
    assert t.matching("gem") == (2, 30)
    spans = [("step", 0, 50), ("restore", 45, 80)]
    assert [g[0] for g in t.top_gaps(spans)] == ["restore", "restore", "step"]
    assert Trace(0, 100, {}, []).idle_share() is None
    fam = Trace(0, 10, {"nvjet_tst_256x128": [1, 4e9], "local_max_args_kernel": [2, 1e9],
                        "vectorized_elementwise_kernel": [1, 2e9], "x": [1, 1e9]},
                []).families()
    assert fam == {"matmul": 4.0, "kernel1": 1.0, "elementwise": 2.0, "other": 1.0}


@pytest.mark.parametrize("seed", [1, 2**31 + 7, 5_000_000_021])
def test_every_seed_gets_the_same_faults_in_another_order(seed):
    spec_ = {"first_s": 5.0, "gaps_s": [8.0, 9.5, 12.0], "classes": ["a", "b"]}
    plan = schedule.fault_times(spec_, seed, 51.0)
    assert plan == schedule.fault_times(spec_, seed, 51.0)
    assert len(plan) == 4 and plan[0][0] == spec_["first_s"]
    gaps = sorted(b[0] - a[0] for a, b in zip(plan, plan[1:]))
    assert gaps == sorted(spec_["gaps_s"])
    assert [c for _, c in plan] == ["a", "b", "a", "b"]  # the file's order
    orders = {tuple(t for t, _ in schedule.fault_times(spec_, s, 51.0))
              for s in range(seed, seed + 16)}
    assert len(orders) > 1  # the seed orders the gaps
    assert schedule.fault_times(spec_, seed, 20.0) == plan[:2]
    assert schedule.fault_times(None, seed, 51.0) == []


@pytest.mark.parametrize("seed", [1, 5_000_000_021])
def test_the_fault_cell_has_the_same_timeline_on_every_seed(seed):
    spec_ = spec.traffic("faults")["faults"]
    assert schedule.fault_times(spec_, seed, 51.0) == schedule.fault_times(spec_, 7, 51.0)


def test_every_named_module_is_there():
    """Each configuration's reference and each traffic file's fault class
    are found by name."""
    for conf in BENCH["configs"]:
        ref = spec.reference(spec.config(conf))
        assert callable(ref.train) and 0 < ref.B1 < 1
    for cell in BENCH["workloads"]:
        for cls in (spec.traffic(cell["traffic"]).get("faults") or {}).get("classes", []):
            assert NAME.match(cls)
            mod = importlib.import_module(f"portbench.faults.{cls}")
            assert callable(mod.fire)


def test_sizes_are_read_from_either_naming(tmp_path):
    gpt2 = {"n_embd": 8, "n_head": 2, "n_layer": 1, "n_positions": 4,
            "n_inner": None, "vocab_size": 16}
    hf = {"hidden_size": 8, "num_attention_heads": 2, "num_hidden_layers": 1,
          "max_position_embeddings": 4, "intermediate_size": 32, "vocab_size": 16}
    want = {"vocab": 16, "d_model": 8, "n_heads": 2, "n_layers": 1, "d_ff": 32,
            "max_seq": 4}
    for i, cfg in enumerate((gpt2, hf)):
        (tmp_path / f"{i}.json").write_text(json.dumps(cfg))
        got = spec.config({"file": f"{i}.json"}, root=str(tmp_path))["model"]
        assert got == want
    (tmp_path / "bad.json").write_text(json.dumps({"vocab_size": 16}))
    with pytest.raises(SystemExit):
        spec.config({"file": "bad.json"}, root=str(tmp_path))
