"""The harness's run with its timed path broken underneath must come out
not correct (CPU, a tiny model; the look for a card is skipped).

Each cell is held to its own configuration's limits.  The faults planted
are the ones a training cell on one card can have: a step that returns its
state unchanged, half of the batch left out with the mean over the rest, an
answer (the step's loss) altered where it is produced; and, in the cell
with faults, a restore that brings nothing back.
"""

import os

import pytest
import torch

from portbench import check, driver, faults, spec
from portbench.reference import decoder

SEED = 4_200_000_123  # above 2**31, as a run's seeds are


def _config(limits: dict) -> dict:
    cfg = {"n_embd": 32, "n_head": 4, "n_layer": 2, "n_positions": 16,
           "n_inner": None, "vocab_size": 64, "seq": 16, "batch": 4,
           "dtype": "float32", "reference_rows": 2, "limits": limits,
           "lr": 1e-3, "reference": "decoder"}
    cfg["model"] = {"vocab": 64, "d_model": 32, "n_heads": 4, "n_layers": 2,
                    "d_ff": 128, "max_seq": 16}
    return cfg


def _traffic(name: str) -> dict:
    traffic = spec.traffic(name)
    if traffic.get("faults"):
        # the cell's classes and order, at gaps a CPU run can hold
        traffic["faults"] = {**traffic["faults"], "first_s": 0.5,
                             "gaps_s": [1.0] * len(traffic["faults"]["gaps_s"])}
    return traffic


def _cells():
    bench = spec.benchmark()
    for w in bench["workloads"]:
        conf = next(c for c in bench["configs"] if c["name"] == w["config"])
        yield w["name"], spec.config(conf)["limits"], w["traffic"]


CELLS = list(_cells())
FAULT_CLASSES = sorted(
    f[:-3] for f in os.listdir(os.path.dirname(faults.__file__))
    if f.endswith(".py") and f != "__init__.py")


def _plant(monkeypatch, fault: str):
    real = driver.program_step

    def broken(model, lr, dtype):
        step, cfg = real(model, lr, dtype)
        if fault == "unchanged":
            from tpu_resiliency_torch.models import transformer as tr

            def faulty(p, o, batch):
                with torch.no_grad():
                    return p, o, tr.loss_fn(p, batch, cfg)
        elif fault == "half_batch":
            def faulty(p, o, batch):
                n = batch[0].shape[0] // 2
                return step(p, o, (batch[0][:n], batch[1][:n]))
        elif fault == "answer_altered":
            def faulty(p, o, batch):
                p, o, loss = step(p, o, batch)
                return p, o, loss * 1.1
        return faulty, cfg

    monkeypatch.setattr(driver, "program_step", broken)


def _judge(limits, traffic, seconds):
    cfg = _config(limits)
    run = driver.run(cfg, _traffic(traffic), SEED, seconds, False, "cpu")
    assert run.window_s is not None, (run.aborted, run.errors)
    ref = decoder.train(cfg, SEED, device="cpu", against=run.grad_first)
    return check.judge(check.numbers(run, ref), limits), run


@pytest.mark.parametrize("cell,limits,traffic", CELLS, ids=[c[0] for c in CELLS])
def test_sound_run_is_correct(cell, limits, traffic):
    (ok, compared), run = _judge(limits, traffic, 2.5 if "faults" in cell else 1.0)
    assert ok, compared
    assert not run.errors and not run.false_trips
    if "faults" in cell:
        planned = len(_traffic(traffic)["faults"]["gaps_s"]) + 1
        assert len(run.restore_mismatch) == len(run.faults) == planned


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "answer_altered"])
@pytest.mark.parametrize("cell,limits,traffic", CELLS, ids=[c[0] for c in CELLS])
def test_broken_step_is_not_correct(monkeypatch, cell, limits, traffic, fault):
    _plant(monkeypatch, fault)
    (ok, compared), _ = _judge(limits, "steady", 0.5)
    assert not ok, compared


def test_restore_that_brings_nothing_back_is_not_correct(monkeypatch):
    from tpu_resiliency_torch.checkpointing.async_ckpt import checkpointer

    monkeypatch.setattr(checkpointer, "load_checkpoint",
                        lambda ckpt_dir, template, **kw: template)
    cell, limits, traffic = next(c for c in CELLS if "faults" in c[0])
    (ok, compared), run = _judge(limits, traffic, 1.5)
    assert not ok and compared["restore_mismatch"]["value"] > 0, compared


@pytest.mark.parametrize("cls", FAULT_CLASSES)
def test_each_fault_class_restarts_and_restores(cls):
    cell, limits, traffic = next(c for c in CELLS if "faults" in c[0])
    plan = {**_traffic(traffic), "faults": {"first_s": 0.5, "gaps_s": [],
                                            "classes": [cls]}}
    cfg = _config(limits)
    run = driver.run(cfg, plan, SEED, 3.0, False, "cpu")
    assert run.window_s is not None, (run.aborted, run.errors)
    assert not run.errors and not run.false_trips
    assert [f["class"] for f in run.faults] == [cls]
    assert run.faults[0].get("restarted") and run.faults[0]["detect_ms"] > 0
    ref = decoder.train(cfg, SEED, device="cpu", against=run.grad_first)
    ok, compared = check.judge(check.numbers(run, ref), limits)
    assert ok, compared


def _children() -> list:
    kids = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[1]) == os.getpid() and fields[0] != "Z":
            kids.append(int(pid))
    return kids


def test_no_process_outlives_the_run():
    from portbench import run as run_mod

    cell, limits, traffic = next(c for c in CELLS if "faults" in c[0])
    before = set(_children())
    driver.run(_config(limits), _traffic(traffic), SEED, 1.5, False, "cpu")
    run_mod.stop_helpers()
    assert set(_children()) - before == set()
