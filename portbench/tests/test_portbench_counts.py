"""The benchmark's operation counts against the plain reference, and the
guard that keeps JAX and the JAX package out of a run (CPU)."""

import os
import subprocess
import sys
import types

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import counts, feed, run, spec, weights
from portbench.reference import decoder

TINY = {"vocab": 96, "d_model": 32, "n_heads": 4, "n_layers": 2, "d_ff": 128,
        "max_seq": 16}


def test_published_step_flops():
    """The counts of the two configurations as the benchmark states them:
    1.0520e13 and 8.749e11 model FLOPs per 1024-token sequence."""
    bench = spec.benchmark()
    got = {c["name"]: counts.train_flops_per_seq(spec.config(c)["model"], 1024)
           for c in bench["configs"]}
    assert round(got["gpt2-xl"] / 1e13, 4) == 1.0520
    assert round(got["gpt2-small"] / 1e11, 3) == 8.749


@pytest.mark.parametrize("rows,seq", [(1, 16), (3, 8)])
def test_step_flops_match_the_reference(rows, seq):
    """Every matrix product of the reference's forward and backward, counted
    by PyTorch, adds up to the benchmark's count exactly."""
    p = [w.to(torch.float32).requires_grad_(True) for w in weights.leaves(
        weights.make(TINY, 7, "cpu", torch.float32))]
    tokens, targets = feed.batch(TINY, 7, 1, rows, seq, "cpu")
    mm = decoder._matmuls("f32")
    with FlopCounterMode(display=False) as fc:
        decoder.nll_sum(p, TINY, tokens, targets, mm).backward()
    assert fc.get_total_flops() == counts.train_flops_per_step(TINY, rows, seq)


def test_local_max_bound():
    assert counts.local_max_bytes(1) == 8
    assert counts.local_max_bound_s(1) == pytest.approx(8 / 3.35e12)


def test_guard_compares_whole_top_level_names(monkeypatch):
    for name in ("tpu_resiliency_torch.fake", "jaxtyping_fake", "flaxen_fake"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert run.forbidden_modules() == []
    for name in ("jax.fake", "jaxlib", "flax.fake", "tpu_resiliency.fake"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert run.forbidden_modules() == ["flax.fake", "jax.fake", "jaxlib",
                                       "tpu_resiliency.fake"]


def test_harness_imports_no_jax():
    """Every module of the harness, the port's parts it drives and the
    reference, imported in a fresh process, load no forbidden module."""
    code = ("import portbench.run, portbench.driver, portbench.trace, "
            "portbench.reference.decoder, portbench.check, portbench.spec\n"
            "import tpu_resiliency_torch.inprocess, tpu_resiliency_torch.straggler, "
            "tpu_resiliency_torch.models.transformer, "
            "tpu_resiliency_torch.checkpointing.async_ckpt.checkpointer\n"
            "for m in spec_metrics: portbench.spec.reader(m)\n"
            "print(portbench.run.forbidden_modules())")
    metrics = [m["name"] for m in spec.benchmark()["per_layer"]
               + spec.benchmark()["end_to_end"]]
    out = subprocess.run(
        [sys.executable, "-c", f"spec_metrics = {metrics!r}\n" + code],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
