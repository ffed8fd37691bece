"""The control of each cell's comparison, on the card at the cell's size.

The control is the reference put in the program's place in the nearest
precision below the configuration's bf16: float8 e4m3 matrix products.
Beside it, the fault of half of each batch left out, planted in the
reference put in the program's place.  Each must come out not correct
against the configuration's limits on every seed; the readings, printed as
one JSON line per seed, are the upper readings the limits are set below
(``PERF.md``).  Run on the card with

    python -m pytest -m cuda -s portbench/tests/test_portbench_control.py
"""

import gc
import json

import pytest
import torch

from portbench import check, spec
from portbench.reference import decoder

SEEDS = (4_300_000_011, 4_300_000_022, 4_300_000_033)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return "cuda"


def _configs():
    bench = spec.benchmark()
    return [(c["name"], spec.config(c)) for c in bench["configs"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", [n for n, _ in _configs()])
def test_control_and_half_batch_fail(card, name):
    cfg = dict(_configs())[name]
    passed = []
    for seed in SEEDS:
        readings = {}
        for what, kw in (("fp8", {"precision": "fp8"}), ("half_batch", {"half_batch": True})):
            prog = decoder.train(cfg, seed, device=card, keep_grad=True, **kw)
            ref = decoder.train(cfg, seed, device=card, against=prog.pop("grad"))
            readings[what] = check.gaps(prog, ref)
            del prog, ref
            gc.collect()
            torch.cuda.empty_cache()
        print(json.dumps({"config": name, "seed": seed, **readings}), flush=True)
        passed += [(what, seed) for what, gaps in readings.items()
                   if check.judge(gaps, cfg["limits"])[0]]
    assert not passed, passed
