"""Find a cell's files by the names ``BENCHMARK.json`` gives them.

A cell names a configuration, whose ``file`` holds its sizes, batch,
learning rate, limits and the plain reference it is held against
(``portbench/reference/<reference>.py``), and a traffic mix,
``portbench/traffic/<mix>.json``, whose fault classes are modules of
``portbench/faults/``.  A metric is measured in a cell when it lists the
cell under ``workloads`` or lists no cells; its reader is
``portbench/metrics/<metric>.py``, a module with ``read(run) -> float |
None``.  Adding a cell or a metric adds files and entries and edits none.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from typing import Callable, Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


# the port's model sizes, each under the published keys that may name it:
# GPT-2's first, then the Hugging Face names most other configurations use
SIZE_KEYS = {
    "vocab": ("vocab_size",),
    "d_model": ("n_embd", "hidden_size"),
    "n_heads": ("n_head", "num_attention_heads"),
    "n_layers": ("n_layer", "num_hidden_layers"),
    "d_ff": ("n_inner", "intermediate_size", "ffn_dim"),
    "max_seq": ("n_positions", "max_position_embeddings"),
}


def config(entry: dict, root: str = ROOT) -> dict:
    """The configuration file, with the port's model sizes read from its
    published keys (a d_ff that is absent or null is 4 x d_model)."""
    cfg = _json(os.path.join(root, entry["file"]))
    model = {k: next((cfg[n] for n in names if cfg.get(n) is not None), None)
             for k, names in SIZE_KEYS.items()}
    if model["d_ff"] is None and model["d_model"] is not None:
        model["d_ff"] = 4 * model["d_model"]
    missing = [k for k, v in model.items() if v is None]
    if missing:
        raise SystemExit(f"portbench: {entry['file']} gives no {missing}")
    cfg["model"] = model
    return cfg


def reference(cfg: dict):
    """The plain reference module the configuration names."""
    return importlib.import_module(f"portbench.reference.{cfg['reference']}")


def traffic(name: str) -> dict:
    return _json(os.path.join(HERE, "traffic", f"{name}.json"))


def _in_cell(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(bench: dict, name: str, root: str = ROOT) -> dict:
    """Everything one run of cell ``name`` needs."""
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"portbench: no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return {
        "name": name,
        "chips": entry["chips"],
        "config": config(conf, root),
        "traffic": traffic(entry["traffic"]),
        "end_to_end": [m for m in bench["end_to_end"] if _in_cell(m, name)],
        "per_layer": [m for m in bench["per_layer"] if _in_cell(m, name)],
    }


def reader(metric: str) -> Callable:
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    mod_spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def read_metrics(metrics: List[dict], run) -> Dict[str, dict]:
    """``{name: {"value", "unit"}}`` of every metric whose reader found
    something to read."""
    out = {}
    for m in metrics:
        value = reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
