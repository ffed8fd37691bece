"""The model's starting weights, made on the device from the seed.

Both sides take these: the program as its parameters, the reference as
its float32 starting point.  They are drawn in the type they are served
in, one ``randn`` per kind of matrix over every layer at once, so that
set-up makes few large calls: normal weights scaled by 1/sqrt(fan in),
0.02 for the embeddings, unit norm scales.
"""

from __future__ import annotations

from typing import Dict, List

import torch

LAYER_KEYS = ("wq", "wk", "wv", "wo", "w1", "w2", "ln1_scale", "ln2_scale")
_WEIGHTS_STREAM = 0x5EED_0001


def generator(device, seed: int, stream: int) -> torch.Generator:
    """A generator on ``device`` for one stream of draws of a run: the seed
    (any non-negative integer) and the stream fold into 63 bits."""
    return torch.Generator(torch.device(device)).manual_seed(
        (int(seed) * 1_000_003 + stream) % (1 << 63))


def make(model: dict, seed: int, device, dtype: torch.dtype) -> Dict:
    """``{"embed", "pos", "layers": [{wq, ..., ln2_scale}], "ln_f_scale"}``,
    in ``dtype`` on ``device``."""
    g = generator(device, seed, _WEIGHTS_STREAM)
    d, f, layers = model["d_model"], model["d_ff"], model["n_layers"]

    def normal(shape, scale):
        w = torch.randn(shape, generator=g, device=g.device, dtype=dtype)
        return w.mul_(scale)

    def stack(rows, cols) -> List[torch.Tensor]:
        full = normal((layers, rows, cols), rows ** -0.5)
        return [w.clone() for w in full.unbind(0)]

    out = {"embed": normal((model["vocab"], d), 0.02),
           "pos": normal((model["max_seq"], d), 0.02)}
    kinds = {"wq": stack(d, d), "wk": stack(d, d), "wv": stack(d, d),
             "wo": stack(d, d), "w1": stack(d, f), "w2": stack(f, d)}
    ones = torch.ones(d, device=g.device, dtype=dtype)
    out["layers"] = [
        {**{k: kinds[k][i] for k in kinds},
         "ln1_scale": ones.clone(), "ln2_scale": ones.clone()}
        for i in range(layers)]
    out["ln_f_scale"] = ones.clone()
    return out


def names(model: dict) -> List[str]:
    """The leaves' names in the order of the port's ``named_parameters()``:
    the module's own embed, pos and ln_f_scale, then each layer's keys."""
    return ["embed", "pos", "ln_f_scale"] + [
        f"layers.{i}.{k}" for i in range(model["n_layers"]) for k in LAYER_KEYS]


def leaves(weights: Dict) -> List[torch.Tensor]:
    """The weights in the order of :func:`names`."""
    out = [weights["embed"], weights["pos"], weights["ln_f_scale"]]
    for layer in weights["layers"]:
        out.extend(layer[k] for k in LAYER_KEYS)
    return out
