"""The port's multi-rank dryrun (``tpu_resiliency_torch/dryrun.py``) on gloo
ranks on the CPU.

``dryrun_multichip(n, device="cpu")`` spawns n rank processes that run the
five stages of ``__graft_entry__.py::dryrun_multichip`` with its tiny
configuration and its assertions (each rank raises on a failed one, and the
parent raises on a failed rank).  The test holds rank 0's summary line to
the reference's tokens, and the stage-3 owner split, summed over the ranks,
to the JAX package's ``stage_pytree`` of the same parameters on a (dp, tp)
mesh of CPU devices.  The reference's dryrun itself cannot run (its
``now_stamp_ms`` import is gone), so its line is held by its format.
"""

import re

import jax
import pytest

from tpu_resiliency.checkpointing.async_ckpt import staging as jstaging
from tpu_resiliency.models import transformer as jt
from tpu_resiliency.parallel.mesh import make_mesh as jax_make_mesh
from tpu_resiliency_torch import dryrun


def _jax_owner_counts(dp: int, tp: int):
    mesh = jax_make_mesh(("data", "model"), (dp, tp), devices=jax.devices()[:dp * tp])
    params = jt.init_params(jt.TransformerConfig(**dryrun.CFG), mesh=mesh)
    staged = jstaging.stage_pytree(params)
    try:
        return (sum(1 for s in staged.shards if s.replica_owner),
                sum(1 for s in staged.shards if not s.replica_owner))
    finally:
        staged.close(unlink=True)


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_on_gloo_ranks(n, capsys, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    dp, tp = n // 2, 2
    out = dryrun.dryrun_multichip(n, device="cpu", timeout_s=300.0)
    line = out["summary"]
    assert line in capsys.readouterr().out.splitlines()
    m = re.fullmatch(
        rf"dryrun_multichip\({n}\): loss=(\d+\.\d{{4}}) quorum_ok "
        rf"mesh=OrderedDict\(\{{'data': {dp}, 'model': {tp}\}}\) "
        r"ckpt_roundtrip_ok owned=(\d+) non_owned=(\d+) "
        r"ici_replication_ok straggler_gather_ok", line)
    assert m, line
    owned, non_owned = int(m.group(2)), int(m.group(3))
    assert (owned, non_owned) == _jax_owner_counts(dp, tp)
    assert owned > 0 and (non_owned > 0 or dp == 1)
    ranks = out["ranks"]
    assert [r["rank"] for r in ranks] == list(range(n))
    assert sum(r["owned"] for r in ranks) == owned
    assert sum(r["non_owned"] for r in ranks) == non_owned
    # one loss on every rank (averaged over "data"), ages fresh, gloo
    assert len({r["loss"] for r in ranks}) == 1
    assert all(0 <= r["age_ns"] < 60_000_000_000 for r in ranks)
    assert all(r["backend"] == "gloo" and r["device"] == "cpu" for r in ranks)
    # the kernels count launches on the card only
    assert all(r["launches"] == {"quorum_local_max": 0, "chunk_fingerprint": 0,
                                 "chunk_fingerprint_shards": 0}
               for r in ranks)
