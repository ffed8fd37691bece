"""Device mesh construction.

The port of ``tpu_resiliency/parallel/mesh.py`` over
``torch.distributed.device_mesh.DeviceMesh``.  One process drives one
device, so a mesh position is a rank; the flat index of a rank in the mesh
is the device index that identify-mode quorum packing reports.

The sharded train step reads a ``("data", "model")`` mesh through
:func:`dp_tp`: the data-parallel and tensor-parallel process groups (the
mesh's own per-axis groups) and this rank's coordinate on each axis, the
counterpart of the ``NamedSharding`` placement the JAX step gets from its
``Mesh``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..utils.device import DeviceLike, resolve_device
from .distributed import init_distributed


def make_mesh(
    axis_names: Sequence[str] = ("data", "model"),
    axis_sizes: Optional[Sequence[int]] = None,
    device: DeviceLike = None,
) -> DeviceMesh:
    """Build a DeviceMesh over every rank of the default process group
    (initialized here from the env when it is not yet).

    With ``axis_sizes=None`` the last axis gets 1 and the first absorbs all
    ranks.  ``-1`` in axis_sizes means "infer"."""
    dev = resolve_device(device)
    group_dev = init_distributed(device=dev)
    if group_dev.type != dev.type:
        raise ValueError(
            f"the default process group runs on {group_dev}, not {dev.type}"
        )
    n = dist.get_world_size()
    if axis_sizes is None:
        axis_sizes = [n] + [1] * (len(axis_names) - 1)
    sizes = list(axis_sizes)
    if sizes.count(-1) > 1:
        raise ValueError("at most one -1 axis")
    known = int(np.prod([s for s in sizes if s != -1]))
    if -1 in sizes:
        if n % known:
            raise ValueError(f"{n} devices not divisible by {known}")
        sizes[sizes.index(-1)] = n // known
    if int(np.prod(sizes)) != n:
        raise ValueError(f"mesh {sizes} != {n} devices")
    ranks = torch.arange(n).reshape(sizes)
    return DeviceMesh(dev.type, ranks, mesh_dim_names=tuple(axis_names))


def mesh_axis_sizes(mesh: DeviceMesh) -> Tuple[int, ...]:
    return tuple(mesh.mesh.shape)


def flat_index(mesh: DeviceMesh) -> int:
    """This rank's position in the flattened mesh (its device index for
    quorum packing and the owner order of checkpoint shards)."""
    return mesh.mesh.flatten().tolist().index(mesh.get_rank())


class DpTp(NamedTuple):
    """A ``("data", "model")`` mesh as the sharded train step sees it."""

    dp: int                 # size of the "data" axis
    tp: int                 # size of the "model" axis
    dp_index: int           # this rank's coordinate on "data"
    tp_index: int           # this rank's coordinate on "model"
    dp_group: "dist.ProcessGroup"
    tp_group: "dist.ProcessGroup"


def dp_tp(mesh: DeviceMesh) -> DpTp:
    """The data- and model-axis sizes, coordinates and groups of this rank
    on ``mesh``, which must name both axes."""
    names = tuple(mesh.mesh_dim_names or ())
    if "data" not in names or "model" not in names:
        raise ValueError(f"the mesh needs 'data' and 'model' axes, has {names}")
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"rank {mesh.get_rank()} is not on the mesh")
    d, m = names.index("data"), names.index("model")
    return DpTp(
        dp=mesh.size(d), tp=mesh.size(m), dp_index=coord[d], tp_index=coord[m],
        dp_group=mesh.get_group("data"), tp_group=mesh.get_group("model"),
    )
