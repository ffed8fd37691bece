"""Mesh and collective helpers used by the port's resiliency layer.

The collective surface is the self-healing wrapper layer:
:class:`ResilientCollective` deadlines, telemeters, and degrades every
resiliency-layer collective.
"""

from .mesh import DpTp, dp_tp, flat_index, make_mesh, mesh_axis_sizes
from .collectives import (
    ResilientCollective,
    device_max_reduce,
    instrument_dispatch,
    make_timeouts_reduce_fn,
    observe_latency_ns,
    wrap_collective,
)
from .deadline import CollectiveTimeout, DeadlineLane, shared_lane
from .degrade import DegradePolicy
from .health import RouteHealth, health
from .distributed import init_distributed

__all__ = [
    "DpTp",
    "dp_tp",
    "flat_index",
    "make_mesh",
    "mesh_axis_sizes",
    "ResilientCollective",
    "CollectiveTimeout",
    "DeadlineLane",
    "DegradePolicy",
    "RouteHealth",
    "device_max_reduce",
    "health",
    "instrument_dispatch",
    "make_timeouts_reduce_fn",
    "observe_latency_ns",
    "shared_lane",
    "wrap_collective",
    "init_distributed",
]
