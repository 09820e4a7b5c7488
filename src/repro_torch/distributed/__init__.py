"""Distribution: sharded fleet execution and fault tolerance.

``fleet.ShardedFleet`` is the scale-out epoch path (views sharded across a
mesh axis, one psum-closed global plan per epoch); ``ft.FleetMonitor`` is
the liveness registry it wires into the mesh plan (``ft`` also holds the
elastic re-mesh, ``plan_elastic_mesh``).
"""

from repro_torch.distributed.fleet import (
    FleetPlanReport,
    ShardedAction,
    ShardedFleet,
    ShardLostError,
)
from repro_torch.distributed.ft import FleetMonitor

__all__ = [
    "FleetMonitor",
    "FleetPlanReport",
    "ShardedAction",
    "ShardedFleet",
    "ShardLostError",
]
