"""Distribution: sharded fleet execution and fault tolerance.

``fleet.ShardedFleet`` is the scale-out epoch path (views sharded across a
mesh axis, one psum-closed global plan per epoch); ``ft.FleetMonitor`` is
the liveness registry it wires into the mesh plan (``ft`` also holds the
elastic re-mesh, ``plan_elastic_mesh``); ``compression`` holds int8
gradient compression with error feedback and the ring all-reduce over a
``LocalMesh``.
"""

from repro_torch.distributed.fleet import (
    FleetPlanReport,
    ShardedAction,
    ShardedFleet,
    ShardLostError,
)
from repro_torch.distributed.compression import (
    dequantize_int8,
    ef_compress,
    make_compressed_allreduce,
    quantize_int8,
    ring_allreduce,
)
from repro_torch.distributed.ft import FleetMonitor

__all__ = [
    "dequantize_int8",
    "ef_compress",
    "make_compressed_allreduce",
    "quantize_int8",
    "ring_allreduce",
    "FleetMonitor",
    "FleetPlanReport",
    "ShardedAction",
    "ShardedFleet",
    "ShardLostError",
]
