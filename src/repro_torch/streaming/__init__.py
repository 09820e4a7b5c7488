"""Streaming sample refresh (continuous-traffic SVC).

DeltaLog buffers out-of-order micro-batches under a memory bound;
StreamingViewService drains them into the fleet clean on size and age
watermarks and answers queries with staleness metadata.
PartitionedDeltaLog keeps one DeltaLog per data shard.
"""

from repro_torch.streaming.delta_log import (
    Backpressure,
    CorruptBatch,
    DeltaLog,
    MicroBatch,
    PartitionedDeltaLog,
)
from repro_torch.streaming.service import (
    BaseStaleness,
    StalenessInfo,
    StreamConfig,
    StreamedEstimate,
    StreamingViewService,
)

__all__ = [
    "Backpressure",
    "BaseStaleness",
    "CorruptBatch",
    "DeltaLog",
    "MicroBatch",
    "PartitionedDeltaLog",
    "StalenessInfo",
    "StreamConfig",
    "StreamedEstimate",
    "StreamingViewService",
]
