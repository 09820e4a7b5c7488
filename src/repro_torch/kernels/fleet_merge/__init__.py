"""Fleet-wide merge remainder: one wrapper call upserts every view's deltas."""

from repro_torch.kernels.fleet_merge.ops import SORT_MAX, TILE, fleet_merge, sort_stale
from repro_torch.kernels.fleet_merge.ref import (
    delta_only_rows,
    fleet_merge_rank_ref,
    fleet_merge_ref,
    merge_slots,
    sort_by_key,
)

__all__ = ["SORT_MAX", "TILE", "delta_only_rows", "fleet_merge", "fleet_merge_rank_ref",
           "fleet_merge_ref", "merge_slots", "sort_by_key", "sort_stale"]
