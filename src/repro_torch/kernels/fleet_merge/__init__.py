"""Fleet-wide merge remainder: one launch upserts every view's deltas."""

from repro_torch.kernels.fleet_merge.ops import fleet_merge, merge_unsorted
from repro_torch.kernels.fleet_merge.ref import delta_only_rows, fleet_merge_ref, sort_by_key

__all__ = ["delta_only_rows", "fleet_merge", "fleet_merge_ref", "merge_unsorted", "sort_by_key"]
