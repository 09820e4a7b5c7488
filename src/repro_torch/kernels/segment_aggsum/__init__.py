"""Group-by segment sums (out-of-range gids dropped) in one pass: the
group-by's entry over sorted ids (int32 counts and sums) and the library
call ``segment_sum`` (ids sorted or in any order)."""

from repro_torch.kernels.segment_aggsum.ops import segment_groupby, segment_sum
from repro_torch.kernels.segment_aggsum.ref import segment_groupby_ref, segment_sum_ref

__all__ = ["segment_groupby", "segment_groupby_ref", "segment_sum", "segment_sum_ref"]
