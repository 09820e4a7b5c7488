"""Group-by segment sum (out-of-range gids dropped) in one pass."""

from repro_torch.kernels.segment_aggsum.ops import segment_sum
from repro_torch.kernels.segment_aggsum.ref import segment_sum_ref

__all__ = ["segment_sum", "segment_sum_ref"]
