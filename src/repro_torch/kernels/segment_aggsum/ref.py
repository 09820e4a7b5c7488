"""Plain PyTorch version of the group-by segment sum.

``index_add_`` raises on out-of-range ids where ``segment_sum`` drops
them, so rows with gid outside [0, G) add into an overflow slot ``G`` that
is sliced off: the sum is ``index_add_`` over the in-range rows.
"""

from __future__ import annotations

import torch


def segment_sum_ref(gid: torch.Tensor, vals: torch.Tensor, num_groups: int) -> torch.Tensor:
    """gid (R,) int32; vals (R, C) f32 → (num_groups, C) f32."""
    g = gid.to(torch.int64)
    g = torch.where((g >= 0) & (g < num_groups), g, torch.full_like(g, num_groups))
    out = torch.zeros((num_groups + 1, vals.shape[1]), dtype=torch.float32, device=vals.device)
    out.index_add_(0, g, vals)
    return out[:num_groups]
