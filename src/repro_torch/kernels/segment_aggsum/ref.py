"""Plain PyTorch versions of the group-by segment sums.

``index_add_`` raises on out-of-range ids where ``segment_sum`` drops
them, so rows with gid outside [0, G) add into an overflow slot ``G`` that
is sliced off: the sum is ``index_add_`` over the in-range rows.  Rows add
in row order, the same order per column as one ``index_add_`` per column.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _slots(gid: torch.Tensor, num_groups: int) -> torch.Tensor:
    """gid with every out-of-range id moved to the overflow slot G."""
    return torch.where((gid >= 0) & (gid < num_groups), gid,
                       torch.full_like(gid, num_groups))


def segment_sum_ref(gid: torch.Tensor, vals: torch.Tensor, num_groups: int) -> torch.Tensor:
    """gid (R,) int32; vals (R, C) f32 → (num_groups, C) f32."""
    out = torch.zeros((num_groups + 1, vals.shape[1]), dtype=torch.float32, device=vals.device)
    out.index_add_(0, _slots(gid, num_groups), vals)
    return out[:num_groups]


def segment_groupby_ref(gid: torch.Tensor, vals: torch.Tensor,
                        num_groups: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """gid (R,) int32; vals (R, C) f32 → (counts (G,) int32, sums (G, C) f32)."""
    g = _slots(gid, num_groups)
    counts = torch.zeros(num_groups + 1, dtype=torch.int32, device=gid.device)
    counts.index_add_(0, g, torch.ones_like(gid))
    sums = torch.zeros((num_groups + 1, vals.shape[1]), dtype=torch.float32, device=vals.device)
    sums.index_add_(0, g, vals)
    return counts[:num_groups], sums[:num_groups]
