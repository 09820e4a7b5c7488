"""Plain PyTorch version of the fused η-filter + group aggregation kernel.

Composes the η mask with an ``index_add_`` group sum, materializing the
keep mask the way the unfused plan executor does.  ``index_add_`` raises on
out-of-range ids where ``segment_sum`` drops them, so dropped rows go to an
overflow slot ``num_groups`` that is sliced off.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.hash_threshold.ref import hash_threshold_ref


def fused_clean_ref(
    gid: torch.Tensor,
    vals: torch.Tensor,
    valid: torch.Tensor,
    m: float,
    seed: int,
    num_groups: int,
    pin_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """gid (R,) int32; vals (R, C) f32; valid (R,) bool; pin_mask (R,) bool.

    Returns (counts (G,) f32, sums (G, C) f32) over the η_{gid,m} sample
    (∪ pinned rows), dropping invalid / out-of-range rows.
    """
    keep = hash_threshold_ref([gid], m, seed)
    if pin_mask is not None:
        keep = keep | pin_mask
    keep = keep & valid & (gid >= 0) & (gid < num_groups)
    g = torch.where(keep, gid.to(torch.int64), torch.full_like(gid, num_groups, dtype=torch.int64))
    nseg = num_groups + 1
    counts = torch.zeros(nseg, dtype=torch.float32, device=gid.device)
    counts.index_add_(0, g, keep.to(torch.float32))
    sums = torch.zeros((nseg, vals.shape[1]), dtype=torch.float32, device=gid.device)
    sums.index_add_(0, g, torch.where(keep[:, None], vals, torch.zeros_like(vals)))
    return counts[:num_groups], sums[:num_groups]
