"""Plain PyTorch version of the fused η-filter + group aggregation kernel.

Composes the η mask with an ``index_add_`` group sum, materializing the
keep mask the way the unfused plan executor does.  ``index_add_`` raises on
out-of-range ids where ``segment_sum`` drops them, so dropped rows go to an
overflow slot ``num_groups`` that is sliced off.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.hashing import as_u32, seed_mix, splitmix32
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


def fused_clean_fleet_ref(
    gid: torch.Tensor,
    vals: torch.Tensor,
    valid: torch.Tensor,
    ms: Sequence[float],
    seeds: Sequence[int],
    num_groups: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """gid (V, R) int32; vals (V, R, C) f32; valid (V, R) bool; per-view
    ratios ``ms`` and seeds.  Returns (counts (V, G) f32, sums (V, G, C) f32).

    The offset-segment trick of ``repro.kernels.fused_clean.ops``: view v's
    groups live at segments [v·(G+1), v·(G+1)+G) of one accumulator, and
    each view's dropped rows go to its own overflow segment v·(G+1)+G."""
    V, R = gid.shape
    C = vals.shape[2]
    dev = gid.device
    mixes = torch.tensor([seed_mix(int(s)) for s in seeds], dtype=torch.int64, device=dev)
    thresh = torch.tensor([float(np.float32(m)) for m in ms], dtype=torch.float32, device=dev)
    h = splitmix32(mixes.reshape(V, 1) ^ splitmix32(as_u32(gid)))
    u = h.to(torch.float32) * (1.0 / 4294967296.0)
    keep = (u < thresh.reshape(V, 1)) & valid & (gid >= 0) & (gid < num_groups)
    nseg = num_groups + 1
    offset = nseg * torch.arange(V, dtype=torch.int64, device=dev).reshape(V, 1)
    g = (torch.where(keep, gid.to(torch.int64), torch.full_like(gid, num_groups,
                                                                dtype=torch.int64))
         + offset).reshape(-1)
    counts = torch.zeros(V * nseg, dtype=torch.float32, device=dev)
    counts.index_add_(0, g, keep.to(torch.float32).reshape(-1))
    sums = torch.zeros((V * nseg, C), dtype=torch.float32, device=dev)
    sums.index_add_(0, g, torch.where(keep[..., None], vals, torch.zeros_like(vals))
                    .reshape(V * R, C))
    return (counts.reshape(V, nseg)[:, :num_groups],
            sums.reshape(V, nseg, C)[:, :num_groups])
