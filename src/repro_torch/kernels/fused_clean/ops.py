"""Fused η_{gid,m} filter + per-group count/sum over delta rows.

``fused_clean_groupby`` is the op ``core/maintenance.clean_sample``
dispatches to when the cleaning plan's delta sub-aggregation has the
canonical SVC shape.  CPU tensors take the plain version (``ref.py``);
CUDA tensors launch ``csrc/fused_clean.cu`` or raise.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.hashing import seed_mix
from repro_torch.kernels import _build as B
from repro_torch.kernels.fused_clean.ref import fused_clean_ref

_ARGS = (B.P, B.P, B.P, B.P, B.I64, B.I32, B.I64, B.U32, B.F32, B.P, B.P)


def fused_clean_groupby(
    gid: torch.Tensor,
    vals: torch.Tensor,
    valid: torch.Tensor,
    m: float,
    seed: int,
    num_groups: int,
    pin_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """gid (R,) int32 group keys (rows with gid outside [0, G) drop); vals
    (R, C) or (R,) f32; valid (R,) bool; pin_mask (R,) bool rows kept
    regardless of their hash.  Returns (counts (G,), sums (G, C))."""
    squeeze = vals.dim() == 1
    if squeeze:
        vals = vals[:, None]
    dev = gid.device
    R, C = vals.shape
    B.check(gid, "gid", torch.int32, dev, (R,))
    B.check(vals, "vals", torch.float32, dev)
    B.check(valid, "valid", torch.bool, dev, (R,))
    if pin_mask is not None:
        B.check(pin_mask, "pin_mask", torch.bool, dev, (R,))
    if dev.type == "cpu":
        counts, sums = fused_clean_ref(gid, vals, valid, m, seed, num_groups, pin_mask)
    else:
        B.check_cuda(dev)
        out = torch.zeros((num_groups, 1 + C), dtype=torch.float32, device=dev)
        B.launch("svc_fused_clean", _ARGS, gid.data_ptr(), valid.data_ptr(),
                 B.ptr(pin_mask), vals.data_ptr(), R, C, num_groups, seed_mix(seed),
                 float(np.float32(m)), out.data_ptr(), B.stream())
        fused_clean_groupby.launches += 1
        counts, sums = out[:, 0], out[:, 1:]
    return counts, (sums[:, 0] if squeeze else sums)


fused_clean_groupby.launches = 0
