"""Fused η_{gid,m} filter + per-group count/sum over delta rows.

``fused_clean_groupby`` is the op ``core/maintenance.clean_sample``
dispatches to when the cleaning plan's delta sub-aggregation has the
canonical SVC shape.  CPU tensors take the plain version (``ref.py``);
CUDA tensors launch ``csrc/fused_clean.cu`` or raise.
``fused_clean_groupby_fleet`` does the same for V views in one launch
(the fleet refresh path, ``svc_refresh_many``).  Both launches add into
one int64 counter per device (``overflow_counter``) the kept rows whose
group found no slot in their block's shared-memory table and went straight
to device memory.  Every call dispatches through ``obs.kprof.profiled``, as
``"fused_clean"`` and ``"fused_clean_fleet"``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.hashing import seed_mix
from repro_torch.kernels import _build as B
from repro_torch.kernels.fused_clean.ref import fused_clean_fleet_ref, fused_clean_ref
from repro_torch.obs.kprof import profiled

_ARGS = (B.P, B.P, B.P, B.P, B.I64, B.I32, B.I64, B.U32, B.F32, B.P, B.P, B.P)
_overflow = {}


def overflow_counter(device: torch.device) -> torch.Tensor:
    """The (1,) int64 count of kept rows that overflowed a block's table,
    summed over every launch on ``device`` since it was last zeroed."""
    device = B.cuda_device(device)
    if device not in _overflow:
        _overflow[device] = torch.zeros(1, dtype=torch.int64, device=device)
    return _overflow[device]


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
        counts, sums = profiled("fused_clean", fused_clean_ref, gid, vals, valid, m, seed,
                                num_groups, pin_mask, fallback=True, rows=R, padded=R)
    else:
        B.check_cuda(dev)
        counts, sums = profiled("fused_clean", _launch, gid, vals, valid, m, seed, num_groups,
                                pin_mask, rows=R, padded=R)
    return counts, (sums[:, 0] if squeeze else sums)


def _launch(gid, vals, valid, m, seed, num_groups, pin_mask):
    dev = gid.device
    R, C = vals.shape
    out = torch.zeros((num_groups, 1 + C), dtype=torch.float32, device=dev)
    card = dev.index
    B.launch_on(card, "svc_fused_clean", _ARGS, gid.data_ptr(), valid.data_ptr(),
                B.ptr(pin_mask), vals.data_ptr(), R, C, num_groups, seed_mix(seed),
                float(np.float32(m)), out.data_ptr(), overflow_counter(dev).data_ptr())
    fused_clean_groupby.launches += 1
    return out[:, 0], out[:, 1:]


fused_clean_groupby.launches = 0


_FLEET_ARGS = (B.P, B.P, B.P, B.I64, B.I64, B.I32, B.I64, B.P, B.P, B.P, B.P, B.P)


def fused_clean_groupby_fleet(
    gid: torch.Tensor,
    vals: torch.Tensor,
    valid: torch.Tensor,
    ms: Sequence[float],
    seeds: Sequence[int],
    num_groups: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch cleans a whole fleet's delta aggregations (pin-free).

    gid (V, R) int32 per-view group keys; vals (V, R, C) f32; valid (V, R)
    bool; ``ms``/``seeds`` the per-view ratios and η seeds, so each view's
    slice equals its own ``fused_clean_groupby`` call.  Returns
    (counts (V, G) f32, sums (V, G, C) f32)."""
    dev = gid.device
    V, R = gid.shape
    B.check(gid, "gid", torch.int32, dev, (V, R))
    B.check(vals, "vals", torch.float32, dev)
    if vals.dim() != 3 or vals.shape[:2] != (V, R):
        raise ValueError(f"vals: shape {tuple(vals.shape)}, expected ({V}, {R}, C)")
    B.check(valid, "valid", torch.bool, dev, (V, R))
    if len(ms) != V or len(seeds) != V:
        raise ValueError(f"need one m and one seed per view: {len(ms)}, {len(seeds)} for {V}")
    if dev.type == "cpu":
        return profiled("fused_clean_fleet", fused_clean_fleet_ref, gid, vals, valid, ms, seeds,
                        num_groups, fallback=True, rows=V * R, padded=V * R)
    B.check_cuda(dev)
    return profiled("fused_clean_fleet", _launch_fleet, gid, vals, valid, ms, seeds, num_groups,
                    rows=V * R, padded=V * R)


def _launch_fleet(gid, vals, valid, ms, seeds, num_groups):
    dev = gid.device
    V, R, C = vals.shape
    # the uint32 seed mixes travel as int32 of the same bits
    mixes = torch.tensor(np.array([seed_mix(s) for s in seeds], dtype=np.uint32).view(np.int32),
                         device=dev)
    thresh = torch.tensor(np.array(ms, dtype=np.float32), device=dev)
    out = torch.zeros((V, num_groups, 1 + C), dtype=torch.float32, device=dev)
    card = dev.index
    B.launch_on(card, "svc_fused_clean_fleet", _FLEET_ARGS, gid.data_ptr(), valid.data_ptr(),
                vals.data_ptr(), V, R, C, num_groups, mixes.data_ptr(), thresh.data_ptr(),
                out.data_ptr(), overflow_counter(dev).data_ptr())
    fused_clean_groupby_fleet.launches += 1
    return out[:, :, 0], out[:, :, 1:]


fused_clean_groupby_fleet.launches = 0
