"""Score every view's {skip, clean, maintain, retune} in one launch.

``fleet_scores`` is the op the budgeted scheduler (``repro_torch.planner``)
calls once per epoch.  CPU tensors take the plain version (``ref.py``);
CUDA tensors launch ``csrc/fleet_score.cu`` or raise.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build as B
from repro_torch.kernels.fleet_score.ref import N_FEATURES, N_SCORES, fleet_score_ref

_ARGS = (B.P, B.I64, B.P, B.P)


def fleet_scores(features: torch.Tensor) -> torch.Tensor:
    """(V, N_FEATURES) f32 per-view features → (V, N_SCORES) f32 scores."""
    if features.dim() != 2 or features.shape[1] != N_FEATURES:
        raise ValueError(f"expected (V, {N_FEATURES}) features, got {tuple(features.shape)}")
    dev = features.device
    B.check(features, "features", torch.float32, dev)
    if dev.type == "cpu":
        return fleet_score_ref(features)
    B.check_cuda(dev)
    V = features.shape[0]
    out = torch.empty((V, N_SCORES), dtype=torch.float32, device=dev)
    if V == 0:
        return out
    B.launch("svc_fleet_score", _ARGS, features.data_ptr(), V, out.data_ptr(), B.stream())
    fleet_scores.launches += 1
    return out


fleet_scores.launches = 0
