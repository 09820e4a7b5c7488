"""Batched fleet moment pass: one scan snapshots every view's §5.2.2 stats."""

from repro_torch.kernels.fleet_moments.ops import fleet_moments
from repro_torch.kernels.fleet_moments.ref import (
    M_HT_AQP,
    M_HT_CORR,
    M_N,
    M_S1,
    M_S2,
    N_MOMENTS,
    fleet_moments_ref,
)

__all__ = ["M_HT_AQP", "M_HT_CORR", "M_N", "M_S1", "M_S2", "N_MOMENTS",
           "fleet_moments", "fleet_moments_ref"]
