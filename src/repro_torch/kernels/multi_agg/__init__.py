"""Batched multi-aggregate query kernels (the query-engine hot loop)."""

from repro_torch.kernels.multi_agg.ops import multi_agg_moments, multi_agg_one, multi_agg_two
from repro_torch.kernels.multi_agg.ref import (
    HT_D,
    HT_NEW,
    HT_OLD,
    K_D,
    K_NEW,
    K_OLD,
    META_IS_AVG,
    META_IS_COUNT,
    META_PER_PRED,
    META_PRED0,
    N_MOMENTS,
    S_D,
    S_NEW,
    S_OLD,
    SS_D,
    SS_NEW,
    SS_OLD,
    multi_agg_ref,
)

__all__ = [
    "multi_agg_moments",
    "multi_agg_one",
    "multi_agg_two",
    "multi_agg_ref",
    "N_MOMENTS",
    "K_NEW", "S_NEW", "SS_NEW", "HT_NEW",
    "K_OLD", "S_OLD", "SS_OLD", "HT_OLD",
    "K_D", "S_D", "SS_D", "HT_D",
    "META_IS_COUNT", "META_IS_AVG", "META_PRED0", "META_PER_PRED",
]
