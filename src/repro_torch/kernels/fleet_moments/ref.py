"""Plain PyTorch version of the batched fleet moment pass.

One scan over the stacked fleet panel — every registered view's
correspondence-aligned clean/stale canonical-column pair, padded to a
common row count — emits, for ALL views at once, the sufficient statistics
of the planner's moment snapshot (``repro.kernels.fleet_moments.ref``):

  N_HAT    Σ v_new·w_new            estimated view rows (Σ 1/π)
  S1       Σ t_new                  weighted canonical-column total
  S2       Σ t_new·x_new            weighted canonical-column Σx²
  HT_AQP   Σ o_new·t_new²           §5.2.1 HT variance of SVC+AQP
  HT_CORR  Σ min(o_new,o_old)·d²    §5.2.2 HT variance of the correction

with t = w·x·valid per side and d = t_new − t_old over the outer-join row
space (absent rows carry t = 0).  Pinned rows (§6.3) carry w = 1, ompi = 0;
padding rows carry all-zero channels and contribute nothing.
"""

from __future__ import annotations

import torch

# moment columns of the (V, N_MOMENTS) output
M_N = 0        # Σ 1/π over the clean sample (estimated rows)
M_S1 = 1       # Σ w·x (weighted canonical-column total)
M_S2 = 2       # Σ w·x² (weighted canonical-column sum of squares)
M_HT_AQP = 3   # Σ (1−π)·t² over the clean sample
M_HT_CORR = 4  # Σ min(1−π_new, 1−π_old)·d² over the joined row space
N_MOMENTS = 5


def fleet_moments_ref(x_new, valid_new, w_new, ompi_new,
                      x_old, valid_old, w_old, ompi_old) -> torch.Tensor:
    """Eight (V, R) f32 channel panels → (V, N_MOMENTS) f32."""
    t_new = w_new * x_new * valid_new
    t_old = w_old * x_old * valid_old
    d = t_new - t_old
    n_hat = (valid_new * w_new).sum(dim=1)
    s1 = t_new.sum(dim=1)
    s2 = (t_new * x_new).sum(dim=1)
    ht_aqp = (ompi_new * t_new * t_new).sum(dim=1)
    ht_corr = (torch.minimum(ompi_new, ompi_old) * d * d).sum(dim=1)
    return torch.stack([n_hat, s1, s2, ht_aqp, ht_corr], dim=1)
