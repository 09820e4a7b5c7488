"""Plain PyTorch version of the fused SVC+CORR moments."""

from __future__ import annotations

import torch


def corr_diff_ref(t_new: torch.Tensor, t_old: torch.Tensor, mask: torch.Tensor):
    """(Σd, Σd², Σmask) with d = (t_new − t_old)·mask, float32 sums."""
    m = mask.to(torch.float32)
    d = (t_new - t_old) * m
    return d.sum(), (d * d).sum(), m.sum()
