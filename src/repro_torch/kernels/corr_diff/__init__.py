"""Fused SVC+CORR moments (Σd, Σd², count) in one pass."""

from repro_torch.kernels.corr_diff.ops import corr_moments
from repro_torch.kernels.corr_diff.ref import corr_diff_ref

__all__ = ["corr_diff_ref", "corr_moments"]
