"""Fused η ∨ outlier-index membership kernel (§6.2 skew fast path)."""

from repro_torch.kernels.outlier_member.ops import (
    MAX_SMEM_KEYS,
    fused_hash_member,
    outlier_codes,
    outlier_member,
)
from repro_torch.kernels.outlier_member.ref import fused_hash_member_ref, outlier_codes_ref

__all__ = [
    "MAX_SMEM_KEYS",
    "fused_hash_member",
    "outlier_codes",
    "outlier_member",
    "fused_hash_member_ref",
    "outlier_codes_ref",
]
