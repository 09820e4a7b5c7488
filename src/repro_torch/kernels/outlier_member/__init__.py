"""Fused η ∨ outlier-index membership kernel (§6.2 skew fast path)."""

from repro_torch.kernels.outlier_member.ops import (
    MAX_SMEM_KEYS,
    digest_table,
    fused_hash_member,
    outlier_codes,
    outlier_member,
    pinned_hash,
)
from repro_torch.kernels.outlier_member.ref import (
    fused_hash_member_ref,
    outlier_codes_ref,
    pinned_hash_ref,
    sorted_digest_table,
)

__all__ = [
    "MAX_SMEM_KEYS",
    "digest_table",
    "fused_hash_member",
    "outlier_codes",
    "outlier_member",
    "pinned_hash",
    "fused_hash_member_ref",
    "outlier_codes_ref",
    "pinned_hash_ref",
    "sorted_digest_table",
]
