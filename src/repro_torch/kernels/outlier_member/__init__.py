"""Fused η ∨ outlier-index membership kernel (§6.2 skew fast path)."""

from repro_torch.kernels.outlier_member.ops import (
    MAX_SMEM_KEYS,
    digest_table,
    fused_hash_member,
    outlier_codes,
    outlier_member,
    pin_launches,
    pin_table,
    pinned_hash,
    table_route,
)
from repro_torch.kernels.outlier_member.ref import (
    compact_pin_keys,
    fused_hash_member_ref,
    outlier_codes_ref,
    pin_table_ref,
    pinned_hash_ref,
    sorted_digest_table,
)

__all__ = [
    "MAX_SMEM_KEYS",
    "digest_table",
    "fused_hash_member",
    "outlier_codes",
    "outlier_member",
    "pin_launches",
    "pin_table",
    "pinned_hash",
    "table_route",
    "compact_pin_keys",
    "fused_hash_member_ref",
    "outlier_codes_ref",
    "pin_table_ref",
    "pinned_hash_ref",
    "sorted_digest_table",
]
