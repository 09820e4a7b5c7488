"""Plain PyTorch version of the fused η ∨ outlier-membership kernel.

Membership ``pk ∈ outlier_keys`` is answered on the 64-bit key digest
(``core/hashing.key_digest``: two uint32 lanes hi, lo).  Both lanes pack
into one int64 whose signed order is the unsigned lexicographic (hi, lo)
order, so the plain version is one sort of the K index digests plus a
``searchsorted`` per probe row — O(R log K), like the JAX package's XLA
path.  Rows whose FIRST key column is ``SENTINEL_KEY`` are never members.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from repro_torch.core.hashing import key_digest
from repro_torch.kernels.hash_threshold.ref import hash_threshold_ref
from repro_torch.relational.relation import SENTINEL_KEY


def pack_digest(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """(hi, lo) uint32 lanes (int64) → one int64, monotone in (hi, lo)."""
    return (hi - 2**31) * 2**32 + lo


def sorted_digest_table(key_cols: Sequence[torch.Tensor]) -> torch.Tensor:
    """Packed digests of the index key tuples, sorted ascending."""
    return torch.sort(pack_digest(*key_digest(key_cols))).values


def digest_member(probe_cols: Sequence[torch.Tensor], table: torch.Tensor) -> torch.Tensor:
    packed = pack_digest(*key_digest(probe_cols))
    live = probe_cols[0] != int(SENTINEL_KEY)
    if table.shape[0] == 0:
        return torch.zeros_like(live)
    pos = torch.searchsorted(table, packed).clamp(max=table.shape[0] - 1)
    return (table[pos] == packed) & live


def fused_hash_member_ref(
    cols: Sequence[torch.Tensor], m: float, seed: int, key_cols: Sequence[torch.Tensor]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(η_{a,m} ∨ membership, membership) row masks."""
    member = digest_member(cols, sorted_digest_table(key_cols))
    return hash_threshold_ref(cols, m, seed) | member, member


def outlier_codes_ref(
    cols: Sequence[torch.Tensor], key_cols: Sequence[torch.Tensor], m: float, seed: int
) -> torch.Tensor:
    """int32 codes: bit0 = keep (η ∨ member), bit1 = member."""
    keep, member = fused_hash_member_ref(cols, m, seed, key_cols)
    return keep.to(torch.int32) | (member.to(torch.int32) << 1)
