"""The SVC hashing operator η_{a,m} (§4.4), bit-identical to ``repro.core.hashing``.

Deterministic uniform hashing of (composite) primary keys to [0,1); rows with
h(a) ≤ m form the sample.  Determinism is what yields the Correspondence
property (§4.6, Prop. 2), so every hash here must equal the JAX package's
bit for bit.

The plain versions below run the uint32 splitmix32 mixer in int64 lanes:
torch has no uint32 shifts on the CPU.  Values stay in [0, 2^32) and every
multiply is split into 16-bit halves so no product leaves int64's range.
``hash_threshold_mask`` dispatches to ``kernels/hash_threshold`` — the plain
version for CPU tensors, the CUDA kernel for CUDA tensors.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

SEED_GAMMA = 0x9E3779B9

# Seeds of the two independent splitmix32 folds that form the 64-bit
# membership digest (key_digest below; kernels/outlier_member).
DIGEST_SEED_HI = 0x0D1D
DIGEST_SEED_LO = 0x10CA

_M32 = 0xFFFFFFFF


def seed_mix(seed: int) -> int:
    """Fold a user seed into the mixer's initial state (Python int)."""
    return (SEED_GAMMA * (int(seed) + 1)) & _M32


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 (or already-u32 int64) lanes → int64 holding the uint32 bits."""
    return x.to(torch.int64) & _M32


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x · c) mod 2^32 for x in [0, 2^32), without int64 overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def splitmix32(x: torch.Tensor) -> torch.Tensor:
    """32-bit avalanche finalizer on uint32 values held in int64."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def hash_columns(cols: Sequence[torch.Tensor], seed: int = 0) -> torch.Tensor:
    """Mix (composite) key columns into one uint32 hash per row (int64 lanes)."""
    h = torch.full(cols[0].shape, seed_mix(seed), dtype=torch.int64, device=cols[0].device)
    for c in cols:
        h = splitmix32(h ^ splitmix32(as_u32(c)))
    return h


def key_digest(cols: Sequence[torch.Tensor], seed: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """64-bit composite-key digest as two uint32 lanes (hi, lo)."""
    return (
        hash_columns(cols, DIGEST_SEED_HI + seed),
        hash_columns(cols, DIGEST_SEED_LO + seed),
    )


def hash_u01(cols: Sequence[torch.Tensor], seed: int = 0) -> torch.Tensor:
    """Uniform [0,1) value per row (float32; round-to-nearest conversion)."""
    h = hash_columns(cols, seed)
    return h.to(torch.float32) * (1.0 / 4294967296.0)


def hash_threshold_mask(cols: Sequence[torch.Tensor], m: float, seed: int = 0) -> torch.Tensor:
    """η_{a,m}: boolean keep-mask, True where h(a) ≤ m."""
    from repro_torch.kernels.hash_threshold.ops import hash_threshold

    return hash_threshold(tuple(cols), float(m), int(seed))


def apply_hash(rel, cols: Tuple[str, ...], m: float, seed: int = 0, pin=None):
    """Apply η to a Relation: narrow validity to the hash sample.

    ``pin`` (a Relation of key values, or None) pins outlier-index rows into
    the sample with weight 1, flagged in ``__outlier`` (Def. 5 / §6.2), via
    the one fused scan of ``outliers.apply_hash_with_outliers``.
    """
    if pin is None:
        mask = hash_threshold_mask([rel.columns[c] for c in cols], m, seed)
        return rel.replace(valid=rel.valid & mask)

    from repro_torch.core.outliers import apply_hash_with_outliers
    from repro_torch.relational.relation import sentinel_where

    pin_keys = tuple(sentinel_where(pin.valid, pin.col(c)) for c in pin.schema.pk)
    return apply_hash_with_outliers(rel, cols, m, seed, pin_keys)
