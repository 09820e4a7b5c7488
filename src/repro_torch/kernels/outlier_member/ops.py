"""Fused η ∨ outlier-index membership: int32 codes, bit0 keep, bit1 member.

``fused_hash_member`` is the op core/outliers dispatches to for the §6.2
sample predicate (η ∨ membership + the ``__outlier`` flag) and
``outlier_member`` the membership-only probe behind ``member_keys`` for
multi-column keys.  Torch glue digests and sorts the index keys (K log K,
K ≪ rows, as the JAX package's ``_sorted_digests``); the per-row work is
the kernel.  CPU tensors take the plain version (``ref.py``); CUDA tensors
launch ``csrc/outlier_member.cu`` — one kernel for every K — or raise.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.hashing import DIGEST_SEED_HI, DIGEST_SEED_LO, seed_mix
from repro_torch.kernels import _build as B
from repro_torch.kernels.outlier_member.ref import outlier_codes_ref, sorted_digest_table

MAX_COLS = 4
# Tables up to this many keys (16 KiB of hi/lo lanes) are staged in shared
# memory by the kernel; larger ones are searched in device memory.
MAX_SMEM_KEYS = 2048
_ARGS = (B.P, B.P, B.P, B.P, B.I32, B.I64, B.P, B.P, B.I64, B.U32, B.U32, B.U32, B.F32,
         B.P, B.P)


def _as_i32_bits(x: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 → int32 tensor with the same bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32).contiguous()


def digest_lanes(key_cols: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's table: sorted (hi, lo) digest lanes as int32 bit patterns."""
    table = sorted_digest_table(key_cols)
    return _as_i32_bits((table >> 32) + 2**31), _as_i32_bits(table & 0xFFFFFFFF)


def outlier_codes(
    cols: Sequence[torch.Tensor], key_cols: Sequence[torch.Tensor], m: float, seed: int
) -> torch.Tensor:
    """Per probe row: bit0 = hash(cols) < f32(m) ∨ member, bit1 = member.

    cols: 1-D int32 composite key columns of the probe rows (SENTINEL_KEY
    marks invalid rows); key_cols: the index key columns, same arity.
    """
    cols, key_cols = tuple(cols), tuple(key_cols)
    if not 1 <= len(cols) <= MAX_COLS or len(key_cols) != len(cols):
        raise ValueError(f"need 1..{MAX_COLS} probe columns and as many key columns")
    dev = cols[0].device
    R, K = cols[0].shape[0], key_cols[0].shape[0]
    for i, c in enumerate(cols):
        B.check(c, f"cols[{i}]", torch.int32, dev, (R,))
    for i, c in enumerate(key_cols):
        B.check(c, f"key_cols[{i}]", torch.int32, dev, (K,))
    if dev.type == "cpu":
        return outlier_codes_ref(cols, key_cols, m, seed)
    B.check_cuda(dev)
    khi, klo = digest_lanes(key_cols)
    out = torch.empty(R, dtype=torch.int32, device=dev)
    ptrs = [c.data_ptr() for c in cols] + [None] * (MAX_COLS - len(cols))
    B.launch("svc_outlier_member", _ARGS, *ptrs, len(cols), R, khi.data_ptr(),
             klo.data_ptr(), K, seed_mix(seed), seed_mix(DIGEST_SEED_HI),
             seed_mix(DIGEST_SEED_LO), float(np.float32(m)), out.data_ptr(), B.stream())
    outlier_codes.launches += 1
    return out


outlier_codes.launches = 0


def fused_hash_member(
    cols: Sequence[torch.Tensor], m: float, seed: int, key_cols: Sequence[torch.Tensor]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(η ∨ membership, membership) bool masks in one fused pass."""
    code = outlier_codes(cols, key_cols, m, seed)
    return (code & 1) > 0, (code & 2) > 0


def outlier_member(probe_cols: Sequence[torch.Tensor], key_cols: Sequence[torch.Tensor]) -> torch.Tensor:
    """Membership-only probe: probe tuple ∈ key tuples (digest identity)."""
    return (outlier_codes(probe_cols, key_cols, 0.0, 0) & 2) > 0
