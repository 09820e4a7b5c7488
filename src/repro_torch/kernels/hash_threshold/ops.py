"""η_{a,m} keep-mask over 1-D (composite) int32 key columns.

CPU tensors take the plain version (``ref.py``); CUDA tensors launch
``csrc/hash_threshold.cu`` or raise.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core.hashing import seed_mix
from repro_torch.kernels import _build as B
from repro_torch.kernels.hash_threshold.ref import hash_threshold_ref

MAX_COLS = 4
_ARGS = (B.P, B.P, B.P, B.P, B.I32, B.I64, B.U32, B.F32, B.P, B.P)


def hash_threshold(cols: Sequence[torch.Tensor], m: float, seed: int = 0) -> torch.Tensor:
    """Bool keep-mask: True where u(hash(cols)) < float32(m)."""
    cols = tuple(cols)
    if not 1 <= len(cols) <= MAX_COLS:
        raise ValueError(f"hash_threshold takes 1..{MAX_COLS} key columns, got {len(cols)}")
    dev = cols[0].device
    n = cols[0].shape[0]
    for i, c in enumerate(cols):
        B.check(c, f"cols[{i}]", torch.int32, dev, (n,))
    if dev.type == "cpu":
        return hash_threshold_ref(cols, m, seed)
    B.check_cuda(dev)
    out = torch.empty(n, dtype=torch.bool, device=dev)
    ptrs = [c.data_ptr() for c in cols] + [None] * (MAX_COLS - len(cols))
    B.launch("svc_hash_threshold", _ARGS, *ptrs, len(cols), n, seed_mix(seed),
             float(np.float32(m)), out.data_ptr(), B.stream())
    hash_threshold.launches += 1
    return out


hash_threshold.launches = 0
