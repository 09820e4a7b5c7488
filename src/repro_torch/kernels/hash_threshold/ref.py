"""Plain PyTorch version of the η hash-threshold kernel (core/hashing's mixer)."""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core.hashing import hash_u01


def hash_threshold_ref(cols: Sequence[torch.Tensor], m: float, seed: int = 0) -> torch.Tensor:
    """η_{a,m} keep-mask: u(hash(cols)) < float32(m), compared in float32 as
    the JAX package does (a float64 ``m`` would flip hashes just under it)."""
    thresh = torch.tensor(float(np.float32(m)), dtype=torch.float32, device=cols[0].device)
    return hash_u01(cols, seed) < thresh
