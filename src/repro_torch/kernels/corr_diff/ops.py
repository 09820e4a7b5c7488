"""Fused (Σd, Σd², count) for d = (t_new − t_old)·mask over 1-D inputs.

``corr_moments`` is the port of ``repro.kernels.corr_diff.ops.
corr_moments``, a library call the JAX package exports (its ``svc_corr``
takes the same moments with ``_masked_moments``, as the port's does).
CPU tensors take the plain version (``ref.py``); CUDA tensors launch
``csrc/corr_diff.cu`` or raise.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build as B
from repro_torch.kernels.corr_diff.ref import corr_diff_ref

_ARGS = (B.P, B.P, B.P, B.I64, B.I32, B.P, B.P, B.P)
_ROWS_PER_BLOCK = 4096  # 512 blocks at the smoke's 2^21 rows: every SM busy


def corr_moments(t_new: torch.Tensor, t_old: torch.Tensor, mask: torch.Tensor):
    """t_new, t_old (n,) f32; mask (n,) bool or int8 → (Σd, Σd², Σmask) as
    three 0-d float32 tensors."""
    dev = t_new.device
    n = t_new.shape[0] if t_new.dim() == 1 else -1
    B.check(t_new, "t_new", torch.float32, dev, (n,))
    B.check(t_old, "t_old", torch.float32, dev, (n,))
    if mask.dtype not in (torch.bool, torch.int8):
        raise TypeError(f"mask: dtype {mask.dtype}, expected torch.bool or torch.int8")
    B.check(mask, "mask", mask.dtype, dev, (n,))
    if dev.type == "cpu":
        return corr_diff_ref(t_new, t_old, mask)
    B.check_cuda(dev)
    if n == 0:
        out = torch.zeros(3, dtype=torch.float32, device=dev)
        return out[0], out[1], out[2]
    out = torch.empty(3, dtype=torch.float32, device=dev)  # the finish writes all three
    chunks = -(-n // _ROWS_PER_BLOCK)
    partials = torch.empty((chunks, 3), dtype=torch.float64, device=dev)
    B.launch("svc_corr_diff", _ARGS, t_new.data_ptr(), t_old.data_ptr(), mask.data_ptr(),
             n, _ROWS_PER_BLOCK, partials.data_ptr(), out.data_ptr(), B.stream())
    corr_moments.launches += 1
    return out[0], out[1], out[2]


corr_moments.launches = 0
