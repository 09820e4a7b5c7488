"""Segment sum: ``out[g, c] = Σ_{gid == g} vals[:, c]``, out-of-range gids dropped.

``segment_sum`` is the port of ``repro.kernels.segment_aggsum.ops.
segment_sum``, a library call the JAX package exports (the group-by in
``relational/ops.py`` sums with ``index_add_``, as JAX's uses
``jax.ops.segment_sum``).  CPU tensors take the plain version (``ref.py``);
CUDA tensors launch ``csrc/segment_aggsum.cu`` or raise.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build as B
from repro_torch.kernels.segment_aggsum.ref import segment_sum_ref

_ARGS = (B.P, B.P, B.I64, B.I32, B.I64, B.P, B.P)


def segment_sum(gid: torch.Tensor, vals: torch.Tensor, num_groups: int) -> torch.Tensor:
    """gid (R,) int32; vals (R, C) or (R,) f32 → (num_groups, C) or
    (num_groups,) f32.  Rows with gid < 0 or ≥ num_groups (the group-by's
    overflow slot) are dropped."""
    squeeze = vals.dim() == 1
    if squeeze:
        vals = vals[:, None]
    dev = gid.device
    R, C = vals.shape
    B.check(gid, "gid", torch.int32, dev, (R,))
    B.check(vals, "vals", torch.float32, dev)
    if num_groups < 0:
        raise ValueError(f"num_groups must be ≥ 0, got {num_groups}")
    if dev.type == "cpu":
        out = segment_sum_ref(gid, vals, num_groups)
    else:
        B.check_cuda(dev)
        out = torch.zeros((num_groups, C), dtype=torch.float32, device=dev)
        if R * C > 0 and num_groups > 0:
            B.launch("svc_segment_sum", _ARGS, gid.data_ptr(), vals.data_ptr(), R, C,
                     num_groups, out.data_ptr(), B.stream())
            segment_sum.launches += 1
    return out[:, 0] if squeeze else out


segment_sum.launches = 0
