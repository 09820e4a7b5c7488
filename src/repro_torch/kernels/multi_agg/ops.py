"""Fused batched-query moment pass; returns (12, Q) f32.

``multi_agg_moments`` is the op the batched query engine calls.  CPU
tensors take the plain version (``ref.py``); CUDA tensors launch
``csrc/multi_agg.cu`` — the two-sided kernel (``multi_agg_two``) when an
old side is given, else the one-sided one (``multi_agg_one``) — or raise.
The kernels select columns by index: each one-hot ``sel`` block column
becomes the index of its 1 (−1 for an all-zero selector, read as 0.0 —
an unused predicate slot has v = 0 and ±inf bounds).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build as B
from repro_torch.kernels.multi_agg.ref import N_MOMENTS, multi_agg_ref

_ARGS = (B.P, B.P, B.P, B.P, B.P, B.P, B.P, B.P, B.I64, B.I32, B.P, B.P, B.I32, B.I32,
         B.I64, B.I32, B.P, B.P, B.P)
_BLOCK = 256
_MAX_BLOCKS = 1024


def selector_indices(sel: torch.Tensor, C: int) -> torch.Tensor:
    """((1+P)·C, Q) one-hot selectors → (1+P, Q) int32 column indices."""
    Q = sel.shape[1]
    sel3 = sel.reshape(-1, C, Q)
    nonzero = sel3 != 0
    if bool(((nonzero & (sel3 != 1)) | (nonzero.sum(1) > 1)[:, None, :]).any()):
        raise ValueError("sel must hold one-hot column selectors (at most one 1 per block)")
    idx = torch.where(nonzero.any(1), nonzero.to(torch.float32).argmax(1),
                      torch.full((sel3.shape[0], Q), -1, dtype=torch.int64, device=sel.device))
    return idx.to(torch.int32).contiguous()


def _check_side(x, valid, w, ompi, dev, R, C, side):
    B.check(x, f"x_{side}", torch.float32, dev, (R, C))
    B.check(valid, f"valid_{side}", torch.bool, dev, (R,))
    B.check(w, f"w_{side}", torch.float32, dev, (R,))
    B.check(ompi, f"ompi_{side}", torch.float32, dev, (R,))


def _moments(wrapper, new, old, sel: torch.Tensor, meta: torch.Tensor) -> torch.Tensor:
    """Check every input, then take the plain version (CPU) or launch (CUDA)."""
    x = new[0]
    dev = x.device
    R, C = x.shape
    _check_side(*new, dev, R, C, "new")
    if old is not None:
        _check_side(*old, dev, R, C, "old")
    if C == 0 or sel.shape[0] % C != 0:
        raise ValueError(f"sel rows {sel.shape[0]} are not a multiple of C={C}")
    P = sel.shape[0] // C - 1
    B.check(sel, "sel", torch.float32, dev)
    B.check(meta, "meta", torch.float32, dev, (2 + 4 * P, sel.shape[1]))
    if dev.type == "cpu":
        return multi_agg_ref(*new, sel, meta, *(old or ()))
    B.check_cuda(dev)
    idx = selector_indices(sel, C)
    Q = idx.shape[1]
    partials_rows = max(_BLOCK, -(-R // _MAX_BLOCKS))
    nblocks = max(1, -(-R // partials_rows))
    partials = torch.empty(nblocks * Q * N_MOMENTS, dtype=torch.float32, device=dev)
    out = torch.empty((N_MOMENTS, Q), dtype=torch.float32, device=dev)
    if Q == 0:
        return out
    old_ptrs = [B.ptr(t) for t in old] if old is not None else [None] * 4
    B.launch("svc_multi_agg", _ARGS, *[t.data_ptr() for t in new], *old_ptrs, R, C,
             idx.data_ptr(), meta.data_ptr(), P, Q, partials_rows, nblocks,
             partials.data_ptr(), out.data_ptr(), B.stream())
    wrapper.launches += 1
    return out


def multi_agg_two(x_new, valid_new, w_new, ompi_new, sel, meta,
                  x_old, valid_old, w_old, ompi_old) -> torch.Tensor:
    """Two-sided scan (clean ∥ stale ∥ diff) → (12, Q)."""
    return _moments(multi_agg_two, (x_new, valid_new, w_new, ompi_new),
                    (x_old, valid_old, w_old, ompi_old), sel, meta)


def multi_agg_one(x_new, valid_new, w_new, ompi_new, sel, meta) -> torch.Tensor:
    """One-sided scan (e.g. the exact batch over the materialized view)."""
    return _moments(multi_agg_one, (x_new, valid_new, w_new, ompi_new), None, sel, meta)


multi_agg_two.launches = 0
multi_agg_one.launches = 0


def multi_agg_moments(
    x_new: torch.Tensor,
    valid_new: torch.Tensor,
    w_new: torch.Tensor,
    ompi_new: torch.Tensor,
    sel: torch.Tensor,
    meta: torch.Tensor,
    x_old: Optional[torch.Tensor] = None,
    valid_old: Optional[torch.Tensor] = None,
    w_old: Optional[torch.Tensor] = None,
    ompi_old: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(12, Q) moments for a batch; two-sided when ``x_old`` is given.

    x_* (R, C) f32 panels (row-aligned when two-sided); valid_* (R,) bool;
    w_* (R,) 1/π weights; ompi_* (R,) 1−π HT factors; sel ((1+P)·C, Q)
    one-hot selectors; meta (2+4P, Q) op codes and bounds.
    """
    if x_old is None:
        return multi_agg_one(x_new, valid_new, w_new, ompi_new, sel, meta)
    return multi_agg_two(x_new, valid_new, w_new, ompi_new, sel, meta,
                         x_old, valid_old, w_old, ompi_old)
