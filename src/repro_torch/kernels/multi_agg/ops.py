"""Fused batched-query moment pass; returns (12, Q) f32.

``multi_agg_moments`` is the op the batched query engine calls.  CPU
tensors take the plain version (``ref.py``); CUDA tensors launch
``csrc/multi_agg.cu`` — two-sided (``multi_agg_two``) when an old side is
given, else one-sided (``multi_agg_one``) — or raise.  The kernel selects
columns by index: each one-hot ``sel`` block column becomes the index of
its 1 (−1 for an all-zero selector, read as 0.0 — an unused predicate slot
has v = 0 and ±inf bounds).  ``QueryBatch`` decodes those indices once, on
the host, into ``sel_idx``; given ``sel_idx=``, a CUDA call reads nothing
back from the device and enqueues one kernel.  Without it the wrapper
decodes ``sel`` on the device first (``selector_indices``: a few launches
and one device→host read for the one-hot check).

The launch's float64 partials and its per-query-chunk tickets live in one
persistent workspace per device (zeroed once; every launch leaves the
tickets at 0), grown on demand and never shrunk.  They serve one stream:
two calls in flight on different streams would share them.  Both entries
dispatch through ``obs.kprof.profiled`` as ``"multi_agg"``.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build as B
from repro_torch.kernels.multi_agg.ref import N_MOMENTS, multi_agg_ref
from repro_torch.obs.kprof import profiled

_ARGS = (B.P,) * 8 + (B.I64, B.I32, B.P, B.P, B.I32, B.I32, B.I32, B.P, B.P, B.P, B.P)
TILE = 256  # rows a block stages per step (kTile in the source)
WARPS = 8  # warps of a block; each owns one query of 8, or two of 16
BLOCKS_PER_SM = 2
GROUP = 16  # blocks whose partials one block sums first (kGroup in the source)


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


def query_chunk(Q: int) -> int:
    """Queries one grid row of the launch answers (its rows read once)."""
    return WARPS if Q <= WARPS else 2 * WARPS


def grid_blocks(R: int, sms: int) -> int:
    """Blocks along the rows: one per tile, at most two an SM (persistent)."""
    return max(1, min(-(-R // TILE), BLOCKS_PER_SM * sms))


_workspace: dict = {}


def workspace(device: torch.device, n: int, kind: str) -> torch.Tensor:
    """The device's persistent buffer of ``kind``, at least ``n`` long:
    "partials" (float64) or "tickets" (int32).  Grown zeroed, at least
    doubling: the tickets must start at 0, and every launch leaves them so."""
    device = B.cuda_device(device)
    key = (device, kind)
    ws = _workspace.get(key)
    if ws is None or ws.numel() < n:
        dtype = torch.float64 if kind == "partials" else torch.int32
        ws = _workspace[key] = torch.zeros(max(n, 2 * (0 if ws is None else ws.numel())),
                                           dtype=dtype, device=device)
    return ws


def _check_side(x, valid, w, ompi, dev, R, C, side):
    B.check(x, f"x_{side}", torch.float32, dev, (R, C))
    B.check(valid, f"valid_{side}", torch.bool, dev, (R,))
    B.check(w, f"w_{side}", torch.float32, dev, (R,))
    B.check(ompi, f"ompi_{side}", torch.float32, dev, (R,))


def _moments(wrapper, new, old, sel: torch.Tensor, meta: torch.Tensor,
             sel_idx: Optional[torch.Tensor]) -> torch.Tensor:
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
    Q = sel.shape[1]
    B.check(meta, "meta", torch.float32, dev, (2 + 4 * P, Q))
    if sel_idx is not None:
        B.check(sel_idx, "sel_idx", torch.int32, dev, (1 + P, Q))
    if dev.type == "cpu":
        return profiled("multi_agg", multi_agg_ref, *new, sel, meta, *(old or ()),
                        fallback=True, rows=R, padded=R)
    B.check_cuda(dev)
    return profiled("multi_agg", _launch, wrapper, new, old, sel, meta, sel_idx, P, Q,
                    rows=R, padded=R)


def _launch(wrapper, new, old, sel, meta, sel_idx, P, Q) -> torch.Tensor:
    dev = new[0].device
    R, C = new[0].shape
    idx = selector_indices(sel, C) if sel_idx is None else sel_idx
    out = torch.empty((N_MOMENTS, Q), dtype=torch.float32, device=dev)
    if Q == 0:
        return out
    card = dev.index
    nblocks = grid_blocks(R, B.sm_count(card))
    groups = -(-nblocks // GROUP)
    partials = workspace(dev, (nblocks + groups) * N_MOMENTS * Q, "partials")
    tickets = workspace(dev, -(-Q // query_chunk(Q)) * (groups + 1), "tickets")
    old_ptrs = [B.ptr(t) for t in old] if old is not None else [None] * 4
    B.launch_on(card, "svc_multi_agg", _ARGS, *[t.data_ptr() for t in new], *old_ptrs, R, C,
                idx.data_ptr(), meta.data_ptr(), P, Q, nblocks, partials.data_ptr(),
                tickets.data_ptr(), out.data_ptr())
    wrapper.launches += 1
    return out


def multi_agg_two(x_new, valid_new, w_new, ompi_new, sel, meta,
                  x_old, valid_old, w_old, ompi_old, *, sel_idx=None) -> torch.Tensor:
    """Two-sided scan (clean ∥ stale ∥ diff) → (12, Q)."""
    return _moments(multi_agg_two, (x_new, valid_new, w_new, ompi_new),
                    (x_old, valid_old, w_old, ompi_old), sel, meta, sel_idx)


def multi_agg_one(x_new, valid_new, w_new, ompi_new, sel, meta, *,
                  sel_idx=None) -> torch.Tensor:
    """One-sided scan (e.g. the exact batch over the materialized view)."""
    return _moments(multi_agg_one, (x_new, valid_new, w_new, ompi_new), None, sel, meta,
                    sel_idx)


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
    *,
    sel_idx: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(12, Q) moments for a batch; two-sided when ``x_old`` is given.

    x_* (R, C) f32 panels (row-aligned when two-sided); valid_* (R,) bool;
    w_* (R,) 1/π weights; ompi_* (R,) 1−π HT factors; sel ((1+P)·C, Q)
    one-hot selectors; meta (2+4P, Q) op codes and bounds; sel_idx, when
    given, ``sel`` decoded as ``selector_indices`` does ((1+P, Q) int32,
    ``QueryBatch.sel_idx``), which the CUDA kernel reads instead of ``sel``.
    """
    if x_old is None:
        return multi_agg_one(x_new, valid_new, w_new, ompi_new, sel, meta, sel_idx=sel_idx)
    return multi_agg_two(x_new, valid_new, w_new, ompi_new, sel, meta,
                         x_old, valid_old, w_old, ompi_old, sel_idx=sel_idx)
