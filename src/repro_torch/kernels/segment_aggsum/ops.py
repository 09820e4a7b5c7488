"""Segment sums: ``out[g, c] = Σ_{gid == g} vals[:, c]``, out-of-range gids dropped.

``segment_groupby`` is the group-by's entry (``relational.ops.groupby``):
ids non-decreasing, as the group-by numbers its sorted rows; it returns
int32 counts and the float32 sums of every column from one pass.
``segment_sum`` is the port of ``repro.kernels.segment_aggsum.ops.
segment_sum``, a library call the JAX package exports; with
``indices_are_sorted=True`` (``jax.ops.segment_sum``'s keyword) it takes
the group-by's kernel, else the kernel for ids in any order.  The caller
chooses the route.  CPU tensors take the plain versions (``ref.py``); CUDA
tensors launch ``csrc/segment_aggsum.cu`` or raise.

The sorted kernel's range records and its ticket live in one persistent
workspace per device (the ticket zeroed once; every launch leaves it at
0), sized for the most blocks the card can hold.  It serves one stream:
two calls in flight on different streams would share it.  Both entries
dispatch through ``obs.kprof.profiled`` as ``"segment_aggsum"``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build as B
from repro_torch.kernels.segment_aggsum.ref import segment_groupby_ref, segment_sum_ref
from repro_torch.obs.kprof import profiled

_ARGS = (B.P, B.P, B.I64, B.I32, B.I64, B.P, B.P)
_SORTED_ARGS = (B.P, B.P, B.I64, B.I32, B.I64, B.P, B.P, B.P, B.P, B.I32, B.P)
MAX_COLS = 8  # columns one launch of the sorted kernel sums (kMaxCols in the source)
BLOCKS_PER_SM = 8  # the most 256-thread blocks an SM holds: the records' bound


_workspace: dict = {}


def _records(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """The device's persistent (ticket + keys + counts int32, sums float64)."""
    ws = _workspace.get(device)
    if ws is None:
        n = 2 * BLOCKS_PER_SM * B.sm_count(device.index or 0)
        ws = _workspace[device] = (torch.zeros(1 + 2 * n, dtype=torch.int32, device=device),
                                   torch.zeros(n * MAX_COLS, dtype=torch.float64, device=device),
                                   n)
    return ws


def _check(gid: torch.Tensor, vals: torch.Tensor, num_groups: int) -> None:
    dev = gid.device
    B.check(gid, "gid", torch.int32, dev, (vals.shape[0],))
    B.check(vals, "vals", torch.float32, dev)
    if num_groups < 0:
        raise ValueError(f"num_groups must be ≥ 0, got {num_groups}")


def _sorted(gid: torch.Tensor, vals: torch.Tensor, num_groups: int,
            counts: torch.Tensor | None) -> torch.Tensor:
    """Launch the sorted kernel over ≤ MAX_COLS columns at a time; fills
    ``counts`` (when given) and returns the (G, C) sums."""
    dev = gid.device
    R, C = vals.shape
    if R == 0 or num_groups == 0 or (C == 0 and counts is None):
        if counts is not None:
            counts.zero_()
        return torch.zeros((num_groups, C), dtype=torch.float32, device=dev)
    ints, f64, n = _records(dev)
    parts = []
    for c0 in range(0, max(C, 1), MAX_COLS):
        part = vals if C <= MAX_COLS else vals[:, c0:c0 + MAX_COLS].contiguous()
        out = torch.empty((num_groups, part.shape[1]), dtype=torch.float32, device=dev)
        B.launch("svc_segment_sorted", _SORTED_ARGS, gid.data_ptr(), part.data_ptr(), R,
                 part.shape[1], num_groups, B.ptr(counts if c0 == 0 else None), out.data_ptr(),
                 ints.data_ptr(), f64.data_ptr(), n, B.stream())
        segment_groupby.launches += 1
        parts.append(out)
    return parts[0] if len(parts) == 1 else torch.cat(parts, 1)


def segment_groupby(gid: torch.Tensor, vals: torch.Tensor,
                    num_groups: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """gid (R,) int32, non-decreasing; vals (R, C) f32 (C may be 0) →
    (counts (num_groups,) int32, sums (num_groups, C) f32).  Rows with gid
    < 0 or ≥ num_groups (the group-by's overflow slot) are dropped.  On the
    card each group's sum is its float64 sum rounded once, the same bits on
    every call; ids out of order still count exactly, with sums whose last
    bits vary."""
    _check(gid, vals, num_groups)
    dev = gid.device
    R = gid.shape[0]
    if dev.type == "cpu":
        return profiled("segment_aggsum", segment_groupby_ref, gid, vals, num_groups,
                        fallback=True, rows=R, padded=R)
    B.check_cuda(dev)
    return profiled("segment_aggsum", _launch_groupby, gid, vals, num_groups, rows=R, padded=R)


def _launch_groupby(gid, vals, num_groups):
    counts = torch.empty(num_groups, dtype=torch.int32, device=gid.device)
    return counts, _sorted(gid, vals, num_groups, counts)


segment_groupby.launches = 0


def segment_sum(gid: torch.Tensor, vals: torch.Tensor, num_groups: int,
                indices_are_sorted: bool = False) -> torch.Tensor:
    """gid (R,) int32; vals (R, C) or (R,) f32 → (num_groups, C) or
    (num_groups,) f32.  Rows with gid < 0 or ≥ num_groups (the group-by's
    overflow slot) are dropped.  ``indices_are_sorted``: the ids are
    non-decreasing, and the call launches the group-by's kernel (counted
    by ``segment_groupby``); else the kernel for ids in any order."""
    squeeze = vals.dim() == 1
    if squeeze:
        vals = vals[:, None]
    _check(gid, vals, num_groups)
    dev = gid.device
    R = vals.shape[0]
    if dev.type == "cpu":
        out = profiled("segment_aggsum", segment_sum_ref, gid, vals, num_groups, fallback=True,
                       rows=R, padded=R)
    else:
        B.check_cuda(dev)
        out = profiled("segment_aggsum", _launch_sum, gid, vals, num_groups, indices_are_sorted,
                       rows=R, padded=R)
    return out[:, 0] if squeeze else out


def _launch_sum(gid, vals, num_groups, indices_are_sorted):
    if indices_are_sorted:
        return _sorted(gid, vals, num_groups, None)
    R, C = vals.shape
    out = torch.zeros((num_groups, C), dtype=torch.float32, device=gid.device)
    if R * C > 0 and num_groups > 0:
        B.launch("svc_segment_sum", _ARGS, gid.data_ptr(), vals.data_ptr(), R, C,
                 num_groups, out.data_ptr(), B.stream())
        segment_sum.launches += 1
    return out


segment_sum.launches = 0
