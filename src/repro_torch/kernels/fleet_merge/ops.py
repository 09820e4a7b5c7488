"""The fleet's merge remainders in one launch, sorted by key per view.

``fleet_merge`` upserts every view's dense fused-groupby deltas into the
padded stale-sample panel with delete-cancellation and returns the merged
rows sorted by group key (valid rows first, ascending; padding last) —
the stable lexsort order ``compact`` gives the per-view path.  The stable
per-view key sort is torch glue around the kernel, as it is XLA glue in
the JAX package.  CPU tensors take the plain version (``ref.py``); CUDA
tensors launch ``csrc/fleet_merge.cu`` or raise.

Padding contract on outputs: invalid rows are key SENTINEL_KEY, values
0.0, valid False.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build as B
from repro_torch.kernels.fleet_merge.ref import fleet_merge_ref, sort_by_key
from repro_torch.relational.relation import SENTINEL_KEY

_ARGS = (B.P, B.P, B.P, B.P, B.P, B.P, B.P, B.I64, B.I64, B.I64, B.I32,
         B.P, B.P, B.P, B.P, B.P)


def _check(stale_keys, stale_valid, stale_vals, ins_valid, ins_vals, del_valid, del_vals):
    if stale_keys.dim() != 2 or stale_vals.dim() != 3 or ins_vals.dim() != 3:
        raise ValueError("fleet_merge expects (V, R[, A]) / (V, G[, A]) panels")
    V, R = stale_keys.shape
    G = ins_valid.shape[1]
    A = stale_vals.shape[2]
    dev = stale_keys.device
    B.check(stale_keys, "stale_keys", torch.int32, dev, (V, R))
    B.check(stale_valid, "stale_valid", torch.bool, dev, (V, R))
    B.check(stale_vals, "stale_vals", torch.float32, dev, (V, R, A))
    B.check(ins_valid, "ins_valid", torch.bool, dev, (V, G))
    B.check(ins_vals, "ins_vals", torch.float32, dev, (V, G, A))
    B.check(del_valid, "del_valid", torch.bool, dev, (V, G))
    B.check(del_vals, "del_vals", torch.float32, dev, (V, G, A))
    return V, R, G, A


def merge_unsorted(stale_keys, stale_valid, stale_vals, ins_valid, ins_vals, del_valid,
                   del_vals):
    """The upsert and delta-only rows, unsorted: (keys, vals, valid) over R + G
    rows per view.  Shapes must be non-degenerate (V, G, A > 0)."""
    V, R, G, A = _check(stale_keys, stale_valid, stale_vals, ins_valid, ins_vals, del_valid,
                        del_vals)
    dev = stale_keys.device
    if dev.type == "cpu":
        return fleet_merge_ref(stale_keys, stale_valid, stale_vals, ins_valid, ins_vals,
                               del_valid, del_vals)
    B.check_cuda(dev)
    keys = torch.empty((V, R + G), dtype=torch.int32, device=dev)
    vals = torch.empty((V, R + G, A), dtype=torch.float32, device=dev)
    valid = torch.empty((V, R + G), dtype=torch.bool, device=dev)
    present = torch.zeros((V, G), dtype=torch.uint8, device=dev)
    B.launch("svc_fleet_merge", _ARGS, stale_keys.data_ptr(), stale_valid.data_ptr(),
             stale_vals.data_ptr(), ins_valid.data_ptr(), ins_vals.data_ptr(),
             del_valid.data_ptr(), del_vals.data_ptr(), V, R, G, A, present.data_ptr(),
             keys.data_ptr(), vals.data_ptr(), valid.data_ptr(), B.stream())
    fleet_merge.launches += 1
    return keys, vals, valid


def fleet_merge(
    stale_keys: torch.Tensor,   # (V, R) int32 group keys
    stale_valid: torch.Tensor,  # (V, R) bool
    stale_vals: torch.Tensor,   # (V, R, A) f32 aggregate columns
    ins_valid: torch.Tensor,    # (V, G) bool insert-delta group liveness
    ins_vals: torch.Tensor,     # (V, G, A) f32 dense insert aggregates
    del_valid: Optional[torch.Tensor] = None,  # (V, G) bool delete-delta liveness
    del_vals: Optional[torch.Tensor] = None,   # (V, G, A) f32
):
    """Batched merge remainder for a fleet panel.

    → (keys (V, R+G) i32, vals (V, R+G, A) f32, valid (V, R+G) bool)
    sorted by key per view, padding last.  ``del_*=None`` means no delete
    side (views without ``with_deletes``)."""
    if stale_keys.dim() != 2 or stale_vals.dim() != 3 or ins_vals.dim() != 3:
        raise ValueError("fleet_merge expects (V, R[, A]) / (V, G[, A]) panels")
    V, R = stale_keys.shape
    G = ins_valid.shape[1]
    A = stale_vals.shape[2]
    dev = stale_keys.device
    if del_valid is None:
        del_valid = torch.zeros((V, G), dtype=torch.bool, device=dev)
        del_vals = torch.zeros((V, G, A), dtype=torch.float32, device=dev)
    if V == 0 or G == 0 or A == 0:
        _check(stale_keys, stale_valid, stale_vals, ins_valid, ins_vals, del_valid, del_vals)
        n = R + G
        return (torch.full((V, n), int(SENTINEL_KEY), dtype=torch.int32, device=dev),
                torch.zeros((V, n, A), dtype=torch.float32, device=dev),
                torch.zeros((V, n), dtype=torch.bool, device=dev))
    return sort_by_key(*merge_unsorted(stale_keys, stale_valid, stale_vals, ins_valid,
                                       ins_vals, del_valid, del_vals))


fleet_merge.launches = 0
