"""The fleet's merge remainders, sorted by key per view, without a sort of them.

``fleet_merge`` upserts every view's dense fused-groupby deltas into the
padded stale-sample panel with delete-cancellation and returns the merged
rows sorted by group key (valid rows first, ascending; padding last) —
the stable lexsort order ``compact`` gives the per-view path.  Only the
(V, R) stale keys are sorted; every output row is then written straight
to its sorted slot (``csrc/fleet_merge.cu``; the plain version is
``ref.fleet_merge_rank_ref``).  CPU tensors take the plain version; CUDA
tensors launch the kernels or raise.  Every call dispatches through
``obs.kprof.profiled`` as ``"fleet_merge"``.

Padding contract on outputs: invalid rows are key SENTINEL_KEY, values
0.0, valid False.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build as B
from repro_torch.kernels.fleet_merge.ref import fleet_merge_rank_ref
from repro_torch.obs.kprof import profiled
from repro_torch.relational.relation import SENTINEL_KEY

# csrc/fleet_merge.cu: groups per block of the count and scatter passes, and
# the most stale rows per view its block sort takes (above, a torch sort)
TILE = 4096
SORT_MAX = 16384
_SORT_ARGS = (B.P, B.P, B.I64, B.I64, B.I64, B.P, B.P, B.P, B.P)
_ARGS = (B.P, B.P, B.P, B.P, B.P, B.P, B.P, B.P, B.P, B.I64, B.I64, B.I64, B.I32,
         B.P, B.P, B.P, B.P, B.P, B.P)


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
    if del_valid is not None:
        B.check(del_valid, "del_valid", torch.bool, dev, (V, G))
        B.check(del_vals, "del_vals", torch.float32, dev, (V, G, A))
    return V, R, G, A


def sort_stale(stale_keys: torch.Tensor, stale_valid: torch.Tensor, G: int):
    """Pass 1 on the card: the stable sort of each view's SENTINEL-masked
    stale keys → (sorted keys (V, R) i32, their rows (V, R) i32, and per
    tile of TILE groups the first sorted rank whose key reaches the tile
    (V, tiles + 1) i32).  On the card the block sort in shared memory takes
    R ≤ SORT_MAX; a larger R, and CPU tensors, are sorted by torch."""
    V, R = stale_keys.shape
    dev = stale_keys.device
    tiles = -(-G // TILE)
    if dev.type != "cpu" and R <= SORT_MAX:
        B.check_cuda(dev)
        sk = torch.empty((V, R), dtype=torch.int32, device=dev)
        perm = torch.empty((V, R), dtype=torch.int32, device=dev)
        bounds = torch.empty((V, tiles + 1), dtype=torch.int32, device=dev)
        card = dev.index
        B.launch_on(card, "svc_fleet_merge_sort", _SORT_ARGS, stale_keys.data_ptr(),
                    stale_valid.data_ptr(), V, R, G, sk.data_ptr(), perm.data_ptr(),
                    bounds.data_ptr())
        return sk, perm, bounds
    masked = torch.where(stale_valid, stale_keys, torch.full_like(stale_keys, int(SENTINEL_KEY)))
    sk, perm = torch.sort(masked, dim=1, stable=True)
    starts = (torch.arange(tiles + 1, device=dev) * TILE).clamp(max=G).to(torch.int32)
    bounds = torch.searchsorted(sk, starts.expand(V, tiles + 1).contiguous())
    return sk, perm.to(torch.int32), bounds.to(torch.int32)


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
    if del_valid is None:
        del_vals = None
    V, R, G, A = _check(stale_keys, stale_valid, stale_vals, ins_valid, ins_vals, del_valid,
                        del_vals)
    dev = stale_keys.device
    if V == 0 or G == 0 or A == 0:
        n = R + G
        return (torch.full((V, n), int(SENTINEL_KEY), dtype=torch.int32, device=dev),
                torch.zeros((V, n, A), dtype=torch.float32, device=dev),
                torch.zeros((V, n), dtype=torch.bool, device=dev))
    if dev.type == "cpu":
        if del_valid is None:
            del_valid = torch.zeros((V, G), dtype=torch.bool)
            del_vals = torch.zeros((V, G, A), dtype=torch.float32)
        return profiled("fleet_merge", fleet_merge_rank_ref, stale_keys, stale_valid, stale_vals,
                        ins_valid, ins_vals, del_valid, del_vals, fallback=True, rows=V * R,
                        padded=V * R)
    B.check_cuda(dev)
    if V > 65535 or R + G > 2**31 - 1:
        raise ValueError(f"fleet_merge takes at most 65,535 views of < 2^31 rows, got {V} × {R + G}")
    return profiled("fleet_merge", _launch, stale_keys, stale_valid, stale_vals, ins_valid,
                    ins_vals, del_valid, del_vals, rows=V * R, padded=V * R)


def _launch(stale_keys, stale_valid, stale_vals, ins_valid, ins_vals, del_valid, del_vals):
    dev = stale_keys.device
    V, R = stale_keys.shape
    G, A = ins_vals.shape[1], ins_vals.shape[2]
    sk, perm, bounds = sort_stale(stale_keys, stale_valid, G)
    tiles = bounds.shape[1] - 1
    flags = torch.empty((V, -(-G // 32)), dtype=torch.int32, device=dev)
    counts = torch.empty((V, tiles), dtype=torch.int32, device=dev)
    keys = torch.empty((V, R + G), dtype=torch.int32, device=dev)
    vals = torch.empty((V, R + G, A), dtype=torch.float32, device=dev)
    valid = torch.empty((V, R + G), dtype=torch.bool, device=dev)
    card = dev.index
    B.launch_on(card, "svc_fleet_merge", _ARGS, sk.data_ptr(), perm.data_ptr(),
                bounds.data_ptr(), stale_valid.data_ptr(), stale_vals.data_ptr(),
                ins_valid.data_ptr(), ins_vals.data_ptr(), B.ptr(del_valid), B.ptr(del_vals), V, R,
                G, A, flags.data_ptr(), counts.data_ptr(), keys.data_ptr(), vals.data_ptr(),
                valid.data_ptr())
    fleet_merge.launches += 1
    return keys, vals, valid


fleet_merge.launches = 0
