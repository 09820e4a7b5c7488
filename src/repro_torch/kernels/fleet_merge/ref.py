"""Plain PyTorch version of the fleet-wide merge remainder.

After the fused delta aggregation, each scheduled view still owes its
*merge remainder*: outer-join the delta view onto the stale sample on the
group key and apply generalized projection — add the insert-side
aggregates, subtract the delete-side ones (Example 1 / change-table IVM),
keeping delta-only groups as new rows.  This computes that remainder for
every view of a fleet panel at once over the padded (V, R) stale layout
and dense (V, G) delta layouts, as ``repro.kernels.fleet_merge.ref``.

Row space of the output: R + G rows per view — the first R are the stale
rows (keys kept, aggregates upserted), the last G are delta-only groups
(key g where a delta group has no stale partner).  Float order is the plan
executor's generalized projection, ``(stale + ins) − del`` per aggregate
in f32, so valid rows are bit-equal to the per-view ``clean_sample`` path.

Validity: a stale row stays valid iff it was valid; a delta group emits
its own row iff it is valid on either side and NO valid stale row carries
its key (a group present only in the delete delta emits ``0 − del``);
everything else is padding — key SENTINEL_KEY, values 0, valid False.
"""

from __future__ import annotations

import torch

from repro_torch.relational.relation import SENTINEL_KEY


def _stale_index(stale_keys: torch.Tensor, stale_valid: torch.Tensor, G: int):
    """(in_range (V, R) bool, clipped keys (V, R) int64)."""
    k = stale_keys.to(torch.int32)
    in_range = stale_valid & (k >= 0) & (k < G)
    return in_range, k.clamp(0, max(G - 1, 0)).to(torch.int64)


def delta_only_rows(stale_keys, stale_valid, ins_valid, ins_vals, del_valid, del_vals):
    """Rows for delta groups with no valid stale partner.

    → (keys (V, G) i32, vals (V, G, A) f32, valid (V, G) bool)."""
    stale_valid, ins_valid, del_valid = (t.to(torch.bool) for t in (stale_valid, ins_valid,
                                                                    del_valid))
    V, G = ins_valid.shape
    in_range, kc = _stale_index(stale_keys, stale_valid, G)
    present = torch.zeros((V, G), dtype=torch.float32, device=kc.device)
    present.scatter_add_(1, kc, in_range.to(torch.float32))
    only = (ins_valid | del_valid) & ~(present > 0)
    zero = torch.zeros_like(ins_vals)
    only_vals = torch.where(ins_valid[..., None], ins_vals, zero) - torch.where(
        del_valid[..., None], del_vals, zero)
    only_vals = torch.where(only[..., None], only_vals, zero)
    g_keys = torch.arange(G, dtype=torch.int32, device=kc.device).expand(V, G)
    only_keys = torch.where(only, g_keys, torch.full_like(g_keys, int(SENTINEL_KEY)))
    return only_keys, only_vals, only


def fleet_merge_ref(stale_keys, stale_valid, stale_vals, ins_valid, ins_vals, del_valid,
                    del_vals):
    """→ (keys (V, R+G) i32, vals (V, R+G, A) f32, valid (V, R+G) bool), unsorted."""
    stale_valid, ins_valid, del_valid = (t.to(torch.bool) for t in (stale_valid, ins_valid,
                                                                    del_valid))
    V, R = stale_keys.shape
    G = ins_valid.shape[1]
    A = stale_vals.shape[2]
    k = stale_keys.to(torch.int32)
    in_range, kc = _stale_index(stale_keys, stale_valid, G)

    base = torch.where(stale_valid[..., None], stale_vals, torch.zeros_like(stale_vals))
    kc3 = kc[..., None].expand(V, R, A)
    ins_hit = torch.gather(ins_valid, 1, kc) & in_range
    del_hit = torch.gather(del_valid, 1, kc) & in_range
    zero = torch.zeros_like(base)
    ins_add = torch.where(ins_hit[..., None], torch.gather(ins_vals, 1, kc3), zero)
    del_sub = torch.where(del_hit[..., None], torch.gather(del_vals, 1, kc3), zero)
    upd_vals = (base + ins_add) - del_sub  # the executor's exact float order
    upd_keys = torch.where(stale_valid, k, torch.full_like(k, int(SENTINEL_KEY)))

    only_keys, only_vals, only = delta_only_rows(stale_keys, stale_valid, ins_valid, ins_vals,
                                                 del_valid, del_vals)
    keys = torch.cat([upd_keys, only_keys], dim=1)
    vals = torch.cat([upd_vals, only_vals], dim=1)
    valid = torch.cat([stale_valid, only], dim=1)
    vals = torch.where(valid[..., None], vals, torch.zeros_like(vals))
    return keys, vals, valid


def sort_by_key(keys, vals, valid):
    """Stable ascending sort on SENTINEL-masked keys per view.

    Valid keys are unique per view (group keys), so this is ``compact``'s
    order on valid rows, with all padding (SENTINEL_KEY) at the tail."""
    masked = torch.where(valid, keys, torch.full_like(keys, int(SENTINEL_KEY)))
    order = torch.sort(masked, dim=1, stable=True).indices
    keys = torch.gather(masked, 1, order)
    vals = torch.gather(vals, 1, order[..., None].expand_as(vals))
    valid = torch.gather(valid, 1, order)
    return keys, vals, valid
