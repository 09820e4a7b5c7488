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

``fleet_merge_ref`` is the row space above, unsorted; ``sort_by_key`` of
it is the oracle of the kernel's sorted output.  ``fleet_merge_rank_ref``
is the kernel's own algorithm — a stable sort of the stale keys only, an
exclusive prefix sum of the delta-only flags and a binary search — and
the plain version the wrapper takes on the CPU.
"""

from __future__ import annotations

import torch

from repro_torch.relational.relation import SENTINEL_KEY


def _stale_index(stale_keys: torch.Tensor, stale_valid: torch.Tensor, G: int):
    """(in_range (V, R) bool, clipped keys (V, R) int64)."""
    k = stale_keys.to(torch.int32)
    in_range = stale_valid & (k >= 0) & (k < G)
    return in_range, k.clamp(0, max(G - 1, 0)).to(torch.int64)


def _delta_rows(only, ins_valid, ins_vals, del_valid, del_vals):
    """The delta-only rows of the groups flagged in ``only`` (V, G); every
    other group is padding.  → (keys (V, G) i32, vals (V, G, A) f32, only)."""
    V, G = only.shape
    zero = torch.zeros_like(ins_vals)
    only_vals = torch.where(ins_valid[..., None], ins_vals, zero) - torch.where(
        del_valid[..., None], del_vals, zero)
    only_vals = torch.where(only[..., None], only_vals, zero)
    g_keys = torch.arange(G, dtype=torch.int32, device=only.device).expand(V, G)
    only_keys = torch.where(only, g_keys, torch.full_like(g_keys, int(SENTINEL_KEY)))
    return only_keys, only_vals, only


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
    return _delta_rows(only, ins_valid, ins_vals, del_valid, del_vals)


def _upserted_stale(stale_keys, stale_valid, stale_vals, ins_valid, ins_vals, del_valid,
                    del_vals):
    """The stale rows with their groups' deltas applied, in stale order.

    → (keys (V, R) i32 SENTINEL-masked, vals (V, R, A) f32 (0 on invalid
    rows), valid (V, R) bool)."""
    V, R = stale_keys.shape
    A = stale_vals.shape[2]
    k = stale_keys.to(torch.int32)
    in_range, kc = _stale_index(stale_keys, stale_valid, ins_valid.shape[1])
    base = torch.where(stale_valid[..., None], stale_vals, torch.zeros_like(stale_vals))
    kc3 = kc[..., None].expand(V, R, A)
    ins_hit = torch.gather(ins_valid, 1, kc) & in_range
    del_hit = torch.gather(del_valid, 1, kc) & in_range
    zero = torch.zeros_like(base)
    ins_add = torch.where(ins_hit[..., None], torch.gather(ins_vals, 1, kc3), zero)
    del_sub = torch.where(del_hit[..., None], torch.gather(del_vals, 1, kc3), zero)
    upd_vals = (base + ins_add) - del_sub  # the executor's exact float order
    upd_vals = torch.where(stale_valid[..., None], upd_vals, zero)
    upd_keys = torch.where(stale_valid, k, torch.full_like(k, int(SENTINEL_KEY)))
    return upd_keys, upd_vals, stale_valid


def fleet_merge_ref(stale_keys, stale_valid, stale_vals, ins_valid, ins_vals, del_valid,
                    del_vals):
    """→ (keys (V, R+G) i32, vals (V, R+G, A) f32, valid (V, R+G) bool), unsorted."""
    stale_valid, ins_valid, del_valid = (t.to(torch.bool) for t in (stale_valid, ins_valid,
                                                                    del_valid))
    upd_keys, upd_vals, upd_valid = _upserted_stale(stale_keys, stale_valid, stale_vals,
                                                    ins_valid, ins_vals, del_valid, del_vals)
    only_keys, only_vals, only = delta_only_rows(stale_keys, stale_valid, ins_valid, ins_vals,
                                                 del_valid, del_vals)
    return (torch.cat([upd_keys, only_keys], dim=1), torch.cat([upd_vals, only_vals], dim=1),
            torch.cat([upd_valid, only], dim=1))


def sort_by_key(keys, vals, valid):
    """Stable ascending sort on SENTINEL-masked keys per view.

    On unique valid keys (group keys) this is ``compact``'s order, with all
    padding (SENTINEL_KEY) at the tail.  It is the oracle of the merge's
    output order: stale rows keep their relative order among equal keys
    and come before a delta-only row of the same key."""
    masked = torch.where(valid, keys, torch.full_like(keys, int(SENTINEL_KEY)))
    order = torch.sort(masked, dim=1, stable=True).indices
    keys = torch.gather(masked, 1, order)
    vals = torch.gather(vals, 1, order[..., None].expand_as(vals))
    valid = torch.gather(valid, 1, order)
    return keys, vals, valid


def merge_slots(stale_keys, stale_valid, ins_valid, del_valid):
    """Where every row of the sorted output comes from, without a sort of it.

    The output is a merge of two sorted lists: the stale rows in stable
    order of their SENTINEL-masked keys, and the delta-only groups in key
    order (then the padding).  With ``excl[g]`` the delta-only groups below
    g (an exclusive prefix sum of the delta-only flags) and D their count:

      stale row of sorted rank j, key k → j + (0 if k < 0, excl[k] if
        k in [0, G), D if k ≥ G — SENTINEL included);
      delta-only group g → excl[g] + (stale keys below g);
      any other group g → R + D + (g − excl[g]), the padding slots.

    → (perm (V, R) i64: the stale row of each sorted rank, sorted masked
    keys (V, R) i32, stale slots (V, R) i64, group slots (V, G) i64,
    delta-only flags (V, G) bool).  Every slot in [0, R + G) is taken once.
    """
    V, R = stale_keys.shape
    G = ins_valid.shape[1]
    dev = stale_keys.device
    masked = torch.where(stale_valid, stale_keys.to(torch.int32),
                         torch.full_like(stale_keys, int(SENTINEL_KEY), dtype=torch.int32))
    skeys, perm = torch.sort(masked, dim=1, stable=True)
    g = torch.arange(G, dtype=torch.int32, device=dev).expand(V, G).contiguous()
    below = torch.searchsorted(skeys, g)  # stale keys below g
    if R:
        present = torch.gather(skeys, 1, below.clamp(max=R - 1)) == g
    else:
        present = torch.zeros((V, G), dtype=torch.bool, device=dev)
    only = (ins_valid | del_valid) & ~present
    excl = torch.cumsum(only, dim=1) - only.to(torch.int64)
    D = only.sum(dim=1, keepdim=True)
    k = skeys.to(torch.int64)
    cnt = torch.where(k < 0, torch.zeros_like(k),
                      torch.where(k >= G, D.expand(V, R),
                                  torch.gather(excl, 1, k.clamp(0, max(G - 1, 0)))))
    stale_slot = torch.arange(R, device=dev) + cnt
    group_slot = torch.where(only, excl + below, R + D + (g.to(torch.int64) - excl))
    return perm, skeys, stale_slot, group_slot, only


def fleet_merge_rank_ref(stale_keys, stale_valid, stale_vals, ins_valid, ins_vals, del_valid,
                         del_vals):
    """The kernel's algorithm as plain PyTorch: ``merge_slots`` places every
    upserted stale row and every delta-only or padding row directly.

    → (keys, vals, valid) over R + G rows per view, equal bit for bit to
    ``sort_by_key(*fleet_merge_ref(...))``."""
    stale_valid, ins_valid, del_valid = (t.to(torch.bool) for t in (stale_valid, ins_valid,
                                                                    del_valid))
    V, R = stale_keys.shape
    G = ins_valid.shape[1]
    A = stale_vals.shape[2]
    perm, _skeys, stale_slot, group_slot, only = merge_slots(stale_keys, stale_valid,
                                                             ins_valid, del_valid)
    upd_keys, upd_vals, upd_valid = _upserted_stale(stale_keys, stale_valid, stale_vals,
                                                    ins_valid, ins_vals, del_valid, del_vals)
    only_keys, only_vals, only = _delta_rows(only, ins_valid, ins_vals, del_valid, del_vals)
    n = R + G
    dev = stale_keys.device
    keys = torch.empty((V, n), dtype=torch.int32, device=dev)
    vals = torch.empty((V, n, A), dtype=torch.float32, device=dev)
    valid = torch.empty((V, n), dtype=torch.bool, device=dev)
    for slot, rows, (k, x, ok) in ((stale_slot, perm, (upd_keys, upd_vals, upd_valid)),
                                   (group_slot, None, (only_keys, only_vals, only))):
        if rows is not None:
            k, ok = torch.gather(k, 1, rows), torch.gather(ok, 1, rows)
            x = torch.gather(x, 1, rows[..., None].expand(V, R, A))
        keys.scatter_(1, slot, k)
        valid.scatter_(1, slot, ok)
        vals.scatter_(1, slot[..., None].expand(x.shape), x)
    return keys, vals, valid
