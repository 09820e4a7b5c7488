"""Distributed SVC: sample cleaning over the shards of a mesh axis (§7.5).

The paper's Spark deployment distributes both the view and the deltas; SVC's
hashing is deterministic and row-local, so each shard cleans its partition
independently and only the *aggregated* delta view is combined — no
shuffle of raw rows.

The port of ``repro.core.distributed_svc``.  Where JAX runs one
``shard_map`` program and ``psum``s the shards' per-group vectors, one
process here drives every shard of a ``launch.mesh.LocalMesh``: shard s
runs on the mesh's s-th device along ``axis`` over its slice of the
sharded arrays, and the psum is a sum of the shards' vectors on the first
device in shard order (deterministic).

``make_sharded_delta_groupby`` takes each shard's η mask from
``kernels.hash_threshold`` and its per-group count and sums from one
``kernels.segment_aggsum.segment_sum``; ``make_sharded_fused_delta_groupby``
runs ``kernels.fused_clean`` (η + γ in one pass) on each shard, the
streaming engine's variant: ``stack_shard_deltas`` builds the sharded
arrays from ``streaming.PartitionedDeltaLog`` drains.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from repro_torch.kernels.fused_clean.ops import fused_clean_groupby
from repro_torch.kernels.hash_threshold import hash_threshold
from repro_torch.kernels.segment_aggsum import segment_sum


def _make_sharded_groupby(mesh, axis: str, agg_cols: Tuple[str, ...], local):
    """Common shard loop + psum: ``local(keys, valid, *vals) -> [count,
    sum_0, ...]`` per shard; returns the runner that sums the shards'
    outputs and names them {"count": ..., col: ...}."""
    devices = mesh.axis_devices(axis)
    n_shards = len(devices)

    def run(keys: torch.Tensor, valid: torch.Tensor,
            values: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        n = keys.shape[0]
        if n % n_shards:
            raise ValueError(f"{n} rows do not shard evenly over {n_shards} shards")
        r = n // n_shards
        # every shard's work enqueued on its card before the first gather
        shard_outs: List[List[torch.Tensor]] = []
        for s, dev in enumerate(devices):
            rows = slice(s * r, (s + 1) * r)
            shard_outs.append(local(keys[rows].to(dev), valid[rows].to(dev),
                                    *[values[c][rows].to(dev) for c in agg_cols]))
        # the psum: on the first device, in shard order
        total: List[torch.Tensor] = []
        for outs in shard_outs:
            outs = [o.to(devices[0]) for o in outs]
            total = outs if not total else [a + b for a, b in zip(total, outs)]
        res = {"count": total[0]}
        for i, c in enumerate(agg_cols):
            res[c] = total[i + 1]
        return res

    return run


def make_sharded_delta_groupby(
    mesh,
    axis: str,
    num_groups: int,
    m: float,
    seed: int,
    agg_cols: Sequence[str],
):
    """Returns f(keys (N,), valid (N,), values dict col->(N,)) -> dict of
    (num_groups,) global aggregates (count + per-col sums) over the hash
    sample.  N is sharded over ``axis``; group keys must be < num_groups.
    """
    agg_cols = tuple(agg_cols)

    def local(keys, valid, *vals):
        keep = hash_threshold([keys], m, seed, valid=valid)
        gid = torch.where(keep, keys, torch.full_like(keys, num_groups))  # overflow slot
        panel = torch.stack([keep.to(torch.float32)] + [
            torch.where(keep, v.to(torch.float32), torch.zeros((), dtype=torch.float32,
                                                               device=v.device))
            for v in vals], dim=1)
        sums = segment_sum(gid, panel, num_groups)
        return [sums[:, i] for i in range(sums.shape[1])]

    return _make_sharded_groupby(mesh, axis, agg_cols, local)


def make_sharded_fused_delta_groupby(
    mesh,
    axis: str,
    num_groups: int,
    m: float,
    seed: int,
    agg_cols: Sequence[str],
):
    """Fused-pass variant of ``make_sharded_delta_groupby``: each shard runs
    the single η+γ pass of kernels/fused_clean over its delta partition (no
    materialized filtered intermediate) and only the dense per-group
    (count, sums) vectors are summed — the streaming engine's per-partition
    DeltaLog drains feed straight into this.  Counts are float32, exact
    below 2^24 rows a group."""
    agg_cols = tuple(agg_cols)

    def local(keys, valid, *vals):
        stacked = (torch.stack([v.to(torch.float32) for v in vals], dim=1) if vals
                   else torch.zeros((keys.shape[0], 0), dtype=torch.float32, device=keys.device))
        counts, sums = fused_clean_groupby(keys, stacked, valid, m, seed, num_groups)
        return [counts] + [sums[:, i] for i in range(len(agg_cols))]

    return _make_sharded_groupby(mesh, axis, agg_cols, local)


def stack_shard_deltas(
    drained,  # list of (inserts, deletes) per shard, from PartitionedDeltaLog.drain()
    key_col: str,
    agg_cols: Sequence[str],
    rows_per_shard: int,
):
    """Flatten per-partition DeltaLog drains into the global sharded arrays
    the sharded group-bys consume: (keys (S*R,), valid (S*R,), values
    col->(S*R,)), on the drains' device.  Each shard's inserts are padded to
    ``rows_per_shard`` so the data axis shards evenly; a drain larger than
    that is an error (size the watermark below the shard arena), as are
    deletes (the sharded aggregation is insert-only)."""
    keys, valid = [], []
    values = {c: [] for c in agg_cols}
    device = next((ins.device for ins, _dels in drained if ins is not None),
                  torch.device("cpu"))

    for shard, (ins, dels) in enumerate(drained):
        if dels is not None:
            raise ValueError(
                f"shard {shard}: sharded delta aggregation is insert-only; "
                "apply deletes at the maintenance period instead"
            )
        if ins is None:
            keys.append(torch.zeros(rows_per_shard, dtype=torch.int32, device=device))
            valid.append(torch.zeros(rows_per_shard, dtype=torch.bool, device=device))
            for c in agg_cols:
                values[c].append(torch.zeros(rows_per_shard, dtype=torch.float32, device=device))
            continue
        if ins.capacity > rows_per_shard:
            raise ValueError(
                f"shard {shard}: drained {ins.capacity} rows > rows_per_shard="
                f"{rows_per_shard}; raise rows_per_shard or lower the watermark"
            )
        pad = rows_per_shard - ins.capacity
        keys.append(torch.nn.functional.pad(ins.col(key_col).to(device, torch.int32), (0, pad)))
        valid.append(torch.nn.functional.pad(ins.valid.to(device), (0, pad)))
        for c in agg_cols:
            values[c].append(torch.nn.functional.pad(ins.col(c).to(device, torch.float32),
                                                     (0, pad)))

    return (
        torch.cat(keys),
        torch.cat(valid),
        {c: torch.cat(v) for c, v in values.items()},
    )


def merge_delta_into_sample(
    sample_keys: torch.Tensor,  # (G,) keys of the sampled view rows (SENTINEL pad)
    sample_vals: Dict[str, torch.Tensor],
    delta: Dict[str, torch.Tensor],  # dense (num_groups,) per-key aggregates
    m: float,
    seed: int,
    num_groups: int,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Apply the (global, dense-keyed) delta view to the sample: existing
    sampled groups are updated in place; groups new to the view enter the
    sample iff their key hashes under the threshold (missing-row rule of
    Property 1).  Only the sample's valid keys (< num_groups) mark
    membership; padding rows mark nothing."""
    dev = sample_keys.device
    all_keys = torch.arange(num_groups, dtype=torch.int32, device=dev)
    live = sample_keys < num_groups
    in_sample_mask = torch.zeros(num_groups, dtype=torch.bool, device=dev)
    in_sample_mask[sample_keys[live].long()] = True
    valid_keys = torch.where(live, sample_keys, torch.zeros_like(sample_keys)).long()
    hashed = hash_threshold([all_keys], m, seed)
    member = in_sample_mask | (hashed & (delta["count"] > 0))
    out_vals = {}
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for c, dv in delta.items():
        sv = sample_vals.get(c, torch.zeros(sample_keys.shape, dtype=torch.float32, device=dev))
        base = torch.zeros(num_groups, dtype=torch.float32, device=dev)
        base.index_add_(0, valid_keys, torch.where(live, sv.to(torch.float32), zero))
        out_vals[c] = torch.where(member, base + dv, zero)
    return torch.where(member, all_keys, torch.full_like(all_keys, 2**31 - 1)), out_vals
