#!/usr/bin/env python3
"""Device and host time of the fleet_merge, outlier_member, multi_agg, segment_aggsum and fleet_score wrappers, per kernel.

Builds inputs of the shapes and densities that ``chip_smoke.py``'s paths
give these wrappers (numpy, seeded): fleet_merge at 15 views × 4,096 stale
rows (~2,165 valid a view) × 2^20 groups × 2 aggregates, ~9,500 live
insert and ~70 live delete groups a view; the pinned hash over 10M rows
against a 1,000-key table and over 1.5M rows against a 105-key table,
with uniform keys (1% members) and with the smoke's keys (``grow_log``'s
video ids, half Zipf(1.6), against the video ids of 1,000 Zipf(1.6)
sessions, as an outlier index on ``bytes`` picks them: most rows members);
the digest table of 105 and of 1.5M keys; multi_agg's two entries with
``chip_smoke.dashboard``'s 16 queries (Q = 16, P = 2) over visitView's
three columns, the two-sided one over a 2,097,152-row correspondence panel
and the one-sided one over the 1,500,000-row view, each called as the
query engine calls it (with the batch's decoded selector), once with half
the rows valid at random and once with the smoke's shares of valid rows
(1.1% and 0.65% of the panel's sides, 9.2% of the view) in front, as the
engine's panels keep them; segment_aggsum at the smoke's ``kernel_api``
shape (the group-by ids of a 10M-session ``grow_log`` delta in a
16,777,216-row arena: 10M rows in range, the hot group ~2.19M rows, the
rest in the overflow slot G = 1.5M; values ``[bytes, 1]``), through the
sorted route (``segment_sum(..., indices_are_sorted=True)``), the
group-by's entry (``segment_groupby`` on ``[bytes]``, counts in int32)
and the unsorted route on a seeded shuffle of the same rows; fleet_score
on the planner's (16, 13) feature panel.  For each wrapper it prints one
JSON line: the host microseconds a call takes to enqueue (calls without a
synchronize in between), the device microseconds of each kernel a call
runs (``torch.profiler``, averaged over the calls) and their sum, the
kernels a call launches, and the CUDA-event milliseconds of back-to-back
calls.  The last line is the card's name and power limit.

Run on a machine with a card, from the repository root:

    python3 tools/kernel_profile.py [--iters 50] [--only multi_agg|segment_aggsum|fleet_score]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SENTINEL = np.iinfo(np.int32).max


def merge_inputs(rng, V=15, R=4096, n_valid=2165, G=1 << 20, A=2, n_ins=9513, n_del=70):
    import torch

    keys = np.full((V, R), SENTINEL, np.int32)
    valid = np.zeros((V, R), bool)
    for v in range(V):
        keys[v, :n_valid] = np.sort(rng.choice(G, n_valid, replace=False))
        valid[v, :n_valid] = True
    ins = np.zeros((V, G), bool)
    dels = np.zeros((V, G), bool)
    for v in range(V):
        ins[v, rng.choice(G, n_ins, replace=False)] = True
        dels[v, rng.choice(G, n_del, replace=False)] = True
    arrays = (keys, valid, rng.normal(0, 1e3, (V, R, A)).astype(np.float32), ins,
              rng.normal(0, 1e3, (V, G, A)).astype(np.float32), dels,
              rng.normal(0, 1e3, (V, G, A)).astype(np.float32))
    return tuple(torch.from_numpy(a).cuda() for a in arrays)


def pinned_inputs(rng, rows, keys, skewed=False):
    import torch

    videos = 1_000_000
    if skewed:  # repro_torch.data.synthetic.grow_log's ids; an index's sessions' ids
        hot = rng.random(rows) < 0.5
        col = np.where(hot, rng.integers(int(videos * 0.9), videos, rows),
                       rng.zipf(1.6, size=rows) % videos).astype(np.int32)
        table_keys = (rng.zipf(1.6, size=keys) % videos).astype(np.int32)
    else:
        col = rng.integers(0, videos, rows).astype(np.int32)
        table_keys = rng.choice(videos, keys, replace=False).astype(np.int32)
        col[: rows // 100] = table_keys[rng.integers(0, keys, rows // 100)]
    valid = rng.uniform(size=rows) < 0.95
    return ((torch.from_numpy(col).cuda(),), torch.from_numpy(valid).cuda(),
            (torch.from_numpy(table_keys).cuda(),))


MULTI_AGG_COLUMNS = ("videoId", "visitCount", "totalBytes")


def multi_agg_inputs(rng, rows, valid_share, in_front, m=0.1, pinned=0.001):
    """One side of a panel shaped like visitView's: (x, valid, w, ompi), its
    valid rows scattered at random or, as the engine's panels keep them, in
    front."""
    import torch

    x = np.stack([rng.integers(0, 1_000_000, rows), rng.integers(1, 60, rows),
                  rng.gamma(2.0, 4e6, rows)], axis=1).astype(np.float32)
    valid = (np.arange(rows) < valid_share * rows if in_front
             else rng.uniform(size=rows) < valid_share)
    pin = valid & (rng.uniform(size=rows) < pinned)
    w = np.where(pin, 1.0, 1.0 / m).astype(np.float32)
    ompi = np.where(pin, 0.0, 1.0 - m).astype(np.float32)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in (x, valid, w, ompi))


def profile_multi_agg(rng, iters):
    sys.path.insert(0, str(ROOT))
    from chip_smoke import N_VIDEOS, dashboard
    from repro_torch.kernels.multi_agg.ops import multi_agg_one, multi_agg_two
    from repro_torch.query import QueryBatch

    batch = QueryBatch.encode(dashboard(N_VIDEOS), MULTI_AGG_COLUMNS, "cuda")
    kw = {"sel_idx": batch.sel_idx}  # as the query engine calls them
    # every tile holds valid rows (scattered), or the smoke's panels' shares
    # of valid rows in front: 23,646 and 13,715 of the correspondence
    # panel's 2,097,152 rows, 137,800 of the view's 1,500,000
    for share_new, share_old, share_one, in_front in ((0.5, 0.5, 0.5, False),
                                                      (0.0113, 0.0065, 0.0919, True)):
        layout = f"valid {'in front' if in_front else 'scattered'}"
        new = multi_agg_inputs(rng, 2_097_152, share_new, in_front)
        old = multi_agg_inputs(rng, 2_097_152, share_old, in_front)
        measure(f"multi_agg_two rows=2097152 C=3 Q=16 P=2 {layout} {share_new}/{share_old}",
                lambda: multi_agg_two(*new, batch.sel, batch.meta, *old, **kw), iters)
        del new, old
        one = multi_agg_inputs(rng, 1_500_000, share_one, in_front)
        measure(f"multi_agg_one rows=1500000 C=3 Q=16 P=2 {layout} {share_one}",
                lambda: multi_agg_one(*one, batch.sel, batch.meta, **kw), iters)
        del one


def measure(name, fn, iters):
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_us = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    event_ms = start.elapsed_time(end) / iters
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev_us = getattr(e, "self_device_time_total", None)
            if dev_us is None:
                dev_us = e.self_cuda_time_total
            kernels[e.key[:80]] = {"calls_per_call": e.count / iters, "us_per_call": dev_us / iters}
    print(json.dumps({
        "wrapper": name, "host_enqueue_us": host_us, "event_ms": event_ms,
        "device_us": sum(k["us_per_call"] for k in kernels.values()),
        "launches_per_call": sum(k["calls_per_call"] for k in kernels.values()),
        "kernels": kernels,
    }), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--only", choices=("fleet_merge", "outlier_member", "multi_agg",
                                       "segment_aggsum", "fleet_score"))
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("kernel_profile: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    rng = np.random.default_rng(0)
    if args.only in (None, "fleet_merge"):
        profile_fleet_merge(rng, args.iters)
    if args.only in (None, "outlier_member"):
        profile_outlier_member(rng, args.iters)
    if args.only in (None, "multi_agg"):
        profile_multi_agg(np.random.default_rng(0), args.iters)
    if args.only in (None, "segment_aggsum"):
        profile_segment_aggsum(np.random.default_rng(0), args.iters)
    if args.only in (None, "fleet_score"):
        profile_fleet_score(np.random.default_rng(0), args.iters)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    return 0


def profile_fleet_merge(rng, iters):
    from repro_torch.kernels.fleet_merge import fleet_merge, sort_stale

    merge = merge_inputs(rng)
    measure("fleet_merge", lambda: fleet_merge(*merge), iters)
    measure("fleet_merge.sort_stale", lambda: sort_stale(merge[0], merge[1], merge[3].shape[1]),
            iters)


def profile_outlier_member(rng, iters):
    import torch

    from repro_torch.kernels.outlier_member import digest_table, pinned_hash

    for rows, keys in ((10_000_000, 1000), (1_500_000, 105)):
        for skewed in (False, True):
            cols, valid, tkeys = pinned_inputs(rng, rows, keys, skewed)
            table = digest_table(tkeys)
            _v, flag = pinned_hash(cols, valid, 0.1, 0, table)
            share = float(flag.float().mean())
            measure(f"pinned_hash rows={rows} keys={keys} "
                    f"{'smoke keys' if skewed else 'uniform keys'} members={share:.3f}",
                    lambda: pinned_hash(cols, valid, 0.1, 0, table), iters)
        measure(f"digest_table keys={keys}", lambda: digest_table(tkeys), iters)
    big = (torch.from_numpy(rng.integers(0, 1 << 30, 1_500_000).astype(np.int32)).cuda(),)
    measure("digest_table keys=1500000", lambda: digest_table(big), iters)


def segment_inputs(rng, rows=16_777_216, kept=10_000_000, groups=1_500_000, videos=1_000_000):
    """The group-by's ids and ``[bytes, 1]`` over a streamed delta arena:
    ``grow_log``'s video ids (half the newest 10% uniform, half Zipf(1.6)),
    sorted and ranked, then the arena's empty slots in the overflow slot."""
    import torch

    hot = rng.random(kept) < 0.5
    vid = np.where(hot, rng.integers(int(videos * 0.9), videos, kept),
                   rng.zipf(1.6, size=kept) % videos)
    _keys, rank = np.unique(np.sort(vid), return_inverse=True)
    gid = np.concatenate([rank, np.full(rows - kept, groups)]).astype(np.int32)
    vals = np.stack([rng.gamma(2.0, 4e6, rows), np.ones(rows)], 1).astype(np.float32)
    return torch.from_numpy(gid).cuda(), torch.from_numpy(vals).cuda(), groups


def profile_segment_aggsum(rng, iters):
    import torch

    from repro_torch.kernels.segment_aggsum import segment_groupby, segment_sum

    gid, vals, G = segment_inputs(rng)
    hot = int(torch.bincount(gid[gid < G].long()).max())
    tag = f"rows={gid.shape[0]} groups={G} hot={hot}"
    measure(f"segment_sum sorted {tag} C=2",
            lambda: segment_sum(gid, vals, G, indices_are_sorted=True), iters)
    bytes_ = vals[:, :1].contiguous()
    measure(f"segment_groupby {tag} C=1 counts int32", lambda: segment_groupby(gid, bytes_, G),
            iters)
    perm = torch.from_numpy(rng.permutation(gid.shape[0])).cuda()
    gid_sh, vals_sh = gid[perm].contiguous(), vals[perm].contiguous()
    measure(f"segment_sum unsorted (shuffled) {tag} C=2",
            lambda: segment_sum(gid_sh, vals_sh, G), iters)


def profile_fleet_score(rng, iters):
    import torch

    from repro_torch.kernels.fleet_score import N_FEATURES, fleet_scores

    feats = torch.from_numpy(rng.uniform(0.0, 10.0, (16, N_FEATURES)).astype(np.float32)).cuda()
    measure(f"fleet_score V=16 F={N_FEATURES}", lambda: fleet_scores(feats), iters)


if __name__ == "__main__":
    sys.exit(main())
