#!/usr/bin/env python3
"""Device and host time of the fleet_merge and outlier_member wrappers, per kernel.

Builds inputs of the shapes and densities that ``chip_smoke.py``'s paths
give these wrappers (numpy, seeded): fleet_merge at 15 views × 4,096 stale
rows (~2,165 valid a view) × 2^20 groups × 2 aggregates, ~9,500 live
insert and ~70 live delete groups a view; the pinned hash over 10M rows
against a 1,000-key table and over 1.5M rows against a 105-key table,
with uniform keys (1% members) and with the smoke's keys (``grow_log``'s
video ids, half Zipf(1.6), against the video ids of 1,000 Zipf(1.6)
sessions, as an outlier index on ``bytes`` picks them: most rows members);
the digest table of 105 and of 1.5M keys.  For each wrapper it prints one
JSON line: the host microseconds a call takes to enqueue (calls without a
synchronize in between), the device microseconds of each kernel a call
runs (``torch.profiler``, averaged over the calls) and their sum, the
kernels a call launches, and the CUDA-event milliseconds of back-to-back
calls.  The last line is the card's name and power limit.

Run on a machine with a card, from the repository root:

    python3 tools/kernel_profile.py [--iters 50]
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
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("kernel_profile: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.fleet_merge import fleet_merge, sort_stale
    from repro_torch.kernels.outlier_member import digest_table, pinned_hash

    rng = np.random.default_rng(0)
    merge = merge_inputs(rng)
    measure("fleet_merge", lambda: fleet_merge(*merge), args.iters)
    measure("fleet_merge.sort_stale", lambda: sort_stale(merge[0], merge[1], merge[3].shape[1]),
            args.iters)
    del merge
    for rows, keys in ((10_000_000, 1000), (1_500_000, 105)):
        for skewed in (False, True):
            cols, valid, tkeys = pinned_inputs(rng, rows, keys, skewed)
            table = digest_table(tkeys)
            _v, flag = pinned_hash(cols, valid, 0.1, 0, table)
            share = float(flag.float().mean())
            measure(f"pinned_hash rows={rows} keys={keys} "
                    f"{'smoke keys' if skewed else 'uniform keys'} members={share:.3f}",
                    lambda: pinned_hash(cols, valid, 0.1, 0, table), args.iters)
        measure(f"digest_table keys={keys}", lambda: digest_table(tkeys), args.iters)
    big = (torch.from_numpy(rng.integers(0, 1 << 30, 1_500_000).astype(np.int32)).cuda(),)
    measure("digest_table keys=1500000", lambda: digest_table(big), args.iters)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
