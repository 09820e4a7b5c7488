#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Builds the CUDA kernels from ``src/repro_torch/csrc`` and drives, at full
size, through the entry points a user calls:

  1. the single-view SVC loop — the paper's running example visitView
     (§2.1, Conviva-shaped session logs, as in ``examples/quickstart.py``)
     through ``ViewManager``; every group-by (``register_view``, the
     unfused clean, the IVM of ``maintain_all``) sums through
     segment_aggsum's sorted kernel, whose int32 counts are held exact on
     visitView's largest group (above 2^24 sessions);
  2. streaming ingest on the same manager — a 10M-session delta as 20
     out-of-order micro-batches through ``StreamingViewService`` (size and
     age watermarks, a spilling ring), answered through the service
     (dashboard, median/percentile/min/max, a select) before and checked
     after ``maintain_all``; then ``segment_sum`` (over the sorted ids and
     over their shuffle) and ``corr_moments``, the library kernels, on that
     path's group-by ids and CORR join; then the group-by's kernel rows in
     the profiles of one unfused clean and one warm ``maintain_all``;
  3. the fleet control plane — 16 group-by views over their own
     Conviva-shaped logs (``benchmarks/fig_planner_fleet.py`` at a real
     size): ``svc_refresh_many`` against per-view cleans, then 5 epochs of
     ``MaintenancePlanner`` under a Zipf query stream;
  4. LM serving — gemma-2b at full width in bf16 (random weights from a
     seed) through ``ServeEngine``: 16 requests on 8 slots, one telemetry
     row per decode tick into a streaming SVC view, then ``dashboard()``
     and ``dashboard("observatory")`` (a kernel profiler installed around
     that call alone); prefill against token-by-token decode, and the
     smoke model on the card against the CPU.  Every attention is the
     flash_attention kernel.

The observatory and the chaos layer ride on these paths:
  * ``chaos_stream`` (after the streaming path): two fresh managers over
    visitView's relations, each fed a new 10M-session delta as 20 shuffled
    micro-batches through a service with admission on; one under a
    hand-written FaultPlan (a duplicate and a corrupt copy, a slow drain, a
    traffic spike, a poisoned cache, a backwards clock) with the tracer on.
    Its exported trace and its observatory panel must reconcile, each fault
    must show in its counter, and after a final refresh its dashboard must
    equal the fault-free service's.
  * ``chaos_fleet`` (after the fleet path): the fleet twice from the same
    host logs, 5 planner epochs each, one twin under FaultPlan.random of
    every action-path fault kind with the tracer on, then recovery epochs
    and ``maintain_all``: its trace reconciles, every injected kernel_error
    is a fleet_merge_failure, and the twins' views and samples agree.
  * ``kprof``: a KernelProfiler over one warm pass of the main path (fused,
    pinned and unfused refreshes, query_batch, the kernel_api entries) and
    of the fleet (svc_refresh_many, a maintain, a planner epoch): no op
    takes its plain version, every wrapper that launched dispatched, and
    the ops' execute seconds fit in the window; with no profiler, the
    median host enqueue of hash_threshold and fleet_scores.

Each path runs with the launch counters set to 0 just before it and read
just after (the main path and ``kernel_api`` also give, in ``routes``,
the launches of hash_threshold and corr_moments by route: 16-byte vector
or scalar); every kernel is then held against its plain PyTorch version on
its path's own tensors.  One JSON object per phase; the line before the
last two is the kernel table, the next the card's name and power limit as
``nvidia-smi`` reports them, and the last line is
``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, without a CUDA device, outside a
checkout of the repository, or when any check fails.

Run:  python3 chip_smoke.py                        (full size, one GPU)
      python3 chip_smoke.py --n-logs 20000000     (the one allowed cut)
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12  # H100 SXM bf16 tensor cores, dense
U = 2.0 ** -24  # float32 unit roundoff
# a sum carried in float64 and rounded once to float32 (corr_diff) lies
# within u·|S| + γ64_{n−1}·Σ|x| of the exact sum: far inside 1e-6·Σ|x|
F64_SUM_RTOL = 1e-6

# The scenario (visitView at the sizing of benchmarks/common.py:142-158).
N_VIDEOS = 1_000_000  # the largest round key domain under the fused bound
N_LOGS = 100_000_000
MIN_N_LOGS = 20_000_000  # the only cut allowed: fewer sessions, down to here
N_DELTA = 10_000_000  # grow_log sessions ingested before the clean
M = 0.1
K = 1000
SEED = 0
ITERS = 20  # calls per timing
# device against CPU, at a size the CPU path runs in seconds
SMALL_VIDEOS, SMALL_LOGS, SMALL_DELTA = 2_000, 200_000, 20_000

# The fleet (benchmarks/fig_planner_fleet.py:95-110 at a real size): 16
# views, each a group-by over its own Conviva-shaped log of 5M sessions on
# 1M videos (a fused key domain of 2^20, MAX_FUSED_GROUPS).
FLEET_VIEWS = 16  # N_VIEWS_FULL, fig_planner_fleet.py:55
FLEET_VIDEOS = 1_000_000
FLEET_LOGS = 5_000_000
FLEET_DELTA = 500_000  # per view and epoch: 10%, the update fraction of fig5_accuracy.py
FLEET_DELETES = 50_000  # existing sessions deleted from each with_deletes view (1%)
FLEET_GROUPS = 1_500_000  # delta_group_capacity and the group-by's arena
FLEET_EPOCHS = 5  # EPOCHS, fig_planner_fleet.py:56
FLEET_QUERIES_PER_HIT = 16
FLEET_HITS = 15  # Zipf-drawn view hits per epoch (240 queries)
# the starvation guard's age cap, in epochs of the planner's clock: every
# view was last maintained at epoch 0, so the guard maintains the drifting
# fleet in epoch 4; the last epoch runs with adapt_m (ratio retunes)
FLEET_AGE_CAP_EPOCHS = 3.5
# model-unit prices of the small card-against-CPU fleet, where measured
# walls would differ between the two devices
CLEAN_COST, MAINTAIN_COST = 1.0, 4.0

# The streaming path, on the visitView manager after the main path: a fresh
# 10M-session grow_log delta (its own seed) as 20 micro-batches of 500k
# sessions offered in a shuffled seq order.  Eight batches fill the ring;
# the ninth spills it and trips the size watermark (4.5M rows); the same
# again; the last 1M rows wait until the clock passes the age watermark.
STREAM_CONFIG = dict(max_rows=4_500_000, max_age_s=3600.0, max_batches=8)
STREAM_BATCHES = 20
STREAM_SEED = 1
SMALL_STREAM_BATCHES = 4

# The observatory and chaos layer.  kprof: a KernelProfiler over one warm
# pass of the main path (on visitView, after a fresh 1M-session delta) and
# of the fleet (one svc_refresh_many and one planner epoch); host enqueue
# medians of KPROF_REPEATS loops of ITERS calls with no profiler installed.
KPROF_DELTA = 1_000_000
KPROF_REPEATS = 5  # tools/kernel_profile.py's REPEATS
# chaos_fleet: the fleet twice from the same host logs, one twin under a
# random plan of every action-path fault kind (FaultPlan.random(views,
# epochs 1-5, rate 0.3, seed 0)); recovery epochs until nothing is
# quarantined (at most CHAOS_RECOVERY_EPOCHS), then maintain_all
CHAOS_FLEET_KINDS = ("refresh_error", "maintain_error", "kernel_error", "latency", "nan_panel")
CHAOS_FLEET_RATE = 0.3
CHAOS_RECOVERY_EPOCHS = 12
# chaos_stream: a fresh 10M-session delta (seed 2) as 20 shuffled, keyed
# micro-batches into two services over visitView's relations, one under a
# hand-written plan: (kind, epoch, target, magnitude); an epoch is one
# offer, followed by two dashboards (times any traffic spike), with a
# forced refresh every fifth offer.  Admission is on with the defaults and
# a 2 s drain-cost overload threshold: the 10 s slow drain at epoch 10
# raises the drain EWMA (α = 0.3) to ~3 s, and the drains at 15 and 20
# bring it back under 2 s before the final dashboard.
CHAOS_STREAM_SEED = 2
CHAOS_STREAM_FAULTS = (
    ("duplicate_batch", 3, "Log", 0.0),
    ("cache_poison", 4, "visitView", 0.0),
    ("corrupt_batch", 6, "Log", 0.0),
    ("traffic_spike", 7, "*", 10.0),
    ("slow_drain", 10, "*", 10.0),
    ("clock_skew", 16, "*", -30.0),
)
CORRUPT_EPOCH = next(e for k, e, _t, _m in CHAOS_STREAM_FAULTS if k == "corrupt_batch")
CHAOS_STREAM_ADMISSION = dict(drain_overload_s=2.0)
CHAOS_REFRESH_EVERY = 5
CHAOS_SETTLE_S = 10.0  # clock seconds between the last offer and the final dashboard
CHAOS_DASHBOARDS = 2
# the fleet tolerance of float columns (tests/test_fleet_panel.py:257-261)
FLEET_RTOL, FLEET_ATOL = 1e-6, 1e-4
# two services' dashboards over samples within same_sample's bound
CHAOS_ANSWER_RTOL = 1e-5

# The LM serving path (src/repro/launch/serve.py's default --arch): gemma-2b
# at full width in bf16 through ServeEngine, 16 requests of 16–256 prompt
# tokens (numpy seed 0) and 32 new tokens each on 8 slots; every decode
# tick offers a telemetry row to serveView, refreshed each 32 ticks.
SERVE_ARCH = "gemma-2b"
SERVE_MAX_BATCH, SERVE_MAX_SEQ = 8, 1024
SERVE_REQUESTS, SERVE_MAX_NEW = 16, 32
SERVE_PROMPT_LENS = (16, 256)
SERVE_TICK_CAPACITY = 1024  # ticks serveView holds (the run takes ~64)
SERVE_STREAM = dict(max_rows=32, max_age_s=3600.0, max_batches=64)
SERVE_PREFILL_LEN = 256
# bf16 at full width: the prefill and the token-by-token decode sum in
# other orders, so an activation may round to a neighbouring bf16 value
# (2^-8 relative) and carry it through 18 layers
PREFILL_DECODE_TOL = 3e-2
SERVE_DEVICE_CPU_ATOL = 1e-4  # f32 smoke model, TF32 off
# the kernel against its plain version: f32 sums in both; a bf16 output may
# round to the neighbouring value
FLASH_TOL = {"torch.bfloat16": 1e-2, "torch.float32": 1e-4}
# and to the output's own scale: max |kernel - plain| at most one bf16 ulp
# of the largest |plain| (at DECODE_32K's length the outputs are ~0.01, far
# under FLASH_TOL's atol)
FLASH_SCALED_TOL = 2.0 ** -7
# (label, (B, S, T, H, K, hd), causal): DECODE_32K's length with gemma-2b's
# heads, a long causal prefill, and the GQA head dims of granite-3-2b (64),
# phi3-mini (96) and qwen2-vl-72b (128) at a small batch
FLASH_SHAPES = (
    ("decode_32k gemma-2b", (32, 1, 32768, 8, 1, 256), False),
    ("prefill 4096 gemma-2b", (1, 4096, 4096, 8, 1, 256), True),
    ("prefill 1024 granite-3-2b", (2, 1024, 1024, 32, 8, 64), True),
    ("prefill 1024 phi3-mini", (2, 1024, 1024, 32, 32, 96), True),
    ("decode 4096 qwen2-vl-72b", (4, 1, 4096, 64, 8, 128), False),
)

# the kernels each path must launch
SVC_LOOP_KERNELS = ("hash_threshold", "fused_clean", "outlier_member", "outlier_digest",
                    "multi_agg_two", "multi_agg_one", "segment_aggsum")
FLEET_KERNELS = ("fused_clean_fleet", "fleet_merge", "fleet_moments", "fleet_score")
STREAM_KERNELS = ("fused_clean", "multi_agg_two", "multi_agg_one")
API_KERNELS = ("segment_aggsum", "segment_aggsum_unsorted", "corr_diff")
# every layer's attention, and the telemetry view's cleans and dashboard
SERVE_KERNELS = ("flash_attention", "hash_threshold", "fused_clean", "multi_agg_two",
                 "multi_agg_one")



def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean device milliseconds of ``fn`` over ``iters`` calls (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_enqueue_us(fn, iters: int) -> float:
    """Mean host microseconds a call of ``fn`` takes to return, calls back to
    back with no synchronize between them (the enqueue, not the device)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return us


def cold_ms(fn, iters: int) -> float:
    """Median device milliseconds of one call of ``fn`` that finds the L2
    cache cold: a 256 MB buffer (five times the card's 50 MB L2) is written
    before each call, and each call is timed by its own event pair.  The
    L2 then holds the buffer's dirty lines, whose write-back the call pays
    as a caller after a large write would."""
    import torch

    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(iters)]
    fn()
    for start, end in pairs:
        flush.fill_(1.0)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in pairs]))


def wall(fn):
    """(result, host seconds) of ``fn`` ending in a device synchronize."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def device_launches(fn, calls: int = 4, tries: int = 3) -> float:
    """Kernels, copies and memsets the card ran per call of ``fn``: the
    profiler's device rows over ``calls`` calls after one warm-up step,
    divided by ``calls``, the largest of ``tries`` profiles (a profile late
    in this process at times dropped a call's kernels; none adds one)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    best = 0.0
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=calls, repeat=1)) as prof:
            for _ in range(calls + 1):
                fn()
                torch.cuda.synchronize()
                prof.step()
        best = max(best, sum(e.count for e in prof.key_averages()
                             if e.device_type == torch.autograd.DeviceType.CUDA
                             and not e.key.startswith("ProfilerStep")) / calls)
    return best


def profile_ops(fn, top: int = 10, match: tuple = ()) -> dict:
    """One call of ``fn`` under ``torch.profiler``: self host and device
    milliseconds in all, the ``top`` operators by each, the calls of the
    CUDA runtime entries that launch kernels, copy or wait, and every row
    whose name holds one of ``match``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        rows.append({"op": e.key, "calls": e.count, "self_cpu_ms": e.self_cpu_time_total / 1e3,
                     "self_device_ms": dev_us / 1e3})
    runtime = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpyAsync", "cudaStreamSynchronize",
               "cudaDeviceSynchronize")
    sort = [r for r in rows if r["op"] == "aten::sort"]
    return {
        "self_cpu_ms": sum(r["self_cpu_ms"] for r in rows),
        "self_device_ms": sum(r["self_device_ms"] for r in rows),
        "device_launches": sum(e.count for e in prof.key_averages()
                               if e.device_type == torch.autograd.DeviceType.CUDA),
        "sort_calls": sum(r["calls"] for r in sort),
        "sort_device_ms": sum(r["self_device_ms"] for r in sort),
        "top_cpu": sorted(rows, key=lambda r: -r["self_cpu_ms"])[:top],
        "top_device": sorted(rows, key=lambda r: -r["self_device_ms"])[:top],
        "runtime_calls": {r["op"]: r["calls"] for r in rows if r["op"] in runtime},
        "matching": [r for r in rows if any(m in r["op"] for m in match)],
    }


# ---------------------------------------------------------------------------
# The scenario: visitView over Log ⋈ Video (benchmarks/common.py sizing)
# ---------------------------------------------------------------------------

def dashboard(n_videos: int):
    """A 16-query dashboard over visitView: count/sum/avg, 0–2 predicates."""
    from repro_torch.core import Query
    from repro_torch.relational.expr import Cmp, Col, Lit, and_

    hot = float(int(n_videos * 0.9))
    vc, tb, vid = Col("visitCount"), Col("totalBytes"), Col("videoId")
    return [
        Query("count"),
        Query("sum", "visitCount"),
        Query("sum", "totalBytes"),
        Query("avg", "totalBytes"),
        Query("avg", "visitCount"),
        Query("count", pred=Cmp("gt", vc, Lit(30.0))),
        Query("sum", "totalBytes", pred=Cmp("ge", vid, Lit(hot))),
        Query("count", pred=Cmp("ge", vid, Lit(hot))),
        Query("avg", "totalBytes", pred=Cmp("gt", vc, Lit(10.0))),
        Query("sum", "visitCount", pred=and_(Cmp("ge", vid, Lit(0.0)),
                                             Cmp("lt", vid, Lit(float(n_videos // 2))))),
        Query("sum", "totalBytes", pred=and_(Cmp("gt", vc, Lit(5.0)), Cmp("lt", vid, Lit(hot)))),
        Query("count", pred=and_(Cmp("ge", vc, Lit(2.0)), Cmp("le", vc, Lit(50.0)))),
        Query("avg", "visitCount", pred=Cmp("lt", vid, Lit(1000.0))),
        Query("sum", "totalBytes", pred=Cmp("le", vc, Lit(3.0))),
        Query("count", pred=Cmp("eq", vc, Lit(1.0))),
        Query("avg", "totalBytes", pred=and_(Cmp("ge", vid, Lit(hot)), Cmp("gt", vc, Lit(1.0)))),
    ]


def build_scenario(n_videos, n_logs, n_delta, m, seed, device):
    from repro_torch.core import ViewDef
    from repro_torch.data.synthetic import grow_log, make_log_video
    from repro_torch.relational.plan import FKJoin, GroupByNode, Scan
    from repro_torch.views import ViewManager

    rng = np.random.default_rng(seed)
    log, video = make_log_video(rng, n_videos, n_logs, device=device)
    delta = grow_log(rng, n_videos, n_logs, n_delta, device=device)
    groups = int(n_videos * 1.5)
    plan = GroupByNode(
        child=FKJoin(fact=Scan("Log", pk=("sessionId",)),
                     dim=Scan("Video", pk=("videoId",)), fact_key="videoId"),
        keys=("videoId",),
        aggs=(("visitCount", "count", None), ("totalBytes", "sum", "bytes")),
        num_groups=groups,
    )
    vm = ViewManager(device=device)
    return vm, ViewDef("visitView", plan), log, video, delta, groups


def sorted_sample(rel):
    from repro_torch.relational.relation import to_host

    h = to_host(rel)
    order = np.argsort(h["videoId"], kind="stable")
    return {k: v[order] for k, v in h.items()}


def f32_sum_rtol(n):
    """γ_{n−1} = (n−1)u / (1 − (n−1)u): a float32 sum of n terms, added in
    any order, lies within γ_{n−1}·Σ|x| of the exact sum (Higham, Accuracy
    and Stability of Numerical Algorithms, 2nd ed., §4.2).  No tighter
    bound holds for every order: once a running sum is large, terms below
    half its ulp are lost one way, so the errors need not cancel.  Infinite
    from n − 1 = 2^24 on, where float32 bounds nothing."""
    k = np.maximum(np.asarray(n, dtype=np.float64) - 1.0, 0.0) * U
    return np.where(k < 1.0, k / np.maximum(1.0 - k, 1e-300), np.inf)


def same_sample(a, b, what: str) -> dict:
    """Keys, counts and flags exact; sums within twice the float32 bound.

    A group's totalBytes adds visitCount non-negative float32 values (so
    Σ|x| is about the sum itself) in an order that differs between the two
    sides; each side lies within ``f32_sum_rtol`` of the exact sum.
    """
    for col in ("videoId", "visitCount") + (("__outlier",) if "__outlier" in a else ()):
        if not np.array_equal(a[col], b[col]):
            fail(f"{what}: column {col} differs")
    rtol = 2 * f32_sum_rtol(a["visitCount"])
    ta, tb = a["totalBytes"].astype(np.float64), b["totalBytes"].astype(np.float64)
    rel = np.abs(ta - tb) / np.maximum(np.abs(tb), 1e-30)
    if np.any(np.abs(ta - tb) > rtol * np.abs(tb)):
        fail(f"{what}: totalBytes beyond tolerance (max rel {rel.max():.3e})")
    return {"rows": int(a["videoId"].shape[0]), "max_rel_err_totalBytes": float(rel.max())}


def run_svc_loop(vm, view, log, video, delta, groups, m, k, queries):
    """register → ingest → refresh → query_batch(auto, aqp) → outlier index →
    refresh → query_batch → refresh(fused=False) → maintain_all."""
    from repro_torch.kernels.segment_aggsum import segment_groupby

    name = view.name
    t = {}
    groupby_launches = {}
    n0 = segment_groupby.launches
    _, t["register_s"] = wall(lambda: (
        vm.register_base("Log", log), vm.register_base("Video", video),
        vm.register_view(view, delta_bases=("Log",), m=m, delta_group_capacity=groups)))
    groupby_launches["register_view"] = segment_groupby.launches - n0
    registered = vm.views[name].materialized
    _, t["ingest_s"] = wall(lambda: vm.ingest("Log", inserts=delta))
    t["svc_refresh_fused_s"] = vm.svc_refresh(name)
    auto, t["query_batch_auto_s"] = wall(lambda: vm.query_batch(name, queries))
    aqp, t["query_batch_aqp_s"] = wall(lambda: vm.query_batch(name, queries, prefer="aqp"))
    from repro_torch.kernels.outlier_member.ops import digest_table, pinned_hash

    _, t["register_outlier_index_s"] = wall(
        lambda: vm.register_outlier_index(name, "Log", "bytes", k=k))
    before = pinned_hash.launches, digest_table.launches
    t["svc_refresh_pinned_s"] = vm.svc_refresh(name)
    # the pinned refresh: its pinned hashes and table builds, then the same
    # refresh again (same deltas, same sample) under the profiler
    pinned_refresh = {"wall_s": t["svc_refresh_pinned_s"],
                      "pinned_hash_launches": pinned_hash.launches - before[0],
                      "table_builds": digest_table.launches - before[1]}
    prof = profile_ops(lambda: vm.svc_refresh(name))
    pinned_refresh["warm_profile"] = {k: prof[k] for k in (
        "self_cpu_ms", "self_device_ms", "device_launches", "runtime_calls")}
    pinned, t["query_batch_pinned_s"] = wall(lambda: vm.query_batch(name, queries))
    fused_sample = vm.views[name].clean_sample
    n0 = segment_groupby.launches
    t["svc_refresh_unfused_s"] = vm.svc_refresh(name, fused=False)
    groupby_launches["svc_refresh_unfused"] = segment_groupby.launches - n0
    unfused_sample = vm.views[name].clean_sample
    # the same clean again under the profiler: the group-by's kernel rows
    unfused_profile = groupby_profile(lambda: vm.svc_refresh(name, fused=False),
                                      "svc_refresh unfused")
    state = {
        "fused_sample": fused_sample,
        "unfused_sample": unfused_sample,
        "stale_sample": vm.views[name].stale_sample,
        "arena": vm.pending.inserts["Log"],
        "pin": vm.views[name].outlier_pin,
        "index": vm.views[name].outlier_index,
        "materialized": vm.views[name].materialized,
        "pinned_refresh": pinned_refresh,
        "registered": registered,
        "unfused_profile": unfused_profile,
    }
    n0 = segment_groupby.launches
    t["ivm_s"], t["maintain_all_s"] = wall(vm.maintain_all)
    groupby_launches["maintain_all"] = segment_groupby.launches - n0
    for step in ("register_view", "maintain_all"):
        if groupby_launches[step] == 0:
            fail(f"the group-by's kernel was never launched in {step}")
    state["groupby_launches"] = groupby_launches
    return t, {"auto": auto, "aqp": aqp, "pinned": pinned}, state


def groupby_profile(fn, what: str) -> dict:
    """One call of ``fn`` under the profiler: its device ms, the group-by's
    kernel rows (segment_aggsum's sorted kernel) and any ``index_add_``
    row, which must be gone from the group-by."""
    prof = profile_ops(fn, top=5, match=("segment_sorted", "index_add"))
    kernel_rows = [r for r in prof["matching"] if "segment_sorted" in r["op"]]
    index_add = [r for r in prof["matching"] if "index_add" in r["op"]]
    if not kernel_rows:
        fail(f"{what}: no row of the group-by's kernel in the profile")
    if index_add:
        fail(f"{what}: the profile still holds {[r['op'] for r in index_add]}")
    return {"self_device_ms": prof["self_device_ms"], "device_launches": prof["device_launches"],
            "groupby_kernel_rows": kernel_rows, "index_add_rows": index_add,
            "top_device": prof["top_device"]}


def check_int_count_lane(log, registered, groups, min_rows=2 ** 24) -> dict:
    """visitView's largest group holds more than ``min_rows`` (2^24)
    sessions: its int32 count from the group-by's entry (over the Log's
    group ids) equals the count of the generator's ids, as every group's
    does, and the view's float32 ``visitCount`` is each exact count rounded
    once."""
    import torch

    from repro_torch.kernels.segment_aggsum import segment_groupby
    from repro_torch.relational import ops

    exact = torch.bincount(log.col("videoId")[log.valid].long())
    hot = int(exact.argmax())
    n_hot = int(exact[hot])
    if n_hot <= min_rows:
        fail(f"int count lane: the largest group holds {n_hot} rows, not above {min_rows}")
    _o, _sk, _sv, _st, gid = ops.group_ids(log, ("videoId",), groups)
    with uncounted():
        counts, _ = segment_groupby(gid, torch.empty((gid.shape[0], 0), device=gid.device),
                                    groups)
    present = exact[exact > 0]  # in video order, the group order
    if not torch.equal(counts[:present.numel()].long(), present) or bool(
            counts[present.numel():].any()):
        fail("int count lane: segment_groupby's int32 counts differ from the generator's")
    vid = registered.col("videoId")[registered.valid].long()
    cnt = registered.col("visitCount")[registered.valid]
    if not torch.equal(cnt, exact[vid].to(torch.float32)):
        fail("int count lane: the view's visitCount is not each exact count rounded once")
    return {"hot_video": hot, "hot_group_rows": n_hot, "int32_count": int(counts.max()),
            "view_visitCount": float(cnt[vid == hot][0]),
            "float32_of_exact": float(torch.tensor(n_hot, dtype=torch.float32)),
            "groups": int(present.numel())}


def profile_warm_maintain(vm, n_videos, n_logs, n_delta, seed) -> dict:
    """A fresh ``grow_log`` delta ingested, then one warm ``maintain_all``
    (the manager's third) under the profiler: the IVM's group-by rows."""
    from repro_torch.data.synthetic import grow_log

    delta = grow_log(np.random.default_rng(seed), n_videos, n_logs, n_delta, device=vm.device)
    vm.ingest("Log", inserts=delta)
    return groupby_profile(vm.maintain_all, "warm maintain_all")


def rel_errors(ests, truth):
    errs = [abs(e.value - t) / abs(t) for e, t in zip(ests, truth) if t != 0]
    return {"median": float(np.median(errs)), "max": float(np.max(errs)),
            "methods": sorted({e.method for e in ests})}


def check_estimates(ests, what):
    for e in ests:
        if not all(math.isfinite(v) for v in (e.value, e.stderr, e.ci_low, e.ci_high)):
            fail(f"{what}: non-finite estimate {e}")


# ---------------------------------------------------------------------------
# Kernels against their plain versions
# ---------------------------------------------------------------------------

def kernel_entry(name, route, source, replaces, launches, err, ms, plain_ms, bytes_, ops,
                 library_ms=None, ops_per_s=FP32_OPS_PER_S, **extra):
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    entry = {
        "name": name, "route": route, "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms,
    }
    entry.update(extra)
    return entry


def check_kernels(state, queries, m, seed, launches, iters):
    """Each kernel's wrapper against its plain version on the main path's
    tensors, timed with CUDA events; wrapper launches here are not counted
    in ``launches``, which was read before."""
    import torch

    from repro_torch.core.outliers import member_keys
    from repro_torch.kernels.fused_clean.ops import fused_clean_groupby, overflow_counter
    from repro_torch.kernels.fused_clean.ref import fused_clean_ref
    from repro_torch.kernels.hash_threshold.ops import hash_threshold
    from repro_torch.kernels.hash_threshold.ref import hash_threshold_ref
    from repro_torch.kernels.multi_agg.ops import multi_agg_one, multi_agg_two, selector_indices
    from repro_torch.kernels.multi_agg.ref import K_D, K_NEW, K_OLD, S_D, S_NEW, S_OLD, multi_agg_ref
    from repro_torch.core.outliers import pin_set
    from repro_torch.kernels.outlier_member.ops import digest_table, outlier_codes, pinned_hash
    from repro_torch.kernels.outlier_member.ref import (
        outlier_codes_ref,
        pinned_hash_ref,
        sorted_digest_table,
    )
    from repro_torch.query import QueryBatch, build_correspondence_cache, sample_columns
    from repro_torch.relational.relation import sentinel_where

    arena = state["arena"]
    valid = arena.valid
    vid = sentinel_where(valid, arena.col("videoId"))
    nbytes = arena.col("bytes")
    R = int(valid.sum())
    # the ingested delta rows: the arena's valid prefix (compact order)
    vid, nbytes, valid = vid[:R].contiguous(), nbytes[:R].contiguous(), valid[:R].contiguous()
    out = []

    # 1. hash_threshold: η on the delta's view key, bare and narrowing the
    # delta's validity, and at the main path's own shape (register_view's
    # apply_hash over the view's 1.5M rows): the fused-validity entry.
    # Times back to back, and cold (the L2 flushed before each call), with
    # each call's host enqueue and device launches.
    mat = state["materialized"]
    mat_cols = (mat.col("videoId"),)
    want = hash_threshold_ref((vid,), m, seed)
    want_mat = hash_threshold_ref(mat_cols, m, seed)
    for what, got, exp in (
            ("delta rows", hash_threshold((vid,), m, seed), want),
            ("delta rows, validity", hash_threshold((vid,), m, seed, valid), valid & want),
            ("view rows", hash_threshold(mat_cols, m, seed), want_mat),
            ("view rows, validity", hash_threshold(mat_cols, m, seed, mat.valid),
             mat.valid & want_mat)):
        if not torch.equal(got, exp):
            fail(f"hash_threshold differs from its plain version ({what})")
    RV = int(mat.valid.shape[0])

    def timings(fn, plain, bytes_):
        return {"ms": cuda_ms(fn, iters), "cold_ms": cold_ms(fn, iters),
                "plain_ms": cuda_ms(plain, iters),
                "bound_ms": bytes_ / HBM_BYTES_PER_S * 1e3,
                "host_enqueue_us": host_enqueue_us(fn, iters),
                "launches_per_call": device_launches(fn)}

    bare = timings(lambda: hash_threshold((vid,), m, seed),
                   lambda: hash_threshold_ref((vid,), m, seed), R * (4 + 1))
    out.append(kernel_entry(
        "hash_threshold", "cuda", "src/repro_torch/csrc/hash_threshold.cu",
        "src/repro/kernels/hash_threshold/kernel.py:45", launches["hash_threshold"], 0.0,
        bare["ms"], bare["plain_ms"], bytes_=R * (4 + 1), ops=0, rows=R,
        cold_ms=bare["cold_ms"], host_enqueue_us=bare["host_enqueue_us"],
        launches_per_call=bare["launches_per_call"],
        fused_validity={
            "entry": "hash_threshold(cols, m, seed, valid): apply_hash's narrowed validity",
            "rows": R, **timings(lambda: hash_threshold((vid,), m, seed, valid),
                                 lambda: valid & hash_threshold_ref((vid,), m, seed),
                                 R * (4 + 1 + 1))},
        main_path_shape={
            "entry": "the fused-validity entry over the view's rows, as register_view's "
                     "apply_hash calls it",
            "rows": RV, "valid_rows": int(mat.valid.sum()),
            **timings(lambda: hash_threshold(mat_cols, m, seed, mat.valid),
                      lambda: mat.valid & hash_threshold_ref(mat_cols, m, seed),
                      RV * (4 + 1 + 1)),
            "bare_ms": cuda_ms(lambda: hash_threshold(mat_cols, m, seed), iters)},
        tolerance="equal masks and validities",
    ))

    # 2. fused_clean: η ∨ pin, per-group [count | Σbytes] at G = 2^20.
    # Counts are exact.  Both float32 sums (kernel and plain) are held to the
    # exact sums, taken in float64 over the same kept rows, within
    # ``f32_sum_rtol``: the atomics add in no fixed order.  The kernel's
    # overflow counter says how many kept rows found no slot in their
    # block's shared table.
    pin = state["pin"]
    pin_keys = pin.keys
    pin_mask = member_keys((vid,), pin_keys)
    vals = nbytes[:, None].contiguous()
    G = 1 << 20
    overflow = overflow_counter(vid.device)
    overflow.zero_()
    gc, gs = fused_clean_groupby(vid, vals, valid, m, seed, G, pin_mask=pin_mask)
    overflow_rows = int(overflow.item())
    pc, ps = fused_clean_ref(vid, vals, valid, m, seed, G, pin_mask)
    if not torch.equal(gc, pc):
        fail("fused_clean counts differ from the plain version")
    keep = (hash_threshold_ref((vid,), m, seed) | pin_mask) & valid & (vid >= 0) & (vid < G)
    g = torch.where(keep, vid.long(), torch.full_like(vid, G, dtype=torch.int64))
    x64 = torch.where(keep, nbytes.double(), torch.zeros_like(nbytes, dtype=torch.float64))
    exact = torch.zeros(G + 1, dtype=torch.float64, device=vid.device).index_add_(0, g, x64)[:G]
    abs_sum = torch.zeros(G + 1, dtype=torch.float64, device=vid.device).index_add_(
        0, g, x64.abs())[:G]
    if not torch.equal(pc.double(), torch.bincount(g, minlength=G + 1)[:G].double()):
        fail("fused_clean plain counts differ from the exact counts")
    bound = torch.from_numpy(f32_sum_rtol(pc.cpu().numpy())).to(vid.device) * abs_sum
    diff = (gs[:, 0].double() - exact).abs()
    if bool((diff > bound).any()):
        fail(f"fused_clean sums beyond the float32 bound (max abs {float(diff.max()):.3e})")
    diff_plain = (ps[:, 0].double() - exact).abs()
    if bool((diff_plain > bound).any()):
        fail("fused_clean plain sums beyond the float32 bound")
    kept = float(pc.sum())
    rel_clean = float((diff / exact.abs().clamp(min=1e-30)).max())
    rel_plain = float((diff_plain / exact.abs().clamp(min=1e-30)).max())

    def index_add_only():
        g = torch.where(valid, vid.long(), torch.full_like(vid, G, dtype=torch.int64))
        torch.zeros((G + 1, 2), dtype=torch.float32, device=vid.device).index_add_(
            0, g, torch.cat([torch.ones_like(vals), vals], 1))

    out.append(kernel_entry(
        "fused_clean", "cuda", "src/repro_torch/csrc/fused_clean.cu",
        "src/repro/kernels/fused_clean/kernel.py:73", launches["fused_clean"],
        float(diff.max()),
        cuda_ms(lambda: fused_clean_groupby(vid, vals, valid, m, seed, G, pin_mask=pin_mask), iters),
        cuda_ms(lambda: fused_clean_ref(vid, vals, valid, m, seed, G, pin_mask), iters),
        bytes_=R * (4 + 1 + 1) + kept * 4 + G * 2 * 4, ops=0,
        rows=R, groups=G, kept_rows=kept, hot_group_rows=float(pc.max()),
        overflow_rows=overflow_rows, max_rel_err=rel_clean, plain_max_rel_err=rel_plain,
        deterministic=False,
        max_bound_share=float((diff / bound.clamp(min=1e-300)).max()),
        index_add_ms=cuda_ms(index_add_only, iters),
        tolerance=("counts exact; float32 sums within gamma_{n-1}*sum|x| of the float64 "
                   "sum, n the group's kept rows, gamma_k = k*2^-24/(1 - k*2^-24)"),
    ))

    # 3. outlier_member: the pinned hash (validity ∧ (η ∨ member) and the
    # __outlier flag in one launch) against its plain version, on the delta
    # rows with the index's K keys as the table (in shared memory) and at
    # the main path's own shape, the view's rows against its pin's table;
    # both again with the pin's full key arena as the table (in device
    # memory).  The codes entry (table build + probe) against
    # outlier_codes_ref, and the digest entry against the plain table.
    idx = state["index"]
    keys_k = (sentinel_where(idx.records.valid, idx.records.col("videoId")),)
    table_k = digest_table(keys_k)
    full_table = digest_table(pin_keys)
    for what, cols, ok, tab in (("delta rows, index table", (vid,), valid, table_k),
                                ("view rows, pin table", mat_cols, mat.valid, pin.table),
                                ("delta rows, full pin arena", (vid,), valid, full_table),
                                ("view rows, full pin arena", mat_cols, mat.valid, full_table)):
        got_v, got_f = pinned_hash(cols, ok, m, seed, tab)
        want_v, want_f = pinned_hash_ref(cols, ok, m, seed, tab)
        if not (torch.equal(got_v, want_v) and torch.equal(got_f, want_f)):
            fail(f"outlier_member pinned hash differs from the plain version ({what})")
    got = outlier_codes((vid,), keys_k, m, seed)
    if not torch.equal(got, outlier_codes_ref((vid,), keys_k, m, seed)):
        fail("outlier_member codes differ from the plain version (K in shared memory)")
    probe = (sentinel_where(mat.valid, mat.col("videoId")),)
    got_g = outlier_codes(probe, pin_keys, m, seed)
    if not torch.equal(got_g, outlier_codes_ref(probe, pin_keys, m, seed)):
        fail("outlier_member codes differ from the plain version (table in device memory)")
    K = int(table_k.shape[0])
    KP, RV = int(pin.table.shape[0]), int(mat.valid.shape[0])
    out.append(kernel_entry(
        "outlier_member", "cuda", "src/repro_torch/csrc/outlier_member.cu",
        "src/repro/kernels/outlier_member/kernel.py:74", launches["outlier_member"], 0.0,
        cuda_ms(lambda: pinned_hash((vid,), valid, m, seed, table_k), iters),
        cuda_ms(lambda: pinned_hash_ref((vid,), valid, m, seed, table_k), iters),
        bytes_=R * (4 + 1 + 1 + 1) + K * 8, ops=0, rows=R, keys=K,
        launches_per_call=device_launches(lambda: pinned_hash((vid,), valid, m, seed, table_k)),
        main_path_shape={
            "rows": RV, "keys": KP,
            "ms": cuda_ms(lambda: pinned_hash(mat_cols, mat.valid, m, seed, pin.table), iters),
            "plain_ms": cuda_ms(lambda: pinned_hash_ref(mat_cols, mat.valid, m, seed, pin.table),
                                iters),
            "bound_ms": (RV * (4 + 1 + 1 + 1) + KP * 8) / HBM_BYTES_PER_S * 1e3,
        },
        full_pin_arena_table={
            "keys": int(full_table.shape[0]),
            "ms": cuda_ms(lambda: pinned_hash(mat_cols, mat.valid, m, seed, full_table), iters),
        },
        table_build_ms=cuda_ms(lambda: pin_set(pin.relation), iters),
        codes={"ms": cuda_ms(lambda: outlier_codes((vid,), keys_k, m, seed), iters),
               "plain_ms": cuda_ms(lambda: outlier_codes_ref((vid,), keys_k, m, seed), iters),
               "launches_per_call": device_launches(lambda: outlier_codes((vid,), keys_k, m,
                                                                          seed))},
        tolerance="equal validity, flags and codes",
    ))
    # the digest entry at the pin's own table keys (its valid keys and one
    # SENTINEL tuple, as core.outliers.pin_set digests them)
    rows = torch.cat([pin.relation.valid.nonzero().flatten(),
                      (~pin.relation.valid).nonzero()[:1].flatten()])
    tkeys = tuple(c[rows].contiguous() for c in pin_keys)
    got_t = digest_table(tkeys)
    if not torch.equal(got_t, pin.table) or not torch.equal(got_t, sorted_digest_table(tkeys)):
        fail("outlier_digest table differs from the plain sorted_digest_table")
    if not torch.equal(full_table, sorted_digest_table(pin_keys)):
        fail("outlier_digest table of the full pin arena differs from the plain one")
    NP = int(pin_keys[0].shape[0])
    out.append(kernel_entry(
        "outlier_digest", "cuda", "src/repro_torch/csrc/outlier_member.cu",
        "src/repro/kernels/outlier_member/ops.py:50", launches["outlier_digest"], 0.0,
        cuda_ms(lambda: digest_table(tkeys), iters),
        cuda_ms(lambda: sorted_digest_table(tkeys), iters),
        bytes_=KP * (4 + 8), ops=0, keys=KP,
        launches_per_call=device_launches(lambda: digest_table(tkeys)),
        full_pin_arena={"keys": NP, "ms": cuda_ms(lambda: digest_table(pin_keys), iters),
                        "plain_ms": cuda_ms(lambda: sorted_digest_table(pin_keys), iters),
                        "bound_ms": NP * (4 + 8) / HBM_BYTES_PER_S * 1e3},
        tolerance="equal tables",
    ))

    # 4. multi_agg: the dashboard over the correspondence panel (two-sided)
    # and over the materialized view (one-sided exact scan), each called as
    # the engine calls it: with the batch's host-decoded selector indices
    clean, stale = state["unfused_sample"], state["stale_sample"]
    cache = build_correspondence_cache(clean, stale, m)
    batch = QueryBatch.encode(queries, sample_columns(clean), clean.device)
    sel_idx = batch.sel_idx
    if not torch.equal(sel_idx, selector_indices(batch.sel, len(batch.columns))):
        fail("QueryBatch.sel_idx differs from selector_indices(sel)")
    used = int(torch.unique(sel_idx[sel_idx >= 0]).numel())
    P = sel_idx.shape[0] - 1
    Q = sel_idx.shape[1]
    new = (cache.x_new, cache.valid_new, cache.w_new, cache.ompi_new)
    old = (cache.x_old, cache.valid_old, cache.w_old, cache.ompi_old)

    def compare(got, want, what):
        scale = want.abs()
        if got.shape[0] > S_D:
            scale[S_D] = want[S_NEW].abs() + want[S_OLD].abs()  # Σ|d| ≤ Σt_new + Σt_old
        for k in (K_NEW, K_OLD, K_D):
            if k < got.shape[0] and not torch.equal(got[k], want[k]):
                fail(f"{what}: count row {k} differs")
        err = (got - want).abs()
        if bool((err > 1e-5 * scale).any()):
            fail(f"{what}: moments beyond 1e-5 relative (max abs {float(err.max()):.3e})")
        return float(err.max()), float((err / scale.clamp(min=1e-30)).max())

    def same_bits(call, got, what):
        if not torch.equal(call(), got):
            fail(f"{what}: a repeated call gave other bits")
        if not torch.equal(call(decode=True), got):
            fail(f"{what}: the call without sel_idx gave other bits")

    def two(decode=False):
        return multi_agg_two(*new, batch.sel, batch.meta, *old,
                             sel_idx=None if decode else sel_idx)

    got = two()
    err2, rel2 = compare(got, multi_agg_ref(*new, batch.sel, batch.meta, *old), "multi_agg_two")
    same_bits(two, got, "multi_agg_two")
    RJ = int(cache.x_new.shape[0])
    out.append(kernel_entry(
        "multi_agg_two", "cuda", "src/repro_torch/csrc/multi_agg.cu",
        "src/repro/kernels/multi_agg/kernel.py:128", launches["multi_agg_two"], err2,
        cuda_ms(two, iters),
        cuda_ms(lambda: multi_agg_ref(*new, batch.sel, batch.meta, *old), iters),
        bytes_=2 * RJ * (4 * used + 1 + 4 + 4), ops=RJ * Q * (2 * (8 + 4 * P) + 9),
        rows=RJ, queries=Q, predicate_slots=P, max_rel_err=rel2,
        valid_rows=[int(cache.valid_new.sum()), int(cache.valid_old.sum())],
        launches_per_call=device_launches(two), host_enqueue_us=host_enqueue_us(two, iters),
        tolerance="counts exact; moments 1e-5 relative (S_D: of S_NEW + S_OLD); "
                  "repeats and the call without sel_idx bit-equal",
    ))
    x = torch.stack([mat.col(c).to(torch.float32) for c in batch.columns], dim=1)
    ones = torch.ones(mat.valid.shape, dtype=torch.float32, device=x.device)
    view = (x, mat.valid, ones, torch.zeros_like(ones))

    def one(decode=False):
        return multi_agg_one(*view, batch.sel, batch.meta, sel_idx=None if decode else sel_idx)

    got = one()
    err1, rel1 = compare(got, multi_agg_ref(*view, batch.sel, batch.meta), "multi_agg_one")
    same_bits(one, got, "multi_agg_one")
    RV = int(x.shape[0])
    out.append(kernel_entry(
        "multi_agg_one", "cuda", "src/repro_torch/csrc/multi_agg.cu",
        "src/repro/kernels/multi_agg/kernel.py:159", launches["multi_agg_one"], err1,
        cuda_ms(one, iters),
        cuda_ms(lambda: multi_agg_ref(*view, batch.sel, batch.meta), iters),
        bytes_=RV * (4 * used + 1 + 4 + 4), ops=RV * Q * (8 + 4 * P),
        rows=RV, queries=Q, predicate_slots=P, max_rel_err=rel1,
        valid_rows=int(mat.valid.sum()),
        launches_per_call=device_launches(one), host_enqueue_us=host_enqueue_us(one, iters),
        tolerance="counts exact; moments 1e-5 relative; "
                  "repeats and the call without sel_idx bit-equal",
    ))
    return out


# ---------------------------------------------------------------------------
# Device against CPU at a small size
# ---------------------------------------------------------------------------

def device_vs_cpu(n_videos, n_logs, n_delta, m, k, seed) -> dict:
    samples, answers = {}, {}
    queries = dashboard(n_videos)
    for device in ("cuda", "cpu"):
        vm, view, log, video, delta, groups = build_scenario(
            n_videos, n_logs, n_delta, m, seed, device)
        vm.register_base("Log", log)
        vm.register_base("Video", video)
        vm.register_view(view, delta_bases=("Log",), m=m, delta_group_capacity=groups)
        vm.ingest("Log", inserts=delta)
        vm.svc_refresh(view.name)
        a1 = vm.query_batch(view.name, queries)
        a2 = vm.query_batch(view.name, queries, prefer="aqp")
        vm.register_outlier_index(view.name, "Log", "bytes", k=k)
        vm.svc_refresh(view.name)
        a3 = vm.query_batch(view.name, queries)
        samples[device] = sorted_sample(vm.views[view.name].clean_sample)
        answers[device] = a1 + a2 + a3
    same = same_sample(samples["cuda"], samples["cpu"], "device vs CPU sample")
    worst = 0.0
    for g, c in zip(answers["cuda"], answers["cpu"]):
        if g.method != c.method:
            fail(f"device vs CPU: method {g.method} != {c.method}")
        for a, b in ((g.value, c.value), (g.ci_low, c.ci_low), (g.ci_high, c.ci_high)):
            err = abs(a - b) / max(abs(a), abs(b), 1.0)
            worst = max(worst, err)
            if err > 1e-5:
                fail(f"device vs CPU: answer {a} vs {b} (rel {err:.3e})")
    return {**same, "answers": len(answers["cpu"]), "max_rel_err_answers": worst}


# ---------------------------------------------------------------------------
# The fleet path: svc_refresh_many and the planner over 16 views
# ---------------------------------------------------------------------------

def traffic_weights(n_views: int) -> np.ndarray:
    """Zipf over a fixed rank permutation that parks the hottest views late
    in registration order (benchmarks/fig_planner_fleet.py:59-70)."""
    rng = np.random.default_rng(123)
    rank = rng.permutation(n_views)
    back = [i for i in range(n_views) if i >= n_views // 2]
    for hot, pos in zip(np.argsort(rank)[:3], back[-3:]):
        rank[hot], rank[pos] = rank[pos], rank[hot]
    w = 1.0 / (1.0 + rank) ** 1.7
    return w / w.sum()


def fleet_logs(n_views, n_videos, n_logs, device):
    """Each fleet view's log (``make_log_video`` with seed i) on ``device``."""
    from repro_torch.data.synthetic import make_log_video

    return [make_log_video(np.random.default_rng(i), n_videos, n_logs, device=device)[0]
            for i in range(n_views)]


def build_fleet(device, n_views, n_videos, n_logs, groups, m, clock=None, logs=None):
    """``n_views`` group-by views, view i over its own log (seed i, or
    ``logs[i]`` when given, e.g. generated once on the host for two
    managers); views in the upper half register ``with_deletes``, view 0
    carries an outlier index (k = K on ``bytes``) and so cleans per view."""
    from repro_torch.core import ViewDef
    from repro_torch.data.synthetic import make_log_video
    from repro_torch.relational.plan import GroupByNode, Scan
    from repro_torch.views import ViewManager

    vm = ViewManager(device=device, **({"clock": clock} if clock else {}))
    names = []
    for i in range(n_views):
        if logs is None:
            log, _video = make_log_video(np.random.default_rng(i), n_videos, n_logs,
                                         device=device)
            del _video
        else:
            log = logs[i]
        vm.register_base(f"FLog{i}", log)
        plan = GroupByNode(child=Scan(f"FLog{i}", pk=("sessionId",)), keys=("videoId",),
                           aggs=(("totalBytes", "sum", "bytes"), ("visits", "count", None)),
                           num_groups=groups)
        vm.register_view(ViewDef(f"fv{i}", plan), delta_bases=(f"FLog{i}",), m=m, seed=i,
                         delta_group_capacity=groups, with_deletes=i >= n_views // 2)
        names.append(f"fv{i}")
    vm.register_outlier_index("fv0", "FLog0", "bytes", k=min(K, n_logs))
    return vm, names


def fleet_ingest(vm, n_views, n_videos, n_logs, n_delta, epoch, n_deletes=0):
    """One epoch's grow_log delta per view (and, when asked, deletes of
    existing sessions for the with_deletes views)."""
    from repro_torch.data.synthetic import grow_log
    from repro_torch.relational.relation import from_columns

    for i in range(n_views):
        rng = np.random.default_rng(10_000 + 100 * epoch + i)
        start = n_logs + epoch * n_delta
        vm.ingest(f"FLog{i}", inserts=grow_log(rng, n_videos, start, n_delta, device=vm.device))
        if n_deletes and i >= n_views // 2:
            import torch

            base = vm.base[f"FLog{i}"]
            pick = torch.from_numpy(rng.choice(n_logs, n_deletes, replace=False)).to(vm.device)
            vm.ingest(f"FLog{i}", deletes=from_columns(
                {c: base.col(c)[pick] for c in base.schema.columns}, pk=base.schema.pk))


def exact_delta_sums(vm, name: str, groups: int):
    """Per group, over the rows the view's η keeps: float64 sums and counts
    of the pending insert and delete deltas' ``bytes``."""
    import torch

    from repro_torch.kernels.hash_threshold.ref import hash_threshold_ref

    mv = vm.views[name]
    d = vm._deltas_for(mv)
    base = mv.delta_bases[0]
    out = {}
    for side, rel in (("ins", d.inserts.get(base)), ("del", d.deletes.get(base))):
        s = torch.zeros(groups + 1, dtype=torch.float64, device=vm.device)
        n = torch.zeros(groups + 1, dtype=torch.int64, device=vm.device)
        if rel is not None:
            vid = rel.col("videoId")
            keep = hash_threshold_ref((vid,), mv.m, mv.seed) & rel.valid
            g = torch.where(keep, vid.long(), torch.full_like(vid, groups, dtype=torch.int64))
            s.index_add_(0, g, torch.where(keep, rel.col("bytes").double(),
                                           torch.zeros_like(rel.col("bytes"), dtype=torch.float64)))
            n = torch.bincount(g, minlength=groups + 1)
        out[side] = (s[:groups].cpu().numpy(), n[:groups].cpu().numpy())
    return out


def same_clean(batched, per_view, stale, exact, what: str) -> dict:
    """Keys and ``visits`` exact; ``totalBytes`` of the two cleans within
    2·γ_{n−1}·Σ|x| of each other, where a group's value is a float32 sum of
    n = 1 + kept inserts + kept deletes terms (its stale value, the inserts,
    the deleted rows) whose absolute values add to Σ|x|: each side lies
    within γ_{n−1}·Σ|x| of the exact sum, in whatever order it added."""
    a, b = sorted_sample(batched), sorted_sample(per_view)
    for col in ("videoId", "visits"):
        if not np.array_equal(a[col], b[col]):
            fail(f"{what}: column {col} differs between the batched and the per-view clean")
    keys = a["videoId"]
    st = sorted_sample(stale)
    pos = np.searchsorted(st["videoId"], keys)
    pos = np.minimum(pos, max(len(st["videoId"]) - 1, 0))
    hit = (st["videoId"][pos] == keys) if len(st["videoId"]) else np.zeros(len(keys), bool)
    stale_abs = np.where(hit, np.abs(st["totalBytes"][pos].astype(np.float64)), 0.0)
    (si, ni), (sd, nd) = exact["ins"], exact["del"]
    abs_sum = stale_abs + si[keys] + sd[keys]
    n = 1 + ni[keys] + nd[keys]
    bound = 2 * f32_sum_rtol(n) * abs_sum
    diff = np.abs(a["totalBytes"].astype(np.float64) - b["totalBytes"].astype(np.float64))
    if np.any(diff > bound):
        fail(f"{what}: totalBytes beyond 2*gamma*sum|x| (max {float(diff.max()):.3e})")
    return {"rows": int(keys.size),
            "max_rel_diff_totalBytes": float(np.max(diff / np.maximum(abs_sum, 1e-30)))
            if keys.size else 0.0,
            "max_bound_share": float(np.max(diff / np.maximum(bound, 1e-300))) if keys.size else 0.0}


class uncounted:
    """Launches inside this block (comparisons with the plain versions) leave
    the kernels' counters as they were."""

    def __enter__(self):
        from repro_torch import kernels

        self.saved = kernels.launch_counts()

    def __exit__(self, *exc):
        from repro_torch import kernels

        for name, fn in kernels.wrappers().items():
            fn.launches = self.saved[name]


class EpochClock:
    """The planner's clock, read in epochs: view ages are whole epochs, so
    the starvation guard fires in a fixed epoch and both choices of an
    epoch (kernel and plain scores) read the same ages."""

    t = 0.0

    def __call__(self) -> float:
        return self.t


def checked_planner(vm, budget_s, clock, age_cap_s):
    """A MaintenancePlanner that, after each plan (outside the spans that
    ``plan`` times), also chooses from the plain ``fleet_score_ref`` scores
    of the same feature panel (on the card) and keeps both decisions, the
    two score panels and the fleet panel's channels for the kernel checks."""
    import torch

    from repro_torch.kernels.fleet_score import fleet_score_ref
    from repro_torch.planner import FleetScores, MaintenancePlanner

    class CheckedPlanner(MaintenancePlanner):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.checks = []
            self.last_inputs = None
            self._fs = None

        def choose(self, fs, budget=None):
            self._fs = fs
            return super().choose(fs, budget)

        def plan(self, budget_s=None):
            report = super().plan(budget_s)
            fs = self._fs
            plain = fleet_score_ref(torch.from_numpy(fs.features).to(self.vm.device)).cpu().numpy()
            alt = MaintenancePlanner.choose(self, FleetScores(fs.names, fs.features, plain),
                                            budget_s)
            self.checks.append((fs, plain, report, alt))
            self.last_inputs = (fs.features, self.vm.fleet_panel()._stacked)
            return report

    return CheckedPlanner(vm, budget_s=budget_s, age_cap_s=age_cap_s, clock=clock)


def run_fleet_path(n_views, n_videos, n_logs, n_delta, n_deletes, groups, m, epochs,
                   device="cuda"):
    """register → ingest (+ deletes) → svc_refresh_many ∥ per-view cleans →
    planner epochs under a Zipf query stream → maintain_all.

    Returns (walls, checks, captured kernel inputs); the caller resets the
    launch counters before and reads them after."""
    import torch

    from repro_torch import kernels
    from repro_torch.core import Query
    from repro_torch.core.maintenance import fleet_fused_inputs, fleet_merge_inputs

    t = {}
    (vm, names), t["register_s"] = wall(
        lambda: build_fleet(device, n_views, n_videos, n_logs, groups, m))
    _, t["ingest_s"] = wall(lambda: fleet_ingest(vm, n_views, n_videos, n_logs, n_delta, 0,
                                                 n_deletes))

    # 1. batched against per-view, from the same stale samples and deltas
    before = kernels.launch_counts()
    dts, t["svc_refresh_many_s"] = wall(lambda: vm.svc_refresh_many(names))
    after = kernels.launch_counts()
    # the cleans moved neither stale samples nor pending deltas: rebuild the
    # batched launches' inputs for the kernel checks
    batched_names = [n for n in names if vm.views[n].outlier_index is None]
    with uncounted():
        jobs = [vm._merge_job(n, vm.views[n], vm.fleet_panel()) for n in batched_names]
        merge_launches, _pre = fleet_merge_inputs(jobs)
        fused_launches = fleet_fused_inputs(
            [((j.name, "ins"), j.ins[0], j.ins[1]) for j in jobs])
        del jobs, _pre
    merge_groups = len(merge_launches)
    if after["fleet_merge"] - before["fleet_merge"] != merge_groups:
        fail(f"fleet_merge launched {after['fleet_merge'] - before['fleet_merge']} times for "
             f"{merge_groups} shape groups")
    if after["fused_clean_fleet"] == before["fused_clean_fleet"]:
        fail("svc_refresh_many did not launch fused_clean_fleet")
    batched = {n: vm.views[n].clean_sample for n in names}
    exact = {n: exact_delta_sums(vm, n, groups) for n in batched_names}
    per_view_s = {}
    for n in names:
        per_view_s[n] = vm.svc_refresh(n)
    t["per_view_cleans_s"] = sum(per_view_s.values())
    comparison = {}
    for n in batched_names:
        comparison[n] = same_clean(batched[n], vm.views[n].clean_sample, vm.views[n].stale_sample,
                                   exact[n], f"fleet {n}")
    del batched, exact
    # the same cleans again, both ways, with every slot and arena warm; then
    # one call of each under the profiler
    _, t["svc_refresh_many_warm_s"] = wall(lambda: vm.svc_refresh_many(names))
    warm_view_s = {n: vm.svc_refresh(n) for n in names}
    t["per_view_cleans_warm_s"] = sum(warm_view_s.values())
    profiles = {"svc_refresh_many": profile_ops(lambda: vm.svc_refresh_many(names)),
                "per_view_cleans": profile_ops(lambda: [vm.svc_refresh(n) for n in names])}

    for what, prof in profiles.items():
        emit({"phase": "fleet_profile", "call": what, **prof})

    # 2. planner epochs under a Zipf query stream, priced from this run's
    # walls: a clean at the median warm per-view clean, a maintain at one
    # view's measured IVM, a retune at one retune-then-clean through the
    # batched path (held against a per-view clean of the retuned view), and
    # fig_planner_fleet's budget of one maintain plus 2.5 cleans
    clean_s = float(np.median(list(warm_view_s.values())))
    maintain_s = vm.maintain(names[-1])
    pair, retuned = names[-3:-1], names[-2]
    new_m = 2.0 * vm.views[retuned].m
    vm.adaptive_m = True
    vm.views[retuned].recommended_m = new_m
    before = kernels.launch_counts()["fleet_merge"]
    retune_dts = vm.svc_refresh_many(pair)
    vm.adaptive_m = False
    retune_s = retune_dts[retuned]
    if vm.views[retuned].m != new_m or kernels.launch_counts()["fleet_merge"] == before:
        fail("the retune did not go through the batched clean")
    batched_retune = vm.views[retuned].clean_sample
    retune_exact = exact_delta_sums(vm, retuned, groups)
    vm.svc_refresh(retuned)
    retune_check = same_clean(batched_retune, vm.views[retuned].clean_sample,
                              vm.views[retuned].stale_sample, retune_exact, f"retuned {retuned}")
    del batched_retune, retune_exact
    budget_s = maintain_s + 2.5 * clean_s
    clock = EpochClock()
    planner = checked_planner(vm, budget_s, clock, FLEET_AGE_CAP_EPOCHS)
    planner.cost_model.pin_costs(refresh_s=clean_s, maintain_s=maintain_s, retune_s=retune_s)
    weights = traffic_weights(n_views)
    t_rng = np.random.default_rng(31)
    q = Query("sum", "totalBytes")
    epochs_out = []
    for epoch in range(1, epochs + 1):
        clock.t = float(epoch)
        if epoch == epochs:  # the last epoch adapts the sampling ratios
            planner.adapt_m = vm.adaptive_m = True
        hits = t_rng.multinomial(FLEET_HITS, weights)
        for i in range(n_views):
            for _ in range(int(hits[i])):
                for e in vm.query_batch(names[i], [q] * FLEET_QUERIES_PER_HIT):
                    if not math.isfinite(float(e.value)):
                        fail(f"fleet query on {names[i]}: non-finite estimate")
        fleet_ingest(vm, n_views, n_videos, n_logs, n_delta, epoch)
        rep = planner.step()
        fs, plain, kernel_rep, plain_rep = planner.checks[-1]
        if kernel_rep is not rep:
            fail("the planner's report is not the one it chose")
        if not np.array_equal(fs.scores.view(np.int32), plain.view(np.int32)):
            fail(f"epoch {epoch}: fleet_score differs from its plain version")
        acts = [(a.view, a.action, a.forced) for a in rep.actions]
        if acts != [(a.view, a.action, a.forced) for a in plain_rep.actions] \
                or rep.skipped != plain_rep.skipped:
            fail(f"epoch {epoch}: the plain scorer chooses other actions")
        if any(a.failed or a.overrun for a in rep.actions):
            fail(f"epoch {epoch}: an action failed: {rep.to_dict()}")
        mix = {k: sum(a.action == k for a in rep.actions) for k in ("clean", "retune", "maintain")}
        epochs_out.append({"epoch": epoch, "actions": [a[:2] for a in acts], "mix": mix,
                           "forced": sum(a.forced for a in rep.actions),
                           "skipped": len(rep.skipped), "adapt_m": planner.adapt_m,
                           "m_after": sorted({vm.views[n].m for n in names}),
                           "snapshot_s": rep.snapshot_s, "schedule_s": rep.schedule_s,
                           "act_s": rep.act_s, "corr_wins": sum(rep.corr_wins.values())})
    for kind in ("clean", "maintain"):
        if not any(e["mix"][kind] for e in epochs_out):
            fail(f"no planner epoch chose a {kind}: {[(e['epoch'], e['mix']) for e in epochs_out]}, "
                 f"prices {clean_s}, {maintain_s}, {retune_s} s, budget {budget_s} s")
    features, channels = planner.last_inputs
    prices = {"clean_s": clean_s, "maintain_s": maintain_s, "retune_s": retune_s,
              "budget_s": budget_s, "age_cap_epochs": FLEET_AGE_CAP_EPOCHS,
              "retune_vs_per_view": retune_check}

    # 3. full maintenance makes every view exact
    _, t["maintain_all_s"] = wall(vm.maintain_all)
    for n in names:
        for qq in (Query("sum", "totalBytes"), Query("count"), Query("sum", "visits")):
            a, b = float(vm.query_stale(n, qq)), float(vm.query_exact_fresh(n, qq))
            if a != b:
                fail(f"fleet {n}: after maintain_all query_stale {a} != query_exact_fresh {b}")
    inputs = {"fused": fused_launches[0][1], "merge": merge_launches[0][1],
              "moments": channels, "features": torch.from_numpy(features).to(vm.device)}
    return t, {"comparison": comparison, "epochs": epochs_out, "merge_groups": merge_groups,
               "per_view_s": per_view_s, "svc_refresh_many_view_s": dts, "prices": prices}, \
        inputs


def check_fleet_kernels(inputs, launches, iters):
    """The fleet kernels against their plain versions on the fleet path's own
    tensors: fused_clean_fleet (the insert side of the batched clean),
    fleet_merge (its merge panels), fleet_moments (the last epoch's fleet
    panel) and fleet_score (the last epoch's feature panel)."""
    import torch

    from repro_torch.kernels.fleet_merge import (
        fleet_merge,
        fleet_merge_rank_ref,
        fleet_merge_ref,
        sort_by_key,
        sort_stale,
    )
    from repro_torch.kernels.fleet_moments import fleet_moments, fleet_moments_ref
    from repro_torch.kernels.fleet_score import fleet_score_ref, fleet_scores
    from repro_torch.kernels.fused_clean.ops import fused_clean_groupby_fleet, overflow_counter
    from repro_torch.kernels.fused_clean.ref import fused_clean_fleet_ref
    from repro_torch.kernels.hash_threshold.ref import hash_threshold_ref

    out = []

    # 1. fused_clean_fleet: counts exact; both float32 sums within the
    # float32 bound of the float64 sums over the same kept rows
    gid, vals, valid, ms, seeds, G = inputs["fused"]
    V, R = gid.shape
    overflow = overflow_counter(gid.device)
    overflow.zero_()
    gc, gs = fused_clean_groupby_fleet(gid, vals, valid, ms, seeds, G)
    overflow_rows = int(overflow.item())
    pc, ps = fused_clean_fleet_ref(gid, vals, valid, ms, seeds, G)
    if not torch.equal(gc, pc):
        fail("fused_clean_fleet counts differ from the plain version")
    keep = torch.stack([hash_threshold_ref((gid[v],), ms[v], seeds[v]) for v in range(V)])
    keep = keep & valid & (gid >= 0) & (gid < G)
    nseg = G + 1
    g = (torch.where(keep, gid.long(), torch.full_like(gid, G, dtype=torch.int64))
         + nseg * torch.arange(V, device=gid.device)[:, None]).reshape(-1)
    x64 = torch.where(keep, vals[..., 0].double(), torch.zeros_like(vals[..., 0], dtype=torch.float64))
    exact = torch.zeros(V * nseg, dtype=torch.float64, device=gid.device).index_add_(
        0, g, x64.reshape(-1)).reshape(V, nseg)[:, :G]
    bound = torch.from_numpy(f32_sum_rtol(pc.cpu().numpy())).to(gid.device) * exact.abs()
    diff = (gs[..., 0].double() - exact).abs()
    diff_plain = (ps[..., 0].double() - exact).abs()
    if bool((diff > bound).any()) or bool((diff_plain > bound).any()):
        fail("fused_clean_fleet sums beyond the float32 bound")
    kept = float(pc.sum())
    C = vals.shape[2]

    def index_add_only():
        gg = (torch.where(valid, gid.long(), torch.full_like(gid, G, dtype=torch.int64))
              + nseg * torch.arange(V, device=gid.device)[:, None]).reshape(-1)
        torch.zeros((V * nseg, 1 + C), dtype=torch.float32, device=gid.device).index_add_(
            0, gg, torch.cat([torch.ones_like(vals[..., :1]), vals], 2).reshape(V * R, 1 + C))

    out.append(kernel_entry(
        "fused_clean_fleet", "cuda", "src/repro_torch/csrc/fused_clean.cu",
        "src/repro/kernels/fused_clean/ops.py:59", launches["fused_clean_fleet"],
        float(diff.max()),
        cuda_ms(lambda: fused_clean_groupby_fleet(gid, vals, valid, ms, seeds, G), iters),
        cuda_ms(lambda: fused_clean_fleet_ref(gid, vals, valid, ms, seeds, G), iters),
        bytes_=V * R * (4 + 1) + kept * 4 * C + V * G * (1 + C) * 4, ops=0,
        views=V, rows=R, groups=G, kept_rows=kept, hot_group_rows=float(pc.max()),
        overflow_rows=overflow_rows,
        max_rel_err=float((diff / exact.abs().clamp(min=1e-30)).max()),
        plain_max_rel_err=float((diff_plain / exact.abs().clamp(min=1e-30)).max()),
        deterministic=False,
        index_add_ms=cuda_ms(index_add_only, iters),
        max_bound_share=float((diff / bound.clamp(min=1e-300)).max()),
        tolerance=("counts exact; float32 sums within gamma_{n-1}*sum|x| of the float64 "
                   "sum, n the group's kept rows"),
    ))

    # 2. fleet_merge: bit-equal to the plain version of its rank computation
    # and to the oracle, the stable sort of the unsorted rows (keys, values,
    # validity)
    args = inputs["merge"]
    V, R = args[0].shape
    G, A = args[3].shape[1], args[2].shape[2]
    # the data decides what must move: keys and flags of every row, values
    # of the valid stale rows and live delta groups only, every output
    n_stale, n_ins, n_del = (int(args[i].sum()) for i in (1, 3, 5))
    got = fleet_merge(*args)
    want = sort_by_key(*fleet_merge_ref(*args))
    rank = fleet_merge_rank_ref(*args)
    for gt, rk, wt, what in zip(got, rank, want, ("keys", "vals", "valid")):
        for x, by in ((gt, "the kernel"), (rk, "the plain rank version")):
            same = torch.equal(x.view(torch.int32), wt.view(torch.int32)) \
                if x.dtype == torch.float32 else torch.equal(x, wt)
            if not same:
                fail(f"fleet_merge {what} of {by} differ from the sorted plain rows")
    out.append(kernel_entry(
        "fleet_merge", "cuda", "src/repro_torch/csrc/fleet_merge.cu",
        "src/repro/kernels/fleet_merge/kernel.py:73", launches["fleet_merge"], 0.0,
        cuda_ms(lambda: fleet_merge(*args), iters),
        cuda_ms(lambda: fleet_merge_rank_ref(*args), iters),
        bytes_=V * R * (4 + 1) + (n_stale + n_ins + n_del) * 4 * A + 2 * V * G
        + V * (R + G) * (4 + 1 + 4 * A),
        ops=2 * n_stale * A,
        views=V, stale_rows=R, groups=G, aggs=A, valid_stale_rows=n_stale,
        live_insert_groups=n_ins, live_delete_groups=n_del,
        launches_per_call=device_launches(lambda: fleet_merge(*args)),
        stale_sort_ms=cuda_ms(lambda: sort_stale(args[0], args[1], G), iters),
        sorted_plain_ms=cuda_ms(lambda: sort_by_key(*fleet_merge_ref(*args)), iters),
        plain_unsorted_ms=cuda_ms(lambda: fleet_merge_ref(*args), iters),
        tolerance="bit-equal (keys, values and validity)",
    ))

    # 3. fleet_moments: ≤ 1e-6 relative, and the same bits run to run
    ch = inputs["moments"]
    V, R = ch[0].shape
    got = fleet_moments(*ch)
    want = fleet_moments_ref(*ch)
    err = (got - want).abs()
    rel = float((err / want.abs().clamp(min=1e-30)).max())
    if bool((err > 1e-6 * want.abs()).any()):
        fail(f"fleet_moments beyond 1e-6 relative of the plain version (max {rel:.3e})")
    if not torch.equal(got, fleet_moments(*ch)):
        fail("fleet_moments differs from run to run")
    out.append(kernel_entry(
        "fleet_moments", "cuda", "src/repro_torch/csrc/fleet_moments.cu",
        "src/repro/kernels/fleet_moments/kernel.py:54", launches["fleet_moments"],
        float(err.max()),
        cuda_ms(lambda: fleet_moments(*ch), iters),
        cuda_ms(lambda: fleet_moments_ref(*ch), iters),
        bytes_=8 * V * R * 4 + V * 5 * 4, ops=22 * V * R,
        views=V, rows=R, max_rel_err=rel, tolerance="1e-6 relative; deterministic",
    ))

    # 4. fleet_score: bit-equal to the plain version
    feats = inputs["features"]
    V = feats.shape[0]
    got = fleet_scores(feats)
    if not torch.equal(got.view(torch.int32), fleet_score_ref(feats).view(torch.int32)):
        fail("fleet_score differs from the plain version")
    out.append(kernel_entry(
        "fleet_score", "cuda", "src/repro_torch/csrc/fleet_score.cu",
        "src/repro/kernels/fleet_score/kernel.py:102", launches["fleet_score"], 0.0,
        cuda_ms(lambda: fleet_scores(feats), iters),
        cuda_ms(lambda: fleet_score_ref(feats), iters),
        bytes_=V * (13 + 6) * 4, ops=45 * V, views=V, tolerance="bit-equal",
    ))
    return out


def fleet_device_vs_cpu(n_views, n_videos, n_logs, n_delta, n_deletes, m, epochs) -> dict:
    """A small fleet on the card and on the CPU: the same samples after
    svc_refresh_many (keys and counts exact, sums 1e-5 relative) and the
    same planner actions in every epoch."""
    from repro_torch.core import Query
    from repro_torch.planner import MaintenancePlanner

    class Frozen:
        def __call__(self):
            return 0.0

    q = Query("sum", "totalBytes")
    runs = {}
    for device in ("cuda", "cpu"):
        vm, names = build_fleet(device, n_views, n_videos, n_logs, int(n_videos * 1.5), m,
                                clock=Frozen())
        fleet_ingest(vm, n_views, n_videos, n_logs, n_delta, 0, n_deletes)
        vm.svc_refresh_many(names)
        samples = {n: sorted_sample(vm.views[n].clean_sample) for n in names}
        planner = MaintenancePlanner(vm, budget_s=2.5 * CLEAN_COST, age_cap_s=1e9,
                                     clock=Frozen())
        planner.cost_model.pin_costs(refresh_s=CLEAN_COST, maintain_s=MAINTAIN_COST)
        acts = []
        for epoch in range(1, epochs + 1):
            for i, n in enumerate(names):
                vm.query_batch(n, [q] * (1 + (i * 7) % 5))
            fleet_ingest(vm, n_views, n_videos, n_logs, n_delta, epoch)
            acts.append([(a.view, a.action) for a in planner.step().actions])
        runs[device] = (samples, acts)
    (gs, ga), (cs, ca) = runs["cuda"], runs["cpu"]
    if ga != ca:
        fail(f"fleet device vs CPU: planner actions {ga} != {ca}")
    worst = 0.0
    for n in gs:
        for col in ("videoId", "visits"):
            if not np.array_equal(gs[n][col], cs[n][col]):
                fail(f"fleet device vs CPU: {n} column {col} differs")
        a, b = gs[n]["totalBytes"].astype(np.float64), cs[n]["totalBytes"].astype(np.float64)
        rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-30)
        if rel.size and rel.max() > 1e-5:
            fail(f"fleet device vs CPU: {n} totalBytes rel {rel.max():.3e}")
        worst = max(worst, float(rel.max()) if rel.size else 0.0)
    return {"views": n_views, "epochs": epochs, "actions": ga, "max_rel_err_totalBytes": worst}


# ---------------------------------------------------------------------------
# The streaming path: out-of-order micro-batches through StreamingViewService
# ---------------------------------------------------------------------------

def sync(device) -> None:
    """Wait for the card, so a host clock read after it covers the work."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class StreamClock:
    """The streaming service's injected clock, moved by hand: batch ages and
    the age watermark read it, so refresh points do not depend on walls."""

    t = 0.0

    def __call__(self) -> float:
        return self.t


def stream_queries():
    """The estimators outside the batched engine, on ``totalBytes``."""
    from repro_torch.core import Query

    return [Query("median", "totalBytes"), Query("percentile", "totalBytes", q=0.9),
            Query("min", "totalBytes"), Query("max", "totalBytes")]


def select_predicate():
    from repro_torch.relational.expr import Cmp, Col, Lit

    return Cmp("gt", Col("visitCount"), Lit(30.0))


def micro_batches(delta, n_batches):
    """``delta`` cut into ``n_batches`` equal slices (views, no copies)."""
    from repro_torch.relational.relation import Relation

    step = delta.capacity // n_batches
    out = []
    for i in range(n_batches):
        sl = slice(i * step, delta.capacity if i == n_batches - 1 else (i + 1) * step)
        out.append(Relation({c: v[sl] for c, v in delta.columns.items()}, delta.valid[sl],
                            delta.schema))
    return out


def instrument_stream(vm, svc):
    """Time every refresh (why it ran, its drain-and-apply and its clean)."""
    events = []
    real_refresh, real_many = svc.refresh, vm.svc_refresh_many
    cleans = []

    def svc_refresh_many(*a, **k):
        sync(vm.device)
        t0 = time.perf_counter()
        out = real_many(*a, **k)
        sync(vm.device)
        cleans.append(time.perf_counter() - t0)
        return out

    def refresh(plan=None):
        logs = svc.logs.values()
        rows = sum(lg.pending_rows() for lg in logs)
        age = max((lg.oldest_age_s() for lg in logs), default=0.0)
        reason = ("size" if rows >= svc.config.max_rows
                  else "age" if age >= svc.config.max_age_s else "forced")
        n_clean = len(cleans)
        sync(vm.device)
        t0 = time.perf_counter()
        total = real_refresh(plan)
        sync(vm.device)
        wall = time.perf_counter() - t0
        clean = sum(cleans[n_clean:])
        events.append({"reason": reason, "rows": rows, "wall_s": wall, "clean_s": clean,
                       "drain_apply_s": wall - clean})
        return total

    vm.svc_refresh_many = svc_refresh_many
    svc.refresh = refresh
    return events


def offer_stream(vm, svc, clock, batches, order):
    """Offer ``batches[i]`` with seq i, arriving in ``order``, one clock
    second apart; returns each offer's wall and whether it refreshed."""
    walls = []
    for i in order:
        clock.t += 1.0
        t0 = time.perf_counter()
        refreshed = vm.ingest("Log", inserts=batches[i], seq=int(i))
        sync(vm.device)
        walls.append({"seq": int(i), "wall_s": time.perf_counter() - t0,
                      "refreshed": bool(refreshed)})
    return walls


def run_stream_path(vm, view, n_videos, n_logs, n_delta, m, queries, cfg_kw, n_batches, seed):
    """Stream a fresh ``grow_log`` delta through ``vm`` in ``n_batches``
    shuffled micro-batches, then age the tail out; answer the dashboard,
    the bootstrap and min/max queries and one select through the service;
    repeat the dashboard from the cache; then fold everything in with
    ``maintain_all`` and hold the answers to the maintained view's.
    Returns (report, the kernel_api inputs, the phase's launches)."""
    import torch

    from repro_torch import kernels
    from repro_torch.core import Query
    from repro_torch.core.estimators import correspondence_join
    from repro_torch.core.select_queries import svc_select
    from repro_torch.data.synthetic import grow_log
    from repro_torch.streaming import StreamConfig

    name = view.name
    rng = np.random.default_rng(seed)
    # sessions after the main path's delta: every streamed session is new
    delta = grow_log(rng, n_videos, n_logs + n_delta, n_delta, device=vm.device)
    batches = micro_batches(delta, n_batches)
    order = rng.permutation(n_batches)
    clock = StreamClock()
    kernels.reset_launches()
    svc = vm.configure_streaming(StreamConfig(**cfg_kw), clock=clock)
    events = instrument_stream(vm, svc)
    offers = offer_stream(vm, svc, clock, batches, order)
    by_size = sum(e["reason"] == "size" for e in events)
    pending_tail = svc.staleness().pending_rows
    clock.t += svc.config.max_age_s + 1.0  # the tail ages past the age watermark
    if not svc.watermark_due() or pending_tail >= svc.config.max_rows:
        fail(f"stream: the last {pending_tail} rows do not wait for the age watermark")
    t0 = time.perf_counter()
    answers = svc.query_batch(name, queries)  # honours the due watermark first
    sync(vm.device)
    dashboard_s = time.perf_counter() - t0
    st = svc.staleness()
    if st.pending_rows != 0:
        fail(f"stream: {st.pending_rows} rows pending after the last drain")
    if svc.refresh_count < 3 or by_size < 1 or not any(e["reason"] == "age" for e in events):
        fail(f"stream: refreshes {[e['reason'] for e in events]}, want ≥ 3 with one by age")
    if st.spills < 1:
        fail("stream: the ring never spilled")
    others = {}
    for q in stream_queries():
        t0 = time.perf_counter()
        est = svc.query(name, q).estimate
        sync(vm.device)
        others[q.agg if q.agg != "percentile" else f"p{int(q.q * 100)}"] = (
            q, est, time.perf_counter() - t0)
    mv = vm.views[name]
    t0 = time.perf_counter()
    sel = svc_select(mv.materialized, mv.clean_sample, mv.stale_sample, select_predicate(), m)
    sync(vm.device)
    select_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    # the same dashboard again: every answer from the cache, no kernel launched
    hits0 = svc.result_cache.hits
    again = svc.query_batch(name, queries)
    if kernels.launch_counts() != launches:
        fail("stream: a cached dashboard launched a kernel")
    if svc.result_cache.hits != hits0 + len(queries) or any(
            a.estimate is not b.estimate for a, b in zip(again, answers)):
        fail("stream: the repeated dashboard was not served from the cache")
    clean = mv.clean_sample
    tb = clean.col("totalBytes")
    inf = torch.full_like(tb, float("inf"))
    sample_ext = {"max": float(torch.where(clean.valid, tb, -inf).max()),
                  "min": float(torch.where(clean.valid, tb, inf).min())}
    api = {"arena": vm.pending.inserts["Log"], "groups": mv.view.plan.num_groups,
           "join": correspondence_join(mv.clean_sample, mv.stale_sample,
                                       Query("sum", "totalBytes"), m),
           "clean": mv.clean_sample, "stale": mv.stale_sample, "m": m}
    t0 = time.perf_counter()
    vm.maintain_all()
    sync(vm.device)
    maintain_s = time.perf_counter() - t0

    # hold the answers to the maintained view (exact over base + every delta)
    truth = []
    for q in queries:
        a, b = float(vm.query_stale(name, q)), float(vm.query_exact_fresh(name, q))
        if a != b:
            fail(f"stream: after maintain_all query_stale {a} != query_exact_fresh {b} for {q}")
        truth.append(a)
    ests = [r.estimate for r in answers]
    check_estimates(ests, "stream dashboard")
    out_others = {}
    for key, (q, est, wall_s) in others.items():
        exact = float(vm.query_stale(name, q))
        v, lo, hi = float(est.value), float(est.ci_low), float(est.ci_high)
        if not all(math.isfinite(x) for x in (v, lo, hi, float(est.stderr))) or lo > hi:
            fail(f"stream: {key} estimate {est}")
        row = {"method": est.method, "value": v, "ci_low": lo, "ci_high": hi,
               "stderr": float(est.stderr), "exact": exact,
               "rel_err": abs(v - exact) / max(abs(exact), 1e-30), "wall_s": wall_s}
        if q.agg in ("min", "max"):
            p = float(est.stderr)  # the Cantelli probability rides in stderr
            if not 0.0 <= p <= 1.0:
                fail(f"stream: {key} Cantelli probability {p} outside [0, 1]")
            if (q.agg == "max" and v < sample_ext["max"]) or (q.agg == "min" and v > sample_ext["min"]):
                fail(f"stream: {key} {v} beyond the clean sample's own {sample_ext[q.agg]}")
            row["clean_sample_extremum"] = sample_ext[q.agg]
        else:
            row["exact_in_ci"] = lo <= exact <= hi
        out_others[key] = row
    counts = {}
    for key in ("n_updated", "n_added", "n_deleted"):
        e = getattr(sel, key)
        v, lo, hi = float(e.value), float(e.ci_low), float(e.ci_high)
        if not all(math.isfinite(x) for x in (v, lo, hi)) or not lo <= v <= hi:
            fail(f"stream: select {key} {e}")
        counts[key] = {"value": v, "ci_low": lo, "ci_high": hi}
    report = {
        "config": cfg_kw, "micro_batches": n_batches, "rows_per_batch": batches[0].capacity,
        "arrival_seqs": [int(i) for i in order],
        "refreshes": events, "spills": st.spills, "refresh_count": svc.refresh_count,
        "offer_wall_s": offers, "dashboard_s": dashboard_s, "select_s": select_s,
        "maintain_all_s": maintain_s, "pending_rows_after": st.pending_rows,
        "dashboard_rel_err_vs_fresh": rel_errors(ests, truth),
        "estimators": out_others, "select": {"rows": int(sel.patched.valid.sum()), **counts},
        "cache": svc.result_cache.stats(), "launches": launches,
    }
    return report, api, launches


# ---------------------------------------------------------------------------
# kernel_api: segment_sum (both routes) and corr_moments on the streaming
# path's tensors
# ---------------------------------------------------------------------------

def api_inputs(api):
    """The group-by's (gid, [bytes, 1]) over the streamed delta arena, as
    ``relational.ops.groupby`` builds them (sorted ids, invalid rows in the
    overflow slot G), the same rows in a seeded shuffle, and the joined
    ``__t_new``/``__t_old``/valid of SVC+CORR for ``sum(totalBytes)``."""
    import torch

    from repro_torch.relational import ops

    arena, G = api["arena"], api["groups"]
    order, _sk, _sv, _start, gid = ops.group_ids(arena, ("videoId",), G)
    vals = torch.stack([arena.col("bytes")[order],
                        torch.ones(arena.capacity, dtype=torch.float32, device=arena.device)], 1)
    perm = torch.from_numpy(np.random.default_rng(SEED).permutation(arena.capacity)).to(
        arena.device)
    j = api["join"]
    return ((gid.contiguous(), vals.contiguous(), G),
            (gid[perm].contiguous(), vals[perm].contiguous(), G),
            (j.col("__t_new").contiguous(), j.col("__t_old").contiguous(), j.valid.contiguous()))


def drive_api(seg_args, shuffled_args, corr_args):
    """The kernels' own entry points: segment_sum over the sorted ids (the
    group-by's kernel) and over their shuffle, and corr_moments."""
    from repro_torch.kernels.corr_diff import corr_moments
    from repro_torch.kernels.segment_aggsum import segment_sum

    return (segment_sum(*seg_args, indices_are_sorted=True), segment_sum(*shuffled_args),
            corr_moments(*corr_args))


def hold_segment_sum(got, gid, vals, G, what, f64_sums=False):
    """Counts (column 1) exact; sums around the float64 sums.  ``f64_sums``
    (the sorted kernel, which sums each group in float64 and rounds once):
    within F64_SUM_RTOL·Σ|x|; otherwise (float32 sums in any order): within
    γ_{n−1}·Σ|x|.  Returns (max abs error, max share of the bound)."""
    import torch

    keep = (gid >= 0) & (gid < G)
    g = torch.where(keep, gid.long(), torch.full_like(gid, G, dtype=torch.int64))
    exact = torch.zeros((G + 1, 2), dtype=torch.float64, device=gid.device).index_add_(
        0, g, vals.double())[:G]
    abs_sum = torch.zeros((G + 1, 2), dtype=torch.float64, device=gid.device).index_add_(
        0, g, vals.double().abs())[:G]
    if not torch.equal(got[:, 1].double(), exact[:, 1]):
        fail(f"{what}: segment_sum counts differ from the exact counts")
    if f64_sums:
        bound = F64_SUM_RTOL * abs_sum[:, 0]
    else:
        bound = torch.from_numpy(f32_sum_rtol(exact[:, 1].cpu().numpy())).to(gid.device) * \
            abs_sum[:, 0]
    diff = (got[:, 0].double() - exact[:, 0]).abs()
    if bool((diff > bound).any()):
        fail(f"{what}: segment_sum sums beyond the bound (max abs {float(diff.max()):.3e})")
    return float(diff.max()), float((diff / bound.clamp(min=1e-300)).max())


def hold_corr_moments(got, t_new, t_old, mask, what, f64_sums):
    """The count exact; Σd and Σd² around the float64 sums of the float32
    per-row terms.  ``f64_sums`` (the kernel, which adds in float64 and
    rounds once to float32): within F64_SUM_RTOL·Σ|x|; otherwise (the plain
    float32 version): within γ_{n−1}·Σ|x|.  Returns (max abs error, max
    share of the bound)."""
    import torch

    d = (t_new - t_old) * mask.to(torch.float32)
    exact = [d.double().sum(), (d * d).double().sum(), mask.double().sum()]
    if float(got[2]) != float(exact[2]):
        fail(f"{what}: corr_moments count {float(got[2])} != {float(exact[2])}")
    rtol = F64_SUM_RTOL if f64_sums else float(f32_sum_rtol(int(t_new.shape[0])))
    errs, shares = [], []
    for k, scale in ((0, d.double().abs().sum()), (1, exact[1])):
        bound = rtol * float(scale)
        err = abs(float(got[k]) - float(exact[k]))
        if err > bound:
            fail(f"{what}: corr_moments moment {k} off by {err:.3e} > {bound:.3e}")
        errs.append(err)
        shares.append(err / max(bound, 1e-300))
    return max(errs), max(shares)


def check_api_kernels(api, iters, main_launches):
    """kernel_api: reset the counters, drive the entry points on the path's
    tensors, read the counters; then hold each kernel against its plain
    version and against the path's own answer, and time it.
    ``main_launches``: the main path's launches of the group-by's kernel,
    which the sorted line reports as its own."""
    import torch

    from repro_torch import kernels
    from repro_torch.core.estimators import _masked_moments, correspondence_diff_stratified
    from repro_torch.core import Query
    from repro_torch.kernels.corr_diff import corr_diff_ref, corr_moments
    from repro_torch.kernels.segment_aggsum import segment_groupby, segment_sum, segment_sum_ref
    from repro_torch.relational import ops

    seg_args, shuffled_args, corr_args = api_inputs(api)
    kernels.reset_launches()
    seg, seg_sh, corr = drive_api(seg_args, shuffled_args, corr_args)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    routes = kernels.route_counts()
    for k in API_KERNELS:
        if launches[k] == 0:
            fail(f"kernel_api: {k} never launched")
    out = []
    gid, vals, G = seg_args
    R = int(gid.shape[0])
    keep = (gid >= 0) & (gid < G)
    kept = int(keep.sum())
    g_idx = torch.where(keep, gid.long(), torch.full_like(gid, G, dtype=torch.int64))
    exact_n = torch.bincount(g_idx, minlength=G + 1)[:G]
    # the sorted route: counts exact, float64 sums rounded once, same bits
    bytes_col = vals[:, :1].contiguous()  # the group-by's panel: one sum column
    err, share = hold_segment_sum(seg, gid, vals, G, "kernel_api sorted", f64_sums=True)
    with uncounted():
        if not torch.equal(segment_sum(*seg_args, indices_are_sorted=True).view(torch.int32),
                           seg.view(torch.int32)):
            fail("kernel_api: the sorted segment_sum differs from run to run")
        counts, sums = segment_groupby(gid, bytes_col, G)
    if not torch.equal(counts.long(), exact_n):
        fail("kernel_api: segment_groupby's int32 counts differ from the exact counts")
    hold_segment_sum(torch.stack([sums[:, 0], counts.float()], 1), gid, vals, G,
                     "kernel_api segment_groupby", f64_sums=True)
    plain = segment_sum_ref(gid, vals, G)
    hold_segment_sum(plain, gid, vals, G, "kernel_api plain")
    if not torch.equal(seg[:, 1], plain[:, 1]):
        fail("kernel_api: segment_sum counts differ from the plain version")
    # the group-by's own sums over the same arena (the same kernel inside)
    gb = ops.groupby(api["arena"], ("videoId",), {"totalBytes": ("sum", "bytes"),
                                                 "visitCount": ("count", None)}, G)
    if not torch.equal(seg[:, 1], gb.col("visitCount")):
        fail("kernel_api: segment_sum counts differ from the group-by's")
    gb_diff = (seg[:, 0].double() - gb.col("totalBytes").double()).abs()
    gb_bound = 2 * torch.from_numpy(f32_sum_rtol(seg[:, 1].cpu().numpy())).to(gid.device) * \
        gb.col("totalBytes").double().abs()
    if bool((gb_diff > gb_bound).any()):
        fail("kernel_api: segment_sum sums beyond 2*gamma of the group-by's")
    bytes_ = R * 4 + kept * 2 * 4 + G * 2 * 4
    library_call = "index_add_ of vals into a (G + 1, 2) zeroed tensor, gid remapped beforehand"
    out.append(kernel_entry(
        "segment_aggsum", "cuda", "src/repro_torch/csrc/segment_aggsum.cu",
        "src/repro/kernels/segment_aggsum/kernel.py:48", main_launches, err,
        cuda_ms(lambda: segment_sum(gid, vals, G, indices_are_sorted=True), iters),
        cuda_ms(lambda: segment_sum_ref(gid, vals, G), iters),
        bytes_=bytes_, ops=kept * 2,
        library_ms=cuda_ms(lambda: torch.zeros((G + 1, 2), dtype=torch.float32,
                                               device=gid.device).index_add_(0, g_idx, vals),
                           iters),
        entry="segment_sum(gid, vals, G, indices_are_sorted=True): the group-by's kernel",
        kernel_api_launches=launches["segment_aggsum"],
        groupby_entry_ms=cuda_ms(lambda: segment_groupby(gid, bytes_col, G), iters),
        groupby_entry="segment_groupby(gid, [bytes], G): int32 counts and the sum, as the "
                      "group-by calls it",
        rows=R, columns=2, groups=G, kept_rows=kept, overflow_rows=R - kept,
        hot_group_rows=int(exact_n.max()), max_bound_share=share,
        max_rel_diff_vs_groupby=float((gb_diff / gb.col("totalBytes").double().abs()
                                       .clamp(min=1e-30)).max()),
        library_call=library_call,
        tolerance=("counts exact (plain, group-by, float64, int32 from segment_groupby); "
                   "sums within 1e-6*sum|x| of the float64 sum and 2*gamma of the group-by's; "
                   "the same bits on a repeat"),
    ))
    # the unsorted route on the same rows shuffled
    gid_sh, vals_sh, _ = shuffled_args
    err_u, share_u = hold_segment_sum(seg_sh, gid_sh, vals_sh, G, "kernel_api unsorted")
    if not torch.equal(seg_sh[:, 1], plain[:, 1]):
        fail("kernel_api: the unsorted segment_sum's counts differ from the plain version")
    g_sh = torch.where((gid_sh >= 0) & (gid_sh < G), gid_sh.long(),
                       torch.full_like(gid_sh, G, dtype=torch.int64))
    out.append(kernel_entry(
        "segment_aggsum_unsorted", "cuda", "src/repro_torch/csrc/segment_aggsum.cu",
        "src/repro/kernels/segment_aggsum/kernel.py:48", launches["segment_aggsum_unsorted"],
        err_u,
        cuda_ms(lambda: segment_sum(gid_sh, vals_sh, G), iters),
        cuda_ms(lambda: segment_sum_ref(gid_sh, vals_sh, G), iters),
        bytes_=bytes_, ops=kept * 2,
        library_ms=cuda_ms(lambda: torch.zeros((G + 1, 2), dtype=torch.float32,
                                               device=gid.device).index_add_(0, g_sh, vals_sh),
                           iters),
        entry="segment_sum(gid, vals, G): ids in any order, on a seeded shuffle of the rows",
        rows=R, columns=2, groups=G, kept_rows=kept, max_bound_share=share_u,
        library_call=library_call,
        tolerance="counts exact (plain, float64); float32 sums within gamma_{n-1}*sum|x|",
    ))
    t_new, t_old, mask = corr_args
    n = int(t_new.shape[0])
    got = torch.stack(corr)
    err_c, share_c = hold_corr_moments(got, t_new, t_old, mask, "kernel_api", f64_sums=True)
    plain_c = torch.stack(corr_diff_ref(t_new, t_old, mask))
    hold_corr_moments(plain_c, t_new, t_old, mask, "kernel_api plain", f64_sums=False)
    if not torch.equal(got, torch.stack(corr_moments(t_new, t_old, mask))):
        fail("kernel_api: corr_moments differs from run to run")
    d, dmask, _ = correspondence_diff_stratified(api["clean"], api["stale"],
                                                 Query("sum", "totalBytes"), api["m"])
    k, s, _mean, _var = _masked_moments(d, dmask)
    if float(k) != float(got[2]):
        fail(f"kernel_api: corr_moments count {float(got[2])} != svc_corr's k {float(k)}")
    # svc_corr's s is a float32 sum in which the masked rows add exact
    # zeros, so only its k live terms round: γ_{k−1}, plus the kernel's own
    s_bound = (float(f32_sum_rtol(int(float(k)))) + F64_SUM_RTOL) * \
        float(torch.where(dmask, d, torch.zeros_like(d)).double().abs().sum())
    if abs(float(s) - float(got[0])) > s_bound:
        fail("kernel_api: corr_moments sum beyond gamma_{k-1} + 1e-6 of svc_corr's s")
    out.append(kernel_entry(
        "corr_diff", "cuda", "src/repro_torch/csrc/corr_diff.cu",
        "src/repro/kernels/corr_diff/kernel.py:50", launches["corr_diff"], err_c,
        cuda_ms(lambda: corr_moments(t_new, t_old, mask), iters),
        cuda_ms(lambda: corr_diff_ref(t_new, t_old, mask), iters),
        bytes_=n * (4 + 4 + 1) + 3 * 4, ops=5 * n, library_ms=None,
        host_enqueue_us=host_enqueue_us(lambda: corr_moments(t_new, t_old, mask), iters),
        launches_per_call=device_launches(lambda: corr_moments(t_new, t_old, mask)),
        rows=n, valid_rows=int(float(got[2])), svc_corr_k=float(k), svc_corr_s=float(s),
        max_bound_share=share_c,
        moments=[float(x) for x in got],
        plain_is="the three-reduction expression (d.sum(), (d*d).sum(), mask.sum())",
        tolerance=("count exact (plain, float64, svc_corr's k); the kernel's sums within "
                   "1e-6*sum|x| of the float64 sums (it adds in float64), the plain version's "
                   "within gamma_{n-1}*sum|x|; (gamma_{k-1} + 1e-6)*sum|x| of svc_corr's s, "
                   "k its live rows; the same bits run to run"),
    ))
    return out, launches, routes


# ---------------------------------------------------------------------------
# The streaming path on the card against the CPU, at a small size
# ---------------------------------------------------------------------------

def stream_device_vs_cpu(n_videos, n_logs, n_delta, m, seed, n_batches,
                         devices=("cuda", "cpu")) -> dict:
    """The same offers through a CUDA and a CPU manager (``devices``: the
    card's first; the CPU rehearsal passes two CPUs): the same refreshes
    and staleness, the same clean samples, and on the CPU's samples (moved
    to the card) the same min/max values and bootstrap stats under the same
    uniforms; both kernels on the small path's tensors within the float32
    bound, counts equal to the CPU's plain versions."""
    import torch

    from repro_torch.core import Query
    from repro_torch.core.bootstrap import gather_cond, resample_stats
    from repro_torch.core.estimators import correspondence_join
    from repro_torch.core.minmax import svc_minmax
    from repro_torch.data.synthetic import grow_log
    from repro_torch.kernels.corr_diff import corr_diff_ref
    from repro_torch.kernels.segment_aggsum import segment_sum_ref
    from repro_torch.streaming import StreamConfig

    step = n_delta // n_batches
    # two batches fill the ring; the third spills and trips the size
    # watermark; the last waits for the age watermark
    cfg_kw = dict(max_rows=int(2.4 * step), max_age_s=3600.0, max_batches=2)
    runs = []
    for device in devices:
        vm, view, log, video, _delta, groups = build_scenario(n_videos, n_logs, 0, m, seed, device)
        vm.register_base("Log", log)
        vm.register_base("Video", video)
        vm.register_view(view, delta_bases=("Log",), m=m, delta_group_capacity=groups)
        rng = np.random.default_rng(seed + 1)
        delta = grow_log(rng, n_videos, n_logs, n_delta, device=device)
        clock = StreamClock()
        svc = vm.configure_streaming(StreamConfig(**cfg_kw), clock=clock)
        events = instrument_stream(vm, svc)
        offer_stream(vm, svc, clock, micro_batches(delta, n_batches), rng.permutation(n_batches))
        clock.t += cfg_kw["max_age_s"] + 1.0
        svc.query_batch(view.name, dashboard(n_videos))
        mv = vm.views[view.name]
        st = svc.staleness()
        runs.append({
            "refreshes": [e["reason"] for e in events],
            "staleness": (svc.refresh_count, st.pending_rows, st.pending_batches, st.spills,
                          st.refreshed_through_seq),
            "clean": mv.clean_sample, "stale": mv.stale_sample,
            "stale_result": {q.agg: vm.query_stale(view.name, q) for q in stream_queries()[2:]},
            "minmax": {q.agg: float(svc.query(view.name, q).value) for q in stream_queries()[2:]},
            "api": {"arena": vm.pending.inserts["Log"], "groups": groups,
                    "join": correspondence_join(mv.clean_sample, mv.stale_sample,
                                                Query("sum", "totalBytes"), m)},
        })
    gpu, cpu = runs
    if gpu["refreshes"] != cpu["refreshes"] or gpu["staleness"] != cpu["staleness"]:
        fail(f"stream device vs CPU: refreshes {gpu['refreshes']} {gpu['staleness']} != "
             f"{cpu['refreshes']} {cpu['staleness']}")
    if "age" not in gpu["refreshes"] or gpu["staleness"][3] < 1:
        fail(f"stream device vs CPU: refreshes {gpu['refreshes']}, spills {gpu['staleness'][3]}")
    same = same_sample(sorted_sample(gpu["clean"]), sorted_sample(cpu["clean"]),
                       "stream device vs CPU clean sample")

    # the CPU's samples on both devices
    worst = 0.0
    rng = np.random.default_rng(seed + 2)
    for q in stream_queries():
        got = []
        if q.agg in ("min", "max"):
            for device in devices:
                r = svc_minmax(cpu["stale_result"][q.agg].to(device), cpu["clean"].to(device),
                               cpu["stale"].to(device), q, m)
                got.append((float(r.value), float(r.exceed_prob)))
            (va, pa), (vb, pb) = got
            if va != vb or abs(pa - pb) > 1e-5 * max(abs(pb), 1e-30):
                fail(f"stream device vs CPU: {q.agg} {got[0]} != {got[1]}")
            continue
        us = None
        for device in devices:
            values, k = gather_cond(cpu["clean"].to(device), q)
            if us is None:
                us = rng.random((200, values.shape[0])).astype(np.float32)
            qq = 0.5 if q.agg == "median" else q.q
            got.append(resample_stats(values, k, torch.from_numpy(us).to(device),
                                      qq).cpu().numpy())
        rel = np.abs(got[0] - got[1]) / np.maximum(np.abs(got[1]), 1e-30)
        worst = max(worst, float(rel.max()))
        if rel.max() > 1e-6:
            fail(f"stream device vs CPU: {q.agg} bootstrap stats rel {rel.max():.3e}")

    seg_args, shuffled_args, corr_args = api_inputs(gpu["api"])
    with uncounted():
        seg, seg_sh, corr = drive_api(seg_args, shuffled_args, corr_args)
    gid, vals, G = seg_args
    seg_err = hold_segment_sum(seg, gid, vals, G, "stream small", f64_sums=gid.is_cuda)[0]
    hold_segment_sum(seg_sh, *shuffled_args, "stream small unsorted")
    for got in (seg, seg_sh):
        if not torch.equal(got[:, 1].cpu(), segment_sum_ref(gid.cpu(), vals.cpu(), G)[:, 1]):
            fail("stream device vs CPU: segment_sum counts differ from the CPU's plain version")
    corr_err = hold_corr_moments(torch.stack(corr), *corr_args, "stream small",
                                 f64_sums=corr_args[0].is_cuda)[0]
    if float(corr_diff_ref(*(t.cpu() for t in corr_args))[2]) != float(corr[2]):
        fail("stream device vs CPU: corr_moments count differs from the CPU's plain version")
    return {"n_logs": n_logs, "delta_rows": n_delta, "micro_batches": n_batches,
            "config": cfg_kw, "refreshes": gpu["refreshes"], "staleness": gpu["staleness"],
            **same, "minmax_own_samples": {a: (gpu["minmax"][a], cpu["minmax"][a])
                                           for a in gpu["minmax"]},
            "bootstrap_max_rel_err": worst,
            "kernel_max_abs_err": {"segment_sum": seg_err, "corr_moments": corr_err}}


# ---------------------------------------------------------------------------
# The LM serving path: gemma-2b through ServeEngine, telemetry into SVC
# ---------------------------------------------------------------------------

def serve_prompts(vocab: int, n: int, lo: int, hi: int, seed: int):
    """``n`` prompts of mixed lengths in [lo, hi] (numpy, ``seed``): their
    slots sit at different cache positions, so ticks split into groups."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(lo, hi + 1, n)
    return [rng.integers(0, vocab, int(p)).astype(np.int32) for p in lens]


def telemetry_service(device, capacity: int, stream_kw: dict):
    """tests/test_streaming.py's serveView (sums of active, emitted and
    queued, grouped by tickId) over an empty ServeLog base that holds
    ``capacity`` ticks, streamed under ``stream_kw``."""
    from repro_torch.core import ViewDef
    from repro_torch.relational.plan import GroupByNode, Scan
    from repro_torch.relational.relation import from_columns
    from repro_torch.streaming import StreamConfig
    from repro_torch.views import ViewManager

    vm = ViewManager(device=device)
    none = np.zeros(0, np.float32)
    vm.register_base("ServeLog", from_columns(
        {"tickId": np.zeros(0, np.int32), "active": none, "emitted": none, "queued": none},
        pk=["tickId"], capacity=capacity, device=device))
    plan = GroupByNode(child=Scan("ServeLog", pk=("tickId",)), keys=("tickId",),
                       aggs=(("active", "sum", "active"), ("emitted", "sum", "emitted"),
                             ("queued", "sum", "queued")),
                       num_groups=capacity)
    vm.register_view(ViewDef("serveView", plan), delta_bases=("ServeLog",), m=1.0,
                     delta_group_capacity=capacity)
    return vm.configure_streaming(StreamConfig(**stream_kw))


class DecodeProbe:
    """A Model's ``decode_step`` that counts its calls, folds the finiteness
    of every logit into one device flag (no host sync), and keeps the
    decoded rows' logits on the host when ``keep``."""

    def __init__(self, model, keep: bool = False):
        self.inner, self.keep = model.decode_step, keep
        self.calls, self.finite, self.logits = 0, None, []

    def __call__(self, params, cache, tokens, pos, rows=None):
        import torch

        logits, cache = self.inner(params, cache, tokens, pos, rows)
        self.calls += 1
        ok = torch.isfinite(logits).all()
        self.finite = ok if self.finite is None else self.finite & ok
        if self.keep:
            self.logits.append(logits[list(rows)].float().cpu())
        return logits, cache


class FlashCapture:
    """Stands in for the transformer's ``flash_attention`` while the serve
    path runs: it calls the wrapper (which counts its launch) and keeps a
    copy, with the same strides, of the inputs of the first decode call
    whose cache slice reaches ``t_min`` keys (layer 0 of that step)."""

    def __init__(self, t_min: int):
        from repro_torch.models import transformer

        self.mod, self.real, self.t_min, self.inputs = transformer, transformer.flash_attention, t_min, None

    def __call__(self, q, k, v, causal=True):
        import torch

        out = self.real(q, k, v, causal)
        if self.inputs is None and not causal and k.shape[1] >= self.t_min:
            self.inputs = tuple(torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                                                    device=t.device).copy_(t) for t in (q, k, v))
        return out

    def __enter__(self):
        self.mod.flash_attention = self
        return self

    def __exit__(self, *exc):
        self.mod.flash_attention = self.real


def run_serve_path(cfg, max_batch, max_seq, prompts, max_new, tick_capacity, stream_kw, seed,
                   device="cuda"):
    """``cfg`` (gemma-2b at full width in bf16) with weights drawn on the
    card from a ``torch.Generator(seed)``; the engine serves ``prompts``
    with its telemetry streamed into serveView, then answers
    ``dashboard()``.  The launch counters are set to 0 just before and read
    just after.  Returns (report, model, params, the captured decode
    inputs, launches)."""
    import torch

    from repro_torch import kernels
    from repro_torch.models import get_model
    from repro_torch.serving import Request, ServeEngine

    model = get_model(cfg, device=device)
    params, init_s = wall(lambda: model.init(torch.Generator(device=device).manual_seed(seed)))
    probe = DecodeProbe(model)
    svc = telemetry_service(device, tick_capacity, stream_kw)
    engine = ServeEngine(dataclasses.replace(model, decode_step=probe), params,
                         max_batch=max_batch, max_seq=max_seq, telemetry=svc)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    with FlashCapture(max(len(p) for p in prompts)) as cap:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for rid, p in enumerate(prompts):
            engine.submit(Request(rid=rid, prompt=p, max_new=max_new))
        done = engine.run()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        _, refresh_s = wall(svc.refresh)  # the ticks since the last watermark trip
        dash, dashboard_s = wall(engine.dashboard)
    launches = kernels.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # the observatory panel of the telemetry service, a profiler installed
    # around this call alone (on the whole run it would synchronize every
    # flash launch)
    from repro_torch.obs.kprof import KernelProfiler

    kernels.set_profiler(KernelProfiler())
    try:
        panel, observatory_s = wall(lambda: engine.dashboard("observatory"))
    finally:
        kernels.set_profiler(None)
    if not panel["reconciliation"]["queries_ok"]:
        fail(f"serve_path: the observatory panel does not reconcile: {panel['reconciliation']}")
    # one warm decode call of the whole pool at the longest prompt's last
    # position, alone and under the profiler
    cache = model.init_cache(max_batch, max_seq)
    tokens = torch.zeros((max_batch, 1), dtype=torch.int32, device=device)
    rows, pos = list(range(max_batch)), max(len(p) for p in prompts) - 1

    def decode_call():
        return model.decode_step(params, cache, tokens, pos, rows)

    with uncounted():
        decode_call()
        _, decode_call_s = wall(decode_call)
        decode_profile = profile_ops(decode_call)
    del cache

    if len(done) != len(prompts):
        fail(f"serve_path: {len(done)} of {len(prompts)} requests completed")
    short = [r.rid for r in done if len(r.out_tokens) != max_new + 1]
    if short:
        fail(f"serve_path: requests {short} did not emit their budget of {max_new} + 1 tokens")
    if not bool(probe.finite):
        fail("serve_path: a decode step returned non-finite logits")
    after_admission = sum(len(r.out_tokens) - 1 for r in done)
    if float(dash["ticks"].value) != engine.ticks:
        fail(f"serve_path: dashboard ticks {float(dash['ticks'].value)} != engine ticks {engine.ticks}")
    if float(dash["tokens_emitted"].value) != after_admission:
        fail(f"serve_path: dashboard tokens_emitted {float(dash['tokens_emitted'].value)} != "
             f"{after_admission} emitted after admission")
    prefill_calls = sum(len(p) for p in prompts)
    if launches["flash_attention"] < cfg.n_layers * probe.calls:
        fail(f"serve_path: flash_attention launched {launches['flash_attention']} times, fewer "
             f"than {cfg.n_layers} layers x {probe.calls} decode calls")
    if cap.inputs is None:
        fail("serve_path: no decode call reached the longest prompt's length")
    lat = np.array([r.t_done - r.t_submit for r in done])
    tokens = sum(len(r.out_tokens) for r in done)
    report = {
        "arch": cfg.name, "params": sum(p.numel() for p in params.parameters()),
        "dtype": cfg.compute_dtype, "max_batch": max_batch, "max_seq": max_seq,
        "requests": len(prompts), "prompt_lens": [len(p) for p in prompts], "max_new": max_new,
        "completed": len(done), "tokens": tokens, "tokens_after_admission": after_admission,
        "run_s": run_s, "tok_per_s": tokens / run_s,
        "p50_latency_s": float(np.percentile(lat, 50)), "p99_latency_s": float(np.percentile(lat, 99)),
        "ticks": engine.ticks, "decode_calls": probe.calls, "prefill_decode_calls": prefill_calls,
        "decode_calls_per_tick": (probe.calls - prefill_calls) / engine.ticks,
        "flash_launches_per_decode_call": launches["flash_attention"] / probe.calls,
        "init_s": init_s, "refresh_s": refresh_s, "dashboard_s": dashboard_s,
        "telemetry_refreshes": svc.refresh_count,
        "dashboard": {k: float(v.value) for k, v in dash.items() if hasattr(v, "value")},
        "dashboard_pending_rows": dash["ticks"].staleness.pending_rows,
        "observatory": {"reconciliation": panel["reconciliation"], "wall_s": observatory_s,
                        "kernels": panel["kernels"], "trace": panel["trace"],
                        "stream_refreshes": panel["metrics"].get("stream_refreshes"),
                        "stream_queries": panel["metrics"].get("stream_queries")},
        "peak_device_gb": peak_gb, "launches": launches,
        "decode_call_s": decode_call_s, "decode_call_profile": decode_profile,
    }
    return report, model, params, cap.inputs, launches


def serve_prefill_vs_decode(model, params, n: int, seed: int) -> dict:
    """``prefill`` of one n-token prompt (the kernel's causal mode) against
    the same tokens fed one by one through ``decode_step`` (its non-causal
    mode on the cache slice), at full width in bf16: logits within
    PREFILL_DECODE_TOL of the largest |logit|, caches likewise."""
    import torch

    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, model.cfg.vocab, (1, n)).astype(np.int32)).to(model.device)
    pre, cache_p = model.prefill(params, {"tokens": toks}, cache_len=n)
    cache = model.init_cache(1, n)
    outs = []
    for i in range(n):
        lg, cache = model.decode_step(params, cache, toks[:, i:i + 1], i)
        outs.append(lg[:, 0])
    dec = torch.stack(outs, 1).float()
    pre = pre.float()
    scale = float(pre.abs().max())
    err = float((pre - dec).abs().max())
    cache_err = max(float((cache_p[k].float() - cache[k].float()).abs().max()) for k in ("k", "v"))
    cache_scale = max(float(cache_p[k].float().abs().max()) for k in ("k", "v"))
    if not (bool(torch.isfinite(pre).all()) and bool(torch.isfinite(dec).all())):
        fail("serve_prefill_vs_decode: non-finite logits")
    if err > PREFILL_DECODE_TOL * scale or cache_err > PREFILL_DECODE_TOL * cache_scale:
        fail(f"serve_prefill_vs_decode: logits {err} (of {scale}) or cache {cache_err} "
             f"(of {cache_scale}) beyond {PREFILL_DECODE_TOL} of the largest magnitude")
    return {"tokens": n, "max_abs_err": err, "max_abs_logit": scale,
            "rel_err": err / scale, "mean_abs_err": float((pre - dec).abs().mean()),
            "cache_max_abs_err": cache_err, "cache_max_abs": cache_scale,
            "argmax_agree": float((pre.argmax(-1) == dec.argmax(-1)).float().mean()),
            "tolerance": f"max |prefill - decode| <= {PREFILL_DECODE_TOL} * max |prefill| "
                         "(logits and K/V caches; bf16 activations round at 2^-8 relative "
                         "wherever the two paths' sums differ)"}


def flash_entry(label, q, k, v, causal, launches, iters, **extra):
    """The kernel against its plain version on (q, k, v) and timed beside
    it and beside scaled_dot_product_attention (the yardstick: the port
    never calls it); launches here are not counted."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref
    from repro_torch.kernels.flash_attention.ops import plan

    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    pl = plan(q.dtype, B, S, T, H, K, hd, causal)
    with uncounted():
        got = flash_attention(q, k, v, causal)
        want = flash_attention_ref(q, k, v, causal)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        scale = float(want.float().abs().max())
        tol = FLASH_TOL[str(q.dtype)]
        if not torch.allclose(got.float(), want.float(), rtol=tol, atol=tol):
            fail(f"flash_attention {label}: max abs diff {err} from the plain version beyond {tol}")
        if err > FLASH_SCALED_TOL * scale:
            fail(f"flash_attention {label}: max abs diff {err} beyond {FLASH_SCALED_TOL} of "
                 f"max |plain| {scale}")
        ms = cuda_ms(lambda: flash_attention(q, k, v, causal), iters)
    plain_ms = cuda_ms(lambda: flash_attention_ref(q, k, v, causal), iters)

    def sdpa():
        return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                              v.transpose(1, 2), is_causal=causal,
                                              enable_gqa=H != K)

    lib_err = float((sdpa().transpose(1, 2).float() - want.float()).abs().max())
    library_ms = cuda_ms(sdpa, iters)
    m = min(S, T)
    pairs = m * (m + 1) // 2 + (S - m) * T if causal else S * T  # kept (query, key) pairs
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    return kernel_entry(
        "flash_attention", "cuda", "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/kernel.py:71", launches, err, ms, plain_ms,
        bytes_=nbytes, ops=4 * B * H * hd * pairs, library_ms=library_ms,
        ops_per_s=BF16_OPS_PER_S if str(q.dtype) == "torch.bfloat16" else FP32_OPS_PER_S,
        shape=label, B=B, S=S, T=T, H=H, K=K, hd=hd, causal=causal, dtype=str(q.dtype),
        strides={"q": list(q.stride()), "k": list(k.stride())},
        kernel_route=pl.route, rows_per_tile=pl.rows_per_tile, keys_per_tile=pl.keys_per_tile,
        key_splits=pl.nsplit,
        library_call="torch.nn.functional.scaled_dot_product_attention(enable_gqa)",
        library_max_abs_diff_vs_plain=lib_err,
        max_abs_plain=scale, err_over_max_plain=err / scale if scale else 0.0,
        tolerance=f"|kernel - plain| <= {tol} + {tol}*|plain| and max |kernel - plain| <= "
                  f"{FLASH_SCALED_TOL} * max |plain| (f32 scores, softmax and sums in both, in "
                  "other orders; a bf16 output may round to the neighbouring value)",
        **extra)


def check_flash_kernels(serve_inputs, launches, iters, shapes=FLASH_SHAPES, device="cuda"):
    """flash_attention on the serve path's captured decode inputs (the
    kernels-line entry; bf16, the tensor-core route), the same inputs in
    float32 with the same strides (the CUDA-core route), then at
    ``shapes``: DECODE_32K's length, a 4,096-token causal prefill, and the
    GQA head dims of granite, phi3 and qwen2-vl."""
    import torch

    gen = torch.Generator(device=device).manual_seed(SEED)

    def qkv(B, S, T, H, K, hd):
        return [torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
                for shape in ((B, S, H, hd), (B, T, K, hd), (B, T, K, hd))]

    out = [flash_entry("serve_path decode (layer 0, captured)", *serve_inputs, False, launches,
                       iters)]
    f32 = [torch.empty_strided(t.shape, t.stride(), dtype=torch.float32, device=t.device).copy_(t)
           for t in serve_inputs]
    out.append(flash_entry("serve_path decode (layer 0, captured), float32", *f32, False,
                           launches, iters))
    for label, shape, causal in shapes:
        out.append(flash_entry(label, *qkv(*shape), causal, launches, iters))
    return out


def serve_device_vs_cpu(arch, prompt_lens, max_batch, max_seq, max_new, seed,
                        devices=("cuda", "cpu")) -> dict:
    """``<arch>-smoke`` (f32) served on the card and on the CPU from one set
    of weights (``devices``: the card's first; the CPU rehearsal passes two
    CPUs): the same tokens, and every decoded row's logits within
    SERVE_DEVICE_CPU_ATOL, with TF32 off."""
    import copy

    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import get_model
    from repro_torch.serving import Request, ServeEngine

    cfg = get_smoke_config(arch)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in prompt_lens]
    torch.backends.cuda.matmul.allow_tf32 = False
    p_cpu = get_model(cfg, device="cpu").init(seed)
    runs = []
    for device in devices:
        model = get_model(cfg, device=device)
        params = copy.deepcopy(p_cpu).to(device)
        probe = DecodeProbe(model, keep=True)
        eng = ServeEngine(dataclasses.replace(model, decode_step=probe), params,
                          max_batch=max_batch, max_seq=max_seq)
        for rid, p in enumerate(prompts):
            eng.submit(Request(rid=rid, prompt=p, max_new=max_new))
        runs.append(({r.rid: r.out_tokens for r in eng.run()}, probe.logits, eng.ticks))
    (tok_gpu, lg_gpu, ticks_gpu), (tok_cpu, lg_cpu, ticks_cpu) = runs
    if tok_cpu != tok_gpu or ticks_cpu != ticks_gpu:
        fail("serve_device_vs_cpu: the card emitted other tokens than the CPU")
    if len(lg_cpu) != len(lg_gpu):
        fail("serve_device_vs_cpu: different numbers of decode calls")
    err = max(float((a - b).abs().max()) for a, b in zip(lg_cpu, lg_gpu))
    if err > SERVE_DEVICE_CPU_ATOL:
        fail(f"serve_device_vs_cpu: logits differ by {err} > {SERVE_DEVICE_CPU_ATOL}")
    return {"arch": cfg.name, "requests": len(prompts), "prompt_lens": list(prompt_lens),
            "decode_calls": len(lg_cpu), "ticks": ticks_cpu,
            "tokens": sum(len(t) for t in tok_cpu.values()), "same_tokens": True,
            "logits_max_abs_diff": err,
            "tolerance": f"tokens equal; logits within {SERVE_DEVICE_CPU_ATOL} (f32, TF32 off)"}


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# The observatory and the chaos layer: kprof, chaos_fleet, chaos_stream
# ---------------------------------------------------------------------------

def host_enqueue_median_us(fn, iters: int, repeats: int = KPROF_REPEATS) -> dict:
    """The mean host µs of a call of ``fn`` in each of ``repeats`` loops of
    ``iters`` calls back to back (no synchronize inside a loop), and their
    median: the loop of ``tools/kernel_profile.py``'s host enqueue."""
    import torch

    for _ in range(3):
        fn()
    runs = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        runs.append((time.perf_counter() - t0) / iters * 1e6)
        torch.cuda.synchronize()
    return {"median_us": float(np.median(runs)), "runs_us": runs}


def profiled_window(fn, what: str) -> dict:
    """``fn`` with a fresh ``KernelProfiler`` installed, then the checks: no
    op took its plain version (``fallbacks == 0``), every wrapper whose
    launches grew in the window dispatched under its op at least once, no
    op compiled more often than it dispatched, and the ops' execute
    seconds add to no more than the window's wall."""
    import torch

    from repro_torch import kernels
    from repro_torch.obs.kprof import KernelProfiler

    ops = kernels.op_names()
    before = kernels.launch_counts()
    prof = kernels.set_profiler(KernelProfiler())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        kernels.set_profiler(None)
    wall_s = time.perf_counter() - t0
    launched = {k: n - before[k] for k, n in kernels.launch_counts().items() if n != before[k]}
    summary = prof.summary()
    for op, st in summary.items():
        if st["fallbacks"]:
            fail(f"kprof {what}: {op} took its plain version {st['fallbacks']} times on the card")
        if st["compiles"] > st["dispatches"]:
            fail(f"kprof {what}: {op} compiled {st['compiles']} times in {st['dispatches']}")
    missing = sorted(k for k in launched if summary.get(ops[k], {}).get("dispatches", 0) < 1)
    if missing:
        fail(f"kprof {what}: wrappers launched with no profiled dispatch: {missing}")
    if not launched:
        fail(f"kprof {what}: the window launched no kernel")
    execute_s = sum(st["execute_s"] for st in summary.values())
    if execute_s > wall_s:
        fail(f"kprof {what}: ops' execute {execute_s} s exceeds the window's {wall_s} s")
    return {"wall_s": wall_s, "execute_s": execute_s,
            "compile_s": sum(st["compile_s"] for st in summary.values()),
            "launches": launched, "ops": summary}


def kprof_svc_window(vm, name, queries, api, n_videos, start, n_delta, seed, iters):
    """The single-view main path under the profiler, warm: after a fresh
    ``n_delta``-session delta, a fused (and, visitView being pinned,
    pinned) svc_refresh, the unfused one (the η mask and the group-by),
    query_batch auto and AQP, and the kernel_api entry points; then, with
    no profiler, hash_threshold's host enqueue over the view's rows.  The
    delta is maintained in afterwards, outside the window."""
    from repro_torch.data.synthetic import grow_log
    from repro_torch.kernels.hash_threshold import hash_threshold

    vm.ingest("Log", inserts=grow_log(np.random.default_rng(seed), n_videos, start, n_delta,
                                      device=vm.device))
    if vm.stream is not None:  # a streamed manager buffers it: drain it into the pending deltas
        vm.stream.refresh()
    api_args = api_inputs(api)

    def window():
        vm.svc_refresh(name)
        vm.svc_refresh(name, fused=False)
        vm.query_batch(name, queries)
        vm.query_batch(name, queries, prefer="aqp")
        drive_api(*api_args)

    out = profiled_window(window, "svc")
    del api_args
    vm.maintain_all()
    cols = (vm.views[name].materialized.col("videoId"),)
    out["hash_threshold_host_enqueue"] = {
        "rows": int(cols[0].shape[0]), **host_enqueue_median_us(
            lambda: hash_threshold(cols, M, SEED), iters)}
    return out


def twin_samples(vm, names) -> dict:
    """Each view's materialized view and sample on the host, sorted by key."""
    return {n: {"view": sorted_sample(vm.views[n].materialized),
                "sample": sorted_sample(vm.views[n].clean_sample)} for n in names}


def same_twins(a: dict, b: dict, what: str) -> dict:
    """Keys, counts, the outlier flag and sample membership exact; float
    columns bit-equal, or else within the fleet tolerance (every producer
    but the order of IVM's merges is deterministic on the card: twins that
    maintained at other epochs add a view's deltas in another order)."""
    bit_equal, worst = True, 0.0
    for n in a:
        for part in ("view", "sample"):
            x, y = a[n][part], b[n][part]
            if set(x) != set(y):
                fail(f"{what} {n} {part}: columns {sorted(x)} != {sorted(y)}")
            for col in x:
                if x[col].shape != y[col].shape:
                    fail(f"{what} {n} {part}: {x[col].shape[0]} != {y[col].shape[0]} rows")
                if np.issubdtype(x[col].dtype, np.floating) and col != "visits":
                    if not np.array_equal(x[col], y[col]):
                        bit_equal = False
                        if not np.allclose(x[col], y[col], rtol=FLEET_RTOL, atol=FLEET_ATOL):
                            fail(f"{what} {n} {part}: {col} beyond the fleet tolerance")
                        worst = max(worst, float(np.max(np.abs(
                            x[col].astype(np.float64) - y[col].astype(np.float64)))))
                elif not np.array_equal(x[col], y[col]):
                    fail(f"{what} {n} {part}: column {col} differs")
    return {"views": len(a), "floats": "bit-equal" if bit_equal else "within rtol 1e-6, atol 1e-4",
            "max_abs_float_diff": worst}


def run_chaos_twin(logs, n_views, n_videos, n_logs, n_delta, n_deletes, groups, m, epochs,
                   prices, plan_seed=None, tracer=None, device="cuda"):
    """One fleet twin over ``logs``: the fleet path's epoch-0 ingest, then
    ``epochs`` planner epochs under the fleet path's Zipf query stream and
    prices (no ratio adaptation; a budget of one maintain and every view's
    clean), with a random fault plan when
    ``plan_seed`` is given (and ``tracer`` installed around it), recovery
    epochs until no view is quarantined, and ``maintain_all``."""
    from repro_torch.core import Query
    from repro_torch.obs import trace
    from repro_torch.planner import MaintenancePlanner
    from repro_torch.robustness import FaultPlan

    vm, names = build_fleet(device, n_views, n_videos, n_logs, groups, m, logs=logs)
    fleet_ingest(vm, n_views, n_videos, n_logs, n_delta, 0, n_deletes)
    plan = None
    if plan_seed is not None:
        plan = FaultPlan.random(names, epochs=range(1, epochs + 1), rate=CHAOS_FLEET_RATE,
                                seed=plan_seed, kinds=CHAOS_FLEET_KINDS).attach(vm)
    clock = EpochClock()
    # every view's clean fits in an epoch's budget (besides one maintain),
    # so each epoch touches every view and a scheduled fault meets its
    # target whenever its action is the one the view takes
    budget_s = prices["maintain_s"] + n_views * prices["clean_s"]
    planner = MaintenancePlanner(vm, budget_s=budget_s, age_cap_s=FLEET_AGE_CAP_EPOCHS,
                                 clock=clock)
    planner.cost_model.pin_costs(refresh_s=prices["clean_s"], maintain_s=prices["maintain_s"],
                                 retune_s=prices["retune_s"])
    weights = traffic_weights(n_views)
    t_rng = np.random.default_rng(31)
    q = Query("sum", "totalBytes")
    out = {"epochs": [], "recovery": []}
    trace.set_tracer(tracer)
    try:
        t0 = time.perf_counter()
        for epoch in range(1, epochs + 1):
            clock.t = float(epoch)
            if plan is not None:
                plan.advance()
            hits = t_rng.multinomial(FLEET_HITS, weights)
            for i in range(n_views):
                for _ in range(int(hits[i])):
                    for e in vm.query_batch(names[i], [q] * FLEET_QUERIES_PER_HIT):
                        if not math.isfinite(float(e.value)):
                            fail(f"chaos fleet: non-finite estimate on {names[i]}")
            fleet_ingest(vm, n_views, n_videos, n_logs, n_delta, epoch)
            rep = planner.step()
            out["epochs"].append({"epoch": epoch, "act_s": rep.act_s,
                                  "actions": [(a.view, a.action, a.failed, a.overrun)
                                              for a in rep.actions],
                                  "quarantined": vm.health.quarantined()})
        epoch = epochs
        while vm.health.quarantined():
            if epoch - epochs >= CHAOS_RECOVERY_EPOCHS:
                fail(f"chaos fleet: still quarantined after {CHAOS_RECOVERY_EPOCHS} recovery "
                     f"epochs: {vm.health.quarantined()}")
            epoch += 1
            clock.t = float(epoch)
            if plan is not None:
                plan.advance()
            rep = planner.step()
            out["recovery"].append({"epoch": epoch, "actions": [(a.view, a.action, a.failed)
                                                                 for a in rep.actions],
                                    "quarantined": vm.health.quarantined()})
        vm.maintain_all()
        sync(vm.device)
        out["wall_s"] = time.perf_counter() - t0
    finally:
        trace.set_tracer(None)
    out["fleet_merge_failures"] = vm.fleet_merge_failures
    return vm, names, plan, planner, out


def run_chaos_fleet(n_views, n_videos, n_logs, n_delta, n_deletes, groups, m, epochs, prices,
                    iters, device="cuda"):
    """chaos_fleet, then the fleet's kprof window on the fault-free twin (a
    fresh epoch's delta, one svc_refresh_many, one maintain of an unpinned
    view and two planner epochs: the second's fleet_moments and
    fleet_score dispatches are the profiler's executes, the first's its
    compiles).  Returns (the chaos report, the window)."""
    import tempfile

    import torch

    from repro_torch.kernels.fleet_score import fleet_scores
    from repro_torch.obs import load_jsonl, reconcile
    from repro_torch.obs.trace import Tracer

    t0 = time.perf_counter()
    logs = fleet_logs(n_views, n_videos, n_logs, "cpu")  # generated once, registered twice
    gen_s = time.perf_counter() - t0
    args = (n_views, n_videos, n_logs, n_delta, n_deletes, groups, m, epochs, prices)
    tracer = Tracer()
    faulted, names, plan, _p, fout = run_chaos_twin(logs, *args, plan_seed=0, tracer=tracer,
                                                    device=device)
    # reconcile the faulted twin's trace as an exported file
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "chaos_fleet.jsonl")
        tracer.export_jsonl(path, meta={
            "metrics": faulted.metrics.snapshot(), "pending": {},
            "quarantines": sum(h.failures for h in faulted.health.views.values()),
            "faults_injected": len(plan.injected)})
        meta, records = load_jsonl(path)
    rec = reconcile(meta, records)
    n_fault = sum(r["kind"] == "event" and r["name"] == "fault" for r in records)
    if not rec["ok"] or n_fault != len(plan.injected):
        fail(f"chaos fleet: trace does not reconcile ({n_fault} fault events for "
             f"{len(plan.injected)} injected): {rec['problems'][:5]}")
    kinds = [s.kind for _e, s, _w in plan.injected]
    if kinds.count("kernel_error") != faulted.fleet_merge_failures:
        fail(f"chaos fleet: {kinds.count('kernel_error')} injected kernel_errors, "
             f"{faulted.fleet_merge_failures} fleet_merge_failures")
    # the pin of view 0 is rebuilt only at a clean, so the twins' last pins
    # may come from different epochs' index: both re-derive it from their
    # (equal) bases before the samples are compared
    pinned_before = sorted_sample(faulted.views[names[0]].clean_sample)
    faulted.register_outlier_index(names[0], "FLog0", "bytes", k=min(K, n_logs))
    a = twin_samples(faulted, names)
    del faulted
    torch.cuda.empty_cache()
    clean, _n, _plan, planner, cout = run_chaos_twin(logs, *args, device=device)
    if cout["fleet_merge_failures"] or cout["recovery"]:
        fail(f"chaos fleet: the fault-free twin failed: {cout}")
    pinned_twin = sorted_sample(clean.views[names[0]].clean_sample)
    pinned_same_before = set(pinned_before) == set(pinned_twin) and all(
        np.array_equal(pinned_before[c], pinned_twin[c]) for c in pinned_twin)
    clean.register_outlier_index(names[0], "FLog0", "bytes", k=min(K, n_logs))
    comparison = same_twins(a, twin_samples(clean, names), "chaos fleet")
    del a, logs
    report = {
        "views": n_views, "epochs": epochs, "plan": {"seed": 0, "rate": CHAOS_FLEET_RATE,
                                                     "kinds": list(CHAOS_FLEET_KINDS)},
        "host_generation_s": gen_s,
        "injected": [(e, s.kind, s.target, w) for e, s, w in plan.injected],
        "reconcile": {k: rec[k] for k in ("ok", "checks", "records")}, "fault_events": n_fault,
        "fleet_merge_failures": fout["fleet_merge_failures"],
        "quarantines": meta["quarantines"],
        "faulted": fout, "fault_free": {k: cout[k] for k in ("epochs", "wall_s")},
        "recovered_vs_fault_free": comparison,
        "pinned_view_equal_before_repin": bool(pinned_same_before),
    }
    # kprof: the fleet's warm pass on the fault-free twin
    fleet_ingest(clean, n_views, n_videos, n_logs, n_delta, epochs + 1)
    epochs_before = planner.epoch
    window = profiled_window(lambda: (clean.svc_refresh_many(names), clean.maintain(names[-1]),
                                      planner.step(), planner.step()), "fleet")
    if planner.epoch != epochs_before + 2:
        fail("kprof fleet: the window did not run two planner epochs")
    feats = torch.from_numpy(planner.cost_model.features()).to(clean.device)
    window["fleet_score_host_enqueue"] = {"panel": list(feats.shape), **host_enqueue_median_us(
        lambda: fleet_scores(feats), iters)}
    window["planner_epoch_2"] = {"snapshot_s": planner.last_report.snapshot_s,
                                 "schedule_s": planner.last_report.schedule_s,
                                 "act_s": planner.last_report.act_s}
    del clean, planner
    torch.cuda.empty_cache()
    return report, window


def visit_twin(vm, view, m, groups):
    """A fresh manager over ``vm``'s Log and Video (the same tensors) with
    ``view`` registered as the main path registers it (no outlier index)."""
    from repro_torch.views import ViewManager

    twin = ViewManager(device=vm.device)
    twin.register_base("Log", vm.base["Log"])
    twin.register_base("Video", vm.base["Video"])
    twin.register_view(view, delta_bases=("Log",), m=m, delta_group_capacity=groups)
    return twin


def chaos_stream_run(vm, view, batches, order, queries, plan=None, tracer=None):
    """One service over ``vm``: admission on, STREAM_CONFIG's watermarks; an
    epoch per offer (keyed by seq), a forced refresh every
    CHAOS_REFRESH_EVERY offers, CHAOS_DASHBOARDS dashboards an epoch (times
    the plan's traffic spike), a clock second an epoch (plus the plan's
    skew); then, CHAOS_SETTLE_S clock seconds later, a final refresh and
    dashboard."""
    from repro_torch.obs import trace
    from repro_torch.serving import AdmissionConfig
    from repro_torch.streaming import StreamConfig

    clock = StreamClock()
    svc = vm.configure_streaming(
        StreamConfig(**STREAM_CONFIG, admission=AdmissionConfig(**CHAOS_STREAM_ADMISSION)),
        clock=clock)
    if plan is not None:
        plan.attach(vm)
    trace.set_tracer(tracer)
    verdicts = []
    try:
        for epoch, i in enumerate(order, start=1):
            if plan is not None:
                plan.advance()
            clock.t += 1.0 + (plan.clock_skew_s() if plan is not None else 0.0)
            # the producer keys its offers for at-least-once retries, but for
            # the corrupt copy's epoch: a keyed copy would meet the key
            # dedupe before ingest validation
            key = None if epoch == CORRUPT_EPOCH else f"batch{int(i)}"
            svc.offer("Log", inserts=batches[i], seq=int(i), key=key)
            if epoch % CHAOS_REFRESH_EVERY == 0:
                svc.refresh()
            mult = plan.traffic_multiplier() if plan is not None else 1.0
            for _ in range(max(1, int(round(CHAOS_DASHBOARDS * mult)))):
                ans = svc.query_batch(view.name, queries)
                tag = ans[0].estimate.method.rsplit("+", 1)[-1]
                verdicts.append(tag if tag in ("throttled", "shed", "degraded") else "admitted")
        clock.t += CHAOS_SETTLE_S  # the token buckets refill to their bursts
        svc.refresh()
        overloaded = svc.staleness().overloaded
        final = svc.query_batch(view.name, queries)
        sync(vm.device)
    finally:
        trace.set_tracer(None)
    return svc, final, overloaded, verdicts


def run_chaos_stream(vm, view, n_videos, start, n_delta, m, groups, queries, n_batches, seed):
    """chaos_stream: the faulted service (traced) against a fault-free one,
    each on a fresh twin over the visitView manager's relations."""
    import tempfile

    from repro_torch.data.synthetic import grow_log
    from repro_torch.obs import (export_service_trace, load_jsonl, observatory_panel, reconcile,
                                 trace)
    from repro_torch.obs.trace import Tracer
    from repro_torch.robustness import FaultPlan, FaultSpec

    rng = np.random.default_rng(seed)
    delta = grow_log(rng, n_videos, start, n_delta, device=vm.device)
    batches = micro_batches(delta, n_batches)
    order = rng.permutation(n_batches)
    plan = FaultPlan([FaultSpec(epoch=e, kind=k, target=t, magnitude=mg)
                      for k, e, t, mg in CHAOS_STREAM_FAULTS])
    tracer = Tracer()
    t0 = time.perf_counter()
    a = visit_twin(vm, view, m, groups)
    svc, final, overloaded, verdicts = chaos_stream_run(a, view, batches, order, queries, plan,
                                                        tracer)
    wall_s = time.perf_counter() - t0
    trace.set_tracer(tracer)  # the service's trace and panel read the installed tracer
    try:
        with tempfile.TemporaryDirectory() as tmp:
            path = str(Path(tmp) / "chaos_stream.jsonl")
            export_service_trace(svc, path)
            meta, records = load_jsonl(path)
        panel = observatory_panel(svc)
    finally:
        trace.set_tracer(None)
    rec = reconcile(meta, records)
    log = svc.logs["Log"]
    st = svc.staleness()
    counters = {"deduped_batches": log.deduped_batches, "deduped_rows": log.deduped_rows,
                "corrupt_batches": st.corrupt_batches, "corrupt_rows": log.corrupt_rows,
                "poison_rejected": svc.result_cache.poison_rejected,
                "admitted": svc.admission.admitted, "throttled": svc.admission.throttled,
                "shed": svc.admission.shed, "refreshes": svc.refresh_count}
    if not rec["ok"]:
        fail(f"chaos stream: trace does not reconcile: {rec['problems'][:5]}")
    if not panel["reconciliation"]["queries_ok"]:
        fail(f"chaos stream: observatory reconciliation {panel['reconciliation']}")
    if counters["deduped_batches"] != 1 or counters["corrupt_batches"] != 1:
        fail(f"chaos stream: the duplicate or the corrupt copy was not absorbed: {counters}")
    if counters["poison_rejected"] < 1 or counters["shed"] < 1 or counters["throttled"] < 1:
        fail(f"chaos stream: poison, shed or throttle never showed: {counters}")
    if overloaded:
        fail("chaos stream: still overloaded at the final dashboard")
    fired = sorted({s.kind for _e, s, _w in plan.injected})
    if fired != sorted(k for k, *_ in CHAOS_STREAM_FAULTS):
        fail(f"chaos stream: faults fired {fired}")
    b = visit_twin(vm, view, m, groups)
    _svc, want, _o, _v = chaos_stream_run(b, view, batches, order, queries)
    sample = same_sample(sorted_sample(a.views[view.name].clean_sample),
                         sorted_sample(b.views[view.name].clean_sample), "chaos stream sample")
    worst = 0.0
    for q, x, y in zip(queries, final, want):
        ex, ey = x.estimate, y.estimate
        if ex.method != ey.method:
            fail(f"chaos stream: {q} answered by {ex.method}, fault-free by {ey.method}")
        for f in ("value", "ci_low", "ci_high"):
            u, v = float(getattr(ex, f)), float(getattr(ey, f))
            d = abs(u - v) / max(abs(v), 1e-30)
            worst = max(worst, d)
            if d > CHAOS_ANSWER_RTOL:
                fail(f"chaos stream: {q} {f} {u} vs fault-free {v}")
    del a, b, svc, _svc, delta, batches
    return {"micro_batches": n_batches, "config": {**STREAM_CONFIG, "admission":
                                                   CHAOS_STREAM_ADMISSION},
            "faults": [list(f) for f in CHAOS_STREAM_FAULTS],
            "injected": [(e, s.kind, w) for e, s, w in plan.injected],
            "reconcile": {k: rec[k] for k in ("ok", "checks", "records")},
            "observatory_reconciliation": panel["reconciliation"], "counters": counters,
            "verdicts_by_dashboard": verdicts, "wall_s": wall_s,
            "final_vs_fault_free": {"sample": sample, "max_rel_answer_diff": worst,
                                    "rtol": CHAOS_ANSWER_RTOL}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-logs", type=int, default=N_LOGS,
                    help=f"sessions in Log (at least {MIN_N_LOGS:,}; default {N_LOGS:,})")
    args = ap.parse_args(argv)
    if args.n_logs < MIN_N_LOGS:
        ap.error(f"--n-logs may be cut to {MIN_N_LOGS:,} and no further")

    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT} is not a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    from repro_torch import kernels
    from repro_torch.kernels import _build

    smi = nvidia_smi_line()
    card = {"name": torch.cuda.get_device_name(0), "nvidia_smi": smi,
            "torch": torch.__version__, "cuda": torch.version.cuda}
    emit({"phase": "device", **card})

    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    ptxas = [ln.strip() for ln in str(_build.last_build.get("ptxas", "")).splitlines()
             if "registers" in ln or "Compiling entry" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "library": str(lib.relative_to(ROOT)),
          "cached": not _build.last_build, "ptxas": ptxas})

    queries = dashboard(N_VIDEOS)
    t0 = time.perf_counter()
    vm, view, log, video, delta, groups = build_scenario(
        N_VIDEOS, args.n_logs, N_DELTA, M, SEED, "cuda")
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    times, ests, state = run_svc_loop(vm, view, log, video, delta, groups, M, K, queries)
    launches = kernels.launch_counts()
    routes = kernels.route_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    missing = [k for k in SVC_LOOP_KERNELS if launches[k] == 0]
    if missing:
        fail(f"kernels never launched on the main path: {missing}")
    for what, e in ests.items():
        check_estimates(e, what)
    fused_vs_unfused = same_sample(sorted_sample(state["fused_sample"]),
                                   sorted_sample(state["unfused_sample"]), "fused vs unfused")
    exact_after_ivm = []
    for q in queries:
        a, b = float(vm.query_stale(view.name, q)), float(vm.query_exact_fresh(view.name, q))
        if a != b:
            fail(f"after maintain_all query_stale {a} != query_exact_fresh {b} for {q}")
        exact_after_ivm.append(a)
    # ground truth for the SVC estimates: the maintained view answers the
    # queries exactly over base + delta
    errs = {k: rel_errors(v, exact_after_ivm) for k, v in ests.items()}
    int_lane = check_int_count_lane(log, state["registered"], groups)
    emit({"phase": "main_path", "n_videos": N_VIDEOS, "n_logs": args.n_logs,
          "log_capacity": log.capacity, "delta_rows": N_DELTA, "m": M, "k": K,
          "queries": len(queries), "setup_s": setup_s, "wall_s": times,
          "peak_device_gb": peak_gb, "launches": launches, "routes": routes,
          "groupby_launches": state["groupby_launches"], "int_count_lane": int_lane,
          "pinned_refresh": state["pinned_refresh"], "fused_vs_unfused": fused_vs_unfused, "stale_eq_exact_fresh_after_ivm": True,
          "svc_rel_err_vs_fresh": errs, "card": smi})

    table = check_kernels(state, queries, M, SEED, launches, ITERS)
    for entry in table:
        emit({"phase": "kernel", **entry, "card": smi})

    # the streaming path on the same manager, then the two library kernels
    # on its tensors
    torch.cuda.reset_peak_memory_stats()
    stream, api, stream_launches = run_stream_path(
        vm, view, N_VIDEOS, args.n_logs, N_DELTA, M, queries, STREAM_CONFIG, STREAM_BATCHES,
        STREAM_SEED)
    missing = [k for k in STREAM_KERNELS if stream_launches[k] == 0]
    if missing:
        fail(f"kernels never launched on the streaming path: {missing}")
    emit({"phase": "stream_path", "n_videos": N_VIDEOS, "n_logs": args.n_logs,
          "stream_rows": N_DELTA, "m": M, **stream,
          "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9, "card": smi})
    api_table, api_launches, api_routes = check_api_kernels(api, ITERS,
                                                            launches["segment_aggsum"])
    emit({"phase": "kernel_api", "launches": api_launches, "routes": api_routes, "card": smi})
    for entry in api_table:
        emit({"phase": "kernel", **entry, "card": smi})
    # the group-by's kernel rows in one unfused clean and one warm maintain_all
    emit({"phase": "groupby_profiles", "svc_refresh_unfused": state["unfused_profile"],
          "maintain_all": profile_warm_maintain(vm, N_VIDEOS, args.n_logs + 2 * N_DELTA,
                                                N_DELTA, SEED + 2),
          "card": smi})
    # the main path once more under the kernel profiler (its line follows
    # the fleet's window), then the chaos layer on visitView's relations
    kprof_svc = kprof_svc_window(vm, view.name, queries, api, N_VIDEOS,
                                 args.n_logs + 3 * N_DELTA, KPROF_DELTA, SEED + 3, ITERS)
    del api
    torch.cuda.reset_peak_memory_stats()
    chaos_stream = run_chaos_stream(vm, view, N_VIDEOS, args.n_logs + 4 * N_DELTA, N_DELTA, M,
                                    groups, queries, STREAM_BATCHES, CHAOS_STREAM_SEED)
    emit({"phase": "chaos_stream", **chaos_stream,
          "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9, "card": smi})

    small = device_vs_cpu(SMALL_VIDEOS, SMALL_LOGS, SMALL_DELTA, M, K, SEED)
    emit({"phase": "device_vs_cpu", "n_logs": SMALL_LOGS, **small})

    # the fleet path, on a card the single-view path has let go of
    del vm, view, log, video, delta, state, ests, stream
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    walls, fleet, inputs = run_fleet_path(FLEET_VIEWS, FLEET_VIDEOS, FLEET_LOGS, FLEET_DELTA,
                                          FLEET_DELETES, FLEET_GROUPS, M, FLEET_EPOCHS)
    fleet_launches = kernels.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    missing = [k for k in FLEET_KERNELS if fleet_launches[k] == 0]
    if missing:
        fail(f"kernels never launched on the fleet path: {missing}")
    emit({"phase": "fleet_path", "views": FLEET_VIEWS, "n_videos": FLEET_VIDEOS,
          "n_logs_per_view": FLEET_LOGS, "delta_rows_per_view": FLEET_DELTA,
          "deleted_rows_per_view": FLEET_DELETES, "m": M, "epochs": FLEET_EPOCHS,
          "wall_s": walls, "epochs_out": fleet["epochs"], "merge_shape_groups": fleet["merge_groups"],
          "batched_vs_per_view": fleet["comparison"],
          "svc_refresh_many_view_s": fleet["svc_refresh_many_view_s"],
          "per_view_clean_s": fleet["per_view_s"], "planner_prices": fleet["prices"],
          "peak_device_gb": peak_gb,
          "launches": fleet_launches, "stale_eq_exact_fresh_after_ivm": True, "card": smi})
    fleet_table = check_fleet_kernels(inputs, fleet_launches, ITERS)
    del inputs
    for entry in fleet_table:
        emit({"phase": "kernel", **entry, "card": smi})
    small_fleet = fleet_device_vs_cpu(4, 2_000, 100_000, 10_000, 1_000, M, 2)
    emit({"phase": "fleet_device_vs_cpu", **small_fleet})
    small_stream = stream_device_vs_cpu(SMALL_VIDEOS, SMALL_LOGS, SMALL_DELTA, M, SEED,
                                        SMALL_STREAM_BATCHES)
    emit({"phase": "stream_device_vs_cpu", **small_stream})
    # the fleet under a random fault plan against its fault-free twin, then
    # the fleet's kernel-profiler window on that twin
    torch.cuda.reset_peak_memory_stats()
    chaos_fleet, kprof_fleet = run_chaos_fleet(FLEET_VIEWS, FLEET_VIDEOS, FLEET_LOGS, FLEET_DELTA,
                                               FLEET_DELETES, FLEET_GROUPS, M, FLEET_EPOCHS,
                                               fleet["prices"], ITERS)
    emit({"phase": "chaos_fleet", **chaos_fleet,
          "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9, "card": smi})
    emit({"phase": "kprof", "svc": kprof_svc, "fleet": kprof_fleet, "card": smi})

    # the LM serving path, on a card the SVC paths have let go of
    del fleet, walls, small_fleet, small_stream
    torch.cuda.empty_cache()
    from repro_torch.configs import get_config

    prompts = serve_prompts(get_config(SERVE_ARCH).vocab, SERVE_REQUESTS, *SERVE_PROMPT_LENS, SEED)
    serve, model, params, flash_inputs, serve_launches = run_serve_path(
        get_config(SERVE_ARCH), SERVE_MAX_BATCH, SERVE_MAX_SEQ, prompts, SERVE_MAX_NEW, SERVE_TICK_CAPACITY,
        SERVE_STREAM, SEED)
    missing = [k for k in SERVE_KERNELS if serve_launches[k] == 0]
    if missing:
        fail(f"kernels never launched on the serve path: {missing}")
    emit({"phase": "serve_path", **serve, "card": smi})
    emit({"phase": "serve_prefill_vs_decode", "arch": SERVE_ARCH,
          **serve_prefill_vs_decode(model, params, SERVE_PREFILL_LEN, SEED), "card": smi})
    del model, params
    torch.cuda.empty_cache()
    flash_table = check_flash_kernels(flash_inputs, serve_launches["flash_attention"], ITERS)
    del flash_inputs
    for entry in flash_table:
        emit({"phase": "kernel", **entry, "card": smi})
    emit({"phase": "serve_device_vs_cpu",
          **serve_device_vs_cpu(SERVE_ARCH, (3, 9, 5, 12, 4, 7), 4, 64, 8, SEED)})

    emit({"kernels": table + fleet_table + api_table + flash_table[:1]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
