#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Builds the CUDA kernels from ``src/repro_torch/csrc``, drives the
single-view SVC loop at full size — the paper's running example visitView
(§2.1, Conviva-shaped session logs, as in ``examples/quickstart.py``) —
through ``ViewManager``, holds every kernel against its plain PyTorch
version on the main path's own tensors, checks the answers, and prints one
JSON object per phase.  The line before the last two is the kernel table,
the next the card's name and power limit as ``nvidia-smi`` reports them,
and the last line is ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, without a CUDA device, outside a
checkout of the repository, or when any check fails.

Run:  python3 chip_smoke.py                        (full size, one GPU)
      python3 chip_smoke.py --n-logs 20000000     (the one allowed cut)
"""

from __future__ import annotations

import argparse
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
U = 2.0 ** -24  # float32 unit roundoff

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


def wall(fn):
    """(result, host seconds) of ``fn`` ending in a device synchronize."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


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
    name = view.name
    t = {}
    _, t["register_s"] = wall(lambda: (
        vm.register_base("Log", log), vm.register_base("Video", video),
        vm.register_view(view, delta_bases=("Log",), m=m, delta_group_capacity=groups)))
    _, t["ingest_s"] = wall(lambda: vm.ingest("Log", inserts=delta))
    t["svc_refresh_fused_s"] = vm.svc_refresh(name)
    auto, t["query_batch_auto_s"] = wall(lambda: vm.query_batch(name, queries))
    aqp, t["query_batch_aqp_s"] = wall(lambda: vm.query_batch(name, queries, prefer="aqp"))
    _, t["register_outlier_index_s"] = wall(
        lambda: vm.register_outlier_index(name, "Log", "bytes", k=k))
    t["svc_refresh_pinned_s"] = vm.svc_refresh(name)
    pinned, t["query_batch_pinned_s"] = wall(lambda: vm.query_batch(name, queries))
    fused_sample = vm.views[name].clean_sample
    t["svc_refresh_unfused_s"] = vm.svc_refresh(name, fused=False)
    state = {
        "fused_sample": fused_sample,
        "unfused_sample": vm.views[name].clean_sample,
        "stale_sample": vm.views[name].stale_sample,
        "arena": vm.pending.inserts["Log"],
        "pin": vm.views[name].outlier_pin,
        "index": vm.views[name].outlier_index,
        "materialized": vm.views[name].materialized,
    }
    t["ivm_s"], t["maintain_all_s"] = wall(vm.maintain_all)
    return t, {"auto": auto, "aqp": aqp, "pinned": pinned}, state


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
                 library_ms=None, **extra):
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
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
    from repro_torch.kernels.fused_clean.ops import fused_clean_groupby
    from repro_torch.kernels.fused_clean.ref import fused_clean_ref
    from repro_torch.kernels.hash_threshold.ops import hash_threshold
    from repro_torch.kernels.hash_threshold.ref import hash_threshold_ref
    from repro_torch.kernels.multi_agg.ops import multi_agg_one, multi_agg_two, selector_indices
    from repro_torch.kernels.multi_agg.ref import K_D, K_NEW, K_OLD, S_D, S_NEW, S_OLD, multi_agg_ref
    from repro_torch.kernels.outlier_member.ops import outlier_codes
    from repro_torch.kernels.outlier_member.ref import outlier_codes_ref
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

    # 1. hash_threshold: η on the delta's view key
    got = hash_threshold((vid,), m, seed)
    want = hash_threshold_ref((vid,), m, seed)
    if not torch.equal(got, want):
        fail("hash_threshold mask differs from its plain version")
    out.append(kernel_entry(
        "hash_threshold", "cuda", "src/repro_torch/csrc/hash_threshold.cu",
        "src/repro/kernels/hash_threshold/kernel.py:45", launches["hash_threshold"], 0.0,
        cuda_ms(lambda: hash_threshold((vid,), m, seed), iters),
        cuda_ms(lambda: hash_threshold_ref((vid,), m, seed), iters),
        bytes_=R * (4 + 1), ops=0, rows=R,
    ))

    # 2. fused_clean: η ∨ pin, per-group [count | Σbytes] at G = 2^20.
    # Counts are exact.  Both float32 sums (kernel and plain) are held to the
    # exact sums, taken in float64 over the same kept rows, within
    # ``f32_sum_rtol``: the atomics add in no fixed order.
    pin = state["pin"]
    pin_keys = (sentinel_where(pin.valid, pin.col("videoId")),)
    pin_mask = member_keys((vid,), pin_keys)
    vals = nbytes[:, None].contiguous()
    G = 1 << 20
    gc, gs = fused_clean_groupby(vid, vals, valid, m, seed, G, pin_mask=pin_mask)
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
        max_rel_err=rel_clean, plain_max_rel_err=rel_plain,
        max_bound_share=float((diff / bound.clamp(min=1e-300)).max()),
        index_add_ms=cuda_ms(index_add_only, iters),
        tolerance=("counts exact; float32 sums within gamma_{n-1}*sum|x| of the float64 "
                   "sum, n the group's kept rows, gamma_k = k*2^-24/(1 - k*2^-24)"),
    ))

    # 3. outlier_member: η ∨ digest membership against the index's K keys,
    # and at the main path's own shape (view rows vs the pin table)
    idx = state["index"]
    keys_k = (sentinel_where(idx.records.valid, idx.records.col("videoId")),)
    got = outlier_codes((vid,), keys_k, m, seed)
    if not torch.equal(got, outlier_codes_ref((vid,), keys_k, m, seed)):
        fail("outlier_member codes differ from the plain version (K in shared memory)")
    mat = state["materialized"]
    probe = (sentinel_where(mat.valid, mat.col("videoId")),)
    got_g = outlier_codes(probe, pin_keys, m, seed)
    if not torch.equal(got_g, outlier_codes_ref(probe, pin_keys, m, seed)):
        fail("outlier_member codes differ from the plain version (table in device memory)")
    K = int(keys_k[0].shape[0])
    out.append(kernel_entry(
        "outlier_member", "cuda", "src/repro_torch/csrc/outlier_member.cu",
        "src/repro/kernels/outlier_member/kernel.py:74", launches["outlier_member"], 0.0,
        cuda_ms(lambda: outlier_codes((vid,), keys_k, m, seed), iters),
        cuda_ms(lambda: outlier_codes_ref((vid,), keys_k, m, seed), iters),
        bytes_=R * (4 + 4) + K * 4, ops=0, rows=R, keys=K,
        main_path_shape={
            "rows": int(probe[0].shape[0]), "keys": int(pin_keys[0].shape[0]),
            "ms": cuda_ms(lambda: outlier_codes(probe, pin_keys, m, seed), iters),
            "plain_ms": cuda_ms(lambda: outlier_codes_ref(probe, pin_keys, m, seed), iters),
        },
    ))

    # 4. multi_agg: the dashboard over the correspondence panel (two-sided)
    # and over the materialized view (one-sided exact scan)
    clean, stale = state["unfused_sample"], state["stale_sample"]
    cache = build_correspondence_cache(clean, stale, m)
    batch = QueryBatch.encode(queries, sample_columns(clean), clean.device)
    sel_idx = selector_indices(batch.sel, len(batch.columns))
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

    got = multi_agg_two(*new, batch.sel, batch.meta, *old)
    err2, rel2 = compare(got, multi_agg_ref(*new, batch.sel, batch.meta, *old), "multi_agg_two")
    RJ = int(cache.x_new.shape[0])
    out.append(kernel_entry(
        "multi_agg_two", "cuda", "src/repro_torch/csrc/multi_agg.cu",
        "src/repro/kernels/multi_agg/kernel.py:128", launches["multi_agg_two"], err2,
        cuda_ms(lambda: multi_agg_two(*new, batch.sel, batch.meta, *old), iters),
        cuda_ms(lambda: multi_agg_ref(*new, batch.sel, batch.meta, *old), iters),
        bytes_=2 * RJ * (4 * used + 1 + 4 + 4), ops=RJ * Q * (2 * (8 + 4 * P) + 9),
        rows=RJ, queries=Q, predicate_slots=P, max_rel_err=rel2,
        tolerance="counts exact; moments 1e-5 relative (S_D: of S_NEW + S_OLD)",
    ))
    x = torch.stack([mat.col(c).to(torch.float32) for c in batch.columns], dim=1)
    ones = torch.ones(mat.valid.shape, dtype=torch.float32, device=x.device)
    one = (x, mat.valid, ones, torch.zeros_like(ones))
    got = multi_agg_one(*one, batch.sel, batch.meta)
    err1, rel1 = compare(got, multi_agg_ref(*one, batch.sel, batch.meta), "multi_agg_one")
    RV = int(x.shape[0])
    out.append(kernel_entry(
        "multi_agg_one", "cuda", "src/repro_torch/csrc/multi_agg.cu",
        "src/repro/kernels/multi_agg/kernel.py:159", launches["multi_agg_one"], err1,
        cuda_ms(lambda: multi_agg_one(*one, batch.sel, batch.meta), iters),
        cuda_ms(lambda: multi_agg_ref(*one, batch.sel, batch.meta), iters),
        bytes_=RV * (4 * used + 1 + 4 + 4), ops=RV * Q * (8 + 4 * P),
        rows=RV, queries=Q, predicate_slots=P, max_rel_err=rel1,
        tolerance="counts exact; moments 1e-5 relative",
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
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    missing = [k for k, v in launches.items() if v == 0]
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
    emit({"phase": "main_path", "n_videos": N_VIDEOS, "n_logs": args.n_logs,
          "log_capacity": log.capacity, "delta_rows": N_DELTA, "m": M, "k": K,
          "queries": len(queries), "setup_s": setup_s, "wall_s": times,
          "peak_device_gb": peak_gb, "launches": launches,
          "fused_vs_unfused": fused_vs_unfused, "stale_eq_exact_fresh_after_ivm": True,
          "svc_rel_err_vs_fresh": errs, "card": smi})

    table = check_kernels(state, queries, M, SEED, launches, ITERS)
    for entry in table:
        emit({"phase": "kernel", **entry, "card": smi})

    small = device_vs_cpu(SMALL_VIDEOS, SMALL_LOGS, SMALL_DELTA, M, K, SEED)
    emit({"phase": "device_vs_cpu", "n_logs": SMALL_LOGS, **small})

    emit({"kernels": table})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
