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
     flash_attention kernel;
  5. the other model families, every attention on the same kernel:
     ``moe_serve`` — granite-moe-3b-a800m at its published size in bf16,
     8 requests through ``ServeEngine`` with telemetry as in 4, its
     per-expert load, a profiled warm decode call, and layer 0's MoE FFN
     on the card against the CPU; ``vlm_prefill`` — qwen2-vl-72b at its
     published widths, depth cut 80 -> 8 layers, a vision stub and 256
     text tokens: forward, prefill and decode held to one another;
     ``encdec_generate`` — seamless-m4t-large-v2 at its published size,
     1,024 stub frames a source: prefill and greedy decode held to the
     teacher-forced forward; and each family's smoke config served on the
     card against the CPU;
  6. the recurrent families at their published sizes in bf16:
     ``hybrid_serve`` — recurrentgemma-9b, 4 requests through
     ``ServeEngine`` with telemetry, every attention on the flash kernel's
     ring-buffer mask (``key_pos``); ``hybrid_forward`` — its forward over
     4,096 tokens (the banded window mask at full width) and its first 64
     positions decoded against it; ``ssm_serve`` — xlstm-1.3b through
     ``ServeEngine`` (no attention: the mLSTM's matrix memory and the
     sLSTM, whose every decode step is one per-step slstm_fwd launch and
     whose forward one resident launch a layer) and its forward over
     2 × 512; flash ``kernel`` lines for the
     ring decode and the banded prefill; and each smoke config served on
     the card against the CPU;
  7. training (``launch/train.py``'s ``build``): ``train_path`` —
     gemma-2b at its published size with float32 masters, gradients and
     AdamW states on the card, 6 steps of (8, 512) pipeline batches under
     remat "full" (every layer's attention launches the flash kernel
     forward and again in the recompute; its gradient launches the
     backward kernel, ``flash_attention_bwd``, once a layer), the loss view
     ingesting every step (refreshed every 2, the mixture re-weighted at
     step 4, then a full maintenance whose exact answers the SVC estimates
     are reported against), one step under the kernel profiler and one
     under ``torch.profiler``; every step's loss through the cross-entropy
     kernels (``cross_entropy_fwd`` once a microbatch, ``cross_entropy_bwd``
     once in its backward, counted exactly); the flash ``kernel`` lines at
     the training shape, forward and backward, each beside SDPA's, and the
     two cross-entropy lines at its 4,096 × 256,000 bf16 logits, each beside
     ``F.cross_entropy``'s; ``train_device_vs_cpu`` — the
     smoke configs of gemma-2b, grok-1-314b and the hybrid, ssm and encdec
     archs trained 3 steps on the card and on the CPU; ``train_restart`` —
     ``launch/train.main`` with checkpoints and a host lost at step 6,
     restored bit for bit from step 4;
  8. training the other families through ``make_train_step`` in bf16 with
     float32 masters and remat "full" (``train_family``): xlstm-1.3b (48
     layers, no attention: the mLSTM's chunked parallel form and the
     sLSTM's loop over time, one resident slstm_fwd launch a layer forward
     and again in the recompute, one slstm_bwd launch a layer backward
     (launches a call from the route rule), counted exactly; the two sLSTM
     ``kernel`` lines at its shape, one layer, each beside the per-step
     route's time and held bit for bit against it; its
     first step held against the plain loop within the spread of two
     rounding-sized controls, and its loss-falls check made on one
     super-block, where rounding does not decide it) and
     seamless-m4t-large-v2 (12 +
     12 layers, a frames stub) at their published sizes on (8, 512)
     batches, recurrentgemma-9b at its published widths and 8 of its 38
     layers on one 4,096-token sequence (the 2,048 window binds); each a
     warm-up and 3 timed steps with the loss view ingesting, one step under
     each profiler, and flash ``kernel`` lines, forward and backward, at the
     banded, encoder and cross shapes, each beside SDPA's; the cross-entropy
     kernels once each a step on every family, and their two lines at
     seamless's 4,096 × 256,206 (rows off the 16-byte grid);
  9. the dry run (``launch/dryrun.py``, ``dryrun``): every arch's
     ``train_4k`` and ``decode_32k`` cells, and ``long_500k`` for the two
     sub-quadratic archs, traced on the meta device over the 16×16
     production mesh (no kernel launches: the launch counters stay at 0);
     then its witnesses on the card: the 1×1-mesh trace of
     ``train_path``'s own step (gemma-2b, (8, 512), remat "full") against
     that phase's state as allocated (within 1%), its peak memory and its
     warm step's wall, and the decode cell's cache against
     ``serve_path``'s allocated KV cache (exactly).

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
  * ``sharded_fleet`` (after ``chaos_fleet``, §7.5): the fleet's 16 views
    over ``ShardedFleet(n_shards=4)`` on the card, from the chaos phase's
    host logs, against a flat ``MaintenancePlanner`` twin: a plan preview
    bit-identical to the flat plan, three executed epochs whose actions,
    samples and answers equal the flat twin's, shard 1 lost in epoch 2
    (its views serve their last answer, degraded; its partitions queue)
    and revived in epoch 3 (the drain epoch: nothing pending after it); the
    trace and the per-shard kernel ledger reconcile.  Then visitView's
    streaming delta in four ``PartitionedDeltaLog`` partitions through
    ``stack_shard_deltas`` and both sharded group-bys, held to one flat
    fused clean and to the float64 sums; a ``kernel`` line for
    ``fleet_score_sharded`` (the fleet_score kernel over the (S, Vmax, F)
    stack, bit-equal to the plain score shard by shard).
  * ``multi_card`` (after ``sharded_fleet``): the same three paths with
    shard s on the mesh's s-th device, first over ``LocalMesh([cuda:0] *
    4)`` (the per-device branch, one fleet_score launch per shard on its
    device), then, where more than one card is visible, over ``cuda:0 …
    cuda:S−1`` (S = min(4, cards)), each held to the flat twin and the
    score combine bit-equal to the stacked launch; every wrapper once on
    the last card against its plain version.  The line names the cards
    seen, the device of each shard's tensors, each card's peak memory and
    the epoch walls, and says when only one card was visible.
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
import contextlib
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
# sharded_fleet (§7.5): the fleet scenario's 16 views (no deletes, no
# outlier index) over ShardedFleet(n_shards=4) on cuda:0 and over a flat
# ViewManager + MaintenancePlanner, both from the chaos phase's host logs,
# with the fleet path's prices pinned, one EpochClock, no starvation guard
# and a budget that fits every view's dearer action (so each epoch acts on
# every view that scores, whatever the knapsack's order); a plan preview,
# then 3 executed epochs of 500k new sessions per view: shard 1 is killed
# before epoch 2 and revived before epoch 3, the drain epoch.  Then the
# visitView streaming delta (10M sessions, seed 1) in four partitions
# through both sharded group-bys against one flat fused clean.
SHARDS = 4
SHARDED_EPOCHS = 3
SHARDED_LOST = 1
SHARDED_AGE_CAP_S = 1e9
SHARDED_DELTA_SEED = 30_000
# multi_card: every wrapper on the last card against its plain version, float
# outputs within this share of their largest magnitude (f32 sums in another
# order; the attention's 1e-4 as in tests/test_torch_cuda.py)
MULTI_CARD_TOL = 1e-5

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
# the backward kernel against the plain backward: relative L2 of each of dq,
# dk and dv
FLASH_BWD_TOL = {"torch.bfloat16": 1e-2, "torch.float32": 1e-5}
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

# The other model families on the flash kernel.  granite-moe-3b-a800m at
# its published size in bf16 through ServeEngine: 8 requests of 16–64
# prompt tokens (numpy seed 0) and 16 new tokens each on 8 slots, telemetry
# as on the serve path; layer 0's FFN is also held to the CPU on a forward
# over 8 × 64 prompt tokens.
MOE_ARCH = "granite-moe-3b-a800m"
MOE_MAX_BATCH, MOE_MAX_SEQ = 8, 512
MOE_REQUESTS, MOE_MAX_NEW = 8, 16
MOE_PROMPT_LENS = (16, 64)
MOE_FORWARD_SHAPE = (8, 64)
# the card's bf16 FFN against the CPU's float32 on the same token states:
# six roundings to bf16 (g, u, h, an expert's output, its gate product, y),
# each at 2^-8 relative
MOE_FFN_TOL = 2.0 ** -5
# qwen2-vl-72b at its published widths with its depth cut 80 -> 8 layers
# (all 80 take 143 GB in bf16, more than the card's 80 GB): B = 2, the
# 256-token vision stub (seed 1 on the card) and 256 text tokens; forward
# over all 512, prefill over the first 448, then 64 decode steps
VLM_ARCH = "qwen2-vl-72b"
VLM_LAYERS = 8
VLM_BATCH, VLM_TEXT, VLM_PREFILL = 2, 256, 448
# seamless-m4t-large-v2 at its published size in bf16: 4 sources of 1,024
# stub frames, an 8-token target prefix, 32 greedy new tokens
ENCDEC_ARCH = "seamless-m4t-large-v2"
ENCDEC_BATCH, ENCDEC_SRC, ENCDEC_PREFIX, ENCDEC_NEW = 4, 1024, 8, 32
# the smoke configs served on the card and on the CPU
SMOKE_PROMPT_LENS = (3, 9, 5, 12, 4, 7)
# The recurrent families at their published sizes in bf16, not cut:
# recurrentgemma-9b (hybrid; 38 layers, d_model 4,096, 16 query heads and 1
# KV head of 256, window 2,048, vocabulary 256,000) and xlstm-1.3b (ssm; 48
# layers, d_model 2,048, 4 mLSTM heads of 1,024), each through ServeEngine
# with telemetry as on the serve path: 4 requests of 16–48 prompt tokens
# (numpy seed 0) and 16 new tokens each on 4 slots.
HYBRID_ARCH, SSM_ARCH = "recurrentgemma-9b", "xlstm-1.3b"
RECURRENT_MAX_BATCH, RECURRENT_MAX_SEQ = 4, 128
RECURRENT_REQUESTS, RECURRENT_MAX_NEW = 4, 16
RECURRENT_PROMPT_LENS = (16, 48)
# the hybrid's forward over 1 × 4,096 tokens (past its window, so every
# attention layer runs the banded mask), its first 64 positions decoded and
# held to it at JAX's dense decode-vs-forward tolerance
HYBRID_FORWARD_LEN, HYBRID_DECODE_LEN = 4096, 64
HYBRID_DECODE_TOL = 2e-2
# the ssm's forward over 2 × 512 (two mLSTM chunks, the sLSTM loop) and its
# first 16 positions decoded.  At 48 layers the two paths' roundings diverge
# (in JAX too: tests/torch_xlstm_depth.py), so the served model's pair, and
# the same weights' pair in f32, are reported; the pair is held at JAX's
# xlstm tolerance on the served weights' first super-block (7 mLSTM and 1
# sLSTM layers at full width) in f32 (the mLSTM decode's stabilizer starts
# at m = 0, the parallel form's at the row max)
SSM_FORWARD_SHAPE, SSM_DECODE_LEN = (2, 512), 16
SSM_DECODE_TOL = 5e-2
# the served weights' first mLSTM and sLSTM layers in bf16, over 64 of the
# forward's tokens and one decode step from an empty state, on the card
# against the same layers on the CPU (the plain torch whose bf16 casts
# tests/test_torch_xlstm.py holds to JAX's), both under the entry points'
# f32_accumulation: max |card − CPU| within 2^-6 of max |CPU| (the two sum
# the products in other orders, which moves a bf16 projection by a step of
# 2^-8 here and there, and the mLSTM's normalizer divides by a sum that
# cancels)
SSM_LAYER_LEN, SSM_LAYER_TOL = 64, 2.0 ** -6
# the ring decode at full width: 4 rows at position 4,096 against 2,048
# slots that hold positions 2,049–4,096 (wrapped), 64 of them emptied
RING_SHAPE, RING_POS, RING_HOLES = (4, 1, 2048, 16, 1, 256), 4096, 64
# the smoke configs on the card and on the CPU: prompts past the hybrid
# smoke's window of 16, so its ring wraps
RECURRENT_SMOKE_PROMPT_LENS = (3, 40, 9, 25, 17, 33)

# Training (the port's launch/train.py): gemma-2b at its published size
# (18 layers, d_model 2,048, 8 query heads and 1 KV head of 256, GeGLU d_ff
# 16,384, vocabulary 256,000) with float32 masters, gradients and AdamW
# states on the card (4 × 10.02 GB), the pipeline's (8, 512) batches from
# seed 0, 6 steps of build()'s AdamWConfig(lr 3e-4, total 6, warmup 5);
# the loss view ingests every step, refreshes every 2, re-weights the
# mixture at step 4, then a full maintenance; two more steps are profiled
# (the kernel profiler, then torch.profiler)
TRAIN_ARCH = "gemma-2b"
TRAIN_ARGV = ("--steps", "6", "--batch", "8", "--seq", "512", "--svc-every", "2",
              "--mixture-every", "4", "--svc-ratio", "0.25")
TRAIN_SVC_EVERY, TRAIN_MIXTURE_AT = 2, 4
# the smoke configs (f32, TF32 off) trained 3 steps on the card and on the
# CPU from one seed: loss and grad norm within 1e-5 relative; step 1's
# gradients within 1e-4 of each leaf's largest |gradient| (the same f32
# sums in other orders); all the parameters after each step within 2e-2 of
# the step's update norm, taken over every leaf at once.  AdamW's first
# steps are nearly sign updates (lr·m̂/√v̂ ≈ ±lr), so an element whose
# gradient is within the sums' rounding of 0 may move by ±lr in either
# run: one such flip is 2/√n of the update's norm over n elements (0.57% at
# gemma-2b-smoke's 123,200), and 25% of a 64-element norm leaf, so leaf
# by leaf is reported, not held (a leaf lay 1.2% apart at step 3 on the
# card)
TRAIN_SMOKE_ARCHS = ("gemma-2b", "grok-1-314b", "recurrentgemma-9b", "xlstm-1.3b",
                     "seamless-m4t-large-v2")
TRAIN_SMOKE_BATCH, TRAIN_SMOKE_SEQ, TRAIN_SMOKE_STEPS = 4, 32, 3
TRAIN_LOSS_RTOL, TRAIN_GRAD_TOL, TRAIN_PARAM_TOL = 1e-5, 1e-4, 2e-2
# the ulp control: the CPU's run again from masters each moved by this much
# relative (one float32 ulp's order, what a sum in another order moves),
# reported beside each card/CPU pair.  Where that control alone moves a
# reading past its limit, the limit cannot tell a sound card from an
# unsound one: those (arch, step, quantity) cases, and only those, are held
# at TRAIN_SMOKE_WIDE's limits, 3x the control's reading on the H100's host
# (xlstm-smoke's grad norm at steps 2 and 3: the control 7.1e-4 and 9.8e-4,
# the card 1.0e-5 and 1.2e-4; its parameters after step 3: the control
# 0.0691 of the update's norm, the card 0.0091).  Every other case is held
# at the limits above
ULP_CONTROL = 1e-7
TRAIN_SMOKE_WIDE = {("xlstm-1.3b", 2, "grad_norm"): 3e-3, ("xlstm-1.3b", 3, "grad_norm"): 3e-3,
                    ("xlstm-1.3b", 3, "params"): 0.2}
# launch/train.main on gemma-2b's smoke config with a checkpoint every 4
# steps and a host lost at step 6
TRAIN_RESTART_ARGV = ("--arch", "gemma-2b", "--smoke", "--steps", "12", "--ckpt-every", "4",
                      "--fail-at", "6", "--svc-every", "2", "--mixture-every", "4",
                      "--log-every", "100")
TRAIN_RESTORED_STEP = 4
# the dry run's sweep (single mesh): these shapes for every arch, and
# long_500k for the sub-quadratic ones
DRYRUN_SHAPES = ("train_4k", "decode_32k")
DRYRUN_STATE_RTOL = 0.01
# the hybrid, ssm and encdec families trained on the card, bf16 compute,
# float32 masters and AdamW states, the configs' remat="full", weights
# drawn on the card from seed 0, the pipeline's batches from seed 0 with
# the loss view ingesting every step and refreshing every
# TRAIN_SVC_EVERY: (arch, layers or None for the published depth, batch,
# sequence).  xlstm-1.3b (48 layers) and seamless-m4t-large-v2 (12 + 12)
# at their published sizes; recurrentgemma-9b at its published widths with
# its depth cut 38 -> 8 (2 super-blocks and 2 trailing rec layers): its 38
# layers hold 150.3 GB of float32 state, the card 80 GB.  S 4,096 makes
# the 2,048 window bind in the banded attention.  The encdec batch adds a
# (B, S, d_model) float32 frames stub drawn on the card from seed 1.
TRAIN_FAMILY_RUNS = (("xlstm-1.3b", None, 8, 512), ("seamless-m4t-large-v2", None, 8, 512),
                     ("recurrentgemma-9b", 8, 1, 4096))
TRAIN_FAMILY_STEPS = 3  # timed, after one warm-up; then one under each profiler
TRAIN_FAMILY_OPT = dict(lr=3e-4, warmup_steps=1, total_steps=6)
FRAMES_SEED = 1
# AdamW's kernel line (train_path's live gemma-2b state): the scalars of the
# kernel's norm against the plain version's within ADAMW_RTOL relative; the
# update of the leaves named ADAMW_HELD_LEAVES (layer 0's nine and the final
# norm, on copies) from the same scalars, and ADAMW_ODD_TREE's leaves (odd
# sizes, ranks 1 and 2, the third at an offset of one element) over
# ADAMW_ODD_STEPS steps, every element within 2 ulp of the plain version's
# or ADAMW_RTOL of its leaf's largest magnitude; the plain version timed
# over ADAMW_PLAIN_ITERS calls (~0.12 s each at gemma-2b's size)
ADAMW_RTOL = 1e-6
ADAMW_HELD_LEAVES = ("layers.0.", "final_norm")
ADAMW_ODD_TREE = ((1,), (7,), (4099,), (1025, 3))
ADAMW_ODD_OFFSET = 2
ADAMW_ODD_STEPS = 3
ADAMW_PLAIN_ITERS = 3
ADAMW_OPS_PER_ELEMENT = 19  # float32 update 17 (a fused multiply-add as 2), the norm's 2
# the cross-entropy's kernel lines: gemma-2b's train shape (8 × 512 rows of
# its 256,000 vocabulary, bf16) and seamless-m4t-large-v2's (256,206, whose
# bf16 rows start 4 bytes past a 16-byte boundary), seeded logits and labels
# in range; the forward's lse and nll against the plain version's within
# CE_TOL of their largest magnitude (float32 sums of the row's exps in
# another order), the backward from the kernel's lse within one bf16 ulp of
# the plain backward's; the held copy of the labels also wraps (−1, −V) and
# leaves the range (V), whose NaN must match.  The plain version timed over
# CE_PLAIN_ITERS calls (~12 ms forward, ~17 ms backward each); the library
# call is F.cross_entropy(logits.float(), labels, reduction="none"), its
# forward and its backward (the nll alone: it returns no lse)
CE_TOL = 1e-5
CE_PLAIN_ITERS = 5
CE_SEED = 11
CE_OPS_PER_ELEMENT = 4  # forward: max, subtract, exp, add; backward: subtract, exp, two products
# the sLSTM's kernel lines (train_family's xlstm shape, one layer): the
# kernels against the plain version on the same card within SLSTM_TOL of
# each output's largest magnitude (measured on an H100: at most 3.4e-7);
# the plain version timed over SLSTM_PLAIN_ITERS calls (~0.2 s forward and
# ~0.5 s backward each)
SLSTM_TOL = 5e-6
SLSTM_PLAIN_ITERS = 2
# calls timed with every launch queued before the card reaches it (prequeued_ms)
SLSTM_QUEUED_ITERS = 5
SLSTM_SEED = 7
# train_family's xlstm: each sLSTM layer's kernels (hs, dwx, dR) on the
# inputs its warm-up step gave them, against autograd of the plain loop on
# the card, within SLSTM_PATH_TOL of each output's largest magnitude
# (measured on an H100: at most 3.4e-6, dR of layer 0)
SLSTM_PATH_TOL = 2e-5
# train_family's xlstm at full depth: the first step's loss and grad norm
# through the kernels against the plain loop's, within XLSTM_STEP_SPREAD
# times the spread of the plain loop and its two controls (its outputs
# scaled by 1 ± XLSTM_CONTROL, a rounding-sized change)
XLSTM_CONTROL = 1e-7
XLSTM_STEP_SPREAD = 4

# the kernels each path must launch
SVC_LOOP_KERNELS = ("hash_threshold", "fused_clean", "outlier_member", "outlier_digest",
                    "multi_agg_two", "multi_agg_one", "segment_aggsum")
FLEET_KERNELS = ("fused_clean_fleet", "fleet_merge", "fleet_moments", "fleet_score")
STREAM_KERNELS = ("fused_clean", "multi_agg_two", "multi_agg_one")
API_KERNELS = ("segment_aggsum", "segment_aggsum_unsorted", "corr_diff")
# every layer's attention, and the telemetry view's cleans and dashboard
SHARDED_KERNELS = ("fleet_score_sharded", "fleet_moments", "fused_clean_fleet", "fleet_merge",
                   "fused_clean", "hash_threshold", "segment_aggsum_unsorted")
SERVE_KERNELS = ("flash_attention", "hash_threshold", "fused_clean", "multi_agg_two",
                 "multi_agg_one")
FAMILY_KERNELS = ("flash_attention",)  # vlm_prefill and encdec_generate: every attention
# xlstm has no attention: the telemetry's kernels and the sLSTM's forward
SSM_KERNELS = SERVE_KERNELS[1:] + ("slstm_fwd",)
# every attention of the train step; the loss view's unfused clean, group-bys
# and queries; AdamW's norm and update; the loss's cross-entropy
TRAIN_KERNELS = ("flash_attention", "flash_attention_bwd", "hash_threshold", "segment_aggsum",
                 "multi_agg_two", "multi_agg_one", "adamw_norm", "adamw_update",
                 "cross_entropy_fwd", "cross_entropy_bwd")
ADAMW_KERNELS = ("adamw_norm", "adamw_update")
CE_KERNELS = ("cross_entropy_fwd", "cross_entropy_bwd")
SLSTM_KERNELS = ("slstm_fwd", "slstm_bwd")
# xlstm has no attention: the loss view's kernels, AdamW's, the
# cross-entropy's and the sLSTM's
TRAIN_SSM_KERNELS = TRAIN_KERNELS[2:] + SLSTM_KERNELS
# multi_agg_moments' arguments by name: the one-sided call's six, then the
# two-sided call's other four
MULTI_AGG_ARGS = ("x_new", "valid_new", "w_new", "ompi_new", "sel", "meta", "x_old", "valid_old",
                  "w_old", "ompi_old")



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


def prequeued_ms(fn, iters: int, hold_cycles: int = 100_000_000) -> float:
    """Median device milliseconds of one call of ``fn`` whose launches were
    all queued before the card reached them: a spin kernel
    (``torch.cuda._sleep``, ~50 ms at the card's clock) holds the stream
    while the host enqueues the call, which its own event pair then times.
    What the card takes, apart from the host's launch rate."""
    import torch

    fn()
    runs = []
    for _ in range(iters):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(hold_cycles)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end))
    return float(np.median(runs))


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
        # rows with device time and no host time: the kernels, memcpys and
        # memsets themselves (an operator's row repeats its kernels' time)
        "device_only_ms": sum(r["self_device_ms"] for r in rows if r["self_cpu_ms"] == 0),
        "matching": [r for r in rows if any(m in r["op"] for m in match)],
    }


def profile_raw(fn, top: int = 8) -> dict:
    """One call of ``fn`` under ``torch.profiler``, read from the profiler's
    raw events, not its per-operator table (which takes minutes to build
    for a step of ~400k launches): device milliseconds and count of the
    kernels, copies and memsets, the ``top`` kernels by device time, and
    the calls of the CUDA runtime entries that launch kernels, copy or
    wait."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    runtime = ("cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx", "cudaMemcpyAsync",
               "cudaStreamSynchronize", "cudaDeviceSynchronize")
    dev_ns, calls = collections.Counter(), collections.Counter()
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            dev_ns[e.name()] += e.duration_ns()
            calls[e.name()] += 1
        elif e.name() in runtime:
            calls[e.name()] += 1
    device = [k for k in dev_ns]
    return {"device_only_ms": sum(dev_ns.values()) / 1e6,
            "device_launches": sum(calls[k] for k in device),
            "runtime_calls": {k: calls[k] for k in runtime if calls[k]},
            "top_device": [{"op": k, "calls": calls[k], "device_ms": dev_ns[k] / 1e6}
                           for k in sorted(device, key=lambda k: -dev_ns[k])[:top]]}


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


def hold_moments(got, want, what):
    """multi_agg's (12, Q) moments against the plain version's: the count
    rows equal, every moment within 1e-5 of |plain| (S_D's of
    |S_NEW| + |S_OLD|, which bound Σ|d|).  Returns (max abs error, max
    relative error)."""
    import torch

    from repro_torch.kernels.multi_agg.ref import K_D, K_NEW, K_OLD, S_D, S_NEW, S_OLD

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
    from repro_torch.kernels.multi_agg.ref import multi_agg_ref
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

    def same_bits(call, got, what):
        if not torch.equal(call(), got):
            fail(f"{what}: a repeated call gave other bits")
        if not torch.equal(call(decode=True), got):
            fail(f"{what}: the call without sel_idx gave other bits")

    def two(decode=False):
        return multi_agg_two(*new, batch.sel, batch.meta, *old,
                             sel_idx=None if decode else sel_idx)

    got = two()
    err2, rel2 = hold_moments(got, multi_agg_ref(*new, batch.sel, batch.meta, *old),
                              "multi_agg_two")
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
    err1, rel1 = hold_moments(got, multi_agg_ref(*view, batch.sel, batch.meta), "multi_agg_one")
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
    # walls on one kind of view, as fig_planner_fleet prices a plain view's
    # clean and maintain: a clean at the median warm per-view clean of the
    # plain views (no deletes, no outlier index: an odd count, so the median
    # is one view's wall and never the mean of a plain and a with_deletes
    # view's), a maintain at one plain view's measured IVM, a retune at one
    # retune-then-clean through the batched path (held against a per-view
    # clean of the retuned view), and fig_planner_fleet's budget of one
    # maintain plus 2.5 cleans
    plain_views = names[1:n_views // 2]
    clean_s = float(np.median([warm_view_s[n] for n in plain_views]))
    maintain_s = vm.maintain(plain_views[-1])
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
              "clean_of": plain_views, "maintain_of": plain_views[-1],
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
               "per_view_s": per_view_s, "warm_view_s": warm_view_s,
               "svc_refresh_many_view_s": dts, "prices": prices}, \
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
    """Stands in for the models' ``flash_attention`` (the transformer's, the
    encoder-decoder's and the hybrid's) while a path runs: it calls the
    wrapper (which counts its launch) and keeps a copy, with the same
    strides, of the inputs of the first call that each of ``wants`` (label
    -> predicate on ``(q, k, causal, qpos)``) accepts, and in ``masks`` that
    call's window, key_pos (copied) and qpos.  ``t_min`` wants, as
    ``"decode"``, the first decode call whose cache slice reaches ``t_min``
    keys (layer 0 of that step); ``inputs`` is that capture."""

    def __init__(self, t_min=None, wants=None):
        from repro_torch.models import encdec, rglru, transformer

        self.mods, self.real = (transformer, encdec, rglru), transformer.flash_attention
        self.wants = dict(wants or {})
        if t_min is not None:
            self.wants["decode"] = lambda q, k, causal, qpos: not causal and k.shape[1] >= t_min
        self.captured, self.causal, self.masks = {}, {}, {}

    @property
    def inputs(self):
        return self.captured.get("decode")

    def __call__(self, q, k, v, causal=True, window=0, key_pos=None, qpos=0):
        import torch

        out = self.real(q, k, v, causal, window, key_pos, qpos)
        for label, want in self.wants.items():
            if label not in self.captured and want(q, k, causal, qpos):
                self.causal[label] = causal
                self.masks[label] = dict(window=window, qpos=qpos, key_pos=(
                    None if key_pos is None else key_pos.clone()))
                self.captured[label] = tuple(
                    torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                                        device=t.device).copy_(t.detach()) for t in (q, k, v))
        return out

    def __enter__(self):
        for mod in self.mods:
            mod.flash_attention = self
        return self

    def __exit__(self, *exc):
        for mod in self.mods:
            mod.flash_attention = self.real


class MoeCapture:
    """Stands in for the transformer's ``moe_ffn_local`` while a path runs:
    sums every call's per-expert load on the device (no host read) and
    keeps a copy of the first call's token states and capacity (layer 0
    of the path's first call)."""

    def __init__(self):
        from repro_torch.models import transformer

        self.mod, self.real = transformer, transformer.moe_ffn_local
        self.load, self.calls, self.first = None, 0, None

    def __call__(self, x, router, w_gate, w_up, w_down, cfg, capacity):
        y, load = self.real(x, router, w_gate, w_up, w_down, cfg, capacity)
        self.calls += 1
        self.load = load if self.load is None else self.load + load
        if self.first is None:
            self.first = (x.clone(), capacity)
        return y, load

    def __enter__(self):
        self.mod.moe_ffn_local = self
        return self

    def __exit__(self, *exc):
        self.mod.moe_ffn_local = self.real


def _copied(x):
    """``x`` with every tensor in it (also inside lists and tuples) copied."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, (list, tuple)):
        return type(x)(_copied(y) for y in x)
    return x


class CallCapture:
    """Stands in for ``module.name`` while a path runs: calls it and keeps,
    for every call, a copy of its arguments by parameter name (defaults
    filled in) and of what it returned, so the kernel it reaches can be
    held against its plain version on the path's own inputs afterwards.
    The copies launch no kernel."""

    def __init__(self, module, name: str):
        import inspect

        self.mod, self.name, self.real = module, name, getattr(module, name)
        self.sig = inspect.signature(self.real)
        self.calls = []

    def __call__(self, *args, **kw):
        bound = self.sig.bind(*args, **kw)
        bound.apply_defaults()
        out = self.real(*args, **kw)
        self.calls.append((_copied(dict(bound.arguments)), _copied(out)))
        return out

    def __enter__(self):
        setattr(self.mod, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.real)


@contextlib.contextmanager
def slstm_scan_as(scan):
    """``kernels.slstm.ops.SLSTMScan``, which ``SLSTMBlock.full`` applies on
    the card when a gradient is wanted, replaced by ``scan`` in this block."""
    from repro_torch.kernels.slstm import ops

    real = ops.SLSTMScan
    ops.SLSTMScan = scan
    try:
        yield
    finally:
        ops.SLSTMScan = real


class SLSTMCapture:
    """While a train step runs (``with slstm_scan_as(capture.scan())``):
    every sLSTM backward's inputs, (wx, a copy of R, the gradient reaching
    hs), layer by layer (R is updated in place by the optimizer after the
    step; wx and the gradient are not).  Its scan is ``SLSTMScan`` keeping
    each forward's wx on its autograd context (the remat recompute's, which
    the backward reads); it launches nothing of its own."""

    def __init__(self):
        self.calls = []

    def scan(self):
        from repro_torch.kernels.slstm import SLSTMScan

        calls = self.calls

        class Captured(SLSTMScan):
            @staticmethod
            def forward(ctx, wx, R):
                ctx.inputs = wx.detach(), R.detach()  # with a graph: the first pass's activations
                return SLSTMScan.forward(ctx, wx, R)

            @staticmethod
            def backward(ctx, dhs):
                wx, R = ctx.inputs
                calls.append((wx, R.clone(), dhs.contiguous()))
                return SLSTMScan.backward(ctx, dhs)

        return Captured


class PlainScan:
    """Stands in for ``SLSTMScan`` (``slstm_scan_as``): the plain loop under
    autograd on the card, the model's loop before the kernels, its hs
    scaled by ``scale`` (1 ± XLSTM_CONTROL: a rounding-sized control)."""

    def __init__(self, scale: float = 1.0):
        self.scale = scale

    def apply(self, wx, R):
        from repro_torch.kernels.slstm import slstm_scan_ref

        hs = slstm_scan_ref(wx, R)[0]
        return hs if self.scale == 1.0 else hs * self.scale


def hold_slstm_layers(calls, what: str) -> list:
    """The sLSTM kernels on each captured layer's inputs (``slstm_fwd`` with
    save, then ``slstm_bwd``) against autograd of the plain loop on the
    same tensors: hs, dwx and dR each within SLSTM_PATH_TOL of the plain
    output's largest magnitude.  Not counted as launches."""
    import torch

    from repro_torch.kernels.slstm import slstm_bwd, slstm_fwd, slstm_scan_ref

    held = []
    with uncounted():
        for layer, (wx, R, dhs) in enumerate(calls):
            hs, _last, saved = slstm_fwd(wx, R, save=True)
            dwx, dR = slstm_bwd(dhs, R, hs, saved)
            w, r = wx.detach().requires_grad_(), R.detach().requires_grad_()
            with torch.enable_grad():
                phs = slstm_scan_ref(w, r)[0]
                pwx, pR = torch.autograd.grad(phs, (w, r), dhs)
            errs = {}
            for name, a, b in (("hs", hs, phs.detach()), ("dwx", dwx, pwx), ("dR", dR, pR)):
                scale = float(b.abs().max())
                errs[name] = float((a - b).abs().max()) / scale if scale else 0.0
            if not max(errs.values()) <= SLSTM_PATH_TOL:
                fail(f"{what}: sLSTM layer {layer}'s kernels on the path's inputs {errs} against "
                     f"autograd of the plain loop (limit {SLSTM_PATH_TOL} of the largest "
                     "magnitude)")
            held.append(errs)
    return held


def attention_layers(params) -> int:
    """The attention blocks of a model's parameters: every transformer
    block (dense, moe, vlm) and the hybrid's attention blocks."""
    from repro_torch.models import rglru, transformer

    return sum(isinstance(m, (transformer.Block, rglru.AttnBlock)) for m in params.modules())


def run_serve_path(cfg, max_batch, max_seq, prompts, max_new, tick_capacity, stream_kw, seed,
                   device="cuda", capture=None, flash_wants=None):
    """``cfg`` (gemma-2b at full width in bf16) with weights drawn on the
    card from a ``torch.Generator(seed)``; the engine serves ``prompts``
    with its telemetry streamed into serveView, then answers
    ``dashboard()``.  The launch counters are set to 0 just before and read
    just after.  Every decode call launches flash once in each of the
    model's attention blocks.  Returns (report, model, params, the
    FlashCapture, launches): its ``wants`` are ``flash_wants``, else the
    decode call that reached the longest prompt (``.inputs``), and each
    must have been met."""
    import torch
    from torch.utils._pytree import tree_leaves

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
    flash = (FlashCapture(max(len(p) for p in prompts)) if flash_wants is None
             else FlashCapture(wants=flash_wants))
    attn_layers = attention_layers(params)
    with flash as cap, capture or contextlib.nullcontext():
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
    before_cache = torch.cuda.memory_allocated()
    cache = model.init_cache(max_batch, max_seq)
    kv_cache = {"allocated_bytes": torch.cuda.memory_allocated() - before_cache,
                "engine_tensor_bytes": sum(t.untyped_storage().nbytes()
                                           for t in tree_leaves(engine.cache)
                                           if isinstance(t, torch.Tensor))}
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
    if launches["flash_attention"] < attn_layers * probe.calls:
        fail(f"serve_path: flash_attention launched {launches['flash_attention']} times, fewer "
             f"than {attn_layers} attention layers x {probe.calls} decode calls")
    missing = [label for label in cap.wants if label not in cap.captured]
    if missing:
        fail(f"serve_path: no flash call at the {missing} shapes")
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
        "attention_layers": attn_layers,
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
        "kv_cache": kv_cache,
    }
    return report, model, params, cap, launches


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


def flash_entry(label, q, k, v, causal, launches, iters, mask=None, **extra):
    """The kernel against its plain version on (q, k, v) and timed beside
    it and beside scaled_dot_product_attention (the yardstick: the port
    never calls it; under a window or key_pos it takes the kernel's mask as
    an explicit boolean one); launches here are not counted.  ``mask``:
    the call's window, key_pos and qpos."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref
    from repro_torch.kernels.flash_attention.ops import plan
    from repro_torch.kernels.flash_attention.ref import keep_mask

    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    mask = {name: val for name, val in (mask or {}).items()
            if val is not None and not (isinstance(val, int) and val == 0)}
    pl = plan(q.dtype, B, S, T, H, K, hd, causal, mask.get("window", 0), "key_pos" in mask,
              mask.get("qpos", 0))
    with uncounted():
        got = flash_attention(q, k, v, causal, **mask)
        want = flash_attention_ref(q, k, v, causal, **mask)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        scale = float(want.float().abs().max())
        tol = FLASH_TOL[str(q.dtype)]
        if not torch.allclose(got.float(), want.float(), rtol=tol, atol=tol):
            fail(f"flash_attention {label}: max abs diff {err} from the plain version beyond {tol}")
        if err > FLASH_SCALED_TOL * scale:
            fail(f"flash_attention {label}: max abs diff {err} beyond {FLASH_SCALED_TOL} of "
                 f"max |plain| {scale}")
        ms = cuda_ms(lambda: flash_attention(q, k, v, causal, **mask), iters)
    plain_ms = cuda_ms(lambda: flash_attention_ref(q, k, v, causal, **mask), iters)
    keep = keep_mask(S, T, device=q.device, **mask) if mask else None

    def sdpa():
        if keep is None:
            return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                                  v.transpose(1, 2), is_causal=causal,
                                                  enable_gqa=H != K)
        return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                              v.transpose(1, 2), attn_mask=keep,
                                              enable_gqa=H != K)

    lib_err = float((sdpa().transpose(1, 2).float() - want.float()).abs().max())
    library_ms = cuda_ms(sdpa, iters)
    m = min(S, T)
    pairs = m * (m + 1) // 2 + (S - m) * T if causal else S * T  # kept (query, key) pairs
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    if keep is not None:  # this run's mask: its kept pairs, and K/V of the keys some row keeps
        pairs, kept_keys = int(keep.sum()), int(keep.any(0).sum())
        nbytes = ((2 * q.numel() + (k.numel() + v.numel()) // T * kept_keys) * q.element_size()
                  + (4 * T if "key_pos" in mask else 0))
        with uncounted():  # what the mask costs: the same inputs with every key kept
            no_mask_ms = cuda_ms(lambda: flash_attention(q, k, v, False), iters)
        extra = dict(extra, window=mask.get("window", 0), qpos=mask.get("qpos", 0),
                     no_mask_ms=no_mask_ms,
                     key_positions="ring slots" if "key_pos" in mask else "index",
                     kept_pairs=pairs, kept_share=pairs / (S * T), kept_keys=kept_keys,
                     library_call_mask="attn_mask=keep_mask(...) (boolean (S, T))")
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
        **({"key_pos_slots": int((mask["key_pos"] >= 0).sum())} if "key_pos" in mask else {}),
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
# The other model families on the flash kernel: moe_serve, vlm_prefill,
# encdec_generate
# ---------------------------------------------------------------------------

def hold_logits(what, got, want, tol=PREFILL_DECODE_TOL) -> dict:
    """``got`` against the reference ``want`` (same shape, bf16 at full
    width): finite, max |got - want| within ``tol`` of max |want|, and the
    same greedy token at every position whose choice the two paths' error
    cannot flip: where the reference's top-2 margin exceeds twice that
    position's largest |got - want|.  The other positions (near-ties, most
    of them exact ties of two bf16 logits) are counted and reported."""
    import torch

    got, want = got.float(), want.float()
    if not (bool(torch.isfinite(got).all()) and bool(torch.isfinite(want).all())):
        fail(f"{what}: non-finite logits")
    scale = float(want.abs().max())
    row_err = (got - want).abs().amax(-1)
    err = float(row_err.max())
    top2 = torch.topk(want, 2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    determined = margin > 2 * row_err
    same = got.argmax(-1) == want.argmax(-1)
    if not bool(same[determined].all()):
        bad = determined & ~same
        fail(f"{what}: greedy tokens differ at {int(bad.sum())} positions whose top-2 margin "
             f"exceeds twice their error (smallest such margin {float(margin[bad].min())})")
    if err > tol * scale:
        fail(f"{what}: logits {err} beyond {tol} of the largest |logit| {scale}")
    return {"positions": same.numel(), "determined_positions": int(determined.sum()),
            "same_greedy_tokens_where_determined": True,
            "same_greedy_tokens": int(same.sum()), "near_ties": int((~determined).sum()),
            "exact_ties": int((margin == 0).sum()),
            "near_tie_tokens_differ": int((~same).sum()),
            "max_abs_err": err, "max_abs_logit": scale, "rel_err": err / scale,
            "mean_abs_err": float((got - want).abs().mean()),
            "min_determined_margin": float(margin[determined].min()) if bool(determined.any())
            else None,
            "tolerance": f"max |a - b| <= {tol} * max |reference| (bf16 activations round at "
                         "2^-8 relative wherever the two paths' sums differ); greedy tokens equal "
                         "wherever the reference's top-2 margin exceeds twice the position's "
                         "max |a - b| (bf16 logits tie exactly at a 152k or 256k vocabulary)"}


def check_moe_ffn(blk, x, capacity, cfg, what) -> dict:
    """Block ``blk``'s MoE FFN on the card in bf16 against the same token
    states through the CPU float32 function (the same bf16 weights, as
    f32): keep masks and loads equal, y within MOE_FFN_TOL of max |y_cpu|."""
    import torch

    from repro_torch.models.moe import moe_ffn_local, route

    w = (blk.router, blk.w_gate, blk.w_up, blk.w_down)
    with uncounted():
        y, load = moe_ffn_local(x, *w, cfg, capacity)
        keep = route(x, blk.router, cfg, capacity).keep
    xc, wc = x.float().cpu(), [t.float().cpu() for t in w]
    y_cpu, load_cpu = moe_ffn_local(xc, *wc, cfg, capacity)
    keep_cpu = route(xc, wc[0], cfg, capacity).keep
    if not torch.equal(keep.cpu(), keep_cpu):
        fail(f"{what}: keep masks differ in {int((keep.cpu() != keep_cpu).sum())} pairs")
    if not torch.equal(load.cpu(), load_cpu):
        fail(f"{what}: per-expert loads differ")
    err = float((y.float().cpu() - y_cpu).abs().max())
    scale = float(y_cpu.abs().max())
    if not bool(torch.isfinite(y).all()) or err > MOE_FFN_TOL * scale:
        fail(f"{what}: y differs by {err} from the CPU's, beyond {MOE_FFN_TOL} of {scale}")
    return {"tokens": x.shape[0], "capacity": capacity, "pairs": keep.numel(),
            "dropped_pairs": int((~keep).sum()), "same_keep": True, "same_load": True,
            "max_abs_err": err, "max_abs_cpu": scale, "rel_err": err / scale,
            "tolerance": f"keep masks and loads equal; max |card - cpu| <= {MOE_FFN_TOL} * max "
                         "|cpu| (the card rounds g, u, h, each expert's output, its gate "
                         "product and y to bf16, each at 2^-8 relative)"}


def run_moe_serve(cfg, max_batch, max_seq, prompts, max_new, tick_capacity, stream_kw,
                  forward_shape, seed, device="cuda"):
    """``cfg`` (granite-moe-3b-a800m at its published size in bf16) through
    ``run_serve_path`` with the MoE FFN captured: the run's per-expert
    load (every call routes all ``max_batch`` rows), one warm decode call
    under the kernel profiler (a flash dispatch a layer, none a fallback),
    and layer 0's FFN against the CPU on the first decode's token states
    and on a forward's over ``forward_shape`` prompt tokens.  Returns
    (report, the captured decode inputs, launches)."""
    import torch

    from repro_torch import kernels
    from repro_torch.obs.kprof import KernelProfiler

    moe = MoeCapture()
    report, model, params, cap, launches = run_serve_path(
        cfg, max_batch, max_seq, prompts, max_new, tick_capacity, stream_kw, seed,
        device=device, capture=moe)
    load = moe.load.cpu()
    if moe.calls != cfg.n_layers * report["decode_calls"]:
        fail(f"moe_serve: {moe.calls} MoE calls for {report['decode_calls']} decode calls of "
             f"{cfg.n_layers} layers")
    if int(load.sum()) != moe.calls * max_batch * cfg.moe_top_k:
        fail(f"moe_serve: {int(load.sum())} expert picks, expected every call to route all "
             f"{max_batch} rows")
    cache = model.init_cache(max_batch, max_seq)
    tokens = torch.zeros((max_batch, 1), dtype=torch.int32, device=device)
    pos, rows = max(len(p) for p in prompts) - 1, list(range(max_batch))
    prof = KernelProfiler()
    with uncounted():
        model.decode_step(params, cache, tokens, pos, rows)
        kernels.set_profiler(prof)
        try:
            _, profiled_s = wall(lambda: model.decode_step(params, cache, tokens, pos, rows))
        finally:
            kernels.set_profiler(None)
    del cache
    flash = prof.summary().get("flash_attention", {})
    if flash.get("dispatches") != cfg.n_layers or flash.get("fallbacks") != 0:
        fail(f"moe_serve: a profiled decode call dispatched flash_attention {flash}, expected "
             f"{cfg.n_layers} dispatches and no fallback")
    ffn = {"decode": check_moe_ffn(params.layers[0], *moe.first, cfg, "moe_serve decode FFN")}
    B, S = forward_shape
    toks = torch.from_numpy(np.stack([np.resize(p, S) for p in prompts[:B]])).to(device)
    with MoeCapture() as fwd, uncounted():
        (_, aux), forward_s = wall(lambda: model.forward(params, {"tokens": toks}))
    if int(aux["moe_load"].sum()) != cfg.n_layers * B * S * cfg.moe_top_k:
        fail(f"moe_serve: forward's moe_load sums to {int(aux['moe_load'].sum())}")
    ffn["forward"] = check_moe_ffn(params.layers[0], *fwd.first, cfg, "moe_serve forward FFN")
    report.update({
        "experts": cfg.moe_experts, "top_k": cfg.moe_top_k, "moe_calls": moe.calls,
        "expert_load": [int(v) for v in load],
        "expert_load_share_max": float(load.max() / load.sum()),
        "expert_load_share_min": float(load.min() / load.sum()),
        "profiled_decode_call": {"wall_s": profiled_s, "ops": prof.summary()},
        "ffn_vs_cpu": ffn, "forward_tokens": B * S, "forward_s": forward_s,
        "forward_moe_load_layer0": [int(v) for v in aux["moe_load"][0].cpu()],
    })
    return report, cap.inputs, launches


def run_vlm_prefill(cfg, batch, n_text, n_prefill, seed, device="cuda"):
    """``cfg`` (qwen2-vl-72b at its published widths, depth cut) with
    weights drawn on the card from ``seed``: a (batch, n_vision, 1024)
    vision stub and ``n_text`` text tokens after it; ``forward`` over all
    positions, ``prefill`` over the first ``n_prefill``, then a
    ``decode_step`` per remaining position, teacher-forced.  The decode
    (and the prefill) logits are held to the forward's.  The launch
    counters are set to 0 just before and read just after.  Returns
    (report, the FlashCapture, launches)."""
    import torch

    from repro_torch import kernels
    from repro_torch.models import get_model

    model = get_model(cfg, device=device)
    params, init_s = wall(lambda: model.init(torch.Generator(device=device).manual_seed(seed)))
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    S = cfg.n_vision_tokens + n_text
    vision = torch.randn((batch, cfg.n_vision_tokens, 1024), generator=gen, device=device)
    toks = torch.randint(0, cfg.vocab, (batch, S), generator=gen, device=device,
                         dtype=torch.int32)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    prefill = {"prefill": lambda q, k, causal, qpos: causal and q.shape[1] == S}
    with FlashCapture(wants=prefill) as cap:
        (full, aux), forward_s = wall(lambda: model.forward(
            params, {"tokens": toks, "vision_embeds": vision}))
        (pre, cache), prefill_s = wall(lambda: model.prefill(
            params, {"tokens": toks[:, :n_prefill], "vision_embeds": vision}, cache_len=S))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = []
        for i in range(n_prefill, S):
            lg, cache = model.decode_step(params, cache, toks[:, i:i + 1], i)
            outs.append(lg[:, 0])
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    calls = 2 + (S - n_prefill)
    if launches["flash_attention"] < cfg.n_layers * calls:
        fail(f"vlm_prefill: flash_attention launched {launches['flash_attention']} times, fewer "
             f"than {cfg.n_layers} layers x {calls} calls")
    held = {"decode_vs_forward": hold_logits("vlm_prefill decode", torch.stack(outs, 1),
                                             full[:, n_prefill:]),
            "prefill_vs_forward": hold_logits("vlm_prefill prefill", pre, full[:, :n_prefill])}
    report = {"arch": cfg.name, "layers": cfg.n_layers, "params": sum(
                  p.numel() for p in params.parameters()), "dtype": cfg.compute_dtype,
              "batch": batch, "vision_tokens": cfg.n_vision_tokens, "text_tokens": n_text,
              "prefill_tokens": n_prefill, "decode_steps": S - n_prefill,
              "mrope_sections": list(cfg.mrope_sections), "init_s": init_s,
              "forward_s": forward_s, "prefill_s": prefill_s, "decode_s": decode_s,
              "decode_step_s": decode_s / (S - n_prefill), "peak_device_gb": peak_gb,
              "launches": launches, **held}
    return report, cap, launches


def run_encdec_generate(cfg, batch, src_len, n_prefix, n_new, seed, device="cuda"):
    """``cfg`` (seamless-m4t-large-v2 at its published size in bf16) with
    weights drawn on the card from ``seed``: a (batch, src_len, d_model)
    frame stub and an ``n_prefix``-token target prefix; ``prefill``, then
    ``n_new`` greedy ``decode_step``s, held to ``forward`` teacher-forced
    on the prefix and the generated tokens (greedy tokens equal).  The
    launch counters are set to 0 just before and read just after.
    Returns (report, the FlashCapture, launches)."""
    import torch

    from repro_torch import kernels
    from repro_torch.models import get_model

    model = get_model(cfg, device=device)
    params, init_s = wall(lambda: model.init(torch.Generator(device=device).manual_seed(seed)))
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    frames = torch.randn((batch, src_len, cfg.d_model), generator=gen, device=device)
    prefix = torch.randint(0, cfg.vocab, (batch, n_prefix), generator=gen, device=device,
                           dtype=torch.int32)
    wants = {
        "encoder": lambda q, k, causal, qpos: not causal and q.shape[1] == k.shape[1] == src_len,
        "cross_prefill": lambda q, k, causal, qpos: (not causal and q.shape[1] == n_prefix
                                               and k.shape[1] == src_len),
        "cross_decode": lambda q, k, causal, qpos: (not causal and q.shape[1] == 1
                                              and k.shape[1] == src_len),
    }
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    with FlashCapture(wants=wants) as cap:
        (pre, cache), prefill_s = wall(lambda: model.prefill(
            params, {"frames": frames, "tokens": prefix}, cache_len=n_prefix + n_new))
        nxt = pre[:, -1].argmax(-1)
        generated, outs = [nxt], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n_new):
            lg, cache = model.decode_step(params, cache, nxt[:, None].to(torch.int32),
                                          n_prefix + i)
            outs.append(lg[:, 0])
            nxt = lg[:, 0].argmax(-1)
            generated.append(nxt)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        fed = torch.cat([prefix, torch.stack(generated[:n_new], 1).to(torch.int32)], 1)
        (full, _), forward_s = wall(lambda: model.forward(params, {"frames": frames,
                                                                   "tokens": fed}))
    launches = kernels.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    per_call = cfg.enc_layers + 2 * cfg.dec_layers  # the encoder, then self and cross a layer
    want = 2 * per_call + 2 * cfg.dec_layers * n_new
    if launches["flash_attention"] < want:
        fail(f"encdec_generate: flash_attention launched {launches['flash_attention']} times, "
             f"fewer than the {want} of the prefill, decode and forward")
    missing = [k for k in wants if k not in cap.captured]
    if missing:
        fail(f"encdec_generate: no flash call at the {missing} shapes")
    held = {"decode_vs_forward": hold_logits("encdec_generate decode", torch.stack(outs, 1),
                                             full[:, n_prefix:]),
            "prefill_vs_forward": hold_logits("encdec_generate prefill", pre,
                                              full[:, :n_prefix])}
    report = {"arch": cfg.name, "enc_layers": cfg.enc_layers, "dec_layers": cfg.dec_layers,
              "params": sum(p.numel() for p in params.parameters()), "dtype": cfg.compute_dtype,
              "batch": batch, "source_frames": src_len, "prefix_tokens": n_prefix,
              "new_tokens": n_new, "init_s": init_s, "prefill_s": prefill_s,
              "decode_s": decode_s, "decode_step_s": decode_s / n_new,
              "tok_per_s": batch * n_new / decode_s, "forward_s": forward_s,
              "generated": torch.stack(generated, 1)[0].tolist(), "peak_device_gb": peak_gb,
              "launches": launches, **held}
    return report, cap, launches


def family_flash_lines(cap, launches, iters, what) -> list:
    """A ``kernel`` line for each flash input ``cap`` (a FlashCapture)
    captured on a family's phase."""
    return [flash_entry(f"{what} {label} (layer 0, captured)", *inputs, cap.causal[label],
                        launches, iters)
            for label, inputs in cap.captured.items()]


def family_phases(smi: str) -> None:
    """The moe_serve, vlm_prefill and encdec_generate phases at full size,
    each with the launch counters set to 0 just before it and read just
    after, then their flash ``kernel`` lines and each family's smoke
    config served on the card against the CPU."""
    import torch

    from repro_torch.configs import get_config

    moe_cfg = get_config(MOE_ARCH)
    moe, moe_flash, moe_launches = run_moe_serve(
        moe_cfg, MOE_MAX_BATCH, MOE_MAX_SEQ,
        serve_prompts(moe_cfg.vocab, MOE_REQUESTS, *MOE_PROMPT_LENS, SEED), MOE_MAX_NEW,
        SERVE_TICK_CAPACITY, SERVE_STREAM, MOE_FORWARD_SHAPE, SEED)
    missing = [k for k in SERVE_KERNELS if moe_launches[k] == 0]
    if missing:
        fail(f"kernels never launched on the moe serve path: {missing}")
    emit({"phase": "moe_serve", **moe, "card": smi})
    torch.cuda.empty_cache()
    family_flash = [flash_entry("moe_serve decode (layer 0, captured)", *moe_flash, False,
                                moe_launches["flash_attention"], ITERS)]
    del moe_flash
    emit({"phase": "moe_device_vs_cpu",
          **serve_device_vs_cpu(MOE_ARCH, SMOKE_PROMPT_LENS, 4, 64, 8, SEED), "card": smi})

    vlm_cfg = dataclasses.replace(get_config(VLM_ARCH), n_layers=VLM_LAYERS)
    vlm, vlm_cap, vlm_launches = run_vlm_prefill(vlm_cfg, VLM_BATCH, VLM_TEXT, VLM_PREFILL, SEED)
    missing = [k for k in FAMILY_KERNELS if vlm_launches[k] == 0]
    if missing:
        fail(f"kernels never launched on the vlm path: {missing}")
    emit({"phase": "vlm_prefill", **vlm,
          "depth_cut": f"{get_config(VLM_ARCH).n_layers} -> {VLM_LAYERS} layers", "card": smi})
    torch.cuda.empty_cache()
    family_flash += family_flash_lines(vlm_cap, vlm_launches["flash_attention"], ITERS,
                                       "vlm_prefill")
    del vlm_cap

    enc, enc_cap, enc_launches = run_encdec_generate(
        get_config(ENCDEC_ARCH), ENCDEC_BATCH, ENCDEC_SRC, ENCDEC_PREFIX, ENCDEC_NEW, SEED)
    missing = [k for k in FAMILY_KERNELS if enc_launches[k] == 0]
    if missing:
        fail(f"kernels never launched on the encdec path: {missing}")
    emit({"phase": "encdec_generate", **enc, "card": smi})
    torch.cuda.empty_cache()
    family_flash += family_flash_lines(enc_cap, enc_launches["flash_attention"], ITERS,
                                       "encdec_generate")
    del enc_cap
    for entry in family_flash:
        emit({"phase": "kernel", **entry, "card": smi})
    emit({"phase": "encdec_device_vs_cpu",
          **serve_device_vs_cpu(ENCDEC_ARCH, SMOKE_PROMPT_LENS, 4, 64, 8, SEED), "card": smi})


# ---------------------------------------------------------------------------
# The recurrent families: hybrid (recurrentgemma-9b, local attention on the
# flash kernel's window and ring-buffer masks) and ssm (xlstm-1.3b)
# ---------------------------------------------------------------------------

def ring_positions(W, pos, holes, seed, device):
    """A (W,) int32 ring of slot positions after decodes up to ``pos``:
    slot p mod W holds p for p in (pos − W, pos] (so wrapped and rotated
    once pos ≥ W), and ``holes`` slots other than pos's emptied (−1)."""
    import torch

    buf = np.full(W, -1, np.int32)
    p = np.arange(max(0, pos - W + 1), pos + 1)
    buf[p % W] = p
    others = np.array([s for s in range(W) if s != pos % W])
    buf[np.random.default_rng(seed).choice(others, holes, replace=False)] = -1
    return torch.from_numpy(buf).to(device)


def decode_vs_forward(model, params, toks, n, tol, what, capture=None):
    """``forward`` over ``toks`` (B, S), then its first ``n`` positions fed
    one by one through ``decode_step`` from an empty cache, held to the
    forward's logits by ``hold_logits`` at ``tol`` (only reported when
    ``tol`` is None).  ``capture``: a FlashCapture around both."""
    import torch

    with capture or contextlib.nullcontext():
        (full, _), forward_s = wall(lambda: model.forward(params, {"tokens": toks}))
        cache = model.init_cache(toks.shape[0], n)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = []
        for i in range(n):
            lg, cache = model.decode_step(params, cache, toks[:, i:i + 1], i)
            outs.append(lg[:, 0])
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
    dec, ref = torch.stack(outs, 1).float(), full[:, :n].float()
    if not (bool(torch.isfinite(dec).all()) and bool(torch.isfinite(full).all())):
        fail(f"{what}: non-finite logits")
    if tol is None:
        held = {"held": False, "rel_err": float((dec - ref).abs().max() / ref.abs().max()),
                "same_greedy_tokens": int((dec.argmax(-1) == ref.argmax(-1)).sum()),
                "positions": dec.shape[0] * dec.shape[1]}
    else:
        held = hold_logits(what, dec, ref, tol=tol)
    return {"forward_tokens": toks.numel(), "forward_shape": list(toks.shape),
            "forward_s": forward_s, "forward_tok_per_s": toks.numel() / forward_s,
            "decode_steps": n, "decode_s": decode_s, "decode_step_s": decode_s / n,
            "decode_vs_forward": held}


def ssm_layers_vs_cpu(params, toks) -> dict:
    """The first mLSTM and sLSTM layers of ``params`` (an XLSTM on the
    card) on the embedded ``toks``, full and one decode step from an empty
    state, against copies of the same layers on the CPU, held at
    SSM_LAYER_TOL of the largest |CPU output|."""
    import copy

    import torch

    from repro_torch.models import xlstm
    from repro_torch.models.layers import f32_accumulation

    x = params.embed[toks.long()]  # (1, L, d) in the compute dtype
    H, hd, d = params.cfg.mlstm_heads, xlstm.head_dim(params.cfg), params.cfg.d_model
    out = {}
    for name, blk in (("mlstm", params.mlstm[0]), ("slstm", params.slstm[0])):
        cpu = copy.deepcopy(blk).cpu()
        if name == "mlstm":
            shapes = ((1, H, hd, hd), (1, H, hd), (1, H))
        else:
            shapes = ((1, d),) * 4

        def decode(b, dev):
            state = [torch.zeros(sh, dtype=torch.float32, device=dev) for sh in shapes]
            xs = x[:, :1].to(dev)
            return b.decode(xs, *state) if name == "mlstm" else b.decode(xs, state)

        with f32_accumulation():
            pairs = (("full", blk.full(x), cpu.full(x.cpu())),
                     ("decode", decode(blk, x.device), decode(cpu, "cpu")))
        for mode, got, want in pairs:
            got, want = got.float().cpu(), want.float()
            err, scale = float((got - want).abs().max()), float(want.abs().max())
            if not bool(torch.isfinite(got).all()) or err > SSM_LAYER_TOL * scale:
                fail(f"ssm_serve {name} layer 0 {mode} (bf16): max |card - cpu| {err} beyond "
                     f"{SSM_LAYER_TOL} of max |cpu| {scale}")
            out[f"{name}_{mode}"] = {"max_abs_err": err, "max_abs": scale, "rel_err": err / scale,
                                     "bit_equal_share": float((got == want).float().mean())}
    return dict(out, tokens=toks.shape[1], dtype=str(x.dtype),
                tolerance=f"max |card - cpu| <= {SSM_LAYER_TOL} * max |cpu|")


def recurrent_phases(smi: str, device: str = "cuda") -> None:
    """hybrid_serve, hybrid_forward, the hybrid's flash ``kernel`` lines
    (the serve path's ring decode, the forward's banded prefill and the
    ring decode at full width, wrapped and with holes) and
    hybrid_device_vs_cpu; then ssm_serve (with its forward) and
    ssm_device_vs_cpu.  Each phase runs with the launch counters set to 0
    just before it and read just after.  ``device``: the card (a CPU
    rehearsal passes "cpu", with the smoke configs)."""
    import torch

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models import get_model, rglru, xlstm

    cfg = get_config(HYBRID_ARCH)
    sb, _ = rglru.n_superblocks(cfg)
    ring = min(cfg.attn_window, RECURRENT_MAX_SEQ)
    prompts = serve_prompts(cfg.vocab, RECURRENT_REQUESTS, *RECURRENT_PROMPT_LENS, SEED)
    last = max(len(p) for p in prompts) + RECURRENT_MAX_NEW - 2  # the run's last position
    serve, model, params, cap, launches = run_serve_path(
        cfg, RECURRENT_MAX_BATCH, RECURRENT_MAX_SEQ, prompts, RECURRENT_MAX_NEW,
        SERVE_TICK_CAPACITY, SERVE_STREAM, SEED, device=device,
        flash_wants={"ring decode": lambda q, k, causal, qpos: (
            q.shape[1] == 1 and k.shape[1] == ring and qpos == last)})
    missing = [k for k in SERVE_KERNELS if launches[k] == 0]
    if missing:
        fail(f"kernels never launched on the hybrid serve path: {missing}")
    emit({"phase": "hybrid_serve", **serve, "superblocks": sb, "ring_slots": ring,
          "window": cfg.attn_window, "card": smi})
    flash = [flash_entry("hybrid_serve ring decode (layer 0, captured)",
                         *cap.captured["ring decode"], True, launches["flash_attention"], ITERS,
                         mask=cap.masks["ring decode"])]
    del cap

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    toks = torch.randint(0, cfg.vocab, (1, HYBRID_FORWARD_LEN), generator=gen, device=device,
                         dtype=torch.int32)
    banded = FlashCapture(wants={"banded": lambda q, k, causal, qpos: causal and q.shape[1] > 1})
    fwd = decode_vs_forward(model, params, toks, HYBRID_DECODE_LEN, HYBRID_DECODE_TOL,
                            "hybrid_forward decode", capture=banded)
    fwd_launches = kernels.launch_counts()
    if fwd_launches["flash_attention"] < sb * (1 + HYBRID_DECODE_LEN):
        fail(f"hybrid_forward: flash_attention launched {fwd_launches['flash_attention']} times, "
             f"fewer than {sb} attention layers x {1 + HYBRID_DECODE_LEN} calls")
    if banded.masks["banded"]["window"] != cfg.attn_window:
        fail(f"hybrid_forward: the prefill's flash call had window {banded.masks['banded']}")
    emit({"phase": "hybrid_forward", "arch": cfg.name, **fwd, "launches": fwd_launches,
          "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9, "card": smi})
    flash.append(flash_entry("hybrid_forward banded prefill (layer 0, captured)",
                             *banded.captured["banded"], True, fwd_launches["flash_attention"],
                             ITERS, mask=banded.masks["banded"]))
    del banded, model, params, toks
    torch.cuda.empty_cache()
    B, S, T, H, K, hd = RING_SHAPE
    gen = torch.Generator(device=device).manual_seed(SEED)
    q, k, v = (torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
               for shape in ((B, S, H, hd), (B, T, K, hd), (B, T, K, hd)))
    # no path runs this shape: the served ring (max_seq 128) never wraps at full width
    flash.append(flash_entry(
        f"ring decode recurrentgemma-9b (positions {RING_POS - T + 1}-{RING_POS}, "
        f"{RING_HOLES} holes)", q, k, v, True, 0, ITERS,
        mask=dict(window=cfg.attn_window, key_pos=ring_positions(T, RING_POS, RING_HOLES, SEED,
                                                                 device), qpos=RING_POS),
        on_path="none: a synthetic shape, launches 0"))
    del q, k, v
    for entry in flash:
        emit({"phase": "kernel", **entry, "card": smi})
    emit({"phase": "hybrid_device_vs_cpu", **serve_device_vs_cpu(
        HYBRID_ARCH, RECURRENT_SMOKE_PROMPT_LENS, 4, 64, 8, SEED, devices=(device, "cpu")),
        "card": smi})

    torch.cuda.empty_cache()
    cfg = get_config(SSM_ARCH)
    serve, model, params, _, launches = run_serve_path(
        cfg, RECURRENT_MAX_BATCH, RECURRENT_MAX_SEQ,
        serve_prompts(cfg.vocab, RECURRENT_REQUESTS, *RECURRENT_PROMPT_LENS, SEED),
        RECURRENT_MAX_NEW, SERVE_TICK_CAPACITY, SERVE_STREAM, SEED, device=device,
        flash_wants={})
    missing = [k for k in SSM_KERNELS if launches[k] == 0]
    if missing:
        fail(f"kernels never launched on the ssm serve path: {missing}")
    state = xlstm.init_cache(cfg, RECURRENT_MAX_BATCH, RECURRENT_MAX_SEQ, device="meta")
    mlstm_bytes = sum(4 * state[k].numel() for k in ("mlstm_C", "mlstm_n", "mlstm_m"))
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    toks = torch.randint(0, cfg.vocab, SSM_FORWARD_SHAPE, generator=gen, device=device,
                         dtype=torch.int32)
    fwd = decode_vs_forward(model, params, toks, SSM_DECODE_LEN, None, "ssm_serve forward")
    fwd["peak_device_gb"] = torch.cuda.max_memory_allocated() / 1e9
    # the served weights in f32: the whole model's pair and its forward
    # against the bf16 one (reported), then its first super-block (held)
    torch.backends.cuda.matmul.allow_tf32 = False
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    p32 = xlstm.XLSTM(f32, device)
    p32.load_state_dict(params.state_dict())
    m32 = get_model(f32, device=device)
    full32 = decode_vs_forward(m32, p32, toks, SSM_DECODE_LEN, None, "ssm_serve forward (f32)")
    lg16, lg32 = (m.forward(p, {"tokens": toks})[0].float() for m, p in ((model, params),
                                                                           (m32, p32)))
    full32["bf16_forward_vs_f32_forward_rel_err"] = float(
        (lg16 - lg32).abs().max() / lg32.abs().max())
    del p32, lg16, lg32
    one = dataclasses.replace(f32, n_layers=cfg.slstm_every)
    m1 = get_model(one, device=device)
    p1 = xlstm.XLSTM(one, device)
    keys = set(p1.state_dict())
    p1.load_state_dict({k: t for k, t in params.state_dict().items() if k in keys})
    held = decode_vs_forward(m1, p1, toks, SSM_DECODE_LEN, SSM_DECODE_TOL,
                             "ssm_serve one super-block decode (f32)")
    layers = ssm_layers_vs_cpu(params, toks[:1, :SSM_LAYER_LEN])
    emit({"phase": "ssm_serve", **serve, "superblocks": xlstm.n_superblocks(cfg),
          "mlstm_head_dim": xlstm.head_dim(cfg), "mlstm_state_bytes": mlstm_bytes,
          "slstm_state_bytes": sum(4 * t.numel() for t in state["slstm"]), "forward": fwd,
          "forward_f32": full32, "one_superblock_f32": dict(held, layers=one.n_layers),
          "layers_bf16_vs_cpu": layers,
          "card": smi})
    del model, params, toks, m1, p1
    torch.cuda.empty_cache()
    emit({"phase": "ssm_device_vs_cpu", **serve_device_vs_cpu(
        SSM_ARCH, RECURRENT_SMOKE_PROMPT_LENS, 4, 64, 8, SEED, devices=(device, "cpu")),
        "card": smi})


# ---------------------------------------------------------------------------
# Training: gemma-2b's train step at its published size, the smoke configs
# on the card against the CPU, and the launcher's restart from a checkpoint
# ---------------------------------------------------------------------------

def kept_pairs(S: int, T: int, causal: bool = True, window: int = 0) -> int:
    """(query, key) pairs an attention keeps: S·T without the causal mask,
    else Σ_i min(i + 1, window or T) (query i at position i)."""
    if not causal:
        return S * T
    W = min(window or T, T)
    m = min(S, W)
    return m * (m + 1) // 2 + (S - m) * W


def train_flops(cfg, B: int, S: int) -> float:
    """Model operations of one train step over (B, S) tokens (the encdec
    source also S long): 6·N·tokens (every parameter's product forward and
    twice backward; the tied embedding counted once, as the unembedding)
    plus each attention-like core's two products over its kept pairs,
    4·B·H·hd·pairs a layer forward and twice that backward: the causal
    attention of every transformer layer; the hybrid's banded attention
    (window 2,048) of each super-block; the encoder's non-causal, the
    decoder's causal and the cross attention (S·S); the mLSTM parallel
    form's q·k and scores·v (H 4, hd 2·d/H) over the causal pairs of each
    mLSTM layer.  Elementwise work (the RG-LRU scan, the sLSTM cell, the
    mLSTM's decay matrix) and the remat recompute are not counted."""
    from repro_torch.models import rglru, xlstm
    from repro_torch.models.api import param_counts

    per_pair = 3 * 4.0 * B * cfg.n_heads * cfg.head_dim
    core = {
        "hybrid": lambda: per_pair * kept_pairs(S, S, window=cfg.attn_window)
        * rglru.n_superblocks(cfg)[0],
        "ssm": lambda: 3 * 4.0 * B * cfg.mlstm_heads * xlstm.head_dim(cfg) * kept_pairs(S, S)
        * xlstm.n_superblocks(cfg) * (cfg.slstm_every - 1),
        "encdec": lambda: per_pair * (S * S * cfg.enc_layers
                                      + (kept_pairs(S, S) + S * S) * cfg.dec_layers),
    }.get(cfg.family, lambda: per_pair * kept_pairs(S, S) * cfg.n_layers)
    return 6.0 * param_counts(cfg)["total"] * B * S + core()


def probe_params(params) -> dict:
    """Copies of a few small slices of the parameters, to show they moved."""
    return {"final_norm": params.final_norm.detach()[:64].clone(),
            "layers.0.ln1": params.layers[0].ln1.detach()[:64].clone(),
            "layers.0.wq": params.layers[0].wq.detach()[:8, :8].clone(),
            "embed": params.embed.detach()[:8, :8].clone()}


def run_train_path(argv, seed, device="cuda"):
    """``launch.train.build`` on ``argv`` (float32 masters and AdamW state
    on ``device``), its steps with the loss view's cadences, the SVC
    estimates against the truth after a full maintenance, then one step
    under the kernel profiler and one under ``torch.profiler``.  The launch
    counters are set to 0 just before the steps and read after the
    maintenance.  Returns (report, the FlashCapture, launches, the loss
    view's CallCaptures)."""
    import torch

    from repro_torch import kernels
    from repro_torch.data.pipeline import LOSS_VIEW
    from repro_torch.launch import train
    from repro_torch.obs.kprof import KernelProfiler
    from repro_torch.training import init_train_state

    args = train.parser().parse_args(list(argv) + ["--device", device, "--seed", str(seed)])
    cfg, model, pipe, stats, step_fn = train.build(args)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    before_state = torch.cuda.memory_allocated()
    state, init_s = wall(lambda: init_train_state(model, seed))
    state_allocated = torch.cuda.memory_allocated() - before_state
    leaves = [p for p in state.params.parameters() if p.requires_grad]
    n_params = sum(p.numel() for p in leaves)
    before = probe_params(state.params)
    B, S = args.batch, args.seq
    cap = FlashCapture(wants={"train causal": lambda q, k, causal, qpos: (
        causal and q.shape[1] == S and k.shape[1] == S)})
    svc_caps = train_svc_captures()
    box = [state]

    def one_step(batch):
        box[0], met = step_fn(box[0], batch)
        return met

    steps = []
    kernels.reset_launches()
    with cap, svc_caps["hash_threshold"], svc_caps["segment_aggsum"], svc_caps["multi_agg"]:
        for i in range(args.steps):
            batch = pipe.batch(i)
            flash0 = kernels.launch_counts()
            met, step_s = wall(lambda: one_step(batch))
            flash1 = kernels.launch_counts()
            steps.append({"step": i + 1, "wall_s": step_s, "tok_per_s": B * S / step_s,
                          "flash_launches": flash1["flash_attention"] - flash0["flash_attention"],
                          "flash_bwd_launches": flash1["flash_attention_bwd"]
                          - flash0["flash_attention_bwd"],
                          "adamw_launches": [flash1[k] - flash0[k] for k in ADAMW_KERNELS],
                          "ce_launches": [flash1[k] - flash0[k] for k in CE_KERNELS],
                          **{k: float(met[k]) for k in ("loss", "grad_norm", "clip_scale", "lr")}})
            stats.ingest_step(met["domain_loss_sum"], met["domain_count"])
            if i > 0 and i % args.svc_every == 0:
                stats.svc_refresh()
            if i > 0 and i % args.mixture_every == 0:
                pipe.set_mixture(stats.mixture_weights())
        estimates = [stats.loss_estimate(d) for d in range(stats.n_domains)]
        _, maintain_s = wall(stats.full_maintenance)
    launches = kernels.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    per_step = 2 * cfg.n_layers if cfg.remat == "full" else cfg.n_layers
    bad = [s for s in steps if s["flash_launches"] != per_step]
    if bad:
        fail(f"train_path: flash_attention launches per step {[s['flash_launches'] for s in steps]}"
             f", expected {per_step} (forward and the remat recompute of {cfg.n_layers} layers)")
    if any(s["flash_bwd_launches"] != cfg.n_layers for s in steps):
        fail("train_path: flash_attention_bwd launches per step "
             f"{[s['flash_bwd_launches'] for s in steps]}, expected {cfg.n_layers} (one a layer)")
    adamw_per_step = check_adamw_launches(steps, len(leaves), "train_path")
    check_ce_launches(steps, args.microbatches, "train_path")
    if not all(math.isfinite(s["loss"]) and math.isfinite(s["grad_norm"]) for s in steps):
        fail(f"train_path: a non-finite loss or grad norm: {steps}")
    after = probe_params(state.params)
    still = [k for k in before if bool(torch.equal(before[k], after[k]))]
    if still:
        fail(f"train_path: parameters did not move: {still}")
    if bool(np.allclose(pipe.mixture, 1.0 / len(pipe.mixture))):
        fail("train_path: the mixture was not re-weighted from the SVC estimates")
    # after the maintenance the view is exact: its stale answers are the truth
    truth, svc = [], []
    for d in range(stats.n_domains):
        exact = []
        for q in stats.domain_queries(d):
            a = float(stats.vm.query_stale(LOSS_VIEW, q))
            b = float(stats.vm.query_exact_fresh(LOSS_VIEW, q))
            if a != b:
                fail(f"train_path: domain {d} query_stale {a} != query_exact_fresh {b} after "
                     "full_maintenance")
            exact.append(a)
        mean = exact[0] / max(exact[1], 1.0)
        est, (lo, hi) = estimates[d]
        truth.append(mean)
        svc.append({"domain": d, "tokens_seen": exact[1], "true_mean_loss": mean,
                    "svc_estimate": est, "ci": [lo, hi], "covered": lo <= mean <= hi})
    # one more step under the kernel profiler (every dispatch synchronized):
    # no op takes its plain version
    prof = KernelProfiler()
    kernels.set_profiler(prof)
    try:
        with uncounted():
            one_step(pipe.batch(args.steps))
    finally:
        kernels.set_profiler(None)
    ops = prof.summary()
    for op, want in (("flash_attention", per_step), ("flash_attention_bwd", cfg.n_layers),
                     ("adamw_norm", 1), ("adamw_update", 1),
                     ("cross_entropy_fwd", args.microbatches),
                     ("cross_entropy_bwd", args.microbatches)):
        got = ops.get(op, {})
        if got.get("dispatches") != want or got.get("fallbacks") != 0:
            fail(f"train_path: under the kernel profiler {op} read {got}, expected {want} "
                 "dispatches and 0 fallbacks")
    with uncounted():
        profile = profile_ops(lambda: one_step(pipe.batch(args.steps + 1)), top=12)
    # AdamW alone, on the live state from the last step's gradients (the
    # phase's checks are done): its kernel line, held against the plain
    # version and timed beside it and beside the library's fused AdamW, and
    # one update's wall through each
    from repro_torch.models.convert import jax_leaves

    ranks = {n: r for n, (_k, _i, r) in jax_leaves(box[0].params).items()}
    named = {n: p for n, p in box[0].params.named_parameters()}
    adamw_line, adamw_walls = adamw_entry(step_fn.opt_cfg, named, box[0].opt_state, ranks,
                                          sum(launches[k] for k in ADAMW_KERNELS), ITERS)
    del box, state, leaves, before, after, named
    errs = [abs(e[0] - t) / abs(t) for e, t in zip(estimates, truth) if t]
    warm = steps[1:]
    warm_s = sum(s["wall_s"] for s in warm) / len(warm)
    flops = train_flops(cfg, B, S)
    report = {
        "arch": cfg.name, "params": n_params, "dtype": cfg.compute_dtype, "remat": cfg.remat,
        "vocab": cfg.vocab, "microbatches": args.microbatches, "state_allocated_bytes": state_allocated,
        "state_bytes": {"params": 4 * n_params, "grads": 4 * n_params, "adamw_m": 4 * n_params,
                        "adamw_v": 4 * n_params},
        "batch": B, "seq": S, "steps": steps, "init_s": init_s,
        "warm_tok_per_s": B * S * len(warm) / sum(s["wall_s"] for s in warm),
        "warm_step_s": warm_s, "model_flops_per_step": flops,
        "model_flops_share_of_bf16_peak": flops / warm_s / BF16_OPS_PER_S,
        "svc": {"m": stats.vm.views[LOSS_VIEW].m, "refreshes_every": args.svc_every,
                "mixture_at": args.mixture_every, "mixture": [float(w) for w in pipe.mixture],
                "maintain_s": maintain_s, "domains": svc,
                "rel_err_vs_truth": {"median": float(np.median(errs)), "max": float(np.max(errs))},
                "ci_coverage": sum(r["covered"] for r in svc) / len(svc)},
        "stale_eq_exact_fresh_after_maintenance": True,
        "peak_device_gb": peak_gb, "launches": launches,
        "flash_launches_per_step": per_step, "kprof_step": {k: ops[k] for k in sorted(ops)},
        "adamw_s": adamw_walls["kernel_s"], "adamw_plain_s": adamw_walls["plain_s"],
        "adamw_launches_per_step": 2 * adamw_per_step,
        "ce_launches_per_step": [args.microbatches] * 2,
        # the norm reads every gradient (4 bytes a parameter), the update
        # reads p, g, m, v and writes p, m, v (28)
        "adamw_bound_s": 32 * n_params / HBM_BYTES_PER_S,
        "adamw_bound_parts_s": {"norm": 4 * n_params / HBM_BYTES_PER_S,
                                "update": 28 * n_params / HBM_BYTES_PER_S},
        "adamw_kernel": adamw_line,
        "device_busy_share_of_warm_step": profile.get("device_only_ms", 0.0) / 1e3 / warm_s
        if warm_s else None,
        "step_profile": profile,
    }
    return report, cap, launches, svc_caps


def check_adamw_launches(steps, n_leaves, what) -> int:
    """Every step launched each AdamW kernel once for every group of
    ``max_leaves()`` leaves (one group for every model here); returns that
    count."""
    from repro_torch.kernels.adamw import launches_per_call

    per_call = launches_per_call(n_leaves)
    if any(s["adamw_launches"] != [per_call, per_call] for s in steps):
        fail(f"{what}: adamw_norm and adamw_update launches per step "
             f"{[s['adamw_launches'] for s in steps]}, expected {per_call} each "
             f"({n_leaves} leaves)")
    return per_call


def check_ce_launches(steps, microbatches, what) -> None:
    """Every step launched each cross-entropy kernel once a microbatch."""
    if any(s["ce_launches"] != [microbatches] * 2 for s in steps):
        fail(f"{what}: cross_entropy_fwd and cross_entropy_bwd launches per step "
             f"{[s['ce_launches'] for s in steps]}, expected {microbatches} each (one a "
             "microbatch)")


def adamw_close(got, want, what) -> float:
    """max |got − want|, after holding every element within 2 ulp of the
    plain version's or within ADAMW_RTOL of the leaf's largest magnitude."""
    import torch

    err = (got.double() - want.double()).abs()
    if err.numel() == 0:
        return 0.0
    want = want.float()
    ulp = torch.nextafter(want.abs(), torch.full_like(want, math.inf)) - want.abs()
    ok = (err <= 2 * ulp.double()) | (err <= ADAMW_RTOL * float(want.abs().max()))
    if not bool(ok.all()):
        fail(f"adamw {what}: {int((~ok).sum())} elements beyond 2 ulp and {ADAMW_RTOL} of the "
             f"leaf's largest magnitude from the plain version (max error {float(err.max())})")
    return float(err.max())


def hold_adamw_odd_tree(cfg, device) -> float:
    """The kernel's norm and update against the plain version's over
    ADAMW_ODD_TREE (odd sizes, ranks 1 and 2, one leaf at an offset of one
    element, the scalar route), ADAMW_ODD_STEPS steps from one seed, each
    side from its own scalars: the step exact, lr, grad_norm, clip_scale,
    bc1, bc2 within ADAMW_RTOL relative, every p, m, v as ``adamw_close``.
    Returns the largest absolute error."""
    import torch

    from repro_torch.kernels.adamw import (adamw_apply, adamw_norm, adamw_norm_ref,
                                           adamw_update_ref)

    rng = np.random.default_rng(SEED)

    def put(a, i):
        if i != ADAMW_ODD_OFFSET:
            return torch.from_numpy(a).to(device)
        out = torch.empty(a.size + 1, dtype=torch.float32, device=device)[1:].view(a.shape)
        return out.copy_(torch.from_numpy(a))

    init = [[rng.normal(size=s).astype(np.float32) for s in ADAMW_ODD_TREE],
            [rng.normal(scale=1e-2, size=s).astype(np.float32) for s in ADAMW_ODD_TREE],
            [rng.uniform(0.0, 1e-4, s).astype(np.float32) for s in ADAMW_ODD_TREE]]
    kern, plain = ([[put(a, i) for i, a in enumerate(x)] for x in init] for _ in range(2))
    decay = [len(s) >= 2 for s in ADAMW_ODD_TREE]
    steps = [torch.zeros((), dtype=torch.int32, device=device)] * 2
    worst = 0.0
    for i in range(ADAMW_ODD_STEPS):
        g = [put(rng.normal(scale=0.1, size=s).astype(np.float32), j)
             for j, s in enumerate(ADAMW_ODD_TREE)]
        a, b = adamw_norm(cfg, g, steps[0]), adamw_norm_ref(cfg, g, steps[1])
        if int(a.step) != int(b.step):
            fail(f"adamw odd tree step {i + 1}: step {int(a.step)} against {int(b.step)}")
        for name in ("lr", "grad_norm", "clip_scale", "bc1", "bc2"):
            x, y = float(getattr(a, name)), float(getattr(b, name))
            if not abs(x - y) <= ADAMW_RTOL * abs(y):
                fail(f"adamw odd tree step {i + 1}: {name} {x} against the plain version's {y}")
            worst = max(worst, abs(x - y))
        adamw_apply(cfg, kern[0], g, kern[1], kern[2], decay, a)
        adamw_update_ref(cfg, plain[0], g, plain[1], plain[2], decay, b)
        for what, xs, ys in zip("pmv", kern, plain):
            for shape, x, y in zip(ADAMW_ODD_TREE, xs, ys):
                worst = max(worst, adamw_close(x, y, f"odd tree step {i + 1} {what} {shape}"))
        steps = [a.step, b.step]
    return worst


def adamw_entry(cfg, named, opt_state, ranks, launches, iters):
    """The AdamW kernels (``adamw_norm`` then ``adamw_apply``, two launches
    a step) on train_path's live state (every leaf's p, m, v and the last
    step's gradients), after the phase's checks.  Held: the kernel's
    scalars against the plain version's on every gradient (ADAMW_RTOL
    relative); the update of the ADAMW_HELD_LEAVES, on copies, from the
    same scalars, and ``hold_adamw_odd_tree``.  Timed (CUDA events): one
    ``training.adamw_update`` through the kernels (``ms``), each kernel's
    wrapper alone, the plain version (``adamw_norm_ref`` +
    ``adamw_update_ref``, ADAMW_PLAIN_ITERS calls) and the yardstick, which
    the port never calls: ``torch._foreach_norm`` of the gradients and two
    ``torch._fused_adamw_`` (decayed and undecayed leaves, lr a tensor),
    null where that op is absent.  Each timed call updates the live state.
    Returns (the kernel line, the walls of one update through the kernels
    and through the plain version)."""
    import torch

    from repro_torch.kernels.adamw import (adamw_apply, adamw_norm, adamw_norm_ref,
                                           adamw_update_ref, launches_per_call)
    from repro_torch.training import adamw_update

    names = list(named)
    ps = [named[n] for n in names]
    gs = [p.grad for p in ps]
    grads = dict(zip(names, gs))
    ms, vs = [opt_state["m"][n] for n in names], [opt_state["v"][n] for n in names]
    decay = [ranks[n] >= 2 for n in names]
    n = sum(p.numel() for p in ps)
    per_call = launches_per_call(len(ps))
    with uncounted():
        step = opt_state["step"]
        got, want = adamw_norm(cfg, gs, step), adamw_norm_ref(cfg, gs, step)
        if int(got.step) != int(want.step):
            fail(f"adamw: step {int(got.step)} against the plain version's {int(want.step)}")
        scalars = {}
        for name in ("lr", "grad_norm", "clip_scale", "bc1", "bc2"):
            a, b = float(getattr(got, name)), float(getattr(want, name))
            if not abs(a - b) <= ADAMW_RTOL * abs(b):
                fail(f"adamw: {name} {a} against the plain version's {b} (limit {ADAMW_RTOL} "
                     "relative)")
            scalars[name] = {"kernel": a, "plain": b, "rel_diff": abs(a - b) / abs(b) if b else 0.0}
        held = [i for i, nm in enumerate(names) if nm.startswith(ADAMW_HELD_LEAVES)]
        kern = [[x[i].detach().clone() for i in held] for x in (ps, ms, vs)]
        plain = [[t.clone() for t in x] for x in kern]
        hg, hd = [gs[i] for i in held], [decay[i] for i in held]
        adamw_apply(cfg, kern[0], hg, kern[1], kern[2], hd, got)
        adamw_update_ref(cfg, plain[0], hg, plain[1], plain[2], hd, got)
        err = max(abs(scalars[k]["kernel"] - scalars[k]["plain"]) for k in scalars)
        for what, xs, ys in zip("pmv", kern, plain):
            for i, x, y in zip(held, xs, ys):
                err = max(err, adamw_close(x, y, f"{names[i]} {what}"))
        del kern, plain
        odd_err = hold_adamw_odd_tree(cfg, ps[0].device)
        err = max(err, odd_err)

        def kernels_call():
            adamw_update(cfg, named, grads, opt_state, ranks)

        def plain_call():
            adamw_update_ref(cfg, ps, gs, ms, vs, decay, adamw_norm_ref(cfg, gs, opt_state["step"]))

        ms_ = cuda_ms(kernels_call, iters)
        norm_ms = cuda_ms(lambda: adamw_norm(cfg, gs, opt_state["step"]), iters)
        update_ms = cuda_ms(lambda: adamw_apply(cfg, ps, gs, ms, vs, decay, got), iters)
        plain_ms = cuda_ms(plain_call, ADAMW_PLAIN_ITERS)
        rows = profile_raw(kernels_call, top=4)["top_device"]
        launch_ms = {k: [r["device_ms"] for r in rows if k in r["op"]]
                     for k in ("adamw_sumsq_kernel", "adamw_update_kernel")}
        _, kernel_s = wall(kernels_call)
        _, plain_s = wall(plain_call)
    library_ms, library_call = None, "none: torch._fused_adamw_ is absent"
    if hasattr(torch, "_fused_adamw_"):
        dev = ps[0].device
        lr = got.lr.clone()
        counts = [torch.ones((), dtype=torch.float32, device=dev) for _ in ps]
        groups = [([i for i, d in enumerate(decay) if d], cfg.weight_decay),
                  ([i for i, d in enumerate(decay) if not d], 0.0)]

        def library():
            torch._foreach_norm(gs)
            for idx, wd in groups:
                torch._fused_adamw_([ps[i] for i in idx], [gs[i] for i in idx],
                                    [ms[i] for i in idx], [vs[i] for i in idx], [],
                                    [counts[i] for i in idx], lr=lr, beta1=cfg.b1, beta2=cfg.b2,
                                    weight_decay=wd, eps=cfg.eps, amsgrad=False, maximize=False)

        library_ms = cuda_ms(library, iters)
        library_call = ("torch._foreach_norm(grads) + torch._fused_adamw_ over the decayed and "
                        "the undecayed leaves (lr a tensor; no clip, its own decay form)")
    line = kernel_entry(
        "adamw", "cuda", "src/repro_torch/csrc/adamw.cu",
        "none: XLA's fusion of src/repro/training/optim.py:53 adamw_update with global_norm "
        "at :48 (plain jnp; no Pallas kernel)",
        launches, err, ms_, plain_ms, bytes_=32 * n, ops=ADAMW_OPS_PER_ELEMENT * n,
        library_ms=library_ms, entries_ms={"adamw_norm": norm_ms, "adamw_update": update_ms},
        launch_ms=launch_ms, launches_per_step=2 * per_call, leaves=len(ps), params=n,
        bound_parts_ms={"norm": 4 * n / HBM_BYTES_PER_S * 1e3,
                        "update": 28 * n / HBM_BYTES_PER_S * 1e3},
        scalars_vs_plain=scalars, held_leaves=[names[i] for i in held],
        odd_tree={"shapes": [list(s) for s in ADAMW_ODD_TREE], "offset_leaf": ADAMW_ODD_OFFSET,
                  "steps": ADAMW_ODD_STEPS, "max_abs_err": odd_err},
        plain_call="adamw_norm_ref + adamw_update_ref (the plain version, ~13 passes a leaf)",
        library_call=library_call,
        bound_counts="bytes: g read by the norm (4 a parameter); p, g, m, v read and p, m, v "
                     "written by the update (28); operations: ~19 float32 an element")
    return line, {"kernel_s": kernel_s, "plain_s": plain_s}


def ce_entries(B, S, V, launches, iters, what, device="cuda") -> list:
    """The cross-entropy kernels' two lines at (B·S, V) bf16: each against
    the plain version on the same seeded inputs and timed beside it, beside
    the library call and the bytes bound (the forward reads N·V·2 bytes,
    the backward reads and writes as many)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.cross_entropy import (cross_entropy_bwd, cross_entropy_bwd_ref,
                                                   cross_entropy_fwd, cross_entropy_ref)

    N = B * S
    gen = torch.Generator(device=device).manual_seed(CE_SEED)
    x = (torch.randn((N, V), device=device, generator=gen) * 2.0).to(torch.bfloat16)
    lab = torch.randint(0, V, (N,), device=device, generator=gen, dtype=torch.int32)
    g_lse = torch.rand(N, device=device, generator=gen) * 1e-3
    g_nll = torch.full((N,), 1.0 / N, device=device)
    odd = lab.clone()
    odd[:3] = torch.tensor([-1, -V, V], device=device)

    def hold_fwd(labels):
        got, want = cross_entropy_fwd(x, labels), cross_entropy_ref(x, labels)
        err = 0.0
        for name, a, b in zip(("lse", "nll"), got, want):
            if not torch.equal(a.isnan(), b.isnan()):
                fail(f"cross_entropy_fwd {what}: {name}'s NaN differ from the plain version's")
            ok = ~b.isnan()
            e = float((a[ok] - b[ok]).abs().max())
            if not e <= CE_TOL * max(1.0, float(b[ok].abs().max())):
                fail(f"cross_entropy_fwd {what}: {name} {e} from the plain version's (limit "
                     f"{CE_TOL} of its largest magnitude)")
            err = max(err, e)
        return got[0], err

    with uncounted():
        lse, fwd_err = hold_fwd(lab)
        hold_fwd(odd)
        got = cross_entropy_bwd(x, lab, lse, g_lse, g_nll).double()
        want = cross_entropy_bwd_ref(x, lab, lse, g_lse, g_nll).double()
        diff = (got - want).abs()
        ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp(min=1e-38))) - 7)
        if not bool((diff <= ulp).all()):
            fail(f"cross_entropy_bwd {what}: {int((diff > ulp).sum())} elements beyond one bf16 "
                 "ulp of the plain version's")
        bwd_err = float(diff.max())
        del got, want, diff, ulp
        fwd_ms = cuda_ms(lambda: cross_entropy_fwd(x, lab), iters)
        bwd_ms = cuda_ms(lambda: cross_entropy_bwd(x, lab, lse, g_lse, g_nll), iters)
        plain_fwd_ms = cuda_ms(lambda: cross_entropy_ref(x, lab), CE_PLAIN_ITERS)
        plain_bwd_ms = cuda_ms(lambda: cross_entropy_bwd_ref(x, lab, lse, g_lse, g_nll),
                               CE_PLAIN_ITERS)
    lab64 = lab.long()
    lib_fwd_ms = cuda_ms(lambda: F.cross_entropy(x.float(), lab64, reduction="none"),
                         CE_PLAIN_ITERS)
    xr = x.detach().requires_grad_()
    out = F.cross_entropy(xr.float(), lab64, reduction="none")
    lib_bwd_ms = cuda_ms(lambda: torch.autograd.grad(out, xr, g_nll, retain_graph=True),
                         CE_PLAIN_ITERS)
    del out, xr
    e = 2  # bf16
    common = dict(route="cuda", source="src/repro_torch/csrc/cross_entropy.cu",
                  shape={"rows": N, "vocab": V, "dtype": "bfloat16"}, what=what,
                  tolerance=f"lse and nll within {CE_TOL} of their largest magnitude; the "
                            "gradient within one bf16 ulp of the plain version's",
                  library_call='F.cross_entropy(logits.float(), labels, reduction="none"): the '
                               "nll alone, no lse; its backward through the float() cast")
    return [
        kernel_entry("cross_entropy_fwd", replaces="none: XLA's fusion of "
                     "src/repro/training/train_step.py:46-53 cross_entropy (astype(f32), "
                     "jax.nn.logsumexp, take_along_axis)",
                     launches=launches["cross_entropy_fwd"], err=fwd_err, ms=fwd_ms,
                     plain_ms=plain_fwd_ms, bytes_=N * V * e, ops=CE_OPS_PER_ELEMENT * N * V,
                     library_ms=lib_fwd_ms, plain_call="cross_entropy_ref(logits, labels)",
                     **common),
        kernel_entry("cross_entropy_bwd", replaces="none: the VJP JAX's autodiff takes of that "
                     "composition into the logits",
                     launches=launches["cross_entropy_bwd"], err=bwd_err, ms=bwd_ms,
                     plain_ms=plain_bwd_ms, bytes_=2 * N * V * e, ops=CE_OPS_PER_ELEMENT * N * V,
                     library_ms=lib_bwd_ms,
                     plain_call="cross_entropy_bwd_ref(logits, labels, lse, g_lse, g_nll)",
                     **common),
    ]


def train_svc_captures() -> dict:
    """CallCaptures of the functions through which the loss view reaches
    its kernels: ``apply_hash``'s ``hash_threshold_mask`` (hash_threshold),
    the group-by's ``segment_groupby`` (segment_aggsum) and the query
    engine's ``multi_agg_moments`` (multi_agg, one- and two-sided)."""
    from repro_torch.core import hashing
    from repro_torch.query import engine
    from repro_torch.relational import ops

    return {"hash_threshold": CallCapture(hashing, "hash_threshold_mask"),
            "segment_aggsum": CallCapture(ops, "segment_groupby"),
            "multi_agg": CallCapture(engine, "multi_agg_moments")}


def hold_groupby(got, gid, vals, G, what) -> float:
    """segment_groupby's (counts, sums) on (gid, vals, G): counts equal the
    plain version's and the exact counts; the kernel's sums (each group's
    float64 sum rounded once) within F64_SUM_RTOL·Σ|x| of the float64 sums,
    the plain version's (float32, row order) within γ_{n−1}·Σ|x|.  Returns
    max |kernel − plain| over the sums."""
    import torch

    from repro_torch.kernels.segment_aggsum import segment_groupby_ref

    counts, sums = got
    pc, ps = segment_groupby_ref(gid, vals, G)
    keep = (gid >= 0) & (gid < G)
    g = torch.where(keep, gid.long(), torch.full_like(gid, G, dtype=torch.int64))
    if not (torch.equal(counts, pc) and
            torch.equal(counts.long(), torch.bincount(g, minlength=G + 1)[:G])):
        fail(f"{what}: segment_groupby's counts differ from the plain and the exact counts")
    if vals.shape[1] == 0:
        return 0.0
    exact = torch.zeros((G + 1, vals.shape[1]), dtype=torch.float64, device=gid.device).index_add_(
        0, g, vals.double())[:G]
    abs_sum = torch.zeros((G + 1, vals.shape[1]), dtype=torch.float64,
                          device=gid.device).index_add_(0, g, vals.double().abs())[:G]
    if bool(((sums.double() - exact).abs() > F64_SUM_RTOL * abs_sum).any()):
        fail(f"{what}: segment_groupby's sums beyond {F64_SUM_RTOL} of sum|x| from the float64 "
             "sums")
    rtol = torch.from_numpy(f32_sum_rtol(pc.cpu().numpy())).to(gid.device)[:, None]
    if bool(((ps.double() - exact).abs() > rtol * abs_sum).any()):
        fail(f"{what}: the plain version's sums beyond gamma_(n-1)*sum|x| of the float64 sums")
    return float((sums - ps).abs().max())


def hold_train_svc_calls(caps, launches, path: str) -> dict:
    """The loss view's kernels held against their plain versions on every
    input ``path`` gave them (``caps``: train_svc_captures after the path;
    one captured call for each launch counted in ``launches``).  Returns,
    per kernel, (its captured calls, max |kernel − plain|, max relative
    error or None)."""
    import torch

    from repro_torch.kernels.hash_threshold import hash_threshold_ref
    from repro_torch.kernels.multi_agg.ref import multi_agg_ref

    def held(name, n_calls):
        if n_calls != launches[name]:
            fail(f"{path}: {n_calls} captured calls reach {name}, which launched "
                 f"{launches[name]} times")

    out = {}
    with uncounted():
        # hash_threshold, as apply_hash calls it: (cols, m, seed, valid)
        calls = caps["hash_threshold"].calls
        held("hash_threshold", len(calls))
        for a, got in calls:
            want = hash_threshold_ref(a["cols"], a["m"], a["seed"])
            if not torch.equal(got, want if a["valid"] is None else a["valid"] & want):
                fail(f"{path}: hash_threshold differs from its plain version")
        out["hash_threshold"] = (calls, 0.0, None)
        # segment_aggsum, as the group-by calls it: (gid, vals, num_groups)
        calls = caps["segment_aggsum"].calls
        held("segment_aggsum", len(calls))
        out["segment_aggsum"] = (calls, max(
            (hold_groupby(got, a["gid"], a["vals"], a["num_groups"], f"{path} group-by {i}")
             for i, (a, got) in enumerate(calls)), default=0.0), None)
        # multi_agg, as the query engine calls it: one-sided over a sample
        # or a view, two-sided over a correspondence panel
        sides = {"multi_agg_one": [], "multi_agg_two": []}
        for a, got in caps["multi_agg"].calls:
            sides["multi_agg_two" if a["x_old"] is not None else "multi_agg_one"].append((a, got))
        for name, calls in sides.items():
            held(name, len(calls))
            keys = MULTI_AGG_ARGS[:6] + (MULTI_AGG_ARGS[6:] if name == "multi_agg_two" else ())
            errs = [hold_moments(got, multi_agg_ref(*[a[k] for k in keys]),
                                 f"{path} {name} call {i}")
                    for i, (a, got) in enumerate(calls)]
            out[name] = (calls, max((e for e, _r in errs), default=0.0),
                         max((r for _e, r in errs), default=0.0))
    return out


def check_train_svc_kernels(caps, launches, iters) -> list:
    """The loss view's kernels held against their plain versions on every
    input ``train_path`` gave them (hold_train_svc_calls), each timed on the
    path's largest call.  A ``kernel`` line each, with the path's
    launches."""
    import torch

    from repro_torch.kernels.hash_threshold import hash_threshold, hash_threshold_ref
    from repro_torch.kernels.multi_agg.ops import multi_agg_moments, selector_indices
    from repro_torch.kernels.multi_agg.ref import multi_agg_ref
    from repro_torch.kernels.segment_aggsum import segment_groupby, segment_groupby_ref

    def timed(kernel, plain):
        return {"ms": cuda_ms(kernel, iters), "plain_ms": cuda_ms(plain, iters),
                "host_enqueue_us": host_enqueue_us(kernel, iters)}

    heldc = hold_train_svc_calls(caps, launches, "train_path")
    out = []
    with uncounted():
        calls = heldc["hash_threshold"][0]
        a, _ = max(calls, key=lambda c: c[0]["cols"][0].shape[0])
        cols, m, seed, valid = tuple(a["cols"]), float(a["m"]), int(a["seed"]), a["valid"]
        R = int(cols[0].shape[0])
        t = timed(lambda: hash_threshold(cols, m, seed, valid),
                  lambda: hash_threshold_ref(cols, m, seed) & (True if valid is None else valid))
        out.append(kernel_entry(
            "hash_threshold", "cuda", "src/repro_torch/csrc/hash_threshold.cu",
            "src/repro/kernels/hash_threshold/kernel.py:45", launches["hash_threshold"], 0.0,
            t["ms"], t["plain_ms"], bytes_=R * (4 * len(cols) + 1 + 1), ops=0,
            path="train_path", calls_held=len(calls),
            rows_per_call=[int(c[0]["cols"][0].shape[0]) for c in calls], rows=R,
            host_enqueue_us=t["host_enqueue_us"],
            entry="hash_threshold(cols, m, seed, valid), as apply_hash calls it in the loss "
                  "view's unfused clean; timed on the path's largest call",
            tolerance="equal masks on every call of the path"))

        calls, err, _ = heldc["segment_aggsum"]
        a, _ = max(calls, key=lambda c: c[0]["gid"].shape[0])
        gid, vals, G = a["gid"], a["vals"], int(a["num_groups"])
        R, C = int(gid.shape[0]), int(vals.shape[1])
        g_idx = torch.where((gid >= 0) & (gid < G), gid.long(),
                            torch.full_like(gid, G, dtype=torch.int64))
        kept = int((g_idx < G).sum())
        ones_vals = torch.cat([torch.ones_like(vals[:, :1]), vals], 1)
        t = timed(lambda: segment_groupby(gid, vals, G),
                  lambda: segment_groupby_ref(gid, vals, G))
        out.append(kernel_entry(
            "segment_aggsum", "cuda", "src/repro_torch/csrc/segment_aggsum.cu",
            "src/repro/kernels/segment_aggsum/kernel.py:48", launches["segment_aggsum"], err,
            t["ms"], t["plain_ms"], bytes_=R * 4 + kept * C * 4 + G * 4 * (1 + C),
            ops=kept * (1 + C),
            library_ms=cuda_ms(lambda: torch.zeros((G + 1, C + 1), dtype=torch.float32,
                                                   device=gid.device).index_add_(0, g_idx,
                                                                                 ones_vals),
                               iters),
            library_call="index_add_ of [1 | vals] into a (G + 1, C + 1) zeroed tensor, gid "
                         "remapped beforehand",
            path="train_path", calls_held=len(calls),
            rows_per_call=[int(c[0]["gid"].shape[0]) for c in calls], rows=R, columns=C,
            groups=G, kept_rows=kept, host_enqueue_us=t["host_enqueue_us"],
            entry="segment_groupby(gid, vals, G), as the loss view's group-bys call it; timed "
                  "on the path's largest call",
            tolerance=(f"counts equal to the plain and the exact counts; the kernel's sums within "
                       f"{F64_SUM_RTOL}*sum|x| of the float64 sums, the plain version's within "
                       "gamma_(n-1)*sum|x|; on every call of the path")))

        for name in ("multi_agg_one", "multi_agg_two"):
            calls, err, rel = heldc[name]
            two = name == "multi_agg_two"
            keys = MULTI_AGG_ARGS[:6] + (MULTI_AGG_ARGS[6:] if two else ())
            a, _ = max(calls, key=lambda c: c[0]["x_new"].shape[0])
            args = [a[k] for k in keys]
            sel_idx = a["sel_idx"]
            if sel_idx is None:
                sel_idx = selector_indices(a["sel"], a["x_new"].shape[1])
            used = int(torch.unique(sel_idx[sel_idx >= 0]).numel())
            P, Q = int(sel_idx.shape[0]) - 1, int(sel_idx.shape[1])
            R = int(a["x_new"].shape[0])
            t = timed(lambda: multi_agg_moments(*args, sel_idx=a["sel_idx"]),
                      lambda: multi_agg_ref(*args))
            out.append(kernel_entry(
                name, "cuda", "src/repro_torch/csrc/multi_agg.cu",
                "src/repro/kernels/multi_agg/kernel.py:" + ("128" if two else "159"),
                launches[name], err, t["ms"], t["plain_ms"],
                bytes_=(2 if two else 1) * R * (4 * used + 1 + 4 + 4),
                ops=R * Q * ((2 * (8 + 4 * P) + 9) if two else (8 + 4 * P)),
                path="train_path", calls_held=len(calls), rows=R, queries=Q,
                predicate_slots=P, max_rel_err=rel,
                host_enqueue_us=t["host_enqueue_us"],
                entry="multi_agg_moments as the query engine calls it (sel_idx given) for the "
                      "loss view's queries; timed on the path's largest call",
                tolerance="counts exact; moments 1e-5 relative (S_D: of S_NEW + S_OLD); on "
                          "every call of the path"))
    return out


def flash_bwd_entry(label, q, k, v, launches, iters, causal=True, window=0) -> dict:
    """The backward kernel (``flash_attention_bwd``) on (q, k, v), the
    training forward's output and log-sum-exp and a random output gradient,
    held to the plain backward (autograd through the plain version, the
    gradient the CPU takes) within FLASH_BWD_TOL relative L2 for each of
    dq, dk and dv, and timed beside it, beside the plain version in the
    kernel's form (``flash_attention_bwd_ref``, from the same output and
    log-sum-exp) and beside scaled_dot_product_attention's backward (the
    yardstick, which the port never calls: its forward graph built once,
    outside the timing; a band as an explicit boolean mask), whose distance
    from the plain backward is reported, not held.  ``launch_ms``: the
    device ms of each of the call's launches (D, the dK/dV pass, the sum of
    its row split's partials where it splits, the dQ pass) from the
    profiler's raw kernel events, null for a launch whose row the profiler
    lost in all of three profiles; ``tensor_map_us``: the host µs the call
    spent encoding its four TMA tensor maps (the wgmma route, whose one
    launch runs both passes), the median of five calls.  ``products_per_pair``: the products over the head_dim
    a kept pair takes (``ops.bwd_products``).  Launches here are not
    counted; ``launches`` is the path's."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention_bwd, flash_attention_bwd_ref
    from repro_torch.kernels.flash_attention.autograd import plain_grad
    from repro_torch.kernels.flash_attention.ops import (_dispatch, bwd_plan, bwd_products,
                                                         bwd_tensor_map_us)
    from repro_torch.kernels.flash_attention.ref import keep_mask

    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    g = torch.randn(q.shape, generator=torch.Generator(device=q.device).manual_seed(SEED),
                    device=q.device).to(q.dtype)
    tol = FLASH_BWD_TOL[str(q.dtype)]
    pl = bwd_plan(q.dtype, B, S, T, H, K, hd)
    passes = ({"D": "flash_bwd_prep", "dK/dV and dQ passes": "flash_bwd_wg"}
              if pl.route == "wgmma" else
              {"D": "flash_bwd_prep", "dK/dV pass": "flash_bwd_dkv", "dQ pass": "flash_bwd_dq"})
    if pl.kv_splits > 1:
        passes["partials' sum"] = "flash_bwd_sum"

    def rel_l2(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30))

    with uncounted():
        lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
        o = _dispatch(q, k, v, causal, window, None, 0, lse)

        def kernel():
            return flash_attention_bwd(q, k, v, o, lse, g, causal, window)

        got = kernel()
        want = plain_grad(q, k, v, g, causal, window)
        form = flash_attention_bwd_ref(q, k, v, o, lse, g, causal, window)
        torch.cuda.synchronize()
        rel = {n: rel_l2(a, b) for n, a, b in zip(("dq", "dk", "dv"), got, want)}
        if max(rel.values()) > tol:
            fail(f"flash_attention_bwd {label}: relative L2 error {rel} from the plain backward "
                 f"beyond {tol}")
        err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, want))
        form_rel = {n: rel_l2(a, b) for n, a, b in zip(("dq", "dk", "dv"), got, form)}
        ms = cuda_ms(kernel, iters)
        tmap_us = None
        if pl.route == "wgmma" and q.is_cuda:
            samples = []
            for _ in range(5):
                kernel()
                samples.append(bwd_tensor_map_us())
            tmap_us = float(np.median(samples))
        launch_ms = {n: None for n in passes}
        for _ in range(3):  # the profiler at times drops every kernel row of a call
            rows = profile_raw(kernel, top=8)["top_device"]
            for n, key in passes.items():
                hit = [r["device_ms"] for r in rows if key in r["op"]]
                if hit and launch_ms[n] is None:
                    launch_ms[n] = hit[0]
            if all(t is not None for t in launch_ms.values()):
                break
    plain_ms = cuda_ms(lambda: plain_grad(q, k, v, g, causal, window), iters)
    form_ms = cuda_ms(lambda: flash_attention_bwd_ref(q, k, v, o, lse, g, causal, window), iters)
    del form
    ins = [t.detach().transpose(1, 2).requires_grad_(True) for t in (q, k, v)]
    mask = (dict(attn_mask=keep_mask(S, T, window, device=q.device)) if causal and window
            else dict(is_causal=causal))
    out = F.scaled_dot_product_attention(*ins, enable_gqa=H != K, **mask)
    go = g.transpose(1, 2)
    lib = torch.autograd.grad(out, ins, go, retain_graph=True)
    lib_rel = {n: rel_l2(a.transpose(1, 2), b) for n, a, b in zip(("dq", "dk", "dv"), lib, want)}
    library_ms = cuda_ms(lambda: torch.autograd.grad(out, ins, go, retain_graph=True), iters)
    del lib, out, ins
    if str(q.dtype) == "torch.bfloat16" and any(rel[n] > lib_rel[n] for n in rel):
        fail(f"flash_attention_bwd {label}: relative L2 error {rel} from the plain backward "
             f"beyond SDPA's {lib_rel}")
    pairs = kept_pairs(S, T, causal, window)
    # q, o, dO read and dq written; k, v read and dk, dv written; lse read
    nbytes = (4 * q.numel() + 4 * k.numel()) * q.element_size() + 4 * lse.numel()
    return kernel_entry(
        "flash_attention_bwd", "cuda", "src/repro_torch/csrc/flash_attention_bwd.cu",
        "none: the gradient JAX's autodiff takes of its XLA attention "
        "(src/repro/models/layers.py:102 gqa_attention); the Pallas flash kernel has no VJP",
        launches, err, ms, plain_ms, bytes_=nbytes, ops=10 * B * H * hd * pairs,
        library_ms=library_ms,
        ops_per_s=BF16_OPS_PER_S if str(q.dtype) == "torch.bfloat16" else FP32_OPS_PER_S,
        shape=label, B=B, S=S, T=T, H=H, K=K, hd=hd, causal=causal, window=window,
        dtype=str(q.dtype), kept_pairs=pairs, kernel_route=pl.route,
        products_per_pair=bwd_products(pl.route),
        plan={"dq_rows": pl.dq_rows, "dq_keys": pl.dq_keys, "kv_keys": pl.kv_keys,
              "kv_rows": pl.kv_rows, "kv_cols": pl.kv_cols, "kv_splits": pl.kv_splits,
              "dq_blocks": pl.dq_blocks, "kv_blocks": pl.kv_blocks},
        launch_ms=launch_ms, tensor_map_us=tmap_us,
        rel_l2_vs_plain=rel, plain_call="autograd through flash_attention_ref (plain_grad)",
        plain_kernel_form_ms=form_ms, rel_l2_vs_plain_kernel_form=form_rel,
        library_call="torch.autograd.grad of scaled_dot_product_attention(enable_gqa"
                     + (", attn_mask=keep_mask(...))" if "attn_mask" in mask else ")"),
        library_rel_l2_vs_plain=lib_rel,
        bound_counts="bytes: q, k, v, o, dO, lse read once and dq, dk, dv written once; "
                     "operations: the five products over the kept pairs (S, dO·Vᵀ, dV, dQ, dK)",
        tolerance=f"relative L2 of each of dq, dk, dv from the plain backward <= {tol} (bf16: "
                  "the gradients rounded to bf16 and D taken from the bf16 output, and no "
                  "farther than SDPA's backward; float32: the same f32 sums in other orders)")


def train_device_vs_cpu(archs, B, S, n_steps, seed, devices=("cuda", "cpu")) -> dict:
    """Each smoke config of ``archs`` (f32, TF32 off; the encdec batches
    with a seeded frames stub), and the first again with remat="full",
    trained ``n_steps`` from one seed on ``devices[0]`` and on
    ``devices[1]`` (the CPU): loss and grad norm within TRAIN_LOSS_RTOL,
    step 1's gradients within TRAIN_GRAD_TOL of each leaf's largest
    |gradient|, all the parameters after each step within TRAIN_PARAM_TOL
    of the step's update norm (each leaf's ratio and the elements apart by
    more than lr/2 are reported); the cases of TRAIN_SMOKE_WIDE at its
    limits instead.  Beside each pair runs an ulp control, reported: the
    CPU again from masters each moved by ULP_CONTROL relative (seeded), the
    size of a sum taken in another order.  The TF32 control, the first
    config with TF32 on for ``devices[0]``'s products, is read the same way
    and held to nothing: it shows what each limit separates."""
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.models import get_model
    from repro_torch.training import AdamWConfig, init_train_state, make_train_step

    cfgs = [(a, get_smoke_config(a)) for a in archs]
    cfgs.append((archs[0], dataclasses.replace(cfgs[0][1], remat="full")))
    wide_used = set()
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=n_steps)

    def distance(params, ref, prev, lr):
        """(all leaves' error over the update's norm, the worst leaf's, the
        elements apart by more than lr/2) of ``params`` from ``ref``."""
        ref = dict(ref.named_parameters())
        worst = err2 = upd2 = 0.0
        flips = 0
        for name, p in params.named_parameters():
            q = ref[name].detach()
            diff = p.detach().cpu() - q
            upd, err = float((q - prev[name]).norm()), float(diff.norm())
            err2, upd2 = err2 + err * err, upd2 + upd * upd
            flips += int((diff.abs() > 0.5 * lr).sum())
            worst = max(worst, err / upd if upd else err)
        return (math.sqrt(err2 / upd2) if upd2 else math.sqrt(err2)), worst, flips

    def limit(arch, step, key, default):
        if (arch, step, key) in TRAIN_SMOKE_WIDE:
            wide_used.add((arch, step, key))
            return TRAIN_SMOKE_WIDE[arch, step, key]
        return default

    def compare(arch, cfg, what, hold):
        runs = []
        for dev in devices + devices[1:]:
            model = get_model(cfg, device=dev, train=True)
            runs.append([model, init_train_state(model, seed), make_train_step(model, opt),
                         TokenPipeline(PipelineConfig(cfg.vocab, S, B, seed=seed), device=dev)])
        runs[0][1].params.load_state_dict(runs[1][1].params.state_dict())
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for p in runs[2][1].params.parameters():
                p.mul_(1 + ULP_CONTROL * torch.randn(p.shape, generator=gen))
        rows = []
        for i in range(n_steps):
            prev = {n: p.detach().clone() for n, p in runs[1][1].params.named_parameters()}
            frames = (torch.randn((B, S, cfg.d_model), generator=torch.Generator().manual_seed(
                FRAMES_SEED + i)) if cfg.family == "encdec" else None)
            mets = []
            for run in runs:
                batch = run[3].batch(i)
                if frames is not None:
                    batch["frames"] = frames.to(run[0].device)
                run[1], met = run[2](run[1], batch)
                mets.append(met)
            row, limits = {"step": i + 1}, {}
            for key in ("loss", "grad_norm"):
                a, b, c = (float(m[key]) for m in mets)
                row[key] = [a, b]
                row[f"{key}_rel_diff"] = abs(a - b) / abs(b)
                row[f"{key}_ulp_control_rel_diff"] = abs(c - b) / abs(b)
                if hold:
                    tol = limits[key] = limit(arch, i + 1, key, TRAIN_LOSS_RTOL)
                    if not abs(a - b) <= tol * abs(b):
                        fail(f"train_device_vs_cpu {what} step {i + 1}: {key} {a} against the "
                             f"CPU's {b} (limit {tol} relative)")
            lr = float(mets[1]["lr"])
            whole, worst_p, flips = distance(runs[0][1].params, runs[1][1].params, prev, lr)
            ctrl = distance(runs[2][1].params, runs[1][1].params, prev, lr)
            if hold:
                tol = limits["params"] = limit(arch, i + 1, "params", TRAIN_PARAM_TOL)
                if not whole <= tol:
                    fail(f"train_device_vs_cpu {what} step {i + 1}: the parameters lie {whole} "
                         f"of the update's norm from the CPU's (limit {tol})")
            if i == 0:
                cpu = dict(runs[1][1].params.named_parameters())
                worst_g = 0.0
                for name, p in runs[0][1].params.named_parameters():
                    gs = float(cpu[name].grad.abs().max())
                    ge = float((p.grad.cpu() - cpu[name].grad).abs().max())
                    if hold and ge > TRAIN_GRAD_TOL * gs:
                        fail(f"train_device_vs_cpu {what}: {name}'s gradient {ge} from the CPU's "
                             f"beyond {TRAIN_GRAD_TOL} of its max {gs}")
                    worst_g = max(worst_g, ge / gs if gs else ge)
                row["grad_err_over_max_grad"] = worst_g
            row.update(param_err_over_update_norm=whole, worst_leaf_err_over_update_norm=worst_p,
                       elements_apart_over_half_lr=flips, ulp_control_param_err=ctrl[0],
                       limits=limits)
            if "moe_load" in mets[1]:
                row["moe_load_equal"] = bool(torch.equal(mets[0]["moe_load"].cpu(),
                                                         mets[1]["moe_load"]))
            rows.append(row)
        return rows

    out = {}
    torch.backends.cuda.matmul.allow_tf32 = False
    for arch, cfg in cfgs:
        what = f"{cfg.name} remat={cfg.remat}"
        out[what] = compare(arch, cfg, what, hold=True)
    if wide_used != set(TRAIN_SMOKE_WIDE):
        fail(f"train_device_vs_cpu: TRAIN_SMOKE_WIDE's {sorted(set(TRAIN_SMOKE_WIDE) - wide_used)}"
             " matched no run")
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        control = compare(*cfgs[0], "control", hold=False)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    return {"archs": list(out), "batch": B, "seq": S, "steps": n_steps, "runs": out,
            "control_tf32": {"arch": cfgs[0][1].name, "runs": control},
            "tolerance": f"loss and grad_norm within {TRAIN_LOSS_RTOL} relative; step 1's "
                         f"gradients within {TRAIN_GRAD_TOL} of each leaf's max |grad|; the "
                         f"parameters within {TRAIN_PARAM_TOL} of the update's norm over all "
                         f"leaves (f32, TF32 off); the (arch, step, quantity) cases at the "
                         f"limits of {TRAIN_SMOKE_WIDE}, where the CPU's own run from "
                         f"masters moved by {ULP_CONTROL} relative lies past the limit (a "
                         "row's limits); the TF32 control is read, not held"}


def train_restart(argv, seed, restored_step, device="cuda") -> dict:
    """``launch.train.main`` on ``argv`` with a checkpoint directory under
    ``build/``, under the kernel profiler: the lost host's step restores
    ``restored_step``'s checkpoint, the restored state equals the saved one
    bit for bit (every leaf, as saved and as read back), every step
    dispatched ``adamw_norm``, ``adamw_update``, ``cross_entropy_fwd`` and
    ``cross_entropy_bwd`` once and no op took its plain version, and the run ends with a finite loss.  Reports ``main``'s
    dict, its log, the profiler's ops, and the checkpoints' bytes and
    save/restore walls."""
    import io
    import tempfile

    from repro_torch import kernels
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.obs.kprof import KernelProfiler
    from repro_torch.checkpoint.manager import host_leaves
    from repro_torch.launch import train

    saved, restored, walls = {}, [], {"save_s": [], "restore_s": []}

    class Recording(CheckpointManager):
        def save(self, step, tree, extra=None):
            t0 = time.perf_counter()
            out = super().save(step, tree, extra)
            walls["save_s"].append(time.perf_counter() - t0)
            saved[step] = dict(host_leaves(tree))
            return out

        def restore(self, template, step=None):
            t0 = time.perf_counter()
            tree, extra = super().restore(template, step)
            walls["restore_s"].append(time.perf_counter() - t0)
            got, want = dict(host_leaves(tree)), saved[extra["step"]]
            same = sorted(got) == sorted(want) and all(
                np.array_equal(got[k], want[k]) for k in want)
            restored.append({"step": extra["step"], "leaves": len(got), "bit_equal": same})
            return tree, extra

    (ROOT / "build").mkdir(exist_ok=True)
    real, log = train.CheckpointManager, io.StringIO()
    train.CheckpointManager = Recording
    prof = kernels.set_profiler(KernelProfiler())
    try:
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
            with contextlib.redirect_stdout(log):
                out, wall_s = wall(lambda: train.main(
                    list(argv) + ["--ckpt", tmp, "--device", device, "--seed", str(seed)]))
            files = [p for p in Path(tmp).rglob("*") if p.is_file()]
            ckpt_bytes = sum(p.stat().st_size for p in files)
            kept = sorted(p.name for p in Path(tmp).iterdir())
    finally:
        train.CheckpointManager = real
        kernels.set_profiler(None)
    ops = prof.summary()
    for op in ADAMW_KERNELS + CE_KERNELS:
        if ops.get(op, {}).get("dispatches") != out["steps"]:
            fail(f"train_restart: under the kernel profiler {op} read {ops.get(op)}, expected "
                 f"{out['steps']} dispatches (one a step)")
    if any(st["fallbacks"] for st in ops.values()):
        fail(f"train_restart: an op took its plain version under the kernel profiler: {ops}")
    if [r["step"] for r in restored] != [restored_step]:
        fail(f"train_restart: restored {restored}, expected step {restored_step} once")
    if not all(r["bit_equal"] for r in restored):
        fail(f"train_restart: a restored state differs from the saved one: {restored}")
    if out["last_loss"] is None or not math.isfinite(out["last_loss"]):
        fail(f"train_restart: the run ended with loss {out['last_loss']}")
    return {"main": out, "wall_s": wall_s, "restores": restored, "saves": sorted(saved),
            "save_s": walls["save_s"], "restore_s": walls["restore_s"],
            "checkpoint_bytes_on_disk": ckpt_bytes, "kept": kept, "kprof": ops,
            "bytes_per_checkpoint": ckpt_bytes // max(len(kept), 1),
            "log": log.getvalue().splitlines()}


def train_phases(smi: str, device: str = "cuda", path_argv=None) -> dict:
    """train_path (gemma-2b at its published size; ``path_argv`` replaces
    its arch flags, as a CPU rehearsal's smoke config does), its flash
    ``kernel`` line at the training shape with the backward beside it, the
    loss view's kernels against their plain versions on the path's inputs,
    train_device_vs_cpu and train_restart.  Returns (the kernel lines,
    train_path's report)."""
    import torch

    argv = (("--arch", TRAIN_ARCH) if path_argv is None else tuple(path_argv)) + TRAIN_ARGV
    report, cap, launches, svc = run_train_path(argv, SEED, device=device)
    missing = [k for k in TRAIN_KERNELS if launches[k] == 0]
    if missing:
        fail(f"kernels never launched on the train path: {missing}")
    adamw_line = report.pop("adamw_kernel")
    emit({"phase": "train_path", **report, "card": smi})
    torch.cuda.empty_cache()
    q, k, v = cap.captured["train causal"]
    del cap
    lines = [flash_entry("train_path causal (layer 0, captured)", q, k, v, True,
                         launches["flash_attention"], ITERS),
             flash_bwd_entry("train_path causal (layer 0, captured)", q, k, v,
                             launches["flash_attention_bwd"], ITERS)]
    del q, k, v
    lines += check_train_svc_kernels(svc, launches, ITERS)
    lines.append(adamw_line)
    del svc
    torch.cuda.empty_cache()
    lines += ce_entries(report["batch"], report["seq"], report["vocab"], launches, ITERS,
                        f"train_path {report['arch']}", device)
    for line in lines:
        emit({"phase": "kernel", **line, "card": smi})
    torch.cuda.empty_cache()
    emit({"phase": "train_device_vs_cpu", **train_device_vs_cpu(
        TRAIN_SMOKE_ARCHS, TRAIN_SMOKE_BATCH, TRAIN_SMOKE_SEQ, TRAIN_SMOKE_STEPS, SEED,
        devices=(device, "cpu")), "card": smi})
    emit({"phase": "train_restart", **train_restart(TRAIN_RESTART_ARGV, SEED, TRAIN_RESTORED_STEP,
                                                    device=device), "card": smi})
    return lines, report


# ---------------------------------------------------------------------------
# Training the hybrid, ssm and encdec families: xlstm-1.3b and
# seamless-m4t-large-v2 at their published sizes, recurrentgemma-9b at its
# published widths and 8 layers
# ---------------------------------------------------------------------------

def family_flash_wants(family: str, S: int) -> dict:
    """FlashCapture predicates for a family's train step: the hybrid's
    banded self attention (every one of its attentions), the encoder's
    non-causal self attention (the first non-causal call of a step) and
    the cross attention (the first non-causal call after a causal one: the
    decoder's layer 0)."""
    if family == "hybrid":
        return {"hybrid banded": lambda q, k, causal, qpos: causal and q.shape[1] == S}
    if family != "encdec":
        return {}
    seen = {"causal": False}

    def cross(q, k, causal, qpos):
        seen["causal"] |= bool(causal)
        return not causal and seen["causal"]

    return {"encoder non-causal": lambda q, k, causal, qpos: not causal and not seen["causal"],
            "cross": cross}


def run_family_train(arch, n_layers, B, S, seed, device="cuda"):
    """``arch`` trained on ``device`` (bf16 compute, float32 masters, the
    config's remat) through ``make_train_step``: one warm-up step and
    TRAIN_FAMILY_STEPS timed ones on the pipeline's batches, the loss view
    ingesting every step and refreshing every TRAIN_SVC_EVERY, its
    per-domain estimates read after, every call that reached the loss
    view's kernels held against their plain versions (hold_train_svc_calls);
    then one step under the kernel profiler (every dispatch a kernel's, none
    a fallback) and one under ``torch.profiler``.  The launch counters are
    set to 0 just before the steps and read after the estimates.  Returns
    (report, FlashCapture, launches)."""
    import dataclasses as dc

    import torch

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import PipelineConfig, PipelineStats, TokenPipeline
    from repro_torch.models import get_model
    from repro_torch.models.api import param_counts
    from repro_torch.models.convert import jax_leaves
    from repro_torch.obs.kprof import KernelProfiler
    from repro_torch.training import AdamWConfig, init_train_state, make_train_step
    from repro_torch.training.train_step import cross_entropy

    published = get_config(arch)
    cfg = published if n_layers is None else dc.replace(published, n_layers=n_layers)
    model = get_model(cfg, device=device, train=True)
    pipe = TokenPipeline(PipelineConfig(vocab=cfg.vocab, seq_len=S, global_batch=B, seed=seed),
                         device=device)
    stats = PipelineStats(m=0.25, seed=seed, device=device)
    step_fn = make_train_step(model, AdamWConfig(**TRAIN_FAMILY_OPT))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state, init_s = wall(lambda: init_train_state(model, seed))
    named = [(n, p) for n, p in state.params.named_parameters()]
    n_params = sum(p.numel() for _n, p in named)
    before = {n: p.detach().flatten()[:64].clone() for n, p in named}
    frames = None
    if cfg.family == "encdec":
        frames = torch.randn((B, S, cfg.d_model), device=device,
                             generator=torch.Generator(device=device).manual_seed(FRAMES_SEED))
    box = [state]
    del state

    def batch(i):
        b = pipe.batch(i)
        if frames is not None:
            b["frames"] = frames
        return b

    def one_step(b):
        box[0], met = step_fn(box[0], b)
        return met

    def first_batch_loss():
        """The loss of batch 0 under the current parameters, no graph: it
        falls over the steps, where each step's own loss, on its own
        batch, moves by less than the batches differ."""
        b = batch(0)
        with torch.no_grad():
            return float(cross_entropy(model.forward(box[0].params, b)[0], b["labels"])[0])

    cap = FlashCapture(wants=family_flash_wants(cfg.family, S))
    svc_caps = train_svc_captures()
    slstm_cap = SLSTMCapture() if cfg.family == "ssm" else None
    n_steps = 1 + TRAIN_FAMILY_STEPS
    steps = []
    first_before = first_batch_loss()
    kernels.reset_launches()
    with cap, svc_caps["hash_threshold"], svc_caps["segment_aggsum"], svc_caps["multi_agg"]:
        for i in range(n_steps):
            b = batch(i)
            flash0, routes0 = kernels.launch_counts(), kernels.route_counts()
            with (slstm_scan_as(slstm_cap.scan()) if slstm_cap is not None and i == 0
                  else contextlib.nullcontext()):
                met, step_s = wall(lambda: one_step(b))
            flash1, routes1 = kernels.launch_counts(), kernels.route_counts()
            steps.append({"step": i + 1, "wall_s": step_s, "tok_per_s": B * S / step_s,
                          "flash_launches": flash1["flash_attention"] - flash0["flash_attention"],
                          "flash_bwd_launches": flash1["flash_attention_bwd"]
                          - flash0["flash_attention_bwd"],
                          "adamw_launches": [flash1[k] - flash0[k] for k in ADAMW_KERNELS],
                          "slstm_launches": [flash1[k] - flash0[k] for k in SLSTM_KERNELS],
                          "slstm_routes": [{r: n - routes0[k][r] for r, n in routes1[k].items()
                                            if n != routes0[k][r]} for k in SLSTM_KERNELS],
                          "ce_launches": [flash1[k] - flash0[k] for k in CE_KERNELS],
                          **{k: float(met[k]) for k in ("loss", "grad_norm", "clip_scale", "lr")}})
            stats.ingest_step(met["domain_loss_sum"], met["domain_count"])
            if i > 0 and i % TRAIN_SVC_EVERY == 0:
                stats.svc_refresh()
        estimates = [stats.loss_estimate(d) for d in range(stats.n_domains)]
    launches = kernels.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    svc_held = {name: {"calls_held": len(calls), "max_abs_err": err, "max_rel_err": rel}
                for name, (calls, err, rel) in hold_train_svc_calls(
                    svc_caps, launches, f"train_family {cfg.name}").items()}
    del svc_caps
    losses = [s["loss"] for s in steps]
    if not all(math.isfinite(s["loss"]) and math.isfinite(s["grad_norm"]) for s in steps):
        fail(f"train_family {cfg.name}: a non-finite loss or grad norm: {steps}")
    # every decayed leaf (JAX rank >= 2: matrices and the stacked per-layer
    # vectors) must move; an undecayed one (the top-level norms) may not,
    # when the clipped step's update falls below its float32 resolution
    ranks = {n: r for n, (_k, _i, r) in jax_leaves(box[0].params).items()}
    still = [n for n, p in box[0].params.named_parameters()
             if bool(torch.equal(before[n], p.detach().flatten()[:64]))]
    if any(ranks[n] >= 2 for n in still):
        fail(f"train_family {cfg.name}: parameters did not move: {still[:8]} ({len(still)}); "
             f"steps {steps}")
    # attentions a forward: the hybrid's one a super-block, the encoder's
    # and the decoder's self and cross; each launched again in the recompute
    attentions = {"hybrid": cfg.n_layers // 3, "ssm": 0,
                  "encdec": cfg.enc_layers + 2 * cfg.dec_layers}[cfg.family]
    per_step = attentions * (1 if cfg.remat == "none" else 2)
    if any(s["flash_launches"] != per_step for s in steps):
        fail(f"train_family {cfg.name}: flash_attention launches per step "
             f"{[s['flash_launches'] for s in steps]}, expected {per_step} (every attention "
             "and its remat recompute)")
    if any(s["flash_bwd_launches"] != attentions for s in steps):
        fail(f"train_family {cfg.name}: flash_attention_bwd launches per step "
             f"{[s['flash_bwd_launches'] for s in steps]}, expected {attentions} (one an "
             "attention)")
    adamw_per_step = check_adamw_launches(steps, len(named), f"train_family {cfg.name}")
    check_ce_launches(steps, 1, f"train_family {cfg.name}")
    # the sLSTM's kernels: a forward call a layer, twice under remat (the
    # recompute), and a backward call, each of the route's launches a call
    # (one on the resident route, S on the per-step route)
    sl_layers = cfg.n_layers // cfg.slstm_every if cfg.family == "ssm" else 0
    passes = 1 if cfg.remat == "none" else 2
    sl_calls = slstm_launches_per_call(B, S, cfg.d_model, device) if sl_layers else 0
    sl_route = slstm_route_name(B, S, cfg.d_model, device) if sl_layers else None
    slstm_per_step = [sl_layers * sl_calls * passes, sl_layers * sl_calls]
    if any(s["slstm_launches"] != slstm_per_step for s in steps):
        fail(f"train_family {cfg.name}: (slstm_fwd, slstm_bwd) launches per step "
             f"{[s['slstm_launches'] for s in steps]}, expected {slstm_per_step} ({sl_layers} "
             f"sLSTM layers x {sl_calls} launches a call, the forward {passes} times)")
    # and every one of them on the route the rule names, by the wrappers'
    # own route counters
    slstm_routes = [{sl_route: n} if n else {} for n in slstm_per_step]
    if any(s["slstm_routes"] != slstm_routes for s in steps):
        fail(f"train_family {cfg.name}: (slstm_fwd, slstm_bwd) launches by route per step "
             f"{[s['slstm_routes'] for s in steps]}, expected {slstm_routes} (the route rule's "
             f"{sl_route})")
    # one step under the kernel profiler (every dispatch synchronized)
    prof = KernelProfiler()
    kernels.set_profiler(prof)
    try:
        with uncounted():
            one_step(batch(n_steps))
    finally:
        kernels.set_profiler(None)
    ops = prof.summary()
    # one dispatch of each AdamW wrapper a step, and of the flash wrappers
    # one an attention (twice the forward's under remat)
    want_ops = {"adamw_norm": 1, "adamw_update": 1, "cross_entropy_fwd": 1,
                "cross_entropy_bwd": 1}
    if attentions:
        want_ops.update(flash_attention=per_step, flash_attention_bwd=attentions)
    if sl_layers:
        want_ops.update(slstm_fwd=sl_layers * passes, slstm_bwd=sl_layers)
    for op, got in ops.items():
        if got.get("fallbacks") != 0:
            fail(f"train_family {cfg.name}: under the kernel profiler {op} read {got}")
    for op, want in want_ops.items():
        if ops.get(op, {}).get("dispatches") != want:
            fail(f"train_family {cfg.name}: under the kernel profiler {op} read "
                 f"{ops.get(op)}, expected {want} dispatches")
    with uncounted():
        profile, profile_wall_s = wall(lambda: profile_raw(lambda: one_step(batch(n_steps + 1))))
        first_after = first_batch_loss()
    del box
    slstm_held = None
    if slstm_cap is not None:
        slstm_held = hold_slstm_layers(slstm_cap.calls, f"train_family {cfg.name}")
        if len(slstm_held) != sl_layers:
            fail(f"train_family {cfg.name}: {len(slstm_held)} sLSTM backwards captured in the "
                 f"warm-up step, expected {sl_layers}")
        del slstm_cap
    # a random xlstm deeper than one super-block amplifies a rounding some
    # 1e4-fold into its loss and gradient, in JAX too
    # (tests/torch_xlstm_train_depth.py): whether batch 0's loss falls over a
    # few steps is decided by rounding there, so xlstm's check is made on one
    # super-block (xlstm_superblock_trains), and its whole first step at full
    # depth is held against the plain loop within what rounding does
    # (hold_xlstm_step)
    chaotic = cfg.family == "ssm" and cfg.n_layers > cfg.slstm_every
    xlstm_held = None
    if chaotic:
        with uncounted():
            xlstm_held = {
                "first_step": hold_xlstm_step(model, seed, batch(0), f"train_family {cfg.name}"),
                "one_superblock": xlstm_superblock_trains(cfg, seed, batch,
                                                          f"train_family {cfg.name}", device)}
    elif not first_after < first_before:
        fail(f"train_family {cfg.name}: the first batch's loss did not fall: {first_before} "
             f"before the steps, {first_after} after; steps {steps}")
    warm = steps[1:]
    warm_s = sum(s["wall_s"] for s in warm) / len(warm)
    flops = train_flops(cfg, B, S)
    full = param_counts(published)["total"]
    report = {
        "arch": cfg.name, "family": cfg.family, "n_layers": cfg.n_layers, "params": n_params,
        "dtype": cfg.compute_dtype, "remat": cfg.remat, "batch": B, "seq": S,
        "frames": None if frames is None else list(frames.shape),
        "state_gb": 16 * n_params / 1e9,
        "reduced": None if n_layers is None else {
            "n_layers": [published.n_layers, cfg.n_layers],
            "reason": f"{published.n_layers} layers hold {16 * full / 1e9:.1f} GB of float32 "
                      f"state ({full:,} parameters, gradients, AdamW m and v), more than the "
                      f"card's 80 GB; {cfg.n_layers} layers hold {16 * n_params / 1e9:.1f} GB"},
        "steps": steps, "init_s": init_s, "warm_step_s": warm_s,
        "warm_tok_per_s": B * S / warm_s, "model_flops_per_step": flops,
        "model_flops_share_of_bf16_peak": flops / warm_s / BF16_OPS_PER_S,
        "loss_first_last": [losses[0], losses[-1]],
        "first_batch_loss_before_after": [first_before, first_after],
        "unmoved_undecayed_leaves": still,
        "peak_device_gb": peak_gb,
        "launches": launches, "flash_launches_per_step": per_step,
        "adamw_launches_per_step": 2 * adamw_per_step,
        "slstm_launches_per_step": slstm_per_step,
        "slstm_routes_ran": sorted({r for s in steps for k in s["slstm_routes"] for r in k}),
        "ce_launches_per_step": [1, 1],
        "slstm_layers_vs_plain_autograd": slstm_held,
        "xlstm_step_holds": xlstm_held,
        "kprof_step": {k: ops[k] for k in sorted(ops)},
        "svc_estimates": [{"domain": d, "estimate": e, "ci": [lo, hi]}
                          for d, (e, (lo, hi)) in enumerate(estimates)],
        "svc_kernels_vs_plain": svc_held,
        "device_busy_share_of_warm_step": profile.get("device_only_ms", 0.0) / 1e3 / warm_s,
        "step_profile": profile, "profiled_step_wall_s": profile_wall_s,
    }
    return report, cap, launches


def hold_xlstm_step(model, seed, b, what: str) -> dict:
    """xlstm's whole first train step (``make_train_step``: the forward, the
    loss, the backward and AdamW) from the masters of ``seed`` on batch
    ``b``, the sLSTM's recurrence run four ways: the kernels, the plain loop
    (``PlainScan``), and the plain loop with its outputs scaled by
    1 + XLSTM_CONTROL and by 1 − XLSTM_CONTROL (the controls).  Every loss
    and grad norm must be finite, and the kernels' loss and grad norm each
    lie within XLSTM_STEP_SPREAD times the widest distance among the plain
    loop and its controls from the plain loop's."""
    import itertools

    import torch

    from repro_torch.training import AdamWConfig, init_train_state, make_train_step

    step = make_train_step(model, AdamWConfig(**TRAIN_FAMILY_OPT))

    def first(scan):
        state = init_train_state(model, seed)
        with slstm_scan_as(scan) if scan is not None else contextlib.nullcontext():
            state, met = step(state, b)
        out = [float(met["loss"]), float(met["grad_norm"])]
        del state, met
        torch.cuda.empty_cache()
        return out

    runs = {"kernels": first(None), "plain": first(PlainScan())}
    for sign in (1.0, -1.0):
        runs[f"plain x (1 {'+' if sign > 0 else '-'} {XLSTM_CONTROL})"] = first(
            PlainScan(1.0 + sign * XLSTM_CONTROL))
    if not all(math.isfinite(v) for r in runs.values() for v in r):
        fail(f"{what}: a non-finite first-step loss or grad norm: {runs}")
    refs = [r for name, r in runs.items() if name != "kernels"]
    held = {}
    for i, q in enumerate(("loss", "grad_norm")):
        spread = max(abs(a[i] - c[i]) for a, c in itertools.combinations(refs, 2))
        dist = abs(runs["kernels"][i] - runs["plain"][i])
        held[q] = {"kernels_vs_plain": dist, "control_spread": spread}
        if not dist <= XLSTM_STEP_SPREAD * spread:
            fail(f"{what}: the first step's {q} through the kernels lies {dist} from the plain "
                 f"loop's, beyond {XLSTM_STEP_SPREAD} x the controls' spread {spread}: {runs}")
    return {"runs": {name: dict(zip(("loss", "grad_norm"), r)) for name, r in runs.items()},
            "held": held, "limit": f"{XLSTM_STEP_SPREAD} x the control spread"}


def xlstm_superblock_trains(cfg, seed, batch, what: str, device="cuda") -> dict:
    """xlstm cut to one super-block (its mLSTM layers and one sLSTM) at the
    run's widths, batches and optimizer, from the masters of ``seed``: a
    warm-up and TRAIN_FAMILY_STEPS steps through the kernels, every loss and
    grad norm finite, and batch 0's loss after them below its loss before
    (``run_family_train``'s check, at a depth where rounding does not
    decide it)."""
    import dataclasses as dc

    import torch

    from repro_torch.models import get_model
    from repro_torch.training import AdamWConfig, init_train_state, make_train_step
    from repro_torch.training.train_step import cross_entropy

    cut = dc.replace(cfg, n_layers=cfg.slstm_every)
    model = get_model(cut, device=device, train=True)
    step = make_train_step(model, AdamWConfig(**TRAIN_FAMILY_OPT))
    box = [init_train_state(model, seed)]

    def batch0_loss():
        b = batch(0)
        with torch.no_grad():
            return float(cross_entropy(model.forward(box[0].params, b)[0], b["labels"])[0])

    before = batch0_loss()
    steps = []
    for i in range(1 + TRAIN_FAMILY_STEPS):
        box[0], met = step(box[0], batch(i))
        steps.append({k: float(met[k]) for k in ("loss", "grad_norm", "clip_scale")})
    after = batch0_loss()
    del box
    torch.cuda.empty_cache()
    if not all(math.isfinite(s["loss"]) and math.isfinite(s["grad_norm"]) for s in steps):
        fail(f"{what}, {cut.n_layers} layers: a non-finite loss or grad norm: {steps}")
    if not after < before:
        fail(f"{what}, {cut.n_layers} layers: the first batch's loss did not fall: {before} "
             f"before the steps, {after} after; steps {steps}")
    return {"n_layers": cut.n_layers, "steps": steps,
            "first_batch_loss_before_after": [before, after]}


def slstm_card(device) -> int:
    """The card index of ``device`` (0 for a device without one, as the CPU
    rehearsal's)."""
    import torch

    index = torch.device(device).index
    return 0 if index is None else index


def slstm_route_name(B, S, d, device) -> str:
    """The route ``kernels/slstm``'s rule names for (B, S, d) on the card of
    ``device``."""
    from repro_torch.kernels.slstm import ops

    return ops.route_on(B, S, d, slstm_card(device))


def slstm_launches_per_call(B, S, d, device) -> int:
    """Launches of each sLSTM kernel a call at (B, S, d) on the card of
    ``device``, from the route rule: 1 resident, S per-step."""
    from repro_torch.kernels.slstm import ops

    return ops.launches_per_call(B, S, d, slstm_card(device))


def slstm_entries(B, S, d, launches, iters, device="cuda") -> list:
    """The sLSTM's kernel lines at (B, S, d), one layer: wx ~ N(0, 1) and R
    at the init scale (0.5/sqrt(d)) from SLSTM_SEED, and dhs ~ N(0, 1).
    Held: the forward (``save=True``, as every train forward calls it: hs,
    the last state and the saved gates and states) and the backward (dwx,
    dR from the kernel's saved forward) against the plain version on the
    same inputs, within SLSTM_TOL of each output's largest magnitude; and,
    where the route rule names the resident route, its every output
    ``torch.equal`` to the per-step route's on the same inputs.  Read from
    the wrappers' own counters around the held calls, and failed unless
    they are the rule's: the route each call took (``kernel_route``) and
    its launches (``launches_per_call``).
    Timed (CUDA events): each wrapper call on the rule's route (``ms``,
    ``us_per_step``) and on the per-step route (``step_route_ms``), the
    rule's call with all its launches queued before the card starts
    (``prequeued_ms``), the plain version over SLSTM_PLAIN_ITERS calls, the
    host's enqueue of a call, and one grid barrier of the resident route
    (``barrier_us``: one cooperative launch of d/16 blocks passing S − 1
    barriers and nothing else, over S − 1).  The bound:
    the larger of the operations (2·B·d·d a step for R·h, and for the
    backward's dh also the dR product, at the float32 CUDA-core peak) and
    the bytes (every input read once, R once, every output written once);
    beside it the time R takes to stream from device memory once a step,
    the price of re-reading it each step.  No PyTorch call computes the
    recurrence: ``library_ms`` is null."""
    import torch

    from repro_torch.kernels.slstm import ops, slstm_bwd, slstm_bwd_ref, slstm_fwd, slstm_scan_ref
    from repro_torch.kernels.slstm.ref import slstm_dR

    gen = torch.Generator(device=device).manual_seed(SLSTM_SEED)
    wx = torch.randn((B, S, 4 * d), generator=gen, device=device)
    R = torch.randn((4, d // 4, d), generator=gen, device=device) * (0.5 / d ** 0.5)
    dhs = torch.randn((B, S, d), generator=gen, device=device)
    route = slstm_route_name(B, S, d, device)
    per_call = slstm_launches_per_call(B, S, d, device)
    ran = {}

    def counted(wrapper, *args, **kw):
        """One call of ``wrapper`` and, in ``ran``, the route it took and
        its launches, read from the wrapper's own counters; fails unless
        they are the rule's."""
        n0, r0 = wrapper.launches, dict(wrapper.routes)
        out = wrapper(*args, **kw)
        got = {k: v - r0[k] for k, v in wrapper.routes.items() if v != r0[k]}
        n = wrapper.launches - n0
        if got != {route: per_call} or n != per_call:
            fail(f"{wrapper.__name__}: one call at (B, S, d) = ({B}, {S}, {d}) launched {n} "
                 f"kernels by route {got}; the route rule names {route}, {per_call} a call")
        ran[wrapper.__name__] = {"kernel_route": next(iter(got)), "launches_per_call": n}
        return out

    def rel(a, b):
        return float((a.double() - b.double()).abs().max() / b.double().abs().max())

    def hold(what, pairs):
        errs = {name: rel(a, b) for name, a, b in pairs}
        worst = max(errs.values())
        if not worst <= SLSTM_TOL:
            fail(f"{what}: {errs} against the plain version (limit {SLSTM_TOL} of the largest "
                 "magnitude)")
        abs_err = max(float((a.double() - b.double()).abs().max()) for _n, a, b in pairs)
        return errs, abs_err

    def same_bits(what, names, got, want):
        differ = [n for n, a, b in zip(names, got, want) if not torch.equal(a, b)]
        if differ:
            fail(f"{what}: the {route} route's {differ} differ from the per-step route's")
        return True

    with uncounted():
        hs, last, saved = counted(slstm_fwd, wx, R, save=True)
        rhs, rlast, rsaved = slstm_scan_ref(wx, R, save=True)
        fwd_errs, fwd_abs = hold("slstm_fwd", [("hs", hs, rhs)] + [
            (f"last {n}", a, b) for n, a, b in zip("hcnm", last, rlast)] + [
            (f"saved {n}", a, b) for n, a, b in zip("gcnm", saved, rsaved)])
        del rhs, rlast, rsaved
        dwx, dR = counted(slstm_bwd, dhs, R, hs, saved)
        rwx, rR = slstm_bwd_ref(dhs, R, hs, saved)
        bwd_errs, bwd_abs = hold("slstm_bwd", [("dwx", dwx, rwx), ("dR", dR, rR)])
        del rwx, rR
        fwd_equal = bwd_equal = None
        if route != "step":
            shs, slast, ssaved = ops._launch_fwd(wx, R, None, True, "step")
            fwd_equal = same_bits("slstm_fwd", ["hs", "last h", "last c", "last n", "last m",
                                                "saved g", "saved c", "saved n", "saved m"],
                                  [hs, *last, *saved], [shs, *slast, *ssaved])
            sdwx, sdR = ops._launch_bwd(dhs, R, hs, saved, "step")
            bwd_equal = same_bits("slstm_bwd", ["dwx", "dR"], [dwx, dR], [sdwx, sdR])
            del shs, slast, ssaved, sdwx, sdR
        del dwx, dR
        fwd_ms = cuda_ms(lambda: slstm_fwd(wx, R, save=True), iters)
        fwd_nosave_ms = cuda_ms(lambda: slstm_fwd(wx, R), iters)
        bwd_ms = cuda_ms(lambda: slstm_bwd(dhs, R, hs, saved), iters)
        fwd_step_ms = cuda_ms(lambda: ops._launch_fwd(wx, R, None, True, "step"), iters)
        bwd_step_ms = cuda_ms(lambda: ops._launch_bwd(dhs, R, hs, saved, "step"), iters)
        dG = slstm_bwd(dhs, R, hs, saved)[0]
        dR_ms = cuda_ms(lambda: slstm_dR(hs, dG), iters)  # the backward's product after its loop
        del dG
        barrier_us = None
        if route == "resident" and S > 1:
            barrier_us = cuda_ms(lambda: ops.barrier_probe(device, d // ops.UNIT_TILE, S - 1),
                                 iters) * 1e3 / (S - 1)
        fwd_queued_ms = prequeued_ms(lambda: slstm_fwd(wx, R, save=True), SLSTM_QUEUED_ITERS)
        bwd_queued_ms = prequeued_ms(lambda: slstm_bwd(dhs, R, hs, saved), SLSTM_QUEUED_ITERS)
        fwd_host_us = host_enqueue_us(lambda: slstm_fwd(wx, R, save=True), iters)
        bwd_host_us = host_enqueue_us(lambda: slstm_bwd(dhs, R, hs, saved), iters)
        plain_fwd_ms = cuda_ms(lambda: slstm_scan_ref(wx, R, save=True), SLSTM_PLAIN_ITERS)
        plain_bwd_ms = cuda_ms(lambda: slstm_bwd_ref(dhs, R, hs, saved), SLSTM_PLAIN_ITERS)
    f4, steps_ops = 4, 2 * B * d * d * S  # R·h over every step
    r_bytes = f4 * R.numel()
    state = f4 * B * d
    r_stream_ms = r_bytes * S / HBM_BYTES_PER_S * 1e3
    common = dict(route="cuda", source="src/repro_torch/csrc/slstm.cu", library_ms=None,
                  library_call="none: no PyTorch call computes the sLSTM's recurrence",
                  shape={"B": B, "S": S, "d": d}, barrier_us=barrier_us,
                  r_streamed_from_hbm_each_step_ms=r_stream_ms, tolerance=SLSTM_TOL)
    fwd = kernel_entry(
        "slstm_fwd", replaces="none: the forward of XLA's lax.scan at "
        "src/repro/models/xlstm.py:242-256 (the einsum with R, then _slstm_cell at :213)",
        launches=launches["slstm_fwd"], err=fwd_abs, ms=fwd_ms, plain_ms=plain_fwd_ms,
        bytes_=f4 * B * S * 4 * d + r_bytes + 4 * state + f4 * B * S * d * 4 + f4 * B * S * 4 * d,
        ops=steps_ops, rel_errs=fwd_errs, ms_without_save=fwd_nosave_ms, **ran["slstm_fwd"],
        us_per_step=fwd_ms * 1e3 / S, step_route_ms=fwd_step_ms,
        outputs_equal_to_step_route=fwd_equal,
        host_enqueue_us=fwd_host_us, ms_launches_prequeued=fwd_queued_ms,
        bound_counts="operations: 2·B·d·d a step (R·h); bytes: wx and R read, hs, the last "
                     "state and the saved gates and c, n, m written",
        plain_call="slstm_scan_ref(wx, R, save=True): the model's loop before the kernel",
        **common)
    bwd = kernel_entry(
        "slstm_bwd", replaces="none: the VJP JAX's autodiff takes of the lax.scan at "
        "src/repro/models/xlstm.py:242-256",
        launches=launches["slstm_bwd"], err=bwd_abs, ms=bwd_ms, plain_ms=plain_bwd_ms,
        bytes_=f4 * B * S * d * 2 + r_bytes + f4 * B * S * 4 * d * 2 + f4 * B * S * d * 3
        + r_bytes, ops=2 * steps_ops, rel_errs=bwd_errs, dR_product_ms=dR_ms,
        **ran["slstm_bwd"], us_per_step=(bwd_ms - dR_ms) * 1e3 / S, step_route_ms=bwd_step_ms,
        outputs_equal_to_step_route=bwd_equal,
        host_enqueue_us=bwd_host_us, ms_launches_prequeued=bwd_queued_ms,
        bound_counts="operations: 2·B·d·d a step for dg·Rᵀ and as many for dR; bytes: dhs, "
                     "hs, R, the saved gates and c, n, m read, dwx and dR written",
        plain_call="slstm_bwd_ref: the hand-derived backward in plain PyTorch, step by step",
        **common)
    return [fwd, bwd]


def train_family_phases(smi: str, device: str = "cuda", runs=TRAIN_FAMILY_RUNS) -> list:
    """``train_family`` for each of ``runs``, and the flash ``kernel`` lines
    at the new training shapes (the hybrid's banded window, the encoder's
    non-causal self attention, the cross attention), each captured on its
    path and held against the plain version, with its backward beside it.
    Returns the kernel lines."""
    import gc

    import torch

    lines = []
    for arch, n_layers, B, S in runs:
        t0 = time.perf_counter()
        report, cap, launches = run_family_train(arch, n_layers, B, S, SEED, device=device)
        want = TRAIN_KERNELS if report["family"] != "ssm" else TRAIN_SSM_KERNELS
        missing = [k for k in want if launches[k] == 0]
        if missing:
            fail(f"kernels never launched on {arch}'s train path: {missing}")
        report["phase_s"] = time.perf_counter() - t0
        emit({"phase": "train_family", **report, "card": smi})
        gc.collect()
        torch.cuda.empty_cache()
        if report["family"] == "ssm":
            from repro_torch.configs import get_config

            lines += slstm_entries(B, S, get_config(arch).d_model, launches, ITERS, device)
        if report["family"] == "encdec":  # seamless's 256,206: rows off the 16-byte grid
            from repro_torch.configs import get_config

            lines += ce_entries(B, S, get_config(arch).vocab, launches, ITERS,
                                f"train_family {arch}", device)
        for label, (q, k, v) in cap.captured.items():
            mask, causal = cap.masks[label], cap.causal[label]
            what = f"train_family {arch} {label} (layer 0, captured)"
            lines.append(flash_entry(what, q, k, v, causal, launches["flash_attention"], ITERS,
                                     mask=mask))
            lines.append(flash_bwd_entry(what, q, k, v, launches["flash_attention_bwd"], ITERS,
                                         causal, mask["window"]))
        del cap
        gc.collect()
        torch.cuda.empty_cache()
    for line in lines:
        emit({"phase": "kernel", **line, "card": smi})
    return lines


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


def run_chaos_fleet(logs, gen_s, n_views, n_videos, n_logs, n_delta, n_deletes, groups, m,
                    epochs, prices, iters, device="cuda"):
    """chaos_fleet over the host ``logs`` (generated once in ``gen_s``
    seconds and registered by every twin), then the fleet's kprof window
    on the fault-free twin (a fresh epoch's delta, one svc_refresh_many,
    one maintain of an unpinned view and two planner epochs: the second's
    fleet_moments and fleet_score dispatches are the profiler's executes,
    the first's its compiles).  Returns (the chaos report, the window)."""
    import tempfile

    import torch

    from repro_torch.kernels.fleet_score import fleet_scores
    from repro_torch.obs import load_jsonl, reconcile
    from repro_torch.obs.trace import Tracer

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
    del a
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


def register_fleet_views(target, logs, groups, m):
    """The fleet's group-by views, view i over ``logs[i]``, registered on a
    ViewManager or a ShardedFleet (which places view i on shard i mod S)."""
    from repro_torch.core import ViewDef
    from repro_torch.relational.plan import GroupByNode, Scan

    names = []
    for i, log in enumerate(logs):
        target.register_base(f"FLog{i}", log)
        plan = GroupByNode(child=Scan(f"FLog{i}", pk=("sessionId",)), keys=("videoId",),
                           aggs=(("totalBytes", "sum", "bytes"), ("visits", "count", None)),
                           num_groups=groups)
        target.register_view(ViewDef(f"fv{i}", plan), delta_bases=(f"FLog{i}",), m=m, seed=i,
                             delta_group_capacity=groups)
        names.append(f"fv{i}")
    return names


def same_fleet_views(a: dict, b: dict, what: str) -> dict:
    """``twin_samples`` of two fleets over the same rows: keys and visits
    exact; each group's totalBytes within 2·γ_{n−1}·|x| of the other's, n
    its visits.  Every bytes term is positive, so |x| (the larger of the
    two) bounds Σ|x|: each side lies within γ_{n−1}·Σ|x| of the exact sum,
    in whatever order it added (same_clean's rule)."""
    bit_equal, share = True, 0.0
    for n in a:
        for part in ("view", "sample"):
            x, y = a[n][part], b[n][part]
            if set(x) != set(y):
                fail(f"{what} {n} {part}: columns {sorted(x)} != {sorted(y)}")
            for col in x:
                if x[col].shape != y[col].shape:
                    fail(f"{what} {n} {part}: {x[col].shape[0]} != {y[col].shape[0]} rows")
                if col != "totalBytes":
                    if not np.array_equal(x[col], y[col]):
                        fail(f"{what} {n} {part}: column {col} differs")
                    continue
                if np.array_equal(x[col], y[col]):
                    continue
                bit_equal = False
                xa, ya = x[col].astype(np.float64), y[col].astype(np.float64)
                bound = 2 * f32_sum_rtol(x["visits"]) * np.maximum(np.abs(xa), np.abs(ya))
                diff = np.abs(xa - ya)
                if np.any(diff > bound):
                    fail(f"{what} {n} {part}: totalBytes beyond 2*gamma*|x| "
                         f"(max {float(diff.max()):.3e})")
                share = max(share, float(np.max(diff / np.maximum(bound, 1e-300))))
    return {"views": len(a), "floats": "bit-equal" if bit_equal else "within 2*gamma*|x|",
            "max_bound_share": share}


def same_answers(fleet, flat, names, q, what: str) -> dict:
    """Each view's ``q`` through the sharded fleet and the flat manager
    (traffic unrecorded): equal, or within CHAOS_ANSWER_RTOL of each other
    (two dashboards over samples within same_fleet_views' bound)."""
    out, worst = {}, 0.0
    for n in names:
        a = float(fleet.query(n, q, record_traffic=False).value)
        b = float(flat.query(n, q, record_traffic=False).value)
        if not (math.isfinite(a) and math.isfinite(b)):
            fail(f"{what} {n}: non-finite answer {a}, {b}")
        rel = abs(a - b) / max(abs(b), 1e-30)
        if rel > CHAOS_ANSWER_RTOL:
            fail(f"{what} {n}: sharded {a} vs flat {b} ({rel:.3e} relative)")
        worst = max(worst, rel)
        out[n] = a
    return {"answers": out, "max_rel_diff": worst}


def sharded_plan_parity(rep, flat_rep, fleet, what: str, scores_too: bool) -> dict:
    """The sharded epoch's actions against the flat planner's: the same
    (view, action, forced) and skips (the flat side's suspended views
    aside), each on its owning shard; ``scores_too``: bit-equal scores and
    predicted seconds."""
    got = sorted((a.view, a.action, a.forced) for a in rep.actions)
    want = sorted((a.view, a.action, a.forced) for a in flat_rep.actions)
    if got != want:
        fail(f"{what}: sharded actions {got} != flat {want}")
    for a in rep.actions:
        if a.shard != fleet.shard_of(a.view):
            fail(f"{what}: {a.view} acted on shard {a.shard}, owned by {fleet.shard_of(a.view)}")
        if scores_too:
            b = next(x for x in flat_rep.actions if x.view == a.view)
            if np.float32(a.score).view(np.int32) != np.float32(b.score).view(np.int32) \
                    or a.predicted_s != b.predicted_s:
                fail(f"{what}: {a.view} scored {a.score}/{a.predicted_s} s, flat "
                     f"{b.score}/{b.predicted_s} s")
    skipped = sorted(n for n in flat_rep.skipped if n not in rep.suspended)
    if sorted(rep.skipped) != skipped:
        fail(f"{what}: sharded skipped {sorted(rep.skipped)} != flat {skipped}")
    return {"actions": [(a.view, a.action, a.shard, a.forced) for a in rep.actions],
            "skipped": sorted(rep.skipped), "excluded_shards": rep.excluded_shards,
            "suspended": rep.suspended}


def run_sharded_fleet(logs, n_videos, n_logs, n_delta, groups, m, prices, n_shards, epochs,
                      lost, device="cuda", mesh=None):
    """The sharded fleet against its flat twin over the same host ``logs``.

    A ``ShardedFleet(n_shards)`` on ``device`` (with ``mesh``, shard s on
    the mesh's s-th device, each shard's panel scored there) and a flat
    ``ViewManager`` on ``device`` +
    ``MaintenancePlanner``, the fleet path's prices pinned on every cost
    model, one EpochClock, a budget that fits every view's dearer action:
    the first epoch's deltas go straight into the owning managers, and the
    preview (``execute=False``) must equal the flat plan bit for bit.  Then ``epochs`` executed epochs under a kernel
    profiler and a tracer: later deltas enter the fleet through its
    partitions; shard ``lost`` is killed before epoch 2 (the flat twin
    suspends the same views) and revived before epoch 3.  Every epoch's
    actions, the views' samples and answers are held to the flat twin's;
    the lost views serve their last answer, degraded, while their
    partitions queue; the trace and the per-shard ledger reconcile.
    Returns (report, the score combine's last input); the caller resets
    the launch counters before and reads them after."""
    import torch

    import repro_torch.distributed.fleet as fleet_mod
    from repro_torch import kernels
    from repro_torch.core import Query
    from repro_torch.data.synthetic import grow_log
    from repro_torch.distributed import ShardedFleet
    from repro_torch.obs import reconcile, trace
    from repro_torch.obs.kprof import KernelProfiler
    from repro_torch.obs.reconcile import check_shard_accounting
    from repro_torch.obs.trace import Tracer
    from repro_torch.planner import MaintenancePlanner
    from repro_torch.views import ViewManager

    n_views = len(logs)
    clock = EpochClock()
    budget_s = n_views * max(prices["clean_s"], prices["maintain_s"])
    t = {}
    flat = ViewManager(device=device, clock=clock)
    with uncounted():
        names, t["flat_register_s"] = wall(lambda: register_fleet_views(flat, logs, groups, m))
    planner = MaintenancePlanner(flat, budget_s=budget_s, age_cap_s=SHARDED_AGE_CAP_S,
                                 clock=clock)
    fleet = ShardedFleet(n_shards, budget_s=budget_s, age_cap_s=SHARDED_AGE_CAP_S,
                         clock=clock, device=device, mesh=mesh)
    # each base goes to the card once and the shards' managers share it;
    # over several cards each shard's manager copies it from the host
    home = fleet.devices[0] if len(set(fleet.devices)) == 1 else torch.device("cpu")
    _, t["sharded_register_s"] = wall(lambda: register_fleet_views(
        fleet, [log.to(home) for log in logs], groups, m))
    placement = {n: fleet.shard_of(n) for n in names}
    if sorted(set(placement.values())) != list(range(n_shards)):
        fail(f"sharded fleet: views placed on {sorted(set(placement.values()))}")
    for cm in fleet.cost_models + [planner.cost_model]:
        cm.pin_costs(refresh_s=prices["clean_s"], maintain_s=prices["maintain_s"],
                     retune_s=prices["retune_s"])
    scored = []
    real_sharded = fleet_mod.fleet_scores_sharded

    def recording(stacked, **kw):  # keeps each epoch's score-combine input
        scored.append(stacked)
        return real_sharded(stacked, **kw)

    fleet_mod.fleet_scores_sharded = recording

    def deltas(epoch):
        return [grow_log(np.random.default_rng(SHARDED_DELTA_SEED + 100 * epoch + i), n_videos,
                         n_logs + epoch * n_delta, n_delta, device=device)
                for i in range(n_views)]

    q = Query("sum", "totalBytes")
    out = {"views": n_views, "shards": n_shards, "placement": placement, "budget_s": budget_s,
           "epochs": []}
    try:
        # epoch 1's deltas straight into the owners (the preview drains nothing)
        first, t["generate_epoch1_s"] = wall(lambda: deltas(1))
        for i, d in enumerate(first):
            fleet.vm_of(names[i]).ingest(f"FLog{i}", inserts=d)
            flat.ingest(f"FLog{i}", inserts=d)
        del first
        preview, t["preview_s"] = wall(lambda: fleet.epoch_step(execute=False))
        with uncounted():
            flat_plan = planner.plan()
        out["preview"] = sharded_plan_parity(preview, flat_plan, fleet, "sharded preview", True)
        if fleet.epoch != 0:
            fail("sharded preview advanced the epoch")

        tracer, prof = Tracer(), KernelProfiler()
        before = {}
        for epoch in range(1, epochs + 1):
            clock.t = float(epoch)
            row = {"epoch": epoch}
            if epoch > 1:
                batch, row["generate_s"] = wall(lambda: deltas(epoch))
                trace.set_tracer(tracer)
                try:
                    for i, d in enumerate(batch):
                        fleet.ingest(f"FLog{i}", inserts=d, seq=epoch, key=f"e{epoch}")
                finally:
                    trace.set_tracer(None)
                with uncounted():
                    for i, d in enumerate(batch):
                        flat.ingest(f"FLog{i}", inserts=d)
                del batch
            if epoch == 2:
                fleet.kill_shard(lost)
                for n in fleet.shard_views(lost):
                    flat.health.suspend(n, RuntimeError(f"shard {lost} lost"))
            if epoch == 3:
                fleet.revive_shard(lost)
                for n in fleet.shard_views(lost):
                    flat.health.resume(n)
            trace.set_tracer(tracer)
            kernels.set_profiler(prof)
            try:
                rep, row["sharded_epoch_s"] = wall(fleet.epoch_step)
            finally:
                kernels.set_profiler(None)
                trace.set_tracer(None)
            with uncounted():
                flat_rep, row["flat_epoch_s"] = wall(planner.step)
            row.update(sharded_plan_parity(rep, flat_rep, fleet, f"sharded epoch {epoch}", False))
            row["pending_rows"] = fleet.pending_rows()
            row["forced"] = sum(a.forced for a in rep.actions)
            with uncounted():
                ans = same_answers(fleet, flat, names, q, f"sharded epoch {epoch}")
                row["answers_max_rel_diff"] = ans["max_rel_diff"]
                row["samples_vs_flat"] = same_fleet_views(
                    {n: twin_samples(fleet.vm_of(n), [n])[n] for n in names},
                    twin_samples(flat, names), f"sharded epoch {epoch}")
            lost_views = fleet.shard_views(lost)
            if epoch == 2:
                if rep.excluded_shards != [lost] or sorted(rep.suspended) != sorted(lost_views):
                    fail(f"sharded epoch 2: excluded {rep.excluded_shards}, suspended "
                         f"{rep.suspended}")
                if any(a.view in lost_views for a in rep.actions):
                    fail("sharded epoch 2: a lost view acted")
                if row["pending_rows"] != len(lost_views) * n_delta:
                    fail(f"sharded epoch 2: {row['pending_rows']} rows pending, want "
                         f"{len(lost_views) * n_delta} queued for the lost shard")
                for n in lost_views:
                    if not fleet.is_degraded(n) or ans["answers"][n] != before[n]:
                        fail(f"sharded epoch 2: lost view {n} is not serving its last sample")
                row["lost_serve_stale"] = True
            else:
                if rep.excluded_shards or fleet.degraded_views():
                    fail(f"sharded epoch {epoch}: excluded {rep.excluded_shards}, degraded "
                         f"{fleet.degraded_views()}")
                if row["pending_rows"] != 0:
                    fail(f"sharded epoch {epoch}: {row['pending_rows']} rows still pending")
            if epoch == 3:
                if not set(lost_views) <= {a.view for a in rep.actions}:
                    fail("sharded epoch 3: the drain epoch left lost views out")
                if any(ans["answers"][n] == before[n] for n in lost_views):
                    fail("sharded epoch 3: a lost view's answer did not move")
            before = dict(ans["answers"])
            out["epochs"].append(row)
    finally:
        fleet_mod.fleet_scores_sharded = real_sharded
        kernels.set_profiler(None)
        trace.set_tracer(None)
    quarantines = sum(h.failures for vm in fleet.vms for h in vm.health.views.values())
    meta = {"pending": {}, "quarantines": quarantines, "faults_injected": 0}
    shard_summary = prof.shard_summary()
    rec = reconcile(meta, list(tracer.records), shard_summary=shard_summary)
    if not rec["ok"]:
        fail(f"sharded fleet: the trace does not reconcile: {rec['problems'][:5]}")
    if check_shard_accounting(shard_summary):
        fail("sharded fleet: the per-shard kprof ledger does not add up")
    summary = prof.summary()
    for op, st in summary.items():
        if st["fallbacks"]:
            fail(f"sharded fleet: {op} took its plain version {st['fallbacks']} times")
    per_shard = shard_summary["shards"].get("fleet_score_sharded", {})
    if sorted(per_shard) != list(range(n_shards)) or \
            summary["fleet_score_sharded"]["dispatches"] != epochs:
        fail(f"sharded fleet: fleet_score_sharded's ledger {summary.get('fleet_score_sharded')}")
    out["reconcile"] = {k: rec[k] for k in ("ok", "checks", "records")}
    out["quarantine_events"] = quarantines
    out["kprof"] = {op: {k: st[k] for k in ("dispatches", "fallbacks", "compile_s", "execute_s")}
                    for op, st in summary.items()}
    out["shard_ops"] = {op: sorted(per) for op, per in shard_summary["shards"].items()}
    out["shard_devices"] = shard_devices(fleet)
    out["wall_s"] = t
    del fleet, flat, planner
    torch.cuda.empty_cache()
    return out, scored[-1]


def shard_devices(fleet) -> dict:
    """The devices that hold each shard's tensors (its bases, its views'
    materializations and samples); fails unless that is the shard's own."""
    seen = {}
    for s, vm in enumerate(fleet.vms):
        devs = {str(r.valid.device) for r in vm.base.values()}
        for mv in vm.views.values():
            devs |= {str(mv.materialized.valid.device), str(mv.clean_sample.valid.device)}
        seen[s] = sorted(devs)
        if devs and seen[s] != [str(fleet.devices[s])]:
            fail(f"sharded fleet: shard {s} on {fleet.devices[s]} holds tensors on {seen[s]}")
    return seen


def run_sharded_groupbys(n_videos, start, n_delta, groups, m, seed, n_shards, device="cuda",
                         mesh=None):
    """visitView's streaming delta (``n_delta`` sessions from ``start``,
    seed STREAM_SEED) offered in ``n_shards`` partitions of a
    PartitionedDeltaLog, drained, stacked and aggregated by both sharded
    group-bys over ``mesh`` (by default ``n_shards`` shards of the card
    ``device``); each held
    against one flat fused clean over the whole delta (counts exact) and
    every sum against the float64 sum of its kept rows (within
    γ_{n−1+S}·Σ|x|: n rows in S partial sums), and the two against each
    other.  The caller resets the launch counters before and reads them
    after."""
    import torch

    from repro_torch.core.distributed_svc import (
        make_sharded_delta_groupby,
        make_sharded_fused_delta_groupby,
        stack_shard_deltas,
    )
    from repro_torch.data.synthetic import grow_log
    from repro_torch.kernels.fused_clean.ops import fused_clean_groupby
    from repro_torch.kernels.hash_threshold.ref import hash_threshold_ref
    from repro_torch.launch.mesh import LocalMesh
    from repro_torch.relational.relation import from_columns
    from repro_torch.streaming import PartitionedDeltaLog

    t = {}
    delta, t["generate_s"] = wall(lambda: grow_log(np.random.default_rng(STREAM_SEED), n_videos,
                                                  start, n_delta, device=device))
    per = n_delta // n_shards

    def partition():
        plog = PartitionedDeltaLog("Log", n_shards)
        for s in range(n_shards):
            rows = slice(s * per, n_delta if s == n_shards - 1 else (s + 1) * per)
            plog.offer(s, inserts=from_columns(
                {c: delta.col(c)[rows] for c in delta.schema.columns}, pk=["sessionId"]), seq=0)
        drained = plog.drain()
        width = max(ins.capacity for ins, _d in drained)
        return stack_shard_deltas(drained, "videoId", ["bytes"], rows_per_shard=width), width

    ((keys, valid, values), width), t["partition_drain_stack_s"] = wall(partition)
    del delta
    if mesh is None:
        mesh = LocalMesh([torch.device(device)] * n_shards, {"data": n_shards})
    fused_fn = make_sharded_fused_delta_groupby(mesh, "data", groups, m, seed, ["bytes"])
    unfused_fn = make_sharded_delta_groupby(mesh, "data", groups, m, seed, ["bytes"])
    fused, t["sharded_fused_s"] = wall(lambda: fused_fn(keys, valid, values))
    unfused, t["sharded_unfused_s"] = wall(lambda: unfused_fn(keys, valid, values))
    with uncounted():
        (fc, fs), t["flat_fused_clean_s"] = wall(lambda: fused_clean_groupby(
            keys, values["bytes"], valid, m, seed, groups))
    keep = hash_threshold_ref((keys,), m, seed) & valid & (keys >= 0) & (keys < groups)
    g = torch.where(keep, keys.long(), torch.full_like(keys, groups, dtype=torch.int64))
    x = torch.where(keep, values["bytes"].double(), torch.zeros((), dtype=torch.float64,
                                                                device=keys.device))
    exact = torch.zeros(groups + 1, dtype=torch.float64, device=keys.device).index_add_(0, g, x)
    abs_sum = torch.zeros(groups + 1, dtype=torch.float64, device=keys.device).index_add_(
        0, g, x.abs())
    n = torch.bincount(g, minlength=groups + 1)[:groups]
    exact, abs_sum = exact[:groups], abs_sum[:groups]
    rtol = torch.from_numpy(f32_sum_rtol(n.cpu().numpy() + n_shards)).to(keys.device)
    held = {}
    for what, cnt, sums in (("sharded_fused", fused["count"], fused["bytes"]),
                            ("sharded_unfused", unfused["count"], unfused["bytes"]),
                            ("flat_fused_clean", fc, fs)):
        if not torch.equal(cnt.double(), n.double()):
            fail(f"sharded group-by {what}: counts differ from the exact counts")
        diff = (sums.double() - exact).abs()
        bound = rtol * abs_sum
        if bool((diff > bound).any()):
            fail(f"sharded group-by {what}: sums beyond gamma*sum|x| "
                 f"(max {float(diff.max()):.3e})")
        held[what] = {"max_abs_err": float(diff.max()),
                      "max_bound_share": float((diff / bound.clamp(min=1e-300)).max())}
    if not torch.equal(fused["count"], fc) or not torch.equal(unfused["count"], fc):
        fail("sharded group-by: counts differ from the flat fused clean")
    pair = (fused["bytes"].double() - unfused["bytes"].double()).abs()
    if bool((pair > 2 * rtol * abs_sum).any()):
        fail("sharded group-by: the fused and unfused sums differ beyond 2*gamma*sum|x|")
    report = {"rows": n_delta, "shards": n_shards, "rows_per_shard": width, "groups": groups,
              "devices": [str(d) for d in mesh.axis_devices("data")],
              "kept_rows": int(n.sum()), "hot_group_rows": int(n.max()), "wall_s": t,
              "vs_exact": held, "fused_vs_unfused_max_abs": float(pair.max()),
              "bit_equal_fused_unfused": bool(torch.equal(fused["bytes"], unfused["bytes"]))}
    del keys, valid, values, fused, unfused, fc, fs
    torch.cuda.empty_cache()
    return report


def check_sharded_score(stacked, launches, iters):
    """fleet_score_sharded on the sharded fleet's last (S, Vmax, F) stack:
    bit-equal to the plain score of each shard's panel."""
    import torch

    from repro_torch.kernels.fleet_score import fleet_score_ref, fleet_scores_sharded

    S, vmax, F = stacked.shape
    got = fleet_scores_sharded(stacked)
    for s in range(S):
        if not torch.equal(got[s].view(torch.int32),
                           fleet_score_ref(stacked[s].contiguous()).view(torch.int32)):
            fail(f"fleet_score_sharded differs from the plain version on shard {s}")
    flat = stacked.reshape(S * vmax, F)
    return kernel_entry(
        "fleet_score_sharded", "cuda", "src/repro_torch/csrc/fleet_score.cu",
        "src/repro/kernels/fleet_score/kernel.py:102", launches["fleet_score_sharded"], 0.0,
        cuda_ms(lambda: fleet_scores_sharded(stacked), iters),
        cuda_ms(lambda: fleet_score_ref(flat).reshape(S, vmax, -1), iters),
        bytes_=S * vmax * (F + 6) * 4, ops=45 * S * vmax, shards=S, vmax=vmax,
        jax_entry="src/repro/kernels/fleet_score/ops.py:77", tolerance="bit-equal",
    )


def stacked_score_parity(stacked, mesh, what: str) -> dict:
    """``fleet_scores_sharded`` over ``mesh`` (each shard scored on its
    device) bit-equal to the one launch over the stack on the mesh's first
    device and to the plain score of each shard's panel."""
    import torch

    from repro_torch.kernels.fleet_score import fleet_score_ref, fleet_scores_sharded

    devices = mesh.axis_devices("data")
    got = fleet_scores_sharded(stacked, mesh=mesh)
    with uncounted():
        one = fleet_scores_sharded(stacked.to(devices[0]))
    if got.device != devices[0]:
        fail(f"{what}: the gathered scores lie on {got.device}, not {devices[0]}")
    if not torch.equal(got.view(torch.int32), one.view(torch.int32)):
        fail(f"{what}: the per-device scores differ from the stacked launch")
    for s in range(stacked.shape[0]):
        want = fleet_score_ref(stacked[s].contiguous().cpu())
        if not torch.equal(got[s].cpu().view(torch.int32), want.view(torch.int32)):
            fail(f"{what}: shard {s} differs from the plain score")
    return {"shape": list(stacked.shape), "devices": [str(d) for d in devices],
            "vs_stacked_launch": "bit-equal", "vs_plain": "bit-equal"}


def hold_on_last_card(device, tol=MULTI_CARD_TOL) -> dict:
    """Every wrapper of ``tests/torch_wrapper_calls.py`` once on ``device``
    against its plain version on the CPU over the same seeded inputs:
    integer and boolean outputs exact, float outputs within ``tol`` of the
    largest magnitude (1e-4 for the attention, whose f32 sums run in
    another order).  The launches are not counted."""
    import importlib.util

    import torch

    spec = importlib.util.spec_from_file_location(
        "torch_wrapper_calls", ROOT / "tests" / "torch_wrapper_calls.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    def leaves(x):
        if isinstance(x, torch.Tensor):
            return [x]
        return [t for y in x for t in leaves(y)]

    card, cpu = mod.wrapper_calls(device), mod.wrapper_calls("cpu")
    out = {}
    with uncounted():
        for name, call in card.items():
            got, want = leaves(call()), leaves(cpu[name]())
            worst = 0.0
            for a, b in zip(got, want, strict=True):
                if a.device != torch.device(device):
                    fail(f"{name} on {device}: an output lies on {a.device}")
                a = a.cpu()
                if not b.is_floating_point():
                    if not torch.equal(a, b):
                        fail(f"{name} on {device}: differs from the plain version")
                    continue
                limit = (1e-4 if name.startswith("flash") else tol) * max(
                    1.0, float(b.abs().max()) if b.numel() else 0.0)
                err = float((a.double() - b.double()).abs().max()) if b.numel() else 0.0
                if not err <= limit:
                    fail(f"{name} on {device}: {err:.3e} from the plain version (limit "
                         f"{limit:.3e})")
                worst = max(worst, err)
            out[name] = worst
    return out


def multi_card_phase(logs, n_videos, n_logs, n_delta, groups, m, prices, epochs, lost,
                     gb_videos, gb_start, gb_delta, device="cuda") -> dict:
    """§7.5 with shard s on the mesh's s-th device, through the sharded
    fleet, ``fleet_scores_sharded`` and both sharded group-bys.

    First over ``[device] * SHARDS`` (one card: the per-device branch that
    the ``sharded_fleet`` phase, which passes no mesh, never takes); then,
    where more than one card is visible, over ``cuda:0 … cuda:S−1`` (S =
    min(SHARDS, cards)), and every wrapper once on the last card against
    its plain version.  Each run is held to the flat twin and to the
    stacked launch as ``sharded_fleet`` holds its own; its launches are
    counted from 0."""
    import torch

    from repro_torch import kernels
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import LocalMesh

    on_cuda = torch.device(device).type == "cuda"
    n_cards = torch.cuda.device_count() if on_cuda else 1
    meshes = [("one_card", LocalMesh([torch.device(device)] * SHARDS, {"data": SHARDS}))]
    if n_cards > 1:
        S = min(SHARDS, n_cards)
        meshes.append(("cross_card", LocalMesh([torch.device("cuda", i) for i in range(S)],
                                               {"data": S})))
    out = {"cards_visible": n_cards,
           "cards": [torch.cuda.get_device_name(i) for i in range(n_cards)] if on_cuda
           else ["cpu"],
           "cross_card_ran": n_cards > 1}
    if n_cards == 1:
        out["note"] = ("one card visible: the per-device branch ran with every shard on "
                       f"{meshes[0][1].devices[0]}; nothing ran across cards")
    for label, mesh in meshes:
        devices = mesh.axis_devices("data")
        if on_cuda:
            for i in range(n_cards):
                torch.cuda.reset_peak_memory_stats(i)
        kernels.reset_launches()
        t0 = time.perf_counter()
        fleet, scored = run_sharded_fleet(logs, n_videos, n_logs, n_delta, groups, m, prices,
                                          len(devices), epochs, lost, device=device, mesh=mesh)
        scores = stacked_score_parity(scored, mesh, f"{label} score combine")
        groupbys = run_sharded_groupbys(gb_videos, gb_start, gb_delta, groups, m, SEED,
                                        len(devices), device=device, mesh=mesh)
        launches = kernels.launch_counts()
        missing = [k for k in SHARDED_KERNELS if launches[k] == 0]
        if missing:
            fail(f"multi_card {label}: kernels never launched: {missing}")
        want = (epochs + 2) * len(devices)  # the preview, each epoch, the parity call
        if launches["fleet_score_sharded"] != want:
            fail(f"multi_card {label}: {launches['fleet_score_sharded']} fleet_score_sharded "
                 f"launches, want {want}: one per shard and call")
        run = {"shards": len(devices), "devices": [str(d) for d in devices],
               "shard_devices": fleet["shard_devices"],
               "epoch_s": [e["sharded_epoch_s"] for e in fleet["epochs"]],
               "flat_epoch_s": [e["flat_epoch_s"] for e in fleet["epochs"]],
               "actions": [e["actions"] for e in fleet["epochs"]],
               "preview_vs_flat": "equal", "kprof": fleet["kprof"],
               "score_combine": scores, "groupbys": groupbys, "launches": launches,
               "wall_s": time.perf_counter() - t0}
        if on_cuda:
            run["peak_device_gb"] = {f"cuda:{i}": torch.cuda.max_memory_allocated(i) / 1e9
                                     for i in range(n_cards)}
        out[label] = run
        del fleet, scored
        if on_cuda:
            torch.cuda.empty_cache()
    if n_cards > 1:
        last = torch.device("cuda", n_cards - 1)
        out["last_card"] = {"device": str(last), "max_abs_err": hold_on_last_card(last)}
    out["runtime_device_checked"] = sorted(_build._runtime_checked)
    return out


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


# ---------------------------------------------------------------------------
# The dry run: the production matrix traced on the meta device, and what it
# predicts held against the card's own train step and KV cache
# ---------------------------------------------------------------------------

def dryrun_phase(train: dict, serve: dict) -> dict:
    """``launch.dryrun.run_cell`` on the single production mesh for every
    arch at ``DRYRUN_SHAPES``, and at long_500k for the sub-quadratic ones
    (a cell in error fails the phase), with the launch counters at 0
    before and read after (the trace launches nothing); then
    the witnesses: ``trace_cell`` of ``train``'s step (``train_path``'s
    arch, batch, sequence and microbatches) on a 1×1 mesh against its
    allocated state (within DRYRUN_STATE_RTOL; the predicted arguments are
    the state and the batch), its peak, its model FLOPs and its warm wall
    (ratios, reported), and ``cache_sds`` of ``serve``'s pool against its
    allocated KV cache (exactly)."""
    from repro_torch import kernels
    from repro_torch.configs import ALL_SHAPES, ARCH_IDS, get_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.distributed import sharding
    from repro_torch.launch import dryrun, specs
    from repro_torch.launch.mesh import LocalMesh
    from repro_torch.models import get_model

    out_dir = ROOT / "build" / "dryrun_smoke"
    cells = []
    kernels.reset_launches()
    t0 = time.perf_counter()
    for arch in ARCH_IDS:
        for cell in ALL_SHAPES:
            if not (cell.name in DRYRUN_SHAPES
                    or (cell.name == "long_500k" and get_config(arch).sub_quadratic)):
                continue
            rec = dryrun.run_cell(arch, cell, False, str(out_dir))
            if rec["status"] != "ok":
                fail(f"dryrun: {arch} × {cell.name} × single: {rec['status']} "
                     f"{rec.get('error', rec.get('skip_reason'))}")
            a, mem = rec["analysis"], rec["memory_analysis"]
            cells.append({"arch": arch, "shape": cell.name, "flops_per_device": a["flops"],
                          "memory_bytes_per_device": a["memory_bytes"],
                          "argument_bytes_per_device": mem["argument_size_in_bytes"],
                          "temp_bytes_per_device": mem["temp_size_in_bytes"],
                          "collective_bytes_per_device": a["collective_bytes"],
                          "collectives": a["collectives"],
                          "loop_multipliers": a["loop_multipliers"], "trace_s": rec["trace_s"]})
    sweep_s = time.perf_counter() - t0
    launched = {k: n for k, n in kernels.launch_counts().items() if n}
    if launched:
        fail(f"dryrun: the trace on the meta device launched kernels: {launched}")
    one = LocalMesh(["meta"], {"data": 1, "model": 1})
    w = dryrun.trace_cell(get_config(train["arch"]), ShapeCell(
        "train_path", train["seq"], train["batch"], "train"), one, False, train["microbatches"])
    args_b = w["memory_analysis"]["argument_size_in_bytes"]
    state_b = train["state_allocated_bytes"]
    rel = abs(args_b - state_b) / state_b
    if rel > DRYRUN_STATE_RTOL:
        fail(f"dryrun: predicted arguments {args_b} B against the allocated state {state_b} B "
             f"({rel:.2%} apart, above {DRYRUN_STATE_RTOL:.0%})")
    peak_b = train["peak_device_gb"] * 1e9
    predicted_peak = args_b + w["memory_analysis"]["temp_size_in_bytes"]
    flops = w["analysis"]["flops"]
    serve_cell = ShapeCell("serve_path", serve["max_seq"], serve["max_batch"], "decode")
    cache, cspecs = specs.cache_sds(get_model(get_config(serve["arch"]), "meta"), serve_cell,
                                    one, False)
    cache_b = sum(s.local_bytes for s in sharding.leaves(sharding.with_sharding(cache, cspecs,
                                                                                 one)))
    kv = serve["kv_cache"]
    if not cache_b == kv["engine_tensor_bytes"] == kv["allocated_bytes"]:
        fail(f"dryrun: cache_sds {cache_b} B against the serve path's KV cache {kv}")
    return {
        "sweep": {"mesh": "single", "cells": cells, "wall_s": sweep_s, "launches": launched},
        "train_witness": {
            "arch": train["arch"], "batch": train["batch"], "seq": train["seq"],
            "microbatches": train["microbatches"], "remat": train["remat"], "trace_s": w["trace_s"],
            "predicted_argument_bytes": args_b, "allocated_state_bytes": state_b,
            "argument_rel_diff": rel,
            "predicted_temp_bytes": w["memory_analysis"]["temp_size_in_bytes"],
            "predicted_peak_bytes": predicted_peak, "measured_peak_bytes": peak_b,
            "predicted_over_measured_peak": predicted_peak / peak_b,
            "dryrun_flops": flops, "dryrun_flops_aside": w["analysis"]["flops_aside"],
            "analytic_train_flops": train["model_flops_per_step"],
            "dryrun_over_analytic_flops": flops / train["model_flops_per_step"],
            "warm_step_s": train["warm_step_s"],
            "dryrun_flops_per_s_of_warm_step": flops / train["warm_step_s"],
            "dryrun_flops_share_of_bf16_peak": flops / train["warm_step_s"] / BF16_OPS_PER_S},
        "serve_cache_witness": {"arch": serve["arch"], "max_batch": serve["max_batch"],
                                "max_seq": serve["max_seq"], "cache_sds_bytes": cache_b, **kv},
    }


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
          "per_view_clean_s": fleet["per_view_s"], "per_view_clean_warm_s": fleet["warm_view_s"],
          "planner_prices": fleet["prices"],
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
    t0 = time.perf_counter()
    # generated once on the host, registered by both chaos twins and both
    # sharded twins
    fleet_host_logs = fleet_logs(FLEET_VIEWS, FLEET_VIDEOS, FLEET_LOGS, "cpu")
    chaos_fleet, kprof_fleet = run_chaos_fleet(fleet_host_logs, time.perf_counter() - t0,
                                               FLEET_VIEWS, FLEET_VIDEOS, FLEET_LOGS, FLEET_DELTA,
                                               FLEET_DELETES, FLEET_GROUPS, M, FLEET_EPOCHS,
                                               fleet["prices"], ITERS)
    emit({"phase": "chaos_fleet", **chaos_fleet,
          "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9, "card": smi})
    emit({"phase": "kprof", "svc": kprof_svc, "fleet": kprof_fleet, "card": smi})

    # the sharded fleet (§7.5) over the same host logs, against its flat
    # twin, then the sharded group-bys on visitView's streaming delta
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    sharded, sharded_scores = run_sharded_fleet(
        fleet_host_logs, FLEET_VIDEOS, FLEET_LOGS, FLEET_DELTA, FLEET_GROUPS, M, fleet["prices"],
        SHARDS, SHARDED_EPOCHS, SHARDED_LOST)
    sharded["groupbys"] = run_sharded_groupbys(N_VIDEOS, args.n_logs + N_DELTA, N_DELTA,
                                               FLEET_GROUPS, M, SEED, SHARDS)
    sharded_launches = kernels.launch_counts()
    missing = [k for k in SHARDED_KERNELS if sharded_launches[k] == 0]
    if missing:
        fail(f"kernels never launched on the sharded fleet's path: {missing}")
    emit({"phase": "sharded_fleet", **sharded, "launches": sharded_launches,
          "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9, "card": smi})
    sharded_table = [check_sharded_score(sharded_scores, sharded_launches, ITERS)]
    del sharded_scores
    for entry in sharded_table:
        emit({"phase": "kernel", **entry, "card": smi})
    # the same paths with shard s on the mesh's s-th device: four shards of
    # this card, then, where more are visible, one shard a card
    torch.cuda.empty_cache()
    emit({"phase": "multi_card", **multi_card_phase(
        fleet_host_logs, FLEET_VIDEOS, FLEET_LOGS, FLEET_DELTA, FLEET_GROUPS, M,
        fleet["prices"], SHARDED_EPOCHS, SHARDED_LOST, N_VIDEOS, args.n_logs + N_DELTA,
        N_DELTA), "card": smi})
    del fleet_host_logs

    # the LM serving path, on a card the SVC paths have let go of
    del fleet, walls, small_fleet, small_stream
    torch.cuda.empty_cache()
    from repro_torch.configs import get_config

    prompts = serve_prompts(get_config(SERVE_ARCH).vocab, SERVE_REQUESTS, *SERVE_PROMPT_LENS, SEED)
    serve, model, params, flash, serve_launches = run_serve_path(
        get_config(SERVE_ARCH), SERVE_MAX_BATCH, SERVE_MAX_SEQ, prompts, SERVE_MAX_NEW, SERVE_TICK_CAPACITY,
        SERVE_STREAM, SEED)
    flash_inputs = flash.inputs
    del flash
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
          **serve_device_vs_cpu(SERVE_ARCH, SMOKE_PROMPT_LENS, 4, 64, 8, SEED)})

    # the moe, vlm and encdec families, each on a card the last has let go of
    torch.cuda.empty_cache()
    family_phases(smi)
    # the hybrid and ssm families
    torch.cuda.empty_cache()
    recurrent_phases(smi)
    # training, on a card the serving phases have let go of
    torch.cuda.empty_cache()
    train_lines, train_report = train_phases(smi)
    # the hybrid, ssm and encdec families' training
    torch.cuda.empty_cache()
    train_lines += train_family_phases(smi)
    # the dry run on the meta device, and its witnesses on the card
    emit({"phase": "dryrun", **dryrun_phase(train_report, serve), "card": smi})

    emit({"kernels": table + fleet_table + sharded_table + api_table + flash_table[:1]
          + train_lines})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
