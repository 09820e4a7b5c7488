#!/usr/bin/env python3
"""Warm train steps of one model on one GPU, with the optimizer's share.

The train runs of ``chip_smoke.py``: gemma-2b at its published size
(batch 8 × 512, the launcher's AdamWConfig for 6 steps: lr 3e-4, warm-up
5), xlstm-1.3b and seamless-m4t-large-v2 at their published sizes
(8 × 512) and recurrentgemma-9b at its published widths and 8 layers
(1 × 4,096), bf16 compute, float32 masters, AdamW(lr 3e-4, warm-up 1, 6
steps), weights and batches from seed 0 (seamless's frames stub from seed
1).  One warm-up step, then ``--steps`` timed ones, each a host wall after
a synchronize; around each step's ``adamw_update`` call a pair of CUDA
events gives the optimizer's device ms (the stream's time from the call's
first launch to its last, the device busy with the backward before it).
Then, unless ``--no-profile``, one more step under ``torch.profiler``
(raw kernel events): device ms and launches, the top kernels by device
time, and every sLSTM kernel's.  One JSON line a model, the card's name and power limit in it.

``--src DIR`` imports ``repro_torch`` from another checkout's ``src`` (its
kernels built into that checkout's own ``build/``), so that two versions
run the same work; unpack the other version inside this checkout, in the
git-ignored ``.trees/``.  Compare them only within one call, in turns
(parent, change, change, parent), each model in a fresh process.

Run:  python3 tools/train_step_ab.py --arch gemma-2b [--src .trees/parent/src] [--steps 5]
"""

from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
RUNS = {  # arch: (layers or None for the published depth, batch, sequence)
    "gemma-2b": (None, 8, 512),
    "xlstm-1.3b": (None, 8, 512),
    "seamless-m4t-large-v2": (None, 8, 512),
    "recurrentgemma-9b": (8, 1, 4096),
}
SEED, FRAMES_SEED = 0, 1


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def profile_step(fn, top: int = 10) -> dict:
    """One call of ``fn`` under torch.profiler, from its raw events: the
    device's kernels, copies and memsets (ms and count) and the ``top``
    by device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev_ns, calls = collections.Counter(), collections.Counter()
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            dev_ns[e.name()] += e.duration_ns()
            calls[e.name()] += 1
    return {"device_ms": sum(dev_ns.values()) / 1e6, "device_launches": sum(calls.values()),
            "top_device": [{"op": k[:120], "calls": calls[k], "device_ms": dev_ns[k] / 1e6}
                           for k in sorted(dev_ns, key=lambda k: -dev_ns[k])[:top]],
            "slstm_device": [{"op": k[:120], "calls": calls[k], "device_ms": dev_ns[k] / 1e6}
                             for k in sorted(dev_ns) if "slstm" in k]}


def run(arch: str, steps: int, profile: bool) -> dict:
    import dataclasses

    import torch

    import repro_torch.training.train_step as TS
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.models import get_model
    from repro_torch.training import AdamWConfig, init_train_state, make_train_step

    n_layers, B, S = RUNS[arch]
    cfg = get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    opt = (AdamWConfig(lr=3e-4, total_steps=6, warmup_steps=5) if arch == "gemma-2b"
           else AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=6))
    model = get_model(cfg, device="cuda", train=True)
    pipe = TokenPipeline(PipelineConfig(vocab=cfg.vocab, seq_len=S, global_batch=B, seed=SEED),
                         device="cuda")
    step_fn = make_train_step(model, opt)
    state = init_train_state(model, SEED)
    leaves = [p for p in state.params.parameters() if p.requires_grad]
    frames = None
    if cfg.family == "encdec":
        frames = torch.randn((B, S, cfg.d_model), device="cuda",
                             generator=torch.Generator(device="cuda").manual_seed(FRAMES_SEED))
    events = []
    real = TS.adamw_update

    def timed_update(*args, **kw):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(*args, **kw)
        end.record()
        events.append((start, end))
        return out

    TS.adamw_update = timed_update
    ce_events, ce_shapes = [], []
    real_ce = TS.cross_entropy

    def timed_ce(logits, labels, *args, **kw):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        if logits.requires_grad:
            logits.register_hook(lambda g: ev[3].record())
        ev[0].record()
        loss, nll = real_ce(logits, labels, *args, **kw)
        ev[1].record()
        if loss.requires_grad:
            loss.register_hook(lambda g: ev[2].record())
            ce_events.append(ev)
        ce_shapes.append((tuple(logits.shape), logits.dtype))
        return loss, nll

    TS.cross_entropy = timed_ce
    box = [state]

    def one_step(i):
        b = pipe.batch(i)
        if frames is not None:
            b["frames"] = frames
        box[0], met = step_fn(box[0], b)
        return met

    walls = []
    for i in range(1 + steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        met = one_step(i)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    optimizer_ms = [a.elapsed_time(b) for a, b in events]
    ce_ms = [(e[0].elapsed_time(e[1]), e[2].elapsed_time(e[3])) for e in ce_events]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    out = {"arch": arch, "n_layers": cfg.n_layers, "batch": B, "seq": S,
           "params": sum(p.numel() for p in leaves), "leaves": len(leaves),
           "step_s": walls, "warm_step_s": sum(walls[1:]) / steps,
           "optimizer_ms": optimizer_ms, "warm_optimizer_ms": sum(optimizer_ms[1:]) / steps,
           "ce_fwd_bwd_ms": ce_ms,
           "warm_ce_ms": sum(f + b for f, b in ce_ms[1:]) / steps,
           "loss": float(met["loss"]), "grad_norm": float(met["grad_norm"]),
           "peak_device_gb": peak_gb}
    if profile:
        out["profile"] = profile_step(lambda: one_step(1 + steps))
    TS.cross_entropy = real_ce
    out["ce_alone"] = ce_alone(real_ce, *ce_shapes[-1], cfg.vocab)
    return out


def ce_alone(ce, shape, dtype, vocab: int) -> dict:
    """One forward and backward of ``ce`` on seeded logits of ``shape`` and
    ``dtype`` and labels below ``vocab``: device launches and device ms
    under torch.profiler, and the device bytes it allocates above what was
    live before it."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    logits = torch.randn(shape, device="cuda", generator=gen).to(dtype).requires_grad_()
    labels = torch.randint(0, vocab, shape[:-1], device="cuda", generator=gen,
                           dtype=torch.int32)

    def call():
        loss, _ = ce(logits, labels)
        loss.backward()
        logits.grad = None

    call()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    call()
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    prof = profile_step(call)
    return {"shape": list(shape), "dtype": str(dtype), "device_launches": prof["device_launches"],
            "device_ms": prof["device_ms"], "peak_extra_gb": extra / 1e9,
            "top_device": prof["top_device"][:6]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the checkout's src to import repro_torch from")
    ap.add_argument("--arch", required=True, choices=sorted(RUNS))
    ap.add_argument("--steps", type=int, default=5, help="timed steps after the warm-up")
    ap.add_argument("--no-profile", action="store_true", help="skip the profiled step")
    args = ap.parse_args()
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    import torch

    if not torch.cuda.is_available():
        print("train_step_ab: needs a CUDA device", file=sys.stderr)
        return 2
    line = run(args.arch, args.steps, not args.no_profile)
    print(json.dumps({"tool": "train_step_ab", "src": str(src), **line, "card": card()}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
