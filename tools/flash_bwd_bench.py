#!/usr/bin/env python3
"""The attention's backward at the four training shapes, and the train
steps that call it, on one GPU.

For each training shape — gemma-2b's causal (8, 512, 512, 8/1, hd 256),
recurrentgemma-9b's banded (1, 4,096, 4,096, 16/1, hd 256, window 2,048),
seamless-m4t-large-v2's encoder and cross attention (8, 512, 512, 16/16,
hd 64, non-causal; two draws) — bf16 inputs from a seed on the card, the
training forward's output and log-sum-exp, and a random output gradient:
``flash_attention_bwd``'s ms (CUDA events over ``--iters`` calls after a
warm-up), each of its launches' device ms (the profiler's raw kernel
events, the largest of three profiles; null for a launch none of them
kept), SDPA's backward ms on the same inputs (the yardstick; a band as
an explicit boolean mask), the bound (bytes: q, k, v, o, dO, lse read
once, dq, dk, dv written once; operations: five products over the kept
pairs at the bf16 peak), the route and, where the package reports it,
the tensor maps' host µs.  With ``--steps``, the warm train steps that
launch it: gemma-2b (``chip_smoke.run_train_path``), seamless and the
hybrid at 8 layers (``run_family_train``), each from the same checkout's
own ``chip_smoke.py``: warm step s, tok/s, peak GB, backward launches a
step.  One JSON line per shape and per train run, the card's name and
power limit in each.

``--src DIR`` imports ``repro_torch`` from another checkout's ``src``
(its kernels built into that checkout's own ``build/``) and ``chip_smoke``
from that checkout's root, so that two versions run the same work;
unpack the other version inside this checkout, in the git-ignored
``.trees/``.  Compare them only within one call, in turns (parent,
change, change, parent), each in a fresh process.

Run:  python3 tools/flash_bwd_bench.py [--src .trees/parent/src] [--steps]
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
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
SHAPES = (  # label, B, S, T, H, K, hd, causal, window, seed
    ("gemma-2b causal", 8, 512, 512, 8, 1, 256, True, 0, 0),
    ("recurrentgemma-9b banded", 1, 4096, 4096, 16, 1, 256, True, 2048, 0),
    ("seamless-m4t-large-v2 encoder", 8, 512, 512, 16, 16, 64, False, 0, 0),
    ("seamless-m4t-large-v2 cross", 8, 512, 512, 16, 16, 64, False, 0, 1),
)


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def cuda_ms(fn, iters: int) -> float:
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


def launch_ms(fn, names) -> dict:
    """Device ms of each kernel whose name holds one of ``names``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    best = {n: None for n in names}
    for _ in range(3):  # the profiler at times drops every kernel row of a call
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        got = collections.Counter()
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                for n in names:
                    if n in e.name():
                        got[n] += e.duration_ns() / 1e6
        for n in names:
            if n in got and best[n] is None:
                best[n] = got[n]
        if all(v is not None for v in best.values()):
            break
    return best


def kept_pairs(S: int, T: int, causal: bool, window: int) -> int:
    """``chip_smoke.kept_pairs``: S·T without the causal mask, else
    Σ_i min(i + 1, window or T)."""
    if not causal:
        return S * T
    W = min(window or T, T)
    m = min(S, W)
    return m * (m + 1) // 2 + (S - m) * W


def bench_shape(label, B, S, T, H, K, hd, causal, window, seed, iters) -> dict:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention_bwd
    from repro_torch.kernels.flash_attention import ops as O
    from repro_torch.kernels.flash_attention.ops import _dispatch, bwd_plan
    from repro_torch.kernels.flash_attention.ref import keep_mask

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, S, H, hd, generator=g, device=dev).bfloat16()
    k = torch.randn(B, T, K, hd, generator=g, device=dev).bfloat16()
    v = torch.randn(B, T, K, hd, generator=g, device=dev).bfloat16()
    dout = torch.randn(B, S, H, hd, generator=g, device=dev).bfloat16()
    lse = torch.empty(B, H, S, device=dev)
    o = _dispatch(q, k, v, causal, window, None, 0, lse)

    def kernel():
        return flash_attention_bwd(q, k, v, o, lse, dout, causal, window)

    pl = bwd_plan(q.dtype, B, S, T, H, K, hd)
    ms = cuda_ms(kernel, iters)
    tmap_us = O.bwd_tensor_map_us() if hasattr(O, "bwd_tensor_map_us") else None
    names = (["flash_bwd_prep", "flash_bwd_wg"] if pl.route == "wgmma" else
             ["flash_bwd_prep" if hasattr(O, "bwd_tensor_map_us") else "flash_bwd_delta",
              "flash_bwd_dkv", "flash_bwd_dq"]) + (["flash_bwd_sum"] if pl.kv_splits > 1 else [])
    per_launch = launch_ms(kernel, names)
    ins = [t.detach().transpose(1, 2).requires_grad_(True) for t in (q, k, v)]
    mask = (dict(attn_mask=keep_mask(S, T, window, device=dev)) if causal and window
            else dict(is_causal=causal))
    out = F.scaled_dot_product_attention(*ins, enable_gqa=H != K, **mask)
    go = dout.transpose(1, 2)
    sdpa_ms = cuda_ms(lambda: torch.autograd.grad(out, ins, go, retain_graph=True), iters)
    pairs = kept_pairs(S, T, causal, window)
    nbytes = (4 * q.numel() + 4 * k.numel()) * 2 + 4 * lse.numel()
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 10 * B * H * hd * pairs / BF16_OPS_PER_S * 1e3
    return {"shape": label, "B": B, "S": S, "T": T, "H": H, "K": K, "hd": hd, "causal": causal,
            "window": window, "route": pl.route, "kv_splits": pl.kv_splits, "ms": ms,
            "launch_ms": per_launch, "tensor_map_us": tmap_us, "sdpa_ms": sdpa_ms,
            "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops
            else "operations"}


def bench_steps() -> list:
    import gc

    import torch

    import chip_smoke as C

    out = []
    report, cap, launches, svc = C.run_train_path(("--arch", C.TRAIN_ARCH) + C.TRAIN_ARGV, C.SEED)
    out.append({"train": C.TRAIN_ARCH, "warm_step_s": report["warm_step_s"],
                "warm_tok_per_s": report["warm_tok_per_s"],
                "peak_device_gb": report["peak_device_gb"],
                "bwd_launches_per_step": [s.get("flash_bwd_launches") for s in report["steps"]]})
    del report, cap, launches, svc
    for arch, n_layers, B, S in C.TRAIN_FAMILY_RUNS[1:]:
        gc.collect()
        torch.cuda.empty_cache()
        report, cap, launches = C.run_family_train(arch, n_layers, B, S, C.SEED)
        out.append({"train": arch, "n_layers": report["n_layers"],
                    "warm_step_s": report["warm_step_s"],
                    "warm_tok_per_s": report["warm_tok_per_s"],
                    "peak_device_gb": report["peak_device_gb"],
                    "bwd_launches_per_step": [s.get("flash_bwd_launches")
                                              for s in report["steps"]]})
        del report, cap, launches
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the checkout's src to import repro_torch from")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--steps", action="store_true", help="also time the train steps")
    args = ap.parse_args()
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src.parent))
    sys.path.insert(0, str(src))
    import torch

    if not torch.cuda.is_available():
        print("flash_bwd_bench: needs a CUDA device", file=sys.stderr)
        return 2
    smi = card()
    t0 = time.perf_counter()
    for shape in SHAPES:
        line = bench_shape(*shape, args.iters)
        print(json.dumps({"tool": "flash_bwd_bench", "src": str(src), **line, "card": smi}),
              flush=True)
    if args.steps:
        for line in bench_steps():
            print(json.dumps({"tool": "flash_bwd_bench", "src": str(src), **line,
                              "card": smi}), flush=True)
    print(json.dumps({"tool": "flash_bwd_bench", "src": str(src),
                      "wall_s": time.perf_counter() - t0, "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
