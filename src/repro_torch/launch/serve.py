"""Serving driver: continuous-batching decode on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b --smoke \
        --requests 16 --max-new 12 --device cpu

The port of ``repro.launch.serve`` for every family (``--arch
granite-moe-3b-a800m``, ``qwen2-vl-72b``, ``recurrentgemma-9b``,
``xlstm-1.3b``, ``seamless-m4t-large-v2``, …): the same flags, plus
``--device`` (the card unless the caller asks for the CPU; ``cuda:N`` runs
everything on card N), and the same returned dict.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch.mesh import device_arg, on_device
from repro_torch.models import get_model
from repro_torch.serving import Request, ServeEngine


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", type=device_arg,
                    help="cpu, cuda (the current card) or cuda:N")
    args = ap.parse_args(argv)
    with on_device(args.device):
        return _serve(args)


def _serve(args) -> dict:
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = get_model(cfg, device=args.device)
    params = model.init(args.seed)
    engine = ServeEngine(model, params, max_batch=args.max_batch, max_seq=args.max_seq)

    rng = np.random.default_rng(args.seed)
    t0 = time.time()
    for rid in range(args.requests):
        plen = int(rng.integers(4, 16))
        prompt = rng.integers(0, cfg.vocab, plen).astype(np.int32)
        engine.submit(Request(rid=rid, prompt=prompt, max_new=args.max_new))
    done = engine.run()
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    wall = time.time() - t0
    toks = sum(len(r.out_tokens) for r in done)
    lat = [r.t_done - r.t_submit for r in done if r.t_done]
    out = {
        "completed": len(done),
        "tokens": toks,
        "tok_per_s": toks / wall,
        "p50_latency_s": float(np.median(lat)) if lat else None,
        "ticks": engine.ticks,
    }
    print(f"[serve] {out}")
    return out


if __name__ == "__main__":
    main()
