#!/usr/bin/env python3
"""The smoke's serve path alone: gemma-2b at full width in bf16 through
``ServeEngine`` (16 requests on 8 slots, 32 new tokens each, telemetry into
serveView), on one GPU.  Prints one JSON line: run wall, tokens per second,
p50/p99 request latency, the wall of one warm decode call of the full pool
and its profile's launch count and self host and device milliseconds.

``--src DIR`` imports ``repro_torch`` from another checkout's ``src``
(built into that checkout's own ``build/``), so that two versions of the
package run the same scenario; unpack the other version inside this
checkout, in the git-ignored ``.trees/``, so that its build stays there
too.  Compare them only within one call, in turns (parent, change,
change, parent), since host walls vary between machines.

Run:  python3 tools/serve_bench.py [--src .trees/parent/src]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory whose repro_torch to run")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(Path(args.src).resolve()), str(ROOT)]
    import torch

    if not torch.cuda.is_available():
        print("serve_bench: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import repro_torch
    from repro_torch.configs import get_config

    cfg = get_config(cs.SERVE_ARCH)
    prompts = cs.serve_prompts(cfg.vocab, cs.SERVE_REQUESTS, *cs.SERVE_PROMPT_LENS, cs.SEED)
    report, *_ = cs.run_serve_path(cfg, cs.SERVE_MAX_BATCH, cs.SERVE_MAX_SEQ, prompts,
                                   cs.SERVE_MAX_NEW, cs.SERVE_TICK_CAPACITY, cs.SERVE_STREAM,
                                   cs.SEED)
    prof = report["decode_call_profile"]
    print(json.dumps({
        "package": str(Path(repro_torch.__file__).parent), "card": cs.nvidia_smi_line(),
        **{k: report[k] for k in ("run_s", "tok_per_s", "p50_latency_s", "p99_latency_s",
                                  "decode_calls", "decode_call_s", "peak_device_gb")},
        "flash_launches": report["launches"]["flash_attention"],
        "decode_call_self_host_ms": prof["self_cpu_ms"],
        "decode_call_device_ms": prof["self_device_ms"],
        "decode_call_runtime_calls": prof["runtime_calls"],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
