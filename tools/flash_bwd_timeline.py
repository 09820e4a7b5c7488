#!/usr/bin/env python3
"""Where a block of the attention's backward spends its time, on one GPU.

Builds an instrumented copy of ``src/repro_torch/csrc/flash_attention_bwd.cu``
(under the git-ignored ``build/flash_bwd_timeline/``; the package's own
library is not touched) whose warpgroup-route launch stamps ``%globaltimer``
for every block: at its start, when its first ring slot has landed (the
prologue: barriers, the resident tiles' and first slot's TMA loads), when
its loop over the steps ends, and when its epilogue has written, beside
the SM it ran on.  Then, at the training shapes (gemma-2b's causal, the
hybrid's banded, seamless's encoder; bf16 from a seed on the card), it runs
the backward a few times and prints, for the dK/dV and the dQ blocks
apart: the mean prologue, loop and epilogue µs a block, the steps a block
and the loop's µs a step, and the idle gap between one block's end and the
next block's start on the same SM.  One JSON line per shape, the card's
name and power limit in each.  The stamps cost a few global stores a
block; the instrumented call's ms (CUDA events over 10 calls) is printed
beside the span, to hold against the package's own in
``tools/flash_bwd_bench.py``.

Run:  python3 tools/flash_bwd_timeline.py
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SHAPES = (  # label, B, S, T, H, K, hd, causal, window
    ("gemma-2b causal", 8, 512, 512, 8, 1, 256, True, 0),
    ("recurrentgemma-9b banded", 1, 4096, 4096, 16, 1, 256, True, 2048),
    ("seamless-m4t-large-v2 encoder", 8, 512, 512, 16, 16, 64, False, 0),
)
NB = 1 << 16  # blocks stamped at most

# (anchor, text put after it): the stamps, each written by thread 0 (a
# consumer in warpgroup 0, which every block has)
STAMPS = (
    ("namespace wg {\n",
     "__device__ unsigned long long g_stamp[5][%d];\n"
     "__device__ __forceinline__ unsigned long long gtime() {\n"
     "  unsigned long long t;\n"
     "  asm volatile(\"mov.u64 %%0, %%%%globaltimer;\" : \"=l\"(t));\n"
     "  return t;\n}\n" % NB),
    ("  uint8_t* sm = align1024(wg_smem);\n",
     "  if (threadIdx.x == 0 && blockIdx.x < %d) {\n"
     "    unsigned smid;\n"
     "    asm volatile(\"mov.u32 %%0, %%%%smid;\" : \"=r\"(smid));\n"
     "    g_stamp[0][blockIdx.x] = gtime();\n"
     "    g_stamp[4][blockIdx.x] = smid;\n  }\n" % NB),
    ("    hop::mbar_wait(full + st, (i / STAGES) & 1);\n",
     "    if (i == 0 && tid == 0 && blockIdx.x < %d) g_stamp[1][blockIdx.x] = gtime();\n" % NB),
)
LOOP_ENDS = ("  // dK (slot 0 of a run's partials", "  if constexpr (!SOLO) {\n    // dQ =")
BLOCK_ENDS = ("\n}\n\n// The dQ pass's shared memory", "\n}\n\n// The two passes in one launch")


def instrumented(build: Path) -> Path:
    src = ROOT / "src" / "repro_torch" / "csrc"
    shutil.rmtree(build, ignore_errors=True)
    build.mkdir(parents=True)
    for f in src.glob("*.cu*"):
        shutil.copy(f, build / f.name)
    s = (build / "flash_attention_bwd.cu").read_text()
    for anchor, text in STAMPS:
        if anchor not in s:
            raise SystemExit(f"flash_bwd_timeline: anchor {anchor!r} not in the source")
        s = s.replace(anchor, anchor + text)
    for anchor in LOOP_ENDS:
        if anchor not in s:
            raise SystemExit(f"flash_bwd_timeline: anchor {anchor!r} not in the source")
        s = s.replace(anchor, "  if (tid == 0 && blockIdx.x < %d) g_stamp[2][blockIdx.x] = "
                              "gtime();\n" % NB + anchor)
    for anchor in BLOCK_ENDS:
        if anchor not in s:
            raise SystemExit(f"flash_bwd_timeline: anchor {anchor!r} not in the source")
        s = s.replace(anchor, "\n  if (tid == 0 && blockIdx.x < %d) g_stamp[3][blockIdx.x] = "
                              "gtime();" % NB + anchor)
    s += ('\nextern "C" int svc_bwd_stamps(unsigned long long* out) {\n'
          "  return (int)cudaMemcpyFromSymbol(out, wg::g_stamp, sizeof(wg::g_stamp));\n}\n"
          'extern "C" int svc_bwd_stamps_clear() {\n'
          "  void* at = nullptr;\n"
          "  cudaError_t err = cudaGetSymbolAddress(&at, wg::g_stamp);\n"
          "  return (int)(err != cudaSuccess ? err : cudaMemset(at, 0, sizeof(wg::g_stamp)));\n}\n")
    (build / "flash_attention_bwd.cu").write_text(s)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build as B

    so = build / "libbwd_timeline.so"
    cmd = [B._nvcc(), *B.NVCC_FLAGS, "-shared", "-I", str(build), "-o", str(so),
           str(build / "flash_attention_bwd.cu"), str(build / "common.cu")]
    res = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if res.returncode:
        raise SystemExit("flash_bwd_timeline: nvcc failed\n" + res.stdout[-4000:])
    return so


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("flash_bwd_timeline: needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    so = instrumented(ROOT / "build" / "flash_bwd_timeline")
    from repro_torch.kernels import _build as B
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    from repro_torch.kernels.flash_attention.ops import _dispatch, bwd_plan

    lib = ctypes.CDLL(str(so))
    lib.svc_error_string.argtypes = [ctypes.c_int]
    lib.svc_error_string.restype = ctypes.c_char_p
    package = B.library
    dev = torch.device("cuda")
    buf = np.zeros((5, NB), np.uint64)
    for label, Bn, S, T, H, K, hd, causal, window in SHAPES:
        g = torch.Generator(device=dev).manual_seed(0)
        q, dout = (torch.randn(Bn, S, H, hd, generator=g, device=dev).bfloat16() for _ in "ab")
        k, v = (torch.randn(Bn, T, K, hd, generator=g, device=dev).bfloat16() for _ in "ab")
        lse = torch.empty(Bn, H, S, device=dev)
        B.library = package  # the forward from the package's own build
        B.function.cache_clear()
        o = _dispatch(q, k, v, causal, window, None, 0, lse)
        # the backward from the instrumented build only: a second build of
        # it loaded after the package's in one process refuses its launch
        B.library = lambda: lib
        B.function.cache_clear()
        flash_attention_bwd(q, k, v, o, lse, dout, causal, window)
        begin, done = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        begin.record()
        for _ in range(10):
            flash_attention_bwd(q, k, v, o, lse, dout, causal, window)
        done.record()
        torch.cuda.synchronize()
        call_ms = begin.elapsed_time(done) / 10
        if lib.svc_bwd_stamps_clear():
            raise SystemExit("flash_bwd_timeline: clearing the stamps failed")
        flash_attention_bwd(q, k, v, o, lse, dout, causal, window)
        torch.cuda.synchronize()
        rc = lib.svc_bwd_stamps(buf.ctypes.data_as(ctypes.c_void_p))
        if rc:
            raise SystemExit(f"flash_bwd_timeline: cudaMemcpyFromSymbol returned {rc}")
        pl = bwd_plan(q.dtype, Bn, S, T, H, K, hd)
        n_kv, n = pl.kv_blocks, pl.kv_blocks + pl.dq_blocks
        st = buf[:, :n].astype(np.int64)
        start, first, loop, end = ((st[i] - st[0].min()) / 1e3 for i in range(4))
        sm = st[4]
        # steps a block: the dK/dV block's run, the dQ block's key tiles
        from repro_torch.kernels.flash_attention.ops import wg_schedule

        kv_steps, dq_steps = wg_schedule(S, T, H // K, causal, window, False, 0, pl.kv_splits,
                                         pl.kv_keys)
        steps = {"dK/dV": np.array([len(kv_steps[k0, z]) for z in range(pl.kv_splits)
                                    for k0 in range(0, T, pl.kv_keys)]),
                 "dQ": np.array([len(v_) for v_ in dq_steps.values()])}
        units = {"dK/dV": Bn * K, "dQ": Bn * H}  # (b, kv head) and (b, head) alike
        line = {"tool": "flash_bwd_timeline", "shape": label, "route": pl.route,
                "kv_blocks": n_kv, "dq_blocks": pl.dq_blocks, "span_us": float(end.max()),
                "instrumented_ms_per_call": call_ms, "card": smi}
        for name, sl in (("dK/dV", slice(0, n_kv)), ("dQ", slice(n_kv, n))):
            ran = first[sl] >= start[sl]  # blocks with no step stamp no first tile
            pro, body = (first - start)[sl][ran], (loop - first)[sl][ran]
            line[name] = {"blocks_with_steps": int(ran.sum()),
                          "prologue_us": float(pro.mean()), "loop_us": float(body.mean()),
                          "epilogue_us": float((end - loop)[sl][ran].mean()),
                          "steps_per_block": float(steps[name][steps[name] > 0].mean()),
                          "loop_us_per_step": float(body.sum() / (steps[name].sum()
                                                                  * units[name]))}
        gaps = []
        for smid in np.unique(sm):
            idx = np.where(sm == smid)[0]
            order = np.argsort(start[idx])
            gaps += list(start[idx][order][1:] - end[idx][order][:-1])
        line["gap_between_blocks_us"] = {"mean": float(np.mean(gaps)),
                                         "max": float(np.max(gaps))}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
