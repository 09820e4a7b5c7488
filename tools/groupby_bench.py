#!/usr/bin/env python3
"""Device time of the group-by on visitView's three group-by paths, on one GPU.

Builds ``chip_smoke.py``'s visitView at full size (1M videos, 100M
sessions, a 10M-session delta; numpy, seeded) and runs ``register_view``
(the view's group-by over the Log's 150M slots), the unfused
``svc_refresh`` (the clean's delta group-by, after one fused refresh) and
``maintain_all`` (the IVM's delta group-by).  ``relational.ops.groupby``
runs between two CUDA events and inside a ``record_function`` range.  For
each step it prints the host wall after a synchronize and the group-by's
device span (the events' elapsed time, summed over its calls); then
``register_view`` and the unfused clean run once more under
``torch.profiler``, which gives the device time of the kernels inside the
group-by's range (every kernel it launches: the sort, the gathers, the
sums), of those among them that ``index_add_`` launches and of
segment_aggsum's kernel, and the whole call's kernel time.  One JSON line.

``--src DIR`` imports ``repro_torch`` from another checkout's ``src``
(built into that checkout's own ``build/``), so that two versions of the
package run the same scenario; unpack the other version inside this
checkout, in the git-ignored ``.trees/``.  Compare them only within one
call, in turns (parent, change, change, parent).

Run:  python3 tools/groupby_bench.py [--src .trees/parent/src] [--n-logs 100000000]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
RANGE = "svc::groupby"


class Spans:
    """CUDA events around every group-by call since the last ``take``."""

    def __init__(self):
        self.pairs = []

    def take(self) -> float:
        import torch

        torch.cuda.synchronize()
        ms = sum(a.elapsed_time(b) for a, b in self.pairs)
        self.pairs = []
        return ms


def timed(fn, spans: Spans) -> dict:
    """Wall and group-by device span of one call of ``fn``."""
    import torch

    spans.take()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return {"wall_s": time.perf_counter() - t0, "groupby_calls": len(spans.pairs),
            "groupby_span_ms": spans.take()}


def profiled(fn) -> dict:
    """One call of ``fn`` under the profiler: the kernels (and copies and
    memsets) that ran inside the group-by's range on the device, those of
    ``index_add_`` and segment_aggsum's kernel among them, and all."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    ranges = [e.time_range for e in cuda if e.name == RANGE]
    kernels = [e for e in cuda if e.name != RANGE]

    def inside(e):
        return any(r.start <= e.time_range.start and e.time_range.end <= r.end for r in ranges)

    def ms(events):
        return sum(e.time_range.elapsed_us() for e in events) / 1e3

    mine = [e for e in kernels if inside(e)]
    return {"groupby_ranges": len(ranges), "groupby_kernel_ms": ms(mine),
            "index_add_kernel_ms": ms(e for e in mine if "indexFunc" in e.name),
            "segment_kernel_ms": ms(e for e in mine if "segment_sorted" in e.name),
            "groupby_launches": len(mine), "call_kernel_ms": ms(kernels)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory whose repro_torch to run")
    ap.add_argument("--n-logs", type=int, default=100_000_000)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(Path(args.src).resolve()), str(ROOT)]
    import torch

    if not torch.cuda.is_available():
        print("groupby_bench: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import repro_torch
    from repro_torch.relational import ops

    inner = ops.groupby
    spans = Spans()

    def groupby(*a, **k):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with torch.profiler.record_function(RANGE):
            start.record()
            out = inner(*a, **k)
            end.record()
        spans.pairs.append((start, end))
        return out

    ops.groupby = groupby  # the plan executor calls ops.groupby
    vm, view, log, video, delta, groups = cs.build_scenario(
        cs.N_VIDEOS, args.n_logs, cs.N_DELTA, cs.M, cs.SEED, "cuda")
    vm.register_base("Log", log)
    vm.register_base("Video", video)
    report = {"package": str(Path(repro_torch.__file__).parent), "n_logs": args.n_logs,
              "delta_rows": cs.N_DELTA}

    def register():
        vm.register_view(view, delta_bases=("Log",), m=cs.M, delta_group_capacity=groups)

    report["register_view"] = timed(register, spans)
    report["register_view"]["profile"] = profiled(register)  # registers it again
    vm.ingest("Log", inserts=delta)
    vm.svc_refresh(view.name)
    unfused = lambda: vm.svc_refresh(view.name, fused=False)  # noqa: E731
    report["svc_refresh_unfused"] = timed(unfused, spans)
    report["svc_refresh_unfused"]["profile"] = profiled(unfused)
    report["maintain_all"] = timed(vm.maintain_all, spans)
    report["card"] = cs.nvidia_smi_line()
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
