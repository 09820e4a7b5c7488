#!/usr/bin/env python3
"""Host enqueue of two versions of a kernel wrapper, in turns, in one process.

Loads another checkout's ``kernels/<name>/ops.py`` and ``kernels/_build.py``
(``--parent``, e.g. a ``git archive`` of the parent commit unpacked into
the git-ignored ``.trees/parent``) as modules of their own: the wrapper's
code, its device handling and its kernel library (built from that
checkout's ``csrc/`` into its own ``build/``) are that checkout's, and
every other name it imports resolves to this checkout's ``repro_torch``
(plain versions, hashing, the profiler hook).  So the two versions differ
in the wrapper's Python, ``_build``'s and the C launcher's host code, and
run the same kernels.  Both libraries build first, in parallel.  Both run
on the same inputs: ``hash_threshold``
over the 1,500,000-row key column of visitView's view (137,800 valid keys,
as ``tools/kernel_profile.py`` builds it) and ``fleet_scores`` on a (16, 13)
feature panel, with no kernel profiler installed.  For each wrapper it
times ``--rounds`` rounds of four loops of ``--iters`` calls back to back
(parent, change, change, parent), and prints one JSON line: each
version's median and every loop's mean host µs per call, and the median
of the per-round differences (change − parent).  The last line is the
card's name and power limit.

``--fleet-score`` adds the planner's score and where fleet_score's time
goes (ROADMAP A′.8), each line a JSON object:

* ``planner score``: a (16, 13) numpy panel to numpy scores, the parent's
  composition (a pageable copy to the card, the parent's ``fleet_scores``,
  ``.cpu()``) against the change's staged ``fleet_scores_host``, in turns
  as above;
* ``dispatch``: the wall of one dispatch under a ``KernelProfiler``
  (kprof's ``execute_s`` a dispatch), for the parent's device-panel call
  and the change's staged call, with the card idle before each dispatch
  and behind a queue (a spin kernel of ``--queue-us`` µs enqueued just
  before), in turns; beside them, with no profiler, a call back to back
  (enqueue), a call then ``torch.cuda.synchronize()``, the synchronize
  alone on an idle card, the kernel's device µs by events, and kprof's
  own cost (a dispatch of a function that does nothing);
* ``stretches``: ``--rounds`` rounds of loops of the parent's
  ``fleet_scores`` and of its pieces (``torch.empty`` of the output, the
  raw ctypes launch into a fixed output, the device-panel wrapper whole),
  each loop's mean host µs, so that a slow stretch shows in the pieces
  it touches; once before the A/B loops above and once at the end.
  ``fleet_scores``'s own A/B loops sit between the two.

``--pin-table`` adds ``pin_table`` (``kernels/outlier_member``) at
visitView's pin arena (1,500,000 slots, 104 of them valid, one key
column): the tables held equal, one call's host µs in turns as above
(each call ends with the wrapper's host read), and the pin-table
kernel's device µs a call by ``torch.profiler``, in turns (parent,
change, change, parent) over ``--device-rounds`` rounds, there and at a
4,096-slot arena with as many valid slots.  Here each checkout's kernel
is its own: the two libraries are built from the two ``csrc/`` trees, so
the device µs compare the two kernels.

Run on a machine with a card, from the repository root:

    python3 tools/enqueue_ab.py --parent .trees/parent/src [--rounds 25] [--iters 200]
                                [--fleet-score [--queue-us 50]]
                                [--pin-table [--device-rounds 5]]
"""

from __future__ import annotations

import argparse
import concurrent.futures
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SENTINEL = np.iinfo(np.int32).max


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_parent(parent_src: Path, name: str, build):
    """The other checkout's ``kernels/<name>/ops.py`` as a module of its
    own, launching through ``build`` (that checkout's ``_build``)."""
    mod = load_module(parent_src / "repro_torch" / "kernels" / name / "ops.py",
                      f"parent_{name}_ops")
    mod.B = build
    return mod


def loop_us(fn, iters: int) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return us


def ab(what: str, parent, change, rounds: int, iters: int) -> None:
    for fn in (parent, change):
        for _ in range(3):
            fn()
    runs = {"parent": [], "change": []}
    diffs = []
    for _ in range(rounds):
        p1, c1, c2, p2 = (loop_us(f, iters) for f in (parent, change, change, parent))
        runs["parent"] += [p1, p2]
        runs["change"] += [c1, c2]
        diffs.append((c1 + c2 - p1 - p2) / 2)
    print(json.dumps({
        "wrapper": what,
        "parent_median_us": statistics.median(runs["parent"]),
        "change_median_us": statistics.median(runs["change"]),
        "median_round_diff_us": statistics.median(diffs),
        "rounds": rounds, "iters": iters, "runs_us": runs,
    }), flush=True)


def events_us(fn, iters: int) -> float:
    """Mean device µs of ``fn`` over ``iters`` calls, by CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters * 1e3


def one_call_us(fn, iters: int, queue_cycles: int = 0) -> float:
    """Median host µs of one call of ``fn`` from an idle card (or, with
    ``queue_cycles``, just after a spin kernel of that many cycles was
    enqueued), each call alone."""
    import torch

    runs = []
    for _ in range(iters):
        torch.cuda.synchronize()
        if queue_cycles:
            torch.cuda._sleep(queue_cycles)
        t0 = time.perf_counter()
        fn()
        runs.append((time.perf_counter() - t0) * 1e6)
        torch.cuda.synchronize()
    return statistics.median(runs)


def profiled_us(op: str, fn, iters: int, queue_cycles: int = 0) -> float:
    """Median wall µs of one dispatch of ``op`` under a fresh
    ``KernelProfiler`` (its ``execute_s`` a dispatch, the first dispatch,
    a compile, left out), each from an idle card or behind a queue."""
    import torch

    from repro_torch.obs.kprof import KernelProfiler, set_profiler

    runs = []
    prof = set_profiler(KernelProfiler())
    try:
        fn()  # the compile
        for _ in range(iters):
            torch.cuda.synchronize()
            if queue_cycles:
                torch.cuda._sleep(queue_cycles)
            before = prof.summary()[op]["execute_s"]
            fn()
            runs.append((prof.summary()[op]["execute_s"] - before) * 1e6)
    finally:
        set_profiler(None)
    torch.cuda.synchronize()
    return statistics.median(runs)


def spin_cycles(us: float) -> int:
    """Cycles of ``torch.cuda._sleep`` that take about ``us`` µs here."""
    import torch

    probe = 1_000_000
    ms = events_us(lambda: torch.cuda._sleep(probe), 5) / 1e3
    return int(probe * us / (ms * 1e3))


def fleet_score_report(old_f, feats, panel, rounds: int, iters: int, queue_us: float) -> None:
    """``--fleet-score``: the planner's score in turns, the dispatch's
    parts and the enqueue's stretches (the module's docstring)."""
    import torch

    from repro_torch.kernels.fleet_score import ops as fleet_score_ops
    from repro_torch.obs.kprof import KernelProfiler

    dev = feats.device
    new_f = fleet_score_ops.fleet_scores_host
    parent_trip = lambda: old_f(torch.from_numpy(panel).to(dev)).cpu().numpy()  # noqa: E731
    if not np.array_equal(parent_trip().view(np.int32), new_f(panel, dev).view(np.int32)):
        raise SystemExit("enqueue_ab: the planner's scores differ between the versions")
    ab(f"planner score V={panel.shape[0]}: copy, fleet_scores, copy back | fleet_scores_host",
       parent_trip, lambda: new_f(panel, dev), rounds, iters)

    cycles = spin_cycles(queue_us)
    calls = {"parent device panel": (lambda: old_f(feats)),
             "parent planner score": parent_trip,
             "change staged": (lambda: new_f(panel, dev))}
    noop = KernelProfiler()
    prof_cost = []
    for _ in range(iters):
        t0 = time.perf_counter()
        noop.call("noop", lambda: None)
        prof_cost.append((time.perf_counter() - t0) * 1e6)
    dispatch = {"queue_us": queue_us, "kprof_noop_dispatch_us": statistics.median(prof_cost),
                "sync_idle_us": one_call_us(torch.cuda.synchronize, iters),
                "events_back_to_back_us": events_us(lambda: old_f(feats), iters),
                "kernel_device_us": kernel_device_us(lambda: old_f(feats), "fleet_score", iters),
                "staged_kernel_device_us": kernel_device_us(lambda: new_f(panel, dev), "fleet_score",
                                                            iters)}
    runs = {k: {"profiled_idle_us": [], "profiled_queued_us": [], "call_then_sync_us": [],
                "call_alone_us": []} for k in calls}
    for _ in range(max(1, rounds // 5)):
        for k, fn in calls.items():
            r = runs[k]
            r["profiled_idle_us"].append(profiled_us("fleet_score", fn, iters // 10 or 1))
            r["profiled_queued_us"].append(profiled_us("fleet_score", fn, iters // 10 or 1,
                                                       cycles))
            r["call_then_sync_us"].append(one_call_us(
                lambda: (fn(), torch.cuda.synchronize()), iters // 10 or 1))
            r["call_alone_us"].append(one_call_us(fn, iters // 10 or 1))
    dispatch["calls"] = {k: {m: statistics.median(v) for m, v in r.items()}
                         for k, r in runs.items()}
    dispatch["enqueue_back_to_back_us"] = {
        "parent device panel": loop_us(lambda: old_f(feats), iters)}
    print(json.dumps({"fleet_score": "dispatch", **dispatch}), flush=True)
    stretches(old_f, feats, rounds, iters, "after")


def kernel_device_us(fn, name: str, iters: int) -> float:
    """Mean device µs of the kernel rows whose name holds ``name`` a call
    of ``fn``, by ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if name in e.key
            and e.device_type == torch.autograd.DeviceType.CUDA]
    total = 0.0
    for e in rows:
        us = getattr(e, "self_device_time_total", None)
        total += getattr(e, "self_cuda_time_total", 0.0) if us is None else us
    return total / iters


def pin_arena(n: int, n_valid: int, seed: int):
    """A pin's key arena on the card: one key column of ``n`` slots and
    its validity, ``n_valid`` slots valid."""
    import torch

    rng = np.random.default_rng(seed)
    keys = (torch.from_numpy(rng.integers(0, 1_000_000, n).astype(np.int32)).cuda(),)
    ok = np.zeros(n, bool)
    ok[rng.choice(n, n_valid, replace=False)] = True
    return keys, torch.from_numpy(ok).cuda()


def pin_table_report(old_p, rounds: int, iters: int, device_rounds: int) -> None:
    """``--pin-table``'s readings (the module's docstring): ``old_p`` is
    the other checkout's ``pin_table``.  The kernel's device µs are read
    at visitView's arena and at a 4,096-slot arena with as many valid
    slots, where the scan of the validity is next to nothing, so that the
    difference is the scan's and the rest the launch's fixed cost (the
    ticket, the last block's sort, the length's write)."""
    import torch

    from repro_torch.kernels.outlier_member import ops as outlier_ops

    n, n_valid = 1_500_000, 104
    keys, valid = pin_arena(n, n_valid, 1)
    new_p = outlier_ops.pin_table
    if not torch.equal(old_p(keys, valid), new_p(keys, valid)):
        raise SystemExit("enqueue_ab: the two pin tables disagree")
    ab(f"pin_table slots={n} valid={n_valid}", lambda: old_p(keys, valid),
       lambda: new_p(keys, valid), rounds, iters)
    for slots in (n, 4_096):
        k, v = (keys, valid) if slots == n else pin_arena(slots, n_valid, 2)
        if not torch.equal(old_p(k, v), new_p(k, v)):
            raise SystemExit("enqueue_ab: the two pin tables disagree")
        device = {"parent": [], "change": []}
        for _ in range(device_rounds):
            for name, fn in (("parent", old_p), ("change", new_p), ("change", new_p),
                             ("parent", old_p)):
                device[name].append(kernel_device_us(lambda: fn(k, v), "outlier_pin_table",
                                                     iters))
        print(json.dumps({"pin_table": "kernel device us", "slots": slots,
                          "valid_slots": n_valid, "iters": iters, "runs_us": device,
                          "median_us": {x: statistics.median(y) for x, y in device.items()},
                          "bound_us": (slots + n_valid * 4 + (n_valid + 1) * 8 + 8)
                          / 3.35e12 * 1e6}), flush=True)


def stretches(old_f, feats, rounds: int, iters: int, when: str) -> None:
    """The parent's wrapper and its pieces, loop by loop (the module's
    docstring), printed with ``when``."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.fleet_score import N_SCORES
    from repro_torch.kernels.fleet_score import ops as fleet_score_ops

    dev = feats.device
    out = torch.empty((feats.shape[0], N_SCORES), dtype=torch.float32, device=dev)
    args = (feats.data_ptr(), feats.shape[0], out.data_ptr())
    pieces = {
        "wrapper": lambda: old_f(feats),
        "torch_empty": lambda: torch.empty((feats.shape[0], N_SCORES), dtype=torch.float32,
                                           device=dev),
        "raw_launch": lambda: _build.launch_on(dev.index, "svc_fleet_score",
                                               fleet_score_ops._ARGS, *args),
        "perf_counter_pair": lambda: (time.perf_counter(), time.perf_counter()),
    }
    loops = {k: [] for k in pieces}
    for _ in range(rounds * 2):
        for k, fn in pieces.items():
            loops[k].append(loop_us(fn, iters))
    w = np.array(loops["wrapper"])
    parts = np.array(loops["torch_empty"]) + np.array(loops["raw_launch"])
    print(json.dumps({"fleet_score": "stretches", "when": when, "iters": iters, "loops_us": loops,
                      "corr_wrapper_vs_empty_plus_launch": float(np.corrcoef(w, parts)[0, 1]),
                      "median_us": {k: statistics.median(v) for k, v in loops.items()},
                      "min_us": {k: min(v) for k, v in loops.items()},
                      "max_us": {k: max(v) for k, v in loops.items()}}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="the other checkout's src directory")
    ap.add_argument("--rounds", type=int, default=25)
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--fleet-score", action="store_true",
                    help="the planner's score in turns, the dispatch's parts, the stretches")
    ap.add_argument("--queue-us", type=float, default=50.0,
                    help="device µs queued ahead of a dispatch in the dispatch's queued reading")
    ap.add_argument("--pin-table", action="store_true",
                    help="pin_table at visitView's pin arena: host µs and kernel device µs")
    ap.add_argument("--device-rounds", type=int, default=5,
                    help="rounds of the pin-table kernel's device µs")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("enqueue_ab: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.fleet_score import N_FEATURES
    from repro_torch.kernels.fleet_score import ops as fleet_score_ops
    from repro_torch.kernels.hash_threshold import ops as hash_threshold_ops
    from repro_torch.obs.kprof import get_profiler

    assert get_profiler() is None
    parent = Path(args.parent).resolve()
    from repro_torch.kernels import _build

    parent_build = load_module(parent / "repro_torch" / "kernels" / "_build.py", "parent__build")
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        list(pool.map(lambda b: b.library(), (parent_build, _build)))
    rng = np.random.default_rng(0)
    view = np.full(1_500_000, SENTINEL, np.int32)  # visitView: a slot per group
    view[:137_800] = rng.choice(1_000_000, 137_800, replace=False)
    cols = (torch.from_numpy(view).cuda(),)
    feats = torch.from_numpy(rng.uniform(0.0, 10.0, (16, N_FEATURES)).astype(np.float32)).cuda()
    old_h = load_parent(parent, "hash_threshold", parent_build).hash_threshold
    old_f = load_parent(parent, "fleet_score", parent_build).fleet_scores
    for a, b in ((old_h(cols, 0.1, 0), hash_threshold_ops.hash_threshold(cols, 0.1, 0)),
                 (old_f(feats), fleet_score_ops.fleet_scores(feats))):
        if not torch.equal(a, b):
            raise SystemExit("enqueue_ab: the two versions disagree")
    if args.fleet_score:
        stretches(old_f, feats, args.rounds, args.iters, "before")
    ab("hash_threshold rows=1500000 view rows", lambda: old_h(cols, 0.1, 0),
       lambda: hash_threshold_ops.hash_threshold(cols, 0.1, 0), args.rounds, args.iters)
    ab(f"fleet_scores V=16 F={N_FEATURES}", lambda: old_f(feats),
       lambda: fleet_score_ops.fleet_scores(feats), args.rounds, args.iters)
    if args.fleet_score:
        fleet_score_report(old_f, feats, feats.cpu().numpy(), args.rounds, args.iters,
                           args.queue_us)
    if args.pin_table:
        pin_table_report(load_parent(parent, "outlier_member", parent_build).pin_table,
                         args.rounds, args.iters, args.device_rounds)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
