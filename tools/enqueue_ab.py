#!/usr/bin/env python3
"""Host enqueue of two versions of a kernel wrapper, in turns, in one process.

Loads another checkout's ``kernels/<name>/ops.py`` (``--parent``, e.g. a
``git archive`` of the parent commit unpacked into the git-ignored
``.trees/parent``) as a module of its own: its wrapper's code is that
checkout's, and every name it imports resolves to this checkout's
``repro_torch`` (the same ``_build`` library, plain versions and hashing).
So the two wrappers differ only in their own Python, and launch the same
kernel of the same library.  Both run on the same inputs: ``hash_threshold``
over the 1,500,000-row key column of visitView's view (137,800 valid keys,
as ``tools/kernel_profile.py`` builds it) and ``fleet_scores`` on a (16, 13)
feature panel, with no kernel profiler installed.  For each wrapper it
times ``--rounds`` rounds of four loops of ``--iters`` calls back to back
(parent, change, change, parent), and prints one JSON line: each
version's median and every loop's mean host µs per call, and the median
of the per-round differences (change − parent).  The last line is the
card's name and power limit.

Run on a machine with a card, from the repository root:

    python3 tools/enqueue_ab.py --parent .trees/parent/src [--rounds 25] [--iters 200]
"""

from __future__ import annotations

import argparse
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


def load_parent(parent_src: Path, name: str):
    """The other checkout's ``kernels/<name>/ops.py`` as a module of its own."""
    path = parent_src / "repro_torch" / "kernels" / name / "ops.py"
    spec = importlib.util.spec_from_file_location(f"parent_{name}_ops", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="the other checkout's src directory")
    ap.add_argument("--rounds", type=int, default=25)
    ap.add_argument("--iters", type=int, default=200)
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
    rng = np.random.default_rng(0)
    view = np.full(1_500_000, SENTINEL, np.int32)  # visitView: a slot per group
    view[:137_800] = rng.choice(1_000_000, 137_800, replace=False)
    cols = (torch.from_numpy(view).cuda(),)
    feats = torch.from_numpy(rng.uniform(0.0, 10.0, (16, N_FEATURES)).astype(np.float32)).cuda()
    old_h = load_parent(parent, "hash_threshold").hash_threshold
    old_f = load_parent(parent, "fleet_score").fleet_scores
    for a, b in ((old_h(cols, 0.1, 0), hash_threshold_ops.hash_threshold(cols, 0.1, 0)),
                 (old_f(feats), fleet_score_ops.fleet_scores(feats))):
        if not torch.equal(a, b):
            raise SystemExit("enqueue_ab: the two versions disagree")
    ab("hash_threshold rows=1500000 view rows", lambda: old_h(cols, 0.1, 0),
       lambda: hash_threshold_ops.hash_threshold(cols, 0.1, 0), args.rounds, args.iters)
    ab(f"fleet_scores V=16 F={N_FEATURES}", lambda: old_f(feats),
       lambda: fleet_score_ops.fleet_scores(feats), args.rounds, args.iters)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
