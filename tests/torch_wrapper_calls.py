"""One small call of every kernel wrapper of ``repro_torch.kernels.wrappers()``.

Shared by the CPU profiler tests (``test_torch_kprof.py``) and the card's
(``test_torch_cuda.py``); imports only numpy, torch and repro_torch, so it
runs where JAX is not installed.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch


def wrapper_calls(dev) -> Dict[str, Callable[[], object]]:
    """Kernel name → a call of its wrapper on seeded tensors on ``dev``."""
    from repro_torch.kernels.corr_diff import corr_moments
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.fleet_merge import fleet_merge
    from repro_torch.kernels.fleet_moments import fleet_moments
    from repro_torch.kernels.fleet_score import N_FEATURES, fleet_scores
    from repro_torch.kernels.fused_clean.ops import fused_clean_groupby, fused_clean_groupby_fleet
    from repro_torch.kernels.hash_threshold.ops import hash_threshold
    from repro_torch.kernels.multi_agg.ops import multi_agg_one, multi_agg_two
    from repro_torch.kernels.outlier_member.ops import digest_table, pinned_hash
    from repro_torch.kernels.segment_aggsum import segment_groupby, segment_sum

    rng = np.random.default_rng(0)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    R, C, G, V, Q, P = 1000, 2, 64, 3, 4, 1
    keys = t(rng.integers(0, 500, R).astype(np.int32))
    valid = t(rng.uniform(size=R) < 0.8)
    gid = t(rng.integers(0, G, R).astype(np.int32))
    vals = t(rng.uniform(0.0, 10.0, (R, C)).astype(np.float32))
    table = digest_table((keys[:16].contiguous(),))
    panel = (t(rng.uniform(0.0, 20.0, (R, C)).astype(np.float32)), valid,
             t(np.full(R, 10.0, np.float32)), t(np.full(R, 0.9, np.float32)))
    sel = np.zeros(((1 + P) * C, Q), np.float32)
    sel[np.arange(Q) % C, np.arange(Q)] = 1.0
    meta = np.zeros((2 + 4 * P, Q), np.float32)
    meta[2], meta[3], meta[4], meta[5] = -np.inf, -np.inf, np.inf, np.inf
    sel, meta = t(sel), t(meta)
    fgid = t(rng.integers(0, G, (V, R)).astype(np.int32))
    fvals = t(rng.uniform(0.0, 10.0, (V, R, C)).astype(np.float32))
    fvalid = t(rng.uniform(size=(V, R)) < 0.8)
    Rs = 32
    skeys = t(np.sort(rng.choice(G, (V, Rs)), axis=1).astype(np.int32))
    svalid = t(rng.uniform(size=(V, Rs)) < 0.7)
    svals = t(rng.uniform(0.0, 5.0, (V, Rs, C)).astype(np.float32))
    ivalid = t(rng.uniform(size=(V, G)) < 0.3)
    ivals = t(rng.uniform(0.0, 5.0, (V, G, C)).astype(np.float32))
    moments_in = [t(rng.uniform(0.0, 2.0, (V, R)).astype(np.float32)) for _ in range(8)]
    feats = t(rng.uniform(0.0, 10.0, (16, N_FEATURES)).astype(np.float32))
    sorted_gid = t(np.sort(rng.integers(0, G, R)).astype(np.int32))
    t_new = t(rng.gamma(2.0, 4.0, R).astype(np.float32))
    t_old = t(rng.gamma(2.0, 4.0, R).astype(np.float32))
    g = torch.Generator(device="cpu").manual_seed(0)
    q, k, v = [torch.randn(shape, generator=g).to(dev)
               for shape in ((2, 1, 4, 64), (2, 40, 2, 64), (2, 40, 2, 64))]
    return {
        "hash_threshold": lambda: hash_threshold((keys,), 0.3, 1, valid),
        "fused_clean": lambda: fused_clean_groupby(gid, vals, valid, 0.3, 1, G),
        "outlier_member": lambda: pinned_hash((keys,), valid, 0.3, 1, table),
        "outlier_digest": lambda: digest_table((keys,)),
        "multi_agg_two": lambda: multi_agg_two(*panel, sel, meta, *panel),
        "multi_agg_one": lambda: multi_agg_one(*panel, sel, meta),
        "fused_clean_fleet": lambda: fused_clean_groupby_fleet(fgid, fvals, fvalid,
                                                               [0.3] * V, list(range(V)), G),
        "fleet_merge": lambda: fleet_merge(skeys, svalid, svals, ivalid, ivals),
        "fleet_moments": lambda: fleet_moments(*moments_in),
        "fleet_score": lambda: fleet_scores(feats),
        "segment_aggsum": lambda: segment_groupby(sorted_gid, vals, G),
        "segment_aggsum_unsorted": lambda: segment_sum(gid, vals, G),
        "corr_diff": lambda: corr_moments(t_new, t_old, valid),
        "flash_attention": lambda: flash_attention(q, k, v, causal=False),
    }
