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
    from repro_torch.kernels.adamw import Scalars, adamw_apply, adamw_norm
    from repro_torch.kernels.corr_diff import corr_moments
    from repro_torch.kernels.cross_entropy import (cross_entropy_bwd, cross_entropy_fwd,
                                                   cross_entropy_ref)
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.fleet_merge import fleet_merge
    from repro_torch.kernels.fleet_moments import fleet_moments
    from repro_torch.kernels.fleet_score import N_FEATURES, fleet_scores, fleet_scores_sharded
    from repro_torch.kernels.fused_clean.ops import fused_clean_groupby, fused_clean_groupby_fleet
    from repro_torch.kernels.hash_threshold.ops import hash_threshold
    from repro_torch.kernels.multi_agg.ops import multi_agg_one, multi_agg_two
    from repro_torch.kernels.outlier_member.ops import digest_table, pinned_hash
    from repro_torch.kernels.segment_aggsum import segment_groupby, segment_sum
    from repro_torch.kernels.slstm import slstm_bwd, slstm_fwd, slstm_scan_ref

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
    # the backward's inputs: a causal prefill, its plain output and log-sum-exp
    bq, bk, bv, dout = [torch.randn(shape, generator=g).to(dev)
                        for shape in ((2, 40, 4, 64), (2, 40, 2, 64), (2, 40, 2, 64),
                                      (2, 40, 4, 64))]
    bo, lse = flash_attention_ref(bq, bk, bv, return_lse=True)
    # AdamW over a tree of odd sizes (rank 1 and 2); the update works on
    # copies of the state, so every call gives the same outputs
    from repro_torch.training import AdamWConfig

    opt = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=0.5)
    opt_shapes = ((7,), (5, 3), (4099,))
    opt_p, opt_g, opt_m = [[t(rng.normal(size=s).astype(np.float32)) for s in opt_shapes]
                           for _ in range(3)]
    opt_v = [t(rng.uniform(0.0, 1.0, s).astype(np.float32)) for s in opt_shapes]
    opt_step = torch.tensor(3, dtype=torch.int32, device=dev)
    opt_sc = Scalars(torch.tensor(4, dtype=torch.int32, device=dev),
                     *[torch.tensor(x, dtype=torch.float32, device=dev)
                       for x in (5e-3, 2.0, 0.25, 1 - 0.9 ** 4, 1 - 0.95 ** 4)])
    # the sLSTM over 5 steps of 3 rows (d = 64) from a given state; the
    # backward's saved forward from the plain version
    sl_wx = t(rng.normal(size=(3, 5, 256)).astype(np.float32))
    sl_R = t((rng.normal(size=(4, 16, 64)) * 0.25).astype(np.float32))
    sl_state = [t(rng.normal(size=(3, 64)).astype(np.float32)) for _ in range(4)]
    sl_state[2] = sl_state[2].abs() + 1.0
    sl_dhs = t(rng.normal(size=(3, 5, 64)).astype(np.float32))
    sl_hs, _, sl_saved = slstm_scan_ref(sl_wx, sl_R, save=True)  # a gradient's: from zeros
    # the cross-entropy over 5 rows of an odd vocabulary, two labels wrapped
    # (−1, −V); the backward from the plain lse
    ce_x = t((rng.normal(size=(5, 1003)) * 3).astype(np.float32))
    ce_lab = t(np.array([3, -1, 1002, -1003, 0], np.int32))
    ce_lse = cross_entropy_ref(ce_x, ce_lab)[0]
    ce_g = t(rng.normal(size=(2, 5)).astype(np.float32))
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
        "fleet_score_sharded": lambda: fleet_scores_sharded(feats.reshape(4, 4, N_FEATURES)),
        "segment_aggsum": lambda: segment_groupby(sorted_gid, vals, G),
        "segment_aggsum_unsorted": lambda: segment_sum(gid, vals, G),
        "corr_diff": lambda: corr_moments(t_new, t_old, valid),
        "flash_attention": lambda: flash_attention(q, k, v, causal=False),
        "flash_attention_bwd": lambda: flash_attention_bwd(bq, bk, bv, bo, lse, dout),
        "adamw_norm": lambda: adamw_norm(opt, opt_g, opt_step),
        "adamw_update": lambda: adamw_apply(
            opt, *[[x.clone() for x in xs] for xs in (opt_p, opt_g, opt_m, opt_v)],
            [True, True, False], opt_sc),
        "slstm_fwd": lambda: slstm_fwd(sl_wx, sl_R, sl_state, save=True),
        "slstm_bwd": lambda: slstm_bwd(sl_dhs, sl_R, sl_hs, sl_saved),
        "cross_entropy_fwd": lambda: cross_entropy_fwd(ce_x, ce_lab),
        "cross_entropy_bwd": lambda: cross_entropy_bwd(ce_x, ce_lab, ce_lse, ce_g[0], ce_g[1]),
    }
