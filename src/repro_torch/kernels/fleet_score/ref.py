"""Plain PyTorch version of the fleet scorer.

One pass over a stacked per-view feature matrix emits, for every view at
once, the expected-error-reduction-per-second of the control-plane actions
{skip, clean, maintain, retune}, the §5.2.2 estimator flip and the
recommended sampling ratio — ``repro.kernels.fleet_score.ref`` written out
op by op.  Each torch op rounds once, in the order the JAX reference
evaluates, so this version, the JAX one and the CUDA kernel agree bit for
bit (the knapsack's tie order depends on the scores).

The error model is the paper's break-even analysis turned into a planner
objective: serving without a refresh costs the squared staleness bias of
the un-reflected delta rows plus the current-window estimator variance;
cleaning drops it to the best post-clean estimator variance; maintenance
drops it to zero.  Scores divide the error reduction by the action's
predicted wall time and scale by traffic.
"""

from __future__ import annotations

import torch

# feature columns of the (V, N_FEATURES) input panel
F_N = 0            # estimated view rows (Σ 1/π over the clean sample)
F_EX2 = 1          # estimated population mean of x² for the canonical query
F_MEAN = 2         # estimated population mean of x
F_HT_AQP = 3       # current-window HT variance of SVC+AQP
F_HT_CORR = 4      # current-window HT variance of the SVC+CORR correction
F_DRIFT_CLEAN = 5  # delta rows not yet reflected in the clean sample
F_DRIFT_IVM = 6    # delta rows not yet folded by full maintenance
F_TRAFFIC = 7      # traffic weight (decayed query hit count)
F_COST_CLEAN = 8   # predicted svc_refresh seconds (EWMA)
F_COST_MAINTAIN = 9  # predicted maintain seconds (EWMA)
F_AGE = 10         # seconds since the last full maintenance
F_M = 11           # sampling rate m
F_COST_RETUNE = 12  # predicted retune-then-clean seconds (EWMA)
N_FEATURES = 13

# output columns of the (V, N_SCORES) result
A_SKIP = 0
A_CLEAN = 1
A_MAINTAIN = 2
A_RETUNE = 3  # retune the sampling ratio to REC_M, then clean
CORR_WINS = 4
REC_M = 5  # recommended sampling ratio (clamped step from the current m)
N_SCORES = 6

COST_EPS = 1e-6  # floor for the cost divisors (degenerate EWMA seeds)
M_EPS = 1e-6     # floor for the sampling-rate divisor

# m-adaptation band on the canonical total's relative standard error:
# outside [M_REL_LO, M_REL_HI] the ratio steps ×M_STEP or ÷M_STEP, clamped
# to [M_MIN, M_MAX] — one bounded step per epoch.
M_REL_LO = 0.005
M_REL_HI = 0.02
M_STEP = 2.0
M_MIN = 1.0 / 256.0
M_MAX = 1.0
TOTAL_EPS = 1e-9  # floor for the |total| divisor (empty/zero-sum views)


def fleet_score_ref(feats: torch.Tensor) -> torch.Tensor:
    """(V, N_FEATURES) f32 → (V, N_SCORES) f32, no per-view loop."""
    feats = feats.to(torch.float32)
    n = feats[:, F_N]
    ex2 = feats[:, F_EX2]
    mean = feats[:, F_MEAN]
    ht_aqp = feats[:, F_HT_AQP]
    ht_corr = feats[:, F_HT_CORR]
    d_clean = feats[:, F_DRIFT_CLEAN]
    d_ivm = feats[:, F_DRIFT_IVM]
    traffic = feats[:, F_TRAFFIC]
    cost_c = feats[:, F_COST_CLEAN]
    cost_m = feats[:, F_COST_MAINTAIN]
    cost_r = feats[:, F_COST_RETUNE]
    m = feats[:, F_M]

    e_now = torch.minimum(ht_aqp, ht_corr)
    bias = d_clean * mean
    e_skip = bias * bias + d_clean * ex2 + e_now
    ht_corr_pred = (1.0 - m) / m.clamp(min=M_EPS) * ex2 * d_ivm
    e_clean = torch.minimum(ht_aqp, ht_corr_pred)
    gain_clean = (e_skip - e_clean).clamp(min=0.0)

    score_clean = traffic * gain_clean / cost_c.clamp(min=COST_EPS)
    score_maintain = traffic * e_skip / cost_m.clamp(min=COST_EPS)
    corr_wins = (ht_corr <= ht_aqp).to(torch.float32)
    # the band is judged on the AQP HT variance (the sample's own §5.2.1
    # resolution, monotone in m); zero variance holds the ratio
    rel_se = ht_aqp.clamp(min=0.0).sqrt() / (n * mean).abs().clamp(min=TOTAL_EPS)
    up = torch.maximum((m * M_STEP).clamp(max=M_MAX), m)
    down = torch.minimum((m / M_STEP).clamp(min=M_MIN), m)
    rec_m = torch.where(rel_se > M_REL_HI, up,
                        torch.where((rel_se < M_REL_LO) & (ht_aqp > 0.0), down, m))
    zero = torch.zeros_like(m)
    rec_m = torch.where(m > 0.0, rec_m, zero)
    # retune: step the ratio to rec_m, re-derive the samples, clean — the
    # post-retune error scales both variances to rec_m's (1−m')/m' factor
    r_rec = (1.0 - rec_m) / rec_m.clamp(min=M_EPS)
    ht_aqp_pred = r_rec * n * ex2
    ht_corr_pred_rec = r_rec * ex2 * d_ivm
    e_retune = torch.minimum(ht_aqp_pred, ht_corr_pred_rec)
    gain_retune = (e_skip - e_retune).clamp(min=0.0)
    score_retune = traffic * gain_retune / cost_r.clamp(min=COST_EPS)
    score_retune = torch.where((rec_m != m) & (m > 0.0), score_retune, zero)
    return torch.stack([zero, score_clean, score_maintain, score_retune, corr_wins, rec_m],
                       dim=1)
