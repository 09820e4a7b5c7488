"""Plain PyTorch version of the batched multi-aggregate query kernels.

Evaluates a whole encoded ``QueryBatch`` (repro_torch.query.batch) against
the correspondence-aligned sample panel the way the per-query estimators
do: per-query trans tables (§5.2.1) materialized as an (R, Q)
intermediate via the one-hot selector product, then masked reductions.

Moment row layout of the (12, Q) output (shared with ops.py):

  K/S/SS/HT_NEW   count, sum, sum of squares, HT variance term of the
                  clean-sample trans table
  K/S/SS/HT_OLD   same over the stale sample
  K/S/SS/HT_D     same over the correspondence diff d = t_new − t_old
                  (K_D is query independent: the joined valid-row count;
                  HT_D weights d² by min(1−π_new, 1−π_old), §6.3)
"""

from __future__ import annotations

from typing import Optional

import torch

# moment rows
K_NEW, S_NEW, SS_NEW, HT_NEW = 0, 1, 2, 3
K_OLD, S_OLD, SS_OLD, HT_OLD = 4, 5, 6, 7
K_D, S_D, SS_D, HT_D = 8, 9, 10, 11
N_MOMENTS = 12

# meta rows: [is_count; is_avg; then (ge, gt, le, lt) per predicate term]
META_IS_COUNT = 0
META_IS_AVG = 1
META_PRED0 = 2
META_PER_PRED = 4


def trans_table(x, valid, w, sel, meta):
    """Per-query trans values t (R, Q) and row mask (R, Q) for one side.

      sum/count: t = w · v · cond   rowmask = valid
      avg:       t = v · cond       rowmask = cond
    """
    C = x.shape[1]
    P = sel.shape[0] // C - 1
    is_count = meta[META_IS_COUNT][None, :] > 0
    is_avg = meta[META_IS_AVG][None, :] > 0
    v = x @ sel[:C]
    v = torch.where(is_count, torch.ones_like(v), v)
    cond = valid[:, None].expand(v.shape)
    for p in range(P):
        tv = x @ sel[(1 + p) * C:(2 + p) * C]
        b = meta[META_PRED0 + META_PER_PRED * p:META_PRED0 + META_PER_PRED * (p + 1)]
        cond = (cond
                & (tv >= b[0][None, :]) & (tv > b[1][None, :])
                & (tv <= b[2][None, :]) & (tv < b[3][None, :]))
    w_eff = torch.where(is_avg, torch.ones_like(v), w[:, None].expand(v.shape))
    t = torch.where(cond, v, torch.zeros_like(v)) * w_eff
    rowmask = torch.where(is_avg, cond, valid[:, None].expand(v.shape))
    return t, rowmask


def _side_moments(t, rowmask, ompi):
    k = rowmask.to(torch.float32).sum(0)
    s = t.sum(0)
    ss = (t * t).sum(0)
    ht = (ompi[:, None] * t * t).sum(0)
    return k, s, ss, ht


def multi_agg_ref(
    x_new: torch.Tensor,
    valid_new: torch.Tensor,
    w_new: torch.Tensor,
    ompi_new: torch.Tensor,
    sel: torch.Tensor,
    meta: torch.Tensor,
    x_old: Optional[torch.Tensor] = None,
    valid_old: Optional[torch.Tensor] = None,
    w_old: Optional[torch.Tensor] = None,
    ompi_old: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(12, Q) moments; one-sided (x_old=None) fills OLD/D rows with 0."""
    t_new, m_new = trans_table(x_new, valid_new, w_new, sel, meta)
    kn, sn, ssn, htn = _side_moments(t_new, m_new, ompi_new)
    z = torch.zeros_like(kn)
    if x_old is None:
        return torch.stack([kn, sn, ssn, htn] + [z] * 8)
    t_old, m_old = trans_table(x_old, valid_old, w_old, sel, meta)
    ko, so, sso, hto = _side_moments(t_old, m_old, ompi_old)
    d = t_new - t_old
    kd = z + (valid_new | valid_old).to(torch.float32).sum()
    sd = d.sum(0)
    ssd = (d * d).sum(0)
    # §6.3: a row pinned on EITHER side has an exact diff (1−π = 0)
    ompi_d = torch.minimum(ompi_new, ompi_old)
    htd = (ompi_d[:, None] * d * d).sum(0)
    return torch.stack([kn, sn, ssn, htn, ko, so, sso, hto, kd, sd, ssd, htd])
