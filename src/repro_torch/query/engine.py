"""Batched query engine: one fused pass answers N queries.

Multi-query optimization for the §5 estimators, as in ``repro.query.engine``:

  * **Correspondence cache** — the clean-vs-stale outer join behind
    ``correspondence_diff`` (Def. 4) is query independent, so it is built
    once per refresh window as row-aligned f32 column panels (x_new ∥
    x_old) plus per-row validity/weight/1−π vectors.
  * **Encoded batches** — queries become tensors (repro_torch.query.batch).
  * **Fused moments** — kernels/multi_agg scans the aligned panel once and
    accumulates every sufficient statistic for all Q queries; estimate
    assembly is then O(Q) host arithmetic.

``run_batch`` keeps the stale full-view answer **lazy**: q(S) is scanned
(one batched one-sided pass) only when some query resolves to SVC+CORR.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.estimators import OUTLIER_COL, Estimate, _gamma, _masked_moments
from repro_torch.kernels.multi_agg import (
    HT_D,
    HT_NEW,
    K_D,
    K_NEW,
    K_OLD,
    S_D,
    S_NEW,
    S_OLD,
    SS_D,
    SS_NEW,
    SS_OLD,
    multi_agg_moments,
)
from repro_torch.kernels.multi_agg.ref import trans_table
from repro_torch.query.batch import QueryBatch
from repro_torch.relational import ops
from repro_torch.relational.relation import Relation, Schema


def sample_columns(rel: Relation) -> Tuple[str, ...]:
    """The encodable column panel of a sample: all columns but the flag."""
    return tuple(c for c in rel.schema.columns if c != OUTLIER_COL)


@dataclasses.dataclass
class CorrespondenceCache:
    """Query-independent clean↔stale row alignment for one refresh window."""

    columns: Tuple[str, ...]
    x_new: torch.Tensor  # (RJ, C) f32 clean-sample panel on the joined row space
    x_old: torch.Tensor  # (RJ, C) f32 stale-sample panel, row-aligned
    valid_new: torch.Tensor  # (RJ,) bool
    valid_old: torch.Tensor
    w_new: torch.Tensor  # (RJ,) f32 per-row 1/π weights (§6.3: pinned rows 1)
    w_old: torch.Tensor
    ompi_new: torch.Tensor  # (RJ,) f32 1−π HT factors (pinned rows 0)
    ompi_old: torch.Tensor
    m: float


def _rows_only(rel: Relation) -> Relation:
    """Project a relation to pk + a ``__row`` source-index column."""
    cols = {k: rel.col(k) for k in rel.schema.pk}
    cols["__row"] = torch.arange(rel.capacity, dtype=torch.int32, device=rel.device)
    return Relation(cols, rel.valid, Schema(pk=rel.schema.pk, columns=tuple(sorted(cols))))


def _pin_weights(pin: torch.Tensor, m: float):
    """(w, ompi): 1/π and 1−π per row, π = 1 for pinned rows."""
    w = torch.where(pin, torch.ones_like(pin, dtype=torch.float32),
                    torch.full(pin.shape, 1.0 / m, dtype=torch.float32, device=pin.device))
    ompi = torch.where(pin, torch.zeros_like(pin, dtype=torch.float32),
                       torch.full(pin.shape, 1.0 - m, dtype=torch.float32, device=pin.device))
    return w, ompi


def _gather_side(rel: Relation, idx: torch.Tensor, present: torch.Tensor,
                 columns: Sequence[str], m: float):
    idx = idx.to(torch.int64).clamp(0, rel.capacity - 1)
    x = torch.stack([rel.col(c).to(torch.float32)[idx] for c in columns], dim=1)
    x = torch.where(present[:, None], x, torch.zeros_like(x))
    if OUTLIER_COL in rel.columns:
        pin = rel.col(OUTLIER_COL).to(torch.bool)[idx] & present
    else:
        pin = torch.zeros_like(present)
    w, ompi = _pin_weights(pin, m)
    return x, present, w, ompi


def build_correspondence_cache(
    clean_sample: Relation, stale_sample: Relation, m: float
) -> CorrespondenceCache:
    """One outer join (Def. 4 row space) → reusable aligned panels.

    RJ = |clean| + |stale| capacities, stable across refresh windows.
    """
    columns = sample_columns(clean_sample)
    joined = ops.outer_join_unique(
        _rows_only(clean_sample), _rows_only(stale_sample),
        on=clean_sample.schema.pk, how="outer", suffixes=("_new", "_old"),
    )
    lp = joined.col("__left_present").to(torch.bool) & joined.valid
    rp = joined.col("__right_present").to(torch.bool) & joined.valid
    x_new, valid_new, w_new, ompi_new = _gather_side(
        clean_sample, joined.col("__row_new"), lp, columns, m
    )
    x_old, valid_old, w_old, ompi_old = _gather_side(
        stale_sample, joined.col("__row_old"), rp, columns, m
    )
    return CorrespondenceCache(
        columns=columns,
        x_new=x_new, x_old=x_old,
        valid_new=valid_new, valid_old=valid_old,
        w_new=w_new, w_old=w_old,
        ompi_new=ompi_new, ompi_old=ompi_old,
        m=float(m),
    )


def sample_panel(rel: Relation, columns: Sequence[str], m: float):
    """One-sided (x, valid, w, ompi) panel straight from a sample relation
    — the AQP-only path, which needs no correspondence join."""
    x = torch.stack([rel.col(c).to(torch.float32) for c in columns], dim=1)
    if OUTLIER_COL in rel.columns:
        pin = rel.col(OUTLIER_COL).to(torch.bool) & rel.valid
    else:
        pin = torch.zeros_like(rel.valid)
    w, ompi = _pin_weights(pin, m)
    return x, rel.valid, w, ompi


# ---------------------------------------------------------------------------
# Moment passes
# ---------------------------------------------------------------------------

def panel_moments(cache: CorrespondenceCache, batch: QueryBatch) -> np.ndarray:
    """(12, Q) host moments for a batch over the cached panel."""
    mom = multi_agg_moments(
        cache.x_new, cache.valid_new, cache.w_new, cache.ompi_new,
        batch.sel, batch.meta,
        cache.x_old, cache.valid_old, cache.w_old, cache.ompi_old,
    )
    return mom.cpu().numpy()[:, :len(batch)]


def exact_batch(view: Relation, batch: QueryBatch) -> np.ndarray:
    """One batched scan of a full view → (Q,) exact sum/count/avg answers."""
    x = torch.stack([view.col(c).to(torch.float32) for c in batch.columns], dim=1)
    ones = torch.ones(view.valid.shape, dtype=torch.float32, device=view.device)
    mom = multi_agg_moments(x, view.valid, ones, torch.zeros_like(ones),
                            batch.sel, batch.meta).cpu().numpy()[:, :len(batch)]
    s, k = mom[S_NEW], mom[K_NEW]
    return np.where(batch.is_avg, s / np.maximum(k, 1.0), s)


# ---------------------------------------------------------------------------
# Estimate assembly (§5.1/§5.2 from the sufficient statistics)
# ---------------------------------------------------------------------------

def _var(ss: float, s: float, k: float) -> float:
    """Sample variance from moments: Σ(t−mean)² = Σt² − s²/k (k ≥ 1)."""
    return max(ss - s * s / max(k, 1.0), 0.0) / max(k - 1.0, 1.0)


# When less than this fraction of Σt² survives the mean subtraction, the
# f32 moment-form variance has cancelled away its significant digits — fall
# back to a two-pass Σ(t−mean)² over the panel for that query only.
_CANCEL_EPS = 1e-2


def _ill_conditioned(ss: float, s: float, k: float) -> bool:
    return ss > 0.0 and (ss - s * s / max(k, 1.0)) < _CANCEL_EPS * ss


def _trans_single_side(x, valid, w, batch: QueryBatch, qi: int):
    """(t, mask) of one query on one panel side (the two-pass fallback)."""
    t, mask = trans_table(x, valid, w, batch.sel[:, qi:qi + 1], batch.meta[:, qi:qi + 1])
    return t[:, 0], mask[:, 0]


def _avg_var_new(panel, batch: QueryBatch, qi: int) -> float:
    x, valid, w = panel
    t, mask = _trans_single_side(x, valid, w, batch, qi)
    return float(_masked_moments(t, mask)[3])


def _avg_var_diff(cache: CorrespondenceCache, batch: QueryBatch, qi: int) -> float:
    tn, _ = _trans_single_side(cache.x_new, cache.valid_new, cache.w_new, batch, qi)
    to, _ = _trans_single_side(cache.x_old, cache.valid_old, cache.w_old, batch, qi)
    maskd = cache.valid_new | cache.valid_old
    return float(_masked_moments(tn - to, maskd)[3])


def run_batch(
    cache: CorrespondenceCache,
    batch: QueryBatch,
    confidence: float = 0.95,
    prefer: Optional[str] = None,
    materialized: Optional[Relation] = None,
) -> List[Estimate]:
    """Answer an encoded batch: moments → per-query AQP/CORR estimates.

    ``prefer`` forces the estimator ("corr"/"aqp"); None auto-selects per
    query by the §5.2.2 HT-variance break-even.  ``materialized`` is only
    scanned (one batched pass) when at least one query resolves to CORR.
    """
    mom = panel_moments(cache, batch)
    kn, sn, ssn, htn = mom[K_NEW], mom[S_NEW], mom[SS_NEW], mom[HT_NEW]
    ko, so = mom[K_OLD], mom[S_OLD]
    kd, sd, ssd = mom[K_D], mom[S_D], mom[SS_D]
    ht_corr = mom[HT_D]  # excludes the deterministic outlier stratum (§6.3)
    if prefer == "corr":
        use_corr = np.ones(len(batch), bool)
    elif prefer == "aqp":
        use_corr = np.zeros(len(batch), bool)
    else:
        use_corr = ht_corr <= htn
    stale = None
    if use_corr.any():
        if materialized is None:
            raise ValueError("CORR queries need the materialized view for q(S)")
        stale = exact_batch(materialized, batch)
    g = _gamma(confidence)
    out: List[Estimate] = []
    for i in range(len(batch)):
        if batch.is_avg[i]:
            mean_n = sn[i] / max(kn[i], 1.0)
            if use_corr[i]:
                mean_o = so[i] / max(ko[i], 1.0)
                var_d = _var(ssd[i], sd[i], kd[i])
                if _ill_conditioned(ssd[i], sd[i], kd[i]):
                    var_d = _avg_var_diff(cache, batch, i)
                stderr = math.sqrt(var_d / max(kn[i], 1.0))
                value = float(stale[i]) + (mean_n - mean_o)
                method = "SVC+CORR"
            else:
                var_n = _var(ssn[i], sn[i], kn[i])
                if _ill_conditioned(ssn[i], sn[i], kn[i]):
                    var_n = _avg_var_new((cache.x_new, cache.valid_new, cache.w_new), batch, i)
                stderr = math.sqrt(var_n / max(kn[i], 1.0))
                value = mean_n
                method = "SVC+AQP"
        else:
            if use_corr[i]:
                value = float(stale[i]) + sd[i]
                stderr = math.sqrt(max(ht_corr[i], 0.0))
                method = "SVC+CORR"
            else:
                value = sn[i]
                stderr = math.sqrt(max(htn[i], 0.0))
                method = "SVC+AQP"
        value = float(value)
        out.append(
            Estimate(value, float(stderr), value - g * stderr, value + g * stderr,
                     method, confidence)
        )
    return out


def run_batch_aqp(
    clean_sample: Relation,
    batch: QueryBatch,
    m: float,
    confidence: float = 0.95,
) -> List[Estimate]:
    """AQP-only batch: one one-sided scan of the clean sample, no
    correspondence join, no stale-view access."""
    x, valid, w, ompi = sample_panel(clean_sample, batch.columns, m)
    mom = multi_agg_moments(x, valid, w, ompi, batch.sel, batch.meta).cpu().numpy()
    mom = mom[:, :len(batch)]
    kn, sn, ssn, htn = mom[K_NEW], mom[S_NEW], mom[SS_NEW], mom[HT_NEW]
    g = _gamma(confidence)
    out: List[Estimate] = []
    for i in range(len(batch)):
        if batch.is_avg[i]:
            var_n = _var(ssn[i], sn[i], kn[i])
            if _ill_conditioned(ssn[i], sn[i], kn[i]):
                var_n = _avg_var_new((x, valid, w), batch, i)
            value = sn[i] / max(kn[i], 1.0)
            stderr = math.sqrt(var_n / max(kn[i], 1.0))
        else:
            value = sn[i]
            stderr = math.sqrt(max(htn[i], 0.0))
        value = float(value)
        out.append(
            Estimate(value, float(stderr), value - g * stderr, value + g * stderr,
                     "SVC+AQP", confidence)
        )
    return out


def variance_report(cache: CorrespondenceCache, batch: QueryBatch) -> dict:
    """Batched §5.2.2 break-even report (variance_comparison's keys, (Q,))."""
    mom = panel_moments(cache, batch)

    def stable(ss, s, k, two_pass):
        return two_pass() if _ill_conditioned(ss, s, k) else _var(ss, s, k)

    new = (cache.x_new, cache.valid_new, cache.w_new)
    old = (cache.x_old, cache.valid_old, cache.w_old)
    q = range(len(batch))
    var_new = np.array([stable(mom[SS_NEW][i], mom[S_NEW][i], mom[K_NEW][i],
                               lambda i=i: _avg_var_new(new, batch, i)) for i in q])
    var_old = np.array([stable(mom[SS_OLD][i], mom[S_OLD][i], mom[K_OLD][i],
                               lambda i=i: _avg_var_new(old, batch, i)) for i in q])
    var_d = np.array([stable(mom[SS_D][i], mom[S_D][i], mom[K_D][i],
                             lambda i=i: _avg_var_diff(cache, batch, i)) for i in q])
    ht_aqp, ht_corr = mom[HT_NEW], mom[HT_D]
    return {
        "var_aqp": ht_aqp,
        "var_corr": ht_corr,
        "cov": 0.5 * (var_old + var_new - var_d),
        "corr_wins": ht_corr <= ht_aqp,
    }
