"""Query result estimation on corresponding samples (§5).

Two estimators for q(S'):

  SVC+AQP   direct:      q(S') ≈ s · q(Ŝ')
  SVC+CORR  correction:  q(S') ≈ q(S) + (s·q(Ŝ') − s·q(Ŝ))

with CLT confidence intervals for the sample-mean class (sum/count/avg,
§5.2.1), the correspondence-subtract operator (Def. 4) for the correction,
and the §5.2.2 variance analysis (CORR wins iff σ_S² ≤ 2·cov(S,S')).
Rows pinned by the outlier index (§6) carry weight 1 and π = 1 through the
``__outlier`` column.
"""

from __future__ import annotations

import dataclasses
from statistics import NormalDist
from typing import Optional, Tuple

import torch

from repro_torch.relational import ops
from repro_torch.relational.expr import Expr, eval_expr
from repro_torch.relational.relation import Relation, zeros_where

OUTLIER_COL = "__outlier"


@dataclasses.dataclass(frozen=True)
class Query:
    """SELECT agg(col) FROM view WHERE pred (§3.2 Problem 2 form)."""

    agg: str  # sum | count | avg | median | min | max | percentile
    col: Optional[str] = None
    pred: Optional[Expr] = None
    q: float = 0.5  # for percentile


@dataclasses.dataclass
class Estimate:
    value: object
    stderr: object
    ci_low: object
    ci_high: object
    method: str
    confidence: float

    def __iter__(self):  # (value, lo, hi) convenience
        return iter((self.value, self.ci_low, self.ci_high))


def _gamma(confidence: float) -> float:
    """Two-sided Gaussian tail value z = Φ⁻¹((1+confidence)/2), in double."""
    key = float(confidence)
    if not 0.0 < key < 1.0:
        raise ValueError(f"confidence must be in (0, 1), got {confidence}")
    return float(NormalDist().inv_cdf((1.0 + key) / 2.0))


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.full(like.shape, x, dtype=torch.float32, device=like.device)


def _cond_mask(rel: Relation, query: Query) -> torch.Tensor:
    mask = rel.valid
    if query.pred is not None:
        mask = mask & eval_expr(query.pred, rel.columns).to(torch.bool)
    return mask


def _weights(rel: Relation, m: float) -> torch.Tensor:
    """Per-row inverse inclusion probability (outlier stratum = 1)."""
    w = _f32(1.0 / m, rel.valid)
    if OUTLIER_COL in rel.columns:
        w = torch.where(rel.col(OUTLIER_COL).to(torch.bool), _f32(1.0, w), w)
    return w


def _values(rel: Relation, query: Query) -> torch.Tensor:
    if query.agg == "count":
        return _f32(1.0, rel.valid)
    if query.col is None:
        raise ValueError(f"agg {query.agg} needs a column")
    return rel.col(query.col).to(torch.float32)


# ---------------------------------------------------------------------------
# Exact evaluation (ground truth on a full view; also q(S) for CORR)
# ---------------------------------------------------------------------------

def exact(view: Relation, query: Query) -> torch.Tensor:
    cond = _cond_mask(view, query)
    vals = _values(view, query)
    if query.agg in ("sum", "count"):
        return zeros_where(cond, vals).sum()
    if query.agg == "avg":
        k = cond.to(torch.float32).sum()
        return zeros_where(cond, vals).sum() / k.clamp(min=1.0)
    if query.agg in ("median", "percentile"):
        q = 0.5 if query.agg == "median" else query.q
        return masked_quantile(vals, cond, q)
    if query.agg == "min":
        return torch.where(cond, vals, torch.full_like(vals, float("inf"))).min()
    if query.agg == "max":
        return torch.where(cond, vals, torch.full_like(vals, float("-inf"))).max()
    raise ValueError(query.agg)


def masked_quantile(values: torch.Tensor, mask: torch.Tensor, q: float) -> torch.Tensor:
    """Quantile of values[mask] along the last dimension, with a dynamic
    count (sort + interpolate); leading dimensions are independent rows
    (the bootstrap's replicates), and ``mask`` broadcasts against them."""
    v = torch.where(mask, values, torch.full_like(values, 3.4e38))
    sv = torch.sort(v, dim=-1).values
    k = mask.to(torch.float32).sum(-1)
    top = (k - 1.0).clamp(min=0.0)
    pos = q * top
    n = v.shape[-1]
    lo = pos.floor().to(torch.int64).clamp(0, n - 1)
    hi = (lo + 1).clamp(0, n - 1)
    frac = pos - lo.to(torch.float32)
    lead = sv.shape[:-1]
    v_lo = sv.gather(-1, lo.expand(lead).unsqueeze(-1)).squeeze(-1)
    v_hi = sv.gather(-1, hi.expand(lead).unsqueeze(-1)).squeeze(-1)
    hi_val = torch.where(hi.to(torch.float32) <= top, v_hi, v_lo)
    return v_lo * (1.0 - frac) + hi_val * frac


# ---------------------------------------------------------------------------
# trans tables (§5.2.1) and SVC+AQP
# ---------------------------------------------------------------------------

def trans_values(rel: Relation, query: Query, m: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(t_i, row_mask): the §5.2.1 rewritten per-row values.

    sum:   t = w · attr · cond   over all sampled rows
    count: t = w · cond          over all sampled rows
    avg:   t = attr              over cond rows only
    """
    cond = _cond_mask(rel, query)
    vals = _values(rel, query)
    w = _weights(rel, m)
    if query.agg in ("sum", "count"):
        t = zeros_where(rel.valid, w * zeros_where(cond, vals))
        return t, rel.valid
    if query.agg == "avg":
        return zeros_where(cond, vals), cond
    raise ValueError(f"trans_values: {query.agg} is not in the sample-mean class")


def _masked_moments(t: torch.Tensor, mask: torch.Tensor):
    k = mask.to(torch.float32).sum()
    s = zeros_where(mask, t).sum()
    mean = s / k.clamp(min=1.0)
    var = zeros_where(mask, (t - mean) ** 2).sum() / (k - 1.0).clamp(min=1.0)
    return k, s, mean, var


def _ht_stderr(t: torch.Tensor, mask: torch.Tensor, rel: Relation, m: float):
    """Horvitz-Thompson stderr for hash (Poisson) sampling of totals:
    Σ_S (1−π_i)·t_i², outlier-pinned rows at π = 1 (§6.3)."""
    pi = _f32(m, t)
    if OUTLIER_COL in rel.columns:
        pi = torch.where(rel.col(OUTLIER_COL).to(torch.bool), _f32(1.0, pi), pi)
    var = zeros_where(mask, (1.0 - pi) * t * t).sum()
    return var.clamp(min=0.0).sqrt()


def svc_aqp(clean_sample: Relation, query: Query, m: float, confidence: float = 0.95) -> Estimate:
    """Direct estimate from the clean sample (§5.1)."""
    g = _gamma(confidence)
    if query.agg in ("sum", "count"):
        t, mask = trans_values(clean_sample, query, m)
        _k, s, _mean, _var = _masked_moments(t, mask)
        stderr = _ht_stderr(t, mask, clean_sample, m)
        value = s
    elif query.agg == "avg":
        t, mask = trans_values(clean_sample, query, m)
        k, _s, mean, var = _masked_moments(t, mask)
        stderr = (var / k.clamp(min=1.0)).sqrt()
        value = mean
    else:
        raise ValueError(f"svc_aqp CLT path supports sum/count/avg, got {query.agg}")
    return Estimate(value, stderr, value - g * stderr, value + g * stderr, "SVC+AQP", confidence)


# ---------------------------------------------------------------------------
# Correspondence subtraction (Def. 4) and SVC+CORR
# ---------------------------------------------------------------------------

def correspondence_diff(
    clean_sample: Relation, stale_sample: Relation, query: Query, m: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-key diff table: trans(Ŝ') −̇ trans(Ŝ) with Ø→0 (Def. 4)."""
    d, mask, _ = correspondence_diff_stratified(clean_sample, stale_sample, query, m)
    return d, mask


def correspondence_join(
    clean_sample: Relation, stale_sample: Relation, query: Query, m: float
) -> Relation:
    """The outer join of trans(Ŝ') and trans(Ŝ) on the view key: columns
    ``__t_new``/``__t_old`` hold each side's §5.2.1 value (Ø→0)."""
    pk = clean_sample.schema.pk
    t_new, _ = trans_values(clean_sample, query, m)
    t_old, _ = trans_values(stale_sample, query, m)
    new_cols = {**clean_sample.columns, "__t": t_new}
    old_cols = {**stale_sample.columns, "__t": t_old}
    new_t = Relation(new_cols, clean_sample.valid, clean_sample.schema.with_columns(tuple(new_cols)))
    old_t = Relation(old_cols, stale_sample.valid, stale_sample.schema.with_columns(tuple(old_cols)))
    return ops.outer_join_unique(new_t, old_t, on=pk, how="outer", suffixes=("_new", "_old"))


def correspondence_diff_stratified(
    clean_sample: Relation, stale_sample: Relation, query: Query, m: float
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(d_i, mask, ompi_d): the Def. 4 diff plus its per-row 1−π factor
    (0 for rows flagged ``__outlier`` on either side, §6.3)."""
    joined = correspondence_join(clean_sample, stale_sample, query, m)
    d = joined.col("__t_new") - joined.col("__t_old")  # Ø filled with 0 by the join
    pinned = torch.zeros_like(joined.valid)
    for side in ("_new", "_old"):
        flag = joined.columns.get(OUTLIER_COL + side)
        if flag is not None:
            pinned = pinned | flag.to(torch.bool)
    ompi_d = torch.where(pinned, _f32(0.0, d), _f32(1.0 - m, d))
    return zeros_where(joined.valid, d), joined.valid, ompi_d


def svc_corr(
    stale_result: torch.Tensor,
    clean_sample: Relation,
    stale_sample: Relation,
    query: Query,
    m: float,
    confidence: float = 0.95,
) -> Estimate:
    """Correction estimate: q(S) + ĉ with CLT bounds on the diff (§5.1/5.2.1)."""
    g = _gamma(confidence)
    if query.agg in ("sum", "count"):
        d, mask, ompi_d = correspondence_diff_stratified(clean_sample, stale_sample, query, m)
        _k, s, _mean, _var = _masked_moments(d, mask)
        c = s
        stderr = zeros_where(mask, ompi_d * d * d).sum().clamp(min=0.0).sqrt()
    elif query.agg == "avg":
        new_est = svc_aqp(clean_sample, query, m, confidence)
        old_est = svc_aqp(stale_sample, query, m, confidence)
        c = new_est.value - old_est.value
        d, mask = correspondence_diff(clean_sample, stale_sample, query, m)
        _k, _s, _mean, var = _masked_moments(d, mask)
        kc = _cond_mask(clean_sample, query).to(torch.float32).sum().clamp(min=1.0)
        stderr = (var / kc).sqrt()
    else:
        raise ValueError(f"svc_corr CLT path supports sum/count/avg, got {query.agg}")
    value = stale_result + c
    return Estimate(value, stderr, value - g * stderr, value + g * stderr, "SVC+CORR", confidence)


# ---------------------------------------------------------------------------
# §5.2.2: AQP vs CORR break-even analysis
# ---------------------------------------------------------------------------

def variance_comparison(
    clean_sample: Relation, stale_sample: Relation, query: Query, m: float
):
    """Estimate (var_AQP, var_CORR, cov, corr_wins) from the samples."""
    t_new, mask_new = trans_values(clean_sample, query, m)
    _, _, _, var_new = _masked_moments(t_new, mask_new)
    t_old, mask_old = trans_values(stale_sample, query, m)
    _, _, _, var_old = _masked_moments(t_old, mask_old)
    d, mask_d, ompi_d = correspondence_diff_stratified(clean_sample, stale_sample, query, m)
    _, _, _, var_d = _masked_moments(d, mask_d)
    cov = 0.5 * (var_old + var_new - var_d)
    ht_aqp = _ht_stderr(t_new, mask_new, clean_sample, m) ** 2
    ht_corr = zeros_where(mask_d, ompi_d * d * d).sum()
    return {
        "var_aqp": ht_aqp,
        "var_corr": ht_corr,
        "cov": cov,
        "corr_wins": ht_corr <= ht_aqp,
    }
