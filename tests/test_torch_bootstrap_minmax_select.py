"""Bootstrap CIs (§5.2.5), min/max Cantelli (app. 12.1.1) and select
patching (app. 12.1.2): the port against the JAX package.

Torch's generator cannot give ``jax.random``'s stream, so the bootstrap
parity cases draw the uniforms with numpy and feed them to both packages
(JAX through ``jax.vmap(_resample_stat)`` over ``_gather_cond``'s output,
as ``bootstrap_aqp``/``bootstrap_corr`` compose them).  Replicate stats,
point, lo, hi and stderr agree within 1e-6 relative; min/max values, the
Cantelli probability and the select counts within 1e-6; the patched
selection row for row.  The coverage cases mirror
tests/test_bootstrap_minmax_select.py with the port's own generator.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.relational.expr as jexpr
import repro_torch.core as tcore
import repro_torch.relational.expr as texpr
from repro.core.bootstrap import _gather_cond, _resample_stat
from repro.core.estimators import masked_quantile as jax_masked_quantile
from repro.core.hashing import apply_hash as jax_apply_hash
from repro.core.minmax import svc_minmax as jax_svc_minmax
from repro.core.select_queries import svc_select as jax_svc_select
from repro.relational.relation import from_columns as jax_from_columns
from repro.relational.relation import to_host as jax_to_host
from repro_torch.core.bootstrap import bootstrap_aqp, bootstrap_corr
from repro_torch.core.hashing import apply_hash
from repro_torch.core.minmax import svc_minmax
from repro_torch.core.select_queries import svc_select
from repro_torch.relational.relation import from_columns, to_host

from tests import oracle

B = 200
RTOL = 1e-6


def _close(got, want, rtol=RTOL):
    got, want = float(got), float(want)
    assert abs(got - want) <= rtol * max(abs(got), abs(want), 1e-30), (got, want)


def _views(rng, n=800, drift=1.0, cap=None):
    """(stale, fresh) column dicts over keys 0..n-1, as the JAX tests build them."""
    base = rng.normal(50.0, 10.0, n).astype(np.float32)
    fresh = base + rng.normal(drift, 2.0, n).astype(np.float32)
    k = np.arange(n, dtype=np.int32)
    return {"k": k, "v": base}, {"k": k, "v": fresh}, cap or n + 100


def _pair(cols, cap, m, seed):
    """The same hashed sample in both packages."""
    j = jax_apply_hash(jax_from_columns(cols, pk=["k"], capacity=cap), ("k",), m, seed)
    t = apply_hash(from_columns(cols, pk=["k"], capacity=cap, device="cpu"), ("k",), m, seed)
    return j, t


def _queries(core, X):
    pred = X.Cmp("gt", X.Col("v"), X.Lit(45.0))
    return [core.Query("median", "v"), core.Query("percentile", "v", q=0.9),
            core.Query("percentile", "v", pred=pred, q=0.25), core.Query("median", "v", pred=pred)]


def _jax_stats(rel, q, us):
    values, k = _gather_cond(rel, q)
    qq = 0.5 if q.agg == "median" else q.q
    return np.asarray(jax.vmap(lambda u: _resample_stat(values, k, u, qq))(jnp.asarray(us))), \
        values, k, qq


# ---------------------------------------------------------------------------
# bootstrap, with injected uniforms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("qi", range(4))
@pytest.mark.parametrize("m", [0.25, 0.6])
def test_bootstrap_aqp_matches_jax_under_the_same_uniforms(qi, m):
    rng = np.random.default_rng(qi)
    _stale, fresh, cap = _views(rng)
    jf, tf = _pair(fresh, cap, m, qi)
    jq, tq = _queries(jcore, jexpr)[qi], _queries(tcore, texpr)[qi]
    us = rng.random((B, cap)).astype(np.float32)
    stats, values, k, qq = _jax_stats(jf, jq, us)
    est = bootstrap_aqp(tf, tq, us=torch.from_numpy(us))
    _close(est.value, jax_masked_quantile(values, jnp.arange(values.shape[0]) < k, qq))
    _close(est.ci_low, jnp.quantile(stats, 0.025))
    _close(est.ci_high, jnp.quantile(stats, 0.975))
    _close(est.stderr, jnp.std(stats))
    assert est.method == "SVC+AQP(bootstrap)" and float(est.ci_low) <= float(est.ci_high)
    # the replicate stats themselves, one by one
    from repro_torch.core.bootstrap import gather_cond, resample_stats

    tv, tk = gather_cond(tf, tq)
    assert int(tk) == int(k)
    np.testing.assert_array_equal(tv.numpy()[: int(tk)], np.asarray(values)[: int(k)])
    np.testing.assert_allclose(resample_stats(tv, tk, torch.from_numpy(us), qq).numpy(), stats,
                               rtol=RTOL, atol=0)


@pytest.mark.parametrize("qi", range(4))
def test_bootstrap_corr_matches_jax_under_the_same_uniforms(qi):
    rng = np.random.default_rng(10 + qi)
    stale, fresh, cap = _views(rng, drift=5.0)
    jf, tf = _pair(fresh, cap, 0.25, 3)
    js, ts = _pair(stale, cap, 0.25, 3)
    jq, tq = _queries(jcore, jexpr)[qi], _queries(tcore, texpr)[qi]
    u_new = rng.random((B, cap)).astype(np.float32)
    u_old = rng.random((B, cap)).astype(np.float32)
    s_new, *_ = _jax_stats(jf, jq, u_new)
    s_old, *_ = _jax_stats(js, jq, u_old)
    cs = jnp.asarray(s_new) - jnp.asarray(s_old)
    stale_j = jcore.exact(jax_from_columns(stale, pk=["k"], capacity=cap), jq)
    stale_t = tcore.exact(from_columns(stale, pk=["k"], capacity=cap, device="cpu"), tq)
    _close(stale_t, stale_j)
    est = bootstrap_corr(stale_t, tf, ts, tq, us=(torch.from_numpy(u_new), torch.from_numpy(u_old)))
    _close(est.value, stale_j + jnp.median(cs))
    _close(est.ci_low, stale_j + jnp.quantile(cs, 0.025))
    _close(est.ci_high, stale_j + jnp.quantile(cs, 0.975))
    _close(est.stderr, jnp.std(cs))
    assert est.method == "SVC+CORR(bootstrap)"


def test_bootstrap_draws_from_the_generator_and_defaults_to_seed_zero():
    rng = np.random.default_rng(5)
    _stale, fresh, cap = _views(rng)
    _jf, tf = _pair(fresh, cap, 0.3, 1)
    q = tcore.Query("median", "v")
    a = bootstrap_aqp(tf, q)
    b = bootstrap_aqp(tf, q, rng=torch.Generator().manual_seed(0))
    c = bootstrap_aqp(tf, q, rng=torch.Generator().manual_seed(1))
    assert (float(a.ci_low), float(a.ci_high)) == (float(b.ci_low), float(b.ci_high))
    assert (float(a.ci_low), float(a.ci_high)) != (float(c.ci_low), float(c.ci_high))
    assert float(a.value) == float(c.value)  # the point does not resample


def test_bootstrap_median_coverage():
    rng = np.random.default_rng(0)
    _stale, fresh, cap = _views(rng)
    q = tcore.Query(agg="median", col="v")
    truth = float(tcore.exact(from_columns(fresh, pk=["k"], capacity=cap, device="cpu"), q))
    covered = 0
    trials = 20
    for seed in range(trials):
        _jf, f_hat = _pair(fresh, cap, 0.25, seed)
        est = bootstrap_aqp(f_hat, q, torch.Generator().manual_seed(seed), B=150)
        covered += float(est.ci_low) - 0.5 <= truth <= float(est.ci_high) + 0.5
    assert covered / trials >= 0.8


def test_bootstrap_corr_tracks_truth():
    rng = np.random.default_rng(1)
    stale, fresh, cap = _views(rng, drift=5.0)
    q = tcore.Query(agg="median", col="v")
    truth = float(tcore.exact(from_columns(fresh, pk=["k"], capacity=cap, device="cpu"), q))
    stale_res = tcore.exact(from_columns(stale, pk=["k"], capacity=cap, device="cpu"), q)
    _jf, f_hat = _pair(fresh, cap, 0.25, 3)
    _js, s_hat = _pair(stale, cap, 0.25, 3)
    est = bootstrap_corr(stale_res, f_hat, s_hat, q, torch.Generator().manual_seed(0), B=200)
    assert abs(float(est.value) - truth) < 2.0  # |median drift| ≈ 5 captured


# ---------------------------------------------------------------------------
# min / max
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("agg", ["max", "min"])
@pytest.mark.parametrize("with_pred", [False, True])
@pytest.mark.parametrize("m", [0.3, 1.0])
def test_minmax_matches_jax(agg, with_pred, m):
    rng = np.random.default_rng(2)
    stale, fresh, cap = _views(rng, drift=8.0)
    jf, tf = _pair(fresh, cap, m, 5)
    js, ts = _pair(stale, cap, m, 5)

    def query(core, X):
        pred = X.Cmp("lt", X.Col("v"), X.Lit(60.0)) if with_pred else None
        return core.Query(agg, "v", pred=pred)

    jq, tq = query(jcore, jexpr), query(tcore, texpr)
    stale_j = jcore.exact(jax_from_columns(stale, pk=["k"], capacity=cap), jq)
    stale_t = tcore.exact(from_columns(stale, pk=["k"], capacity=cap, device="cpu"), tq)
    want = jax_svc_minmax(stale_j, jf, js, jq, m)
    got = svc_minmax(stale_t, tf, ts, tq, m)
    _close(got.value, want.value)
    _close(got.exceed_prob, want.exceed_prob)
    assert got.method == want.method == f"SVC+{agg}"
    assert 0.0 <= float(got.exceed_prob) <= 1.0


def test_minmax_correction():
    rng = np.random.default_rng(2)
    stale, fresh, cap = _views(rng, drift=8.0)
    for agg in ("max", "min"):
        q = tcore.Query(agg=agg, col="v")
        truth = float(tcore.exact(from_columns(fresh, pk=["k"], capacity=cap, device="cpu"), q))
        stale_res = tcore.exact(from_columns(stale, pk=["k"], capacity=cap, device="cpu"), q)
        _jf, f_hat = _pair(fresh, cap, 0.3, 5)
        _js, s_hat = _pair(stale, cap, 0.3, 5)
        est = svc_minmax(stale_res, f_hat, s_hat, q, 0.3)
        assert abs(float(est.value) - truth) <= abs(float(stale_res) - truth) + 1e-3
        assert 0.0 <= float(est.exceed_prob) <= 1.0


# ---------------------------------------------------------------------------
# select
# ---------------------------------------------------------------------------

def _select_views(rng, n=300):
    base = rng.normal(0.0, 1.0, n).astype(np.float32)
    fresh_v = base.copy()
    fresh_v[:30] += 10.0  # updated rows now satisfy the predicate
    keys = np.arange(n, dtype=np.int32)
    stale = {"k": keys, "v": base}
    fresh = {"k": np.concatenate([keys[20:], np.arange(n, n + 15, dtype=np.int32)]),
             "v": np.concatenate([fresh_v[20:], np.full(15, 7.0, np.float32)])}
    return stale, fresh, fresh_v


@pytest.mark.parametrize("m", [1.0, 0.4])
def test_select_matches_jax_row_for_row(m):
    rng = np.random.default_rng(3)
    stale, fresh, _ = _select_views(rng)
    cap = 350
    j_stale = jax_from_columns(stale, pk=["k"], capacity=cap)
    t_stale = from_columns(stale, pk=["k"], capacity=cap, device="cpu")
    jf, tf = _pair(fresh, cap, m, 2)
    js, ts = _pair(stale, cap, m, 2)
    want = jax_svc_select(j_stale, jf, js, jexpr.Cmp("gt", jexpr.Col("v"), jexpr.Lit(5.0)), m)
    got = svc_select(t_stale, tf, ts, texpr.Cmp("gt", texpr.Col("v"), texpr.Lit(5.0)), m)
    a, b = to_host(got.patched), jax_to_host(want.patched)
    oa, ob = np.argsort(a["k"]), np.argsort(b["k"])
    assert set(a) == set(b)
    for col in a:
        np.testing.assert_array_equal(a[col][oa], b[col][ob])
    assert got.patched.capacity == want.patched.valid.shape[0]
    for name in ("n_updated", "n_added", "n_deleted"):
        g, w = getattr(got, name), getattr(want, name)
        _close(g.value, w.value)
        _close(g.stderr, w.stderr)
        # value ∓ z·stderr: 1e-6 of the two terms, not of their difference
        scale = abs(float(w.value)) + abs(float(w.ci_high) - float(w.value))
        for x, y in ((g.ci_low, w.ci_low), (g.ci_high, w.ci_high)):
            assert abs(float(x) - float(y)) <= RTOL * scale, (name, float(x), float(y))
        assert g.method == w.method
        assert float(g.ci_low) <= float(g.value) <= float(g.ci_high)


def test_select_query_patching():
    rng = np.random.default_rng(3)
    n = 300
    base = rng.normal(0.0, 1.0, n).astype(np.float32)
    fresh_v = base.copy()
    fresh_v[:30] += 10.0
    stale = from_columns({"k": np.arange(n, dtype=np.int32), "v": base}, pk=["k"],
                         capacity=n + 50, device="cpu")
    fresh = from_columns({"k": np.arange(n, dtype=np.int32), "v": fresh_v}, pk=["k"],
                         capacity=n + 50, device="cpu")
    pred = texpr.Cmp("gt", texpr.Col("v"), texpr.Lit(5.0))
    res = svc_select(stale, apply_hash(fresh, ("k",), 1.0, 0), apply_hash(stale, ("k",), 1.0, 0),
                     pred, m=1.0)
    got = {int(r["k"]) for r in oracle.from_relation(res.patched)}
    assert got == {i for i in range(n) if fresh_v[i] > 5.0}
    assert float(res.n_updated.value) >= 25
