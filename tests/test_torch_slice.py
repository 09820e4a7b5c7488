"""The single-view SVC loop in both packages from the same numpy data.

The quickstart scenario (visitView over Log ⋈ Video, 500 videos, 10,000
sessions, a 2,000-session delta, m = 0.1, then an outlier index with
k = 50) runs through ``repro.views.ViewManager`` and through
``repro_torch.views.ViewManager(device="cpu")``.  Samples must be
row-identical (keys, counts and flags exact, sums within 1e-6 relative),
answers must take the same estimator with value and CI within 1e-5
relative, and the port started from JAX-made state must answer the same.
"""

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.relational.expr as jexpr
import repro.relational.plan as jplan
import repro_torch.core as tcore
import repro_torch.relational.expr as texpr
import repro_torch.relational.plan as tplan
import repro.query as jquery
import repro_torch.query as tquery
from repro.core.outliers import build_outlier_index as jax_build_index
from repro.core.outliers import update_outlier_index as jax_update_index
from repro.data.synthetic import grow_log as jax_grow_log
from repro.data.synthetic import make_log_video as jax_make_log_video
from repro.relational.relation import from_columns as jax_from_columns
from repro.relational.relation import to_host as jax_to_host
from repro.views import ViewManager as JaxViewManager
from repro_torch.core.outliers import build_outlier_index, outlier_index_from_arrays
from repro_torch.core.outliers import update_outlier_index
from repro_torch.data.synthetic import grow_log, make_log_video
from repro_torch.relational.relation import from_arrays, from_columns, to_host
from repro_torch.views import ViewManager

N_VIDEOS, N_LOGS, N_DELTA, GROUPS, M, K = 500, 10_000, 2_000, 768, 0.1, 50


def view_plan(P):
    return P.GroupByNode(
        child=P.FKJoin(fact=P.Scan("Log", pk=("sessionId",)),
                       dim=P.Scan("Video", pk=("videoId",)), fact_key="videoId"),
        keys=("videoId",),
        aggs=(("visitCount", "count", None), ("totalBytes", "sum", "bytes")),
        num_groups=GROUPS,
    )


def dashboard(core, X):
    """16 sum/count/avg queries with 0–2 predicates, built in one package."""
    Q, vc, tb, vid = core.Query, X.Col("visitCount"), X.Col("totalBytes"), X.Col("videoId")
    return [
        Q("count"), Q("sum", "visitCount"), Q("sum", "totalBytes"), Q("avg", "totalBytes"),
        Q("avg", "visitCount"),
        Q("count", pred=X.Cmp("gt", vc, X.Lit(30.0))),
        Q("sum", "totalBytes", pred=X.Cmp("ge", vid, X.Lit(450.0))),
        Q("count", pred=X.Cmp("ge", vid, X.Lit(450.0))),
        Q("avg", "totalBytes", pred=X.Cmp("gt", vc, X.Lit(10.0))),
        Q("sum", "visitCount", pred=X.and_(X.Cmp("ge", vid, X.Lit(0.0)),
                                           X.Cmp("lt", vid, X.Lit(250.0)))),
        Q("sum", "totalBytes", pred=X.and_(X.Cmp("gt", vc, X.Lit(5.0)),
                                           X.Cmp("lt", vid, X.Lit(450.0)))),
        Q("count", pred=X.and_(X.Cmp("ge", vc, X.Lit(2.0)), X.Cmp("le", vc, X.Lit(50.0)))),
        Q("avg", "visitCount", pred=X.Cmp("lt", vid, X.Lit(100.0))),
        Q("sum", "totalBytes", pred=X.Cmp("le", vc, X.Lit(3.0))),
        Q("count", pred=X.Cmp("eq", vc, X.Lit(1.0))),
        Q("avg", "totalBytes", pred=X.and_(X.Cmp("ge", vid, X.Lit(450.0)),
                                           X.Cmp("gt", vc, X.Lit(1.0)))),
    ]


def off_engine(core, X):
    """Queries the batched engine cannot encode (``ne``, ``or``, min, max):
    the per-query estimators answer them."""
    vc, vid = X.Col("visitCount"), X.Col("videoId")
    return [core.Query("sum", "totalBytes", pred=X.Cmp("ne", vc, X.Lit(1.0))),
            core.Query("avg", "visitCount", pred=X.or_(X.Cmp("lt", vid, X.Lit(50.0)),
                                                       X.Cmp("gt", vid, X.Lit(450.0)))),
            core.Query("max", "totalBytes"),
            core.Query("min", "visitCount", pred=X.Cmp("gt", vid, X.Lit(10.0)))]


def sorted_rows(h):
    order = np.argsort(h["videoId"], kind="stable")
    return {k: v[order] for k, v in h.items()}


def answers(vm, name, queries):
    out = {}
    for prefer in (None, "aqp"):
        out[("batch", prefer)] = vm.query_batch(name, queries, prefer=prefer)
        out[("single", prefer)] = [vm.query(name, q, prefer=prefer) for q in queries[:4]]
    return out


def run_jax():
    rng = np.random.default_rng(0)
    log, video = jax_make_log_video(rng, N_VIDEOS, N_LOGS)
    delta = jax_grow_log(rng, N_VIDEOS, N_LOGS, N_DELTA)
    delta2 = jax_grow_log(rng, N_VIDEOS, N_LOGS + N_DELTA, 500)
    vm = JaxViewManager()
    vm.register_base("Log", log)
    vm.register_base("Video", video)
    vm.register_view(jcore.ViewDef("visitView", view_plan(jplan)), delta_bases=("Log",),
                     m=M, delta_group_capacity=GROUPS)
    queries = dashboard(jcore, jexpr)
    vm.ingest("Log", inserts=delta)
    vm.svc_refresh("visitView")
    mv = vm.views["visitView"]
    out = {"s1": (mv.stale_sample, mv.clean_sample), "a1": answers(vm, "visitView", queries),
           "fresh": [float(vm.query_exact_fresh("visitView", q)) for q in queries]}
    vm.register_outlier_index("visitView", "Log", "bytes", k=K)
    vm.svc_refresh("visitView")
    out["s2"] = (mv.stale_sample, mv.clean_sample)
    out["a2"] = answers(vm, "visitView", queries)
    out["fallback"] = [vm.query("visitView", q, prefer=p)
                       for q in off_engine(jcore, jexpr) for p in (None, "corr", "aqp")]
    batch = jquery.QueryBatch.encode(queries, jquery.sample_columns(mv.clean_sample))
    out["variance"] = jquery.variance_report(vm._corr_cache(mv), batch)
    # state the port is started from: base, view, index and pending deltas
    out["carry"] = {
        "base": dict(vm.base), "materialized": mv.materialized,
        "stale_sample": mv.stale_sample, "index": mv.outlier_index,
        "pending": vm.pending.inserts["Log"],
    }
    vm.ingest("Log", inserts=delta2)
    vm.svc_refresh("visitView")
    out["s3"] = (mv.stale_sample, mv.clean_sample)
    out["a3"] = answers(vm, "visitView", queries)
    return out


def run_port():
    rng = np.random.default_rng(0)
    log, video = make_log_video(rng, N_VIDEOS, N_LOGS, device="cpu")
    delta = grow_log(rng, N_VIDEOS, N_LOGS, N_DELTA, device="cpu")
    vm = ViewManager(device="cpu")
    vm.register_base("Log", log)
    vm.register_base("Video", video)
    vm.register_view(tcore.ViewDef("visitView", view_plan(tplan)), delta_bases=("Log",),
                     m=M, delta_group_capacity=GROUPS)
    queries = dashboard(tcore, texpr)
    vm.ingest("Log", inserts=delta)
    mv = vm.views["visitView"]
    out = {}
    vm.svc_refresh("visitView", fused=False)
    out["u1"] = mv.clean_sample
    vm.svc_refresh("visitView")
    out["s1"] = (mv.stale_sample, mv.clean_sample)
    out["a1"] = answers(vm, "visitView", queries)
    out["fresh"] = [float(vm.query_exact_fresh("visitView", q)) for q in queries]
    vm.register_outlier_index("visitView", "Log", "bytes", k=K)
    vm.svc_refresh("visitView")
    out["s2"] = (mv.stale_sample, mv.clean_sample)
    out["a2"] = answers(vm, "visitView", queries)
    out["fallback"] = [vm.query("visitView", q, prefer=p)
                       for q in off_engine(tcore, texpr) for p in (None, "corr", "aqp")]
    batch = tquery.QueryBatch.encode(queries, tquery.sample_columns(mv.clean_sample), "cpu")
    out["variance"] = tquery.variance_report(vm._corr_cache(mv), batch)
    vm.svc_refresh("visitView", fused=False)
    out["u2"] = mv.clean_sample
    vm.maintain_all()
    out["after_ivm"] = [(float(vm.query_stale("visitView", q)),
                         float(vm.query_exact_fresh("visitView", q))) for q in queries]
    return out


@pytest.fixture(scope="module")
def jax_run():
    return run_jax()


@pytest.fixture(scope="module")
def port_run():
    return run_port()


def assert_same_sample(got, want):
    """Row-identical: keys, counts and outlier flags exact; sums ≤ 1e-6."""
    assert got.capacity == want.capacity
    a, b = sorted_rows(to_host(got)), sorted_rows(jax_to_host(want))
    assert set(a) == set(b)
    for col in a:
        if col == "totalBytes":
            np.testing.assert_allclose(a[col], b[col], rtol=1e-6, atol=0)
        else:
            assert np.array_equal(a[col], b[col]), col
    assert a["videoId"].size > 0


def assert_same_answers(got, want):
    for key in want:
        assert len(got[key]) == len(want[key])
        for g, w in zip(got[key], want[key]):
            assert g.method == w.method, key
            for x, y in ((g.value, w.value), (g.ci_low, w.ci_low), (g.ci_high, w.ci_high)):
                x, y = float(x), float(y)
                assert abs(x - y) <= 1e-5 * max(abs(x), abs(y), 1.0), (key, x, y)


@pytest.mark.parametrize("stage", ["s1", "s2"])
def test_stale_and_clean_samples_row_identical(jax_run, port_run, stage):
    for got, want in zip(port_run[stage], jax_run[stage]):
        assert_same_sample(got, want)
    if stage == "s2":
        assert to_host(port_run[stage][1])["__outlier"].sum() > 0


@pytest.mark.parametrize("stage", ["1", "2"])
def test_fused_and_unfused_refresh_give_the_same_sample(port_run, stage):
    fused, unfused = to_host(port_run["s" + stage][1]), to_host(port_run["u" + stage])
    a, b = sorted_rows(fused), sorted_rows(unfused)
    for col in a:
        if col == "totalBytes":
            np.testing.assert_allclose(a[col], b[col], rtol=1e-6, atol=0)
        else:
            assert np.array_equal(a[col], b[col]), col


@pytest.mark.parametrize("stage", ["a1", "a2"])
def test_query_and_query_batch_match_jax(jax_run, port_run, stage):
    assert_same_answers(port_run[stage], jax_run[stage])
    methods = {e.method for e in port_run[stage][("batch", None)]}
    assert methods <= {"SVC+CORR", "SVC+AQP"}


def test_queries_off_the_engine_use_the_per_query_estimators(jax_run, port_run):
    assert_same_answers({"fallback": port_run["fallback"]}, {"fallback": jax_run["fallback"]})


def test_variance_report_matches_jax(jax_run, port_run):
    got, want = port_run["variance"], jax_run["variance"]
    assert np.array_equal(got["corr_wins"], np.asarray(want["corr_wins"]))
    for key in ("var_aqp", "var_corr", "cov"):
        np.testing.assert_allclose(got[key], np.asarray(want[key]), rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("k", [8, 400])
@pytest.mark.parametrize("incremental", [True, False])
def test_outlier_index_build_and_update_match_jax(k, incremental):
    rng = np.random.default_rng(k)

    def rel(n, start):
        cols = {"rid": np.arange(start, start + n, dtype=np.int32),
                "v": rng.integers(0, 1000, n).astype(np.float32)}  # ties on purpose
        return cols

    base, delta = rel(300, 0), rel(120, 1000)
    jb = jax_build_index(jax_from_columns(base, pk=["rid"], capacity=310), "T", "v", k)
    tb = build_outlier_index(from_columns(base, pk=["rid"], capacity=310, device="cpu"),
                             "T", "v", k)
    ju = jax_update_index(jb, jax_from_columns(delta, pk=["rid"]), incremental=incremental)
    tu = update_outlier_index(tb, from_columns(delta, pk=["rid"], device="cpu"),
                              incremental=incremental)
    for got, want in ((tb, jb), (tu, ju)):
        assert float(got.threshold) == float(want.threshold)
        assert np.array_equal(got.records.valid.numpy(), np.asarray(want.records.valid))
        for c in ("rid", "v"):  # same rows in the same (descending) slots
            assert np.array_equal(got.records.col(c).numpy()[got.records.valid.numpy()],
                                  np.asarray(want.records.col(c))[np.asarray(want.records.valid)])


def test_exact_fresh_matches_and_ivm_makes_the_view_exact(jax_run, port_run):
    np.testing.assert_allclose(port_run["fresh"], jax_run["fresh"], rtol=1e-6)
    for stale, fresh in port_run["after_ivm"]:
        assert stale == fresh


def test_port_started_from_jax_state_answers_the_same(jax_run):
    """Carry JAX-made base, view, sample, index and pending delta across at
    full capacity, ingest one more delta, refresh: same sample and answers."""
    c = jax_run["carry"]

    def carry(rel):
        return from_arrays({k: np.asarray(v) for k, v in rel.columns.items()},
                           np.asarray(rel.valid), rel.schema.pk, "cpu")

    vm = ViewManager(device="cpu")
    for name, rel in c["base"].items():
        vm.register_base(name, carry(rel))
    mv = vm.register_view(tcore.ViewDef("visitView", view_plan(tplan)), delta_bases=("Log",),
                          m=M, delta_group_capacity=GROUPS)
    # the pending delta arrived before the index existed, so it is no offer
    vm.ingest("Log", inserts=carry(c["pending"]))
    idx = c["index"]
    mv.outlier_index = outlier_index_from_arrays(
        idx.base, idx.attr, idx.capacity,
        {k: np.asarray(v) for k, v in idx.records.columns.items()},
        np.asarray(idx.records.valid), idx.records.schema.pk, float(idx.threshold), "cpu")
    mv.materialized = carry(c["materialized"])
    mv.stale_sample = mv.clean_sample = carry(c["stale_sample"])
    assert mv.materialized.capacity == c["materialized"].capacity
    rng = np.random.default_rng(0)  # replay the generator to the second delta
    make_log_video(rng, N_VIDEOS, N_LOGS, device="cpu")
    grow_log(rng, N_VIDEOS, N_LOGS, N_DELTA, device="cpu")
    vm.ingest("Log", inserts=grow_log(rng, N_VIDEOS, N_LOGS + N_DELTA, 500, device="cpu"))
    vm.svc_refresh("visitView")
    for got, want in zip((mv.stale_sample, mv.clean_sample), jax_run["s3"]):
        assert_same_sample(got, want)
    assert_same_answers(answers(vm, "visitView", dashboard(tcore, texpr)), jax_run["a3"])
    assert isinstance(mv.outlier_index.threshold, torch.Tensor)
