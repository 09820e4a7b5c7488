"""Serving plane: admission, the staleness-keyed result cache and the
degrade bound, in the port against the JAX package.

Mirrors tests/test_serving_plane.py where it touches
``robustness/degrade.py``, ``serving/result_cache.py`` and
``serving/admission.py``, and its FaultPlan chaos cases (duplicate_batch,
traffic_spike, slow_drain, cache_poison through a plan).  Digests,
verdict sequences, widened intervals, injection logs and the chaos
counters must equal JAX's; a cache hit returns the very Estimate it
stored and computes nothing.
"""

import dataclasses

import numpy as np
import pytest

import repro.core as jcore
import repro.relational.expr as jexpr
import repro.relational.plan as jplan
import repro.serving as jserving
import repro_torch.core as tcore
import repro_torch.relational.expr as texpr
import repro_torch.relational.plan as tplan
from repro.data.synthetic import grow_log as jax_grow_log
from repro.data.synthetic import make_log_video as jax_make_log_video
from repro.robustness import FaultPlan as JFaultPlan
from repro.robustness import FaultSpec as JFaultSpec
from repro.robustness.degrade import widen_estimate as jax_widen_estimate
from repro.streaming import StreamConfig as JStreamConfig
from repro.views import ViewManager as JaxViewManager
from repro_torch.core.estimators import Estimate
from repro_torch.data.synthetic import grow_log, make_log_video
from repro_torch.robustness import FaultPlan, FaultSpec
from repro_torch.robustness.degrade import pending_delta_bound, widen_estimate
from repro_torch.serving import (
    ADMIT,
    SHED,
    THROTTLE,
    AdmissionConfig,
    AdmissionController,
    ResultCache,
    TokenBucket,
    predicate_digest,
    query_key,
)
from repro_torch.streaming import StreamConfig
from repro_torch.views import ViewManager


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _plan(P):
    return P.GroupByNode(
        child=P.FKJoin(fact=P.Scan("Log", pk=("sessionId",)),
                       dim=P.Scan("Video", pk=("videoId",)), fact_key="videoId"),
        keys=("videoId",),
        aggs=(("visitCount", "count", None), ("totalBytes", "sum", "bytes")),
        num_groups=512,
    )


def _vm(seed=5, m=0.2):
    rng = np.random.default_rng(0)
    log, video = make_log_video(rng, 300, 6000, device="cpu")
    vm = ViewManager(device="cpu")
    vm.register_base("Log", log)
    vm.register_base("Video", video)
    vm.register_view(tcore.ViewDef("v", _plan(tplan)), delta_bases=("Log",), m=m, seed=seed,
                     delta_group_capacity=512)
    return vm, rng


def _jax_vm(seed=5, m=0.2):
    rng = np.random.default_rng(0)
    log, video = jax_make_log_video(rng, 300, 6000)
    vm = JaxViewManager()
    vm.register_base("Log", log)
    vm.register_base("Video", video)
    vm.register_view(jcore.ViewDef("v", _plan(jplan)), delta_bases=("Log",), m=m, seed=seed,
                     delta_group_capacity=512)
    return vm, rng


def _svc(vm, clock, **cfg_kw):
    cfg_kw.setdefault("max_rows", 10**9)
    cfg_kw.setdefault("max_age_s", 1e9)
    return vm.configure_streaming(StreamConfig(**cfg_kw), clock=clock)


Q_SUM = tcore.Query(agg="sum", col="totalBytes")
Q_CNT = tcore.Query(agg="count")


# ---------------------------------------------------------------------------
# TokenBucket / AdmissionController
# ---------------------------------------------------------------------------

def test_token_bucket_refill_burst_and_skew_clamp():
    clock = FakeClock()
    b = TokenBucket(rate=2.0, burst=4.0, clock=clock)
    assert b.take(4) and not b.take(1)
    assert b.peek() == 0.0
    clock.t = 1.0
    assert b.peek() == pytest.approx(2.0)
    clock.t = 100.0
    assert b.peek() == pytest.approx(4.0)
    b.take(4)
    clock.t = 50.0  # backwards clock: refills nothing, never negative
    assert b.peek() == 0.0
    clock.t = 50.5
    assert b.peek() == pytest.approx(1.0)


def test_admission_verdicts_match_jax_step_by_step():
    cfg = dict(tenant_qps=1, tenant_burst=2, fleet_qps=100, fleet_burst=10)
    clock = FakeClock()
    ctl = AdmissionController(AdmissionConfig(**cfg), clock=clock)
    jctl = jserving.AdmissionController(jserving.AdmissionConfig(**cfg), clock=clock)
    script = ["a"] * 3 + ["b"] + ["c"] * 20 + ["b"]
    for i, tenant in enumerate(script):
        if i == len(script) - 1:
            clock.t = 100.0  # refill: service resumes
        assert ctl.decide(tenant) == jctl.decide(tenant)
        assert ctl.overloaded() == jctl.overloaded()
    assert (ctl.admitted, ctl.throttled, ctl.shed) == (jctl.admitted, jctl.throttled, jctl.shed)
    assert {k: dataclasses.astuple(v) for k, v in ctl.tenant_stats.items()} == \
        {k: dataclasses.astuple(v) for k, v in jctl.tenant_stats.items()}
    assert ctl.metrics.snapshot() == jctl.metrics.snapshot()
    assert ctl.tenant_stats["a"].throttled == 1 and ctl.shed > 0
    assert [ctl.decide("d") for _ in range(3)][-1] == THROTTLE  # tenant d's burst is 2


def test_drain_ewma_overload_sheds_before_buckets():
    ctl = AdmissionController(AdmissionConfig(drain_overload_s=0.5, drain_ewma_alpha=1.0),
                              clock=FakeClock())
    assert ctl.decide() == ADMIT
    ctl.note_drain(2.0)
    assert ctl.overloaded() and ctl.decide() == SHED
    ctl.note_drain(0.0)
    assert ctl.decide() == ADMIT


# ---------------------------------------------------------------------------
# Query digests
# ---------------------------------------------------------------------------

def _keyed_queries(core, X):
    pred = X.Cmp("lt", X.Col("videoId"), X.Lit(10))
    return [core.Query(agg="sum", col="totalBytes"), core.Query(agg="count"),
            core.Query(agg="sum", col="totalBytes", pred=pred),
            core.Query(agg="avg", col="visitCount", pred=X.and_(pred, pred))]


def test_query_keys_equal_jax_and_separate_every_dimension():
    for tq, jq in zip(_keyed_queries(tcore, texpr), _keyed_queries(jcore, jexpr)):
        for conf, prefer in ((0.95, None), (0.99, "aqp")):
            assert query_key(tq, conf, prefer) == jserving.query_key(jq, conf, prefer, None)
    k1 = query_key(Q_SUM, 0.95, None)
    assert k1 == query_key(Q_SUM, 0.95, None)
    assert len({k1, query_key(Q_CNT, 0.95, None), query_key(Q_SUM, 0.99, None),
                query_key(Q_SUM, 0.95, "aqp")}) == 4
    for agg in ("median", "percentile", "min", "max"):
        assert query_key(tcore.Query(agg=agg, col="totalBytes"), 0.95, None) is None
    for sig in ("", "a", "a\0\0\0\0", "x" * 1000):
        assert predicate_digest(sig) == jserving.predicate_digest(sig)


# ---------------------------------------------------------------------------
# Result cache through the service
# ---------------------------------------------------------------------------

def test_cache_hit_is_the_stored_estimate_and_computes_nothing():
    vm, _ = _vm()
    svc = _svc(vm, FakeClock(), cache_capacity=64)
    twin_vm, _ = _vm()
    twin = _svc(twin_vm, FakeClock(), cache_capacity=0)
    calls = []
    real = vm.query_batch
    vm.query_batch = lambda *a, **k: calls.append(a) or real(*a, **k)
    for q in (Q_SUM, Q_CNT):
        miss = svc.query("v", q).estimate
        n = len(calls)
        hit = svc.query("v", q).estimate
        assert len(calls) == n  # no estimator ran
        assert hit is miss
        assert hit == twin.query("v", q).estimate  # and equal to the never-cached path
    assert svc.result_cache.hits == 2 and twin.result_cache is None


def test_cache_answers_match_jax():
    vm, _ = _vm()
    jvm, _ = _jax_vm()
    svc = _svc(vm, FakeClock(), cache_capacity=64)
    jsvc = jvm.configure_streaming(JStreamConfig(max_rows=10**9, max_age_s=1e9,
                                                 cache_capacity=64), clock=FakeClock())
    for tq, jq in zip(_keyed_queries(tcore, texpr), _keyed_queries(jcore, jexpr)):
        for _ in range(2):
            g, w = svc.query("v", tq).estimate, jsvc.query("v", jq).estimate
            assert g.method == w.method
            for x, y in ((g.value, w.value), (g.ci_low, w.ci_low), (g.ci_high, w.ci_high)):
                assert float(x) == pytest.approx(float(y), rel=1e-5)
    assert svc.result_cache.stats() == jsvc.result_cache.stats()


@pytest.mark.parametrize("bump", ["svc_refresh", "maintain", "retune"])
def test_version_bump_invalidates_cached_answers(bump):
    vm, rng = _vm()
    svc = _svc(vm, FakeClock(), cache_capacity=64)
    first = svc.query("v", Q_SUM).estimate
    assert svc.query("v", Q_SUM).estimate is first
    vm.ingest("Log", inserts=grow_log(rng, 300, 6000, 400, device="cpu"), seq=0)
    mv = vm.views["v"]
    v0 = mv.sample_version
    if bump == "svc_refresh":
        svc.refresh()
    elif bump == "maintain":
        svc.refresh()
        vm.ingest("Log", inserts=grow_log(rng, 300, 6000, 400, device="cpu"), seq=1)
        svc.refresh()
        vm.maintain("v")
    else:
        vm._retune_sample_ratio(mv, 0.4)
    assert mv.sample_version > v0
    puts_before = svc.result_cache.puts
    again = svc.query("v", Q_SUM).estimate
    assert svc.result_cache.puts == puts_before + 1
    if bump != "retune":
        assert again.value != first.value


def test_cache_eviction_is_bounded_and_latest_index_survives():
    vm, _ = _vm()
    svc = _svc(vm, FakeClock(), cache_capacity=2)
    queries = [tcore.Query(agg="sum", col="totalBytes",
                           pred=texpr.Cmp("lt", texpr.Col("videoId"), texpr.Lit(10 * (i + 1))))
               for i in range(5)]
    for q in queries:
        svc.query("v", q)
    cache = svc.result_cache
    assert len(cache) == 2 and cache.evictions == 3
    hits0 = cache.hits
    svc.query("v", queries[-1])
    assert cache.hits == hits0 + 1


def test_result_cache_counters_ride_the_registry_and_reject_poison():
    cache = ResultCache(capacity=4)
    est = Estimate(value=1.0, stderr=0.0, ci_low=1.0, ci_high=1.0, method="m", confidence=0.95)
    assert cache.get("v0", 1, (1, 2)) is None
    cache.put("v0", 1, (1, 2), est)
    assert cache.get("v0", 1, (1, 2)) is est
    assert cache.get_any("v0", (1, 2)) == (est, 1)
    assert cache.poison("v0") == 1
    assert cache.get("v0", 1, (1, 2)) is None and cache.poison_rejected == 1
    snap = cache.metrics.snapshot()
    assert (snap["cache_hits"], snap["cache_misses"], snap["cache_stale_hits"]) == (1.0, 2.0, 1.0)


# ---------------------------------------------------------------------------
# Degraded serving: throttle / shed widening, stale-version serves, degrade
# ---------------------------------------------------------------------------

def test_throttle_and_shed_widen_and_tag_but_keep_value():
    vm, rng = _vm()
    svc = _svc(vm, FakeClock(), cache_capacity=64,
               admission=AdmissionConfig(tenant_qps=1, tenant_burst=1, fleet_qps=100,
                                         fleet_burst=2))
    fresh = svc.query("v", Q_SUM)
    svc.offer("Log", inserts=grow_log(rng, 300, 6000, 500, device="cpu"), seq=0)
    throttled = svc.query("v", Q_SUM)
    shed = svc.query("v", Q_SUM)
    assert throttled.estimate.method.endswith("+throttled")
    assert shed.estimate.method.endswith("+shed")
    for r in (throttled, shed):
        assert r.estimate.value == fresh.estimate.value
        assert r.estimate.ci_low < fresh.estimate.ci_low
        assert r.estimate.ci_high > fresh.estimate.ci_high
    st = shed.staleness
    assert (st.admitted_queries, st.throttled_queries, st.shed_queries) == (1, 1, 1)
    assert st.overloaded


def test_shed_serves_stale_version_from_cache_without_recompute():
    for serve_stale in (True, False):
        vm, rng = _vm()
        svc = _svc(vm, FakeClock(), cache_capacity=64, cache_serve_stale=serve_stale,
                   admission=AdmissionConfig(tenant_qps=100, tenant_burst=100, fleet_qps=1,
                                             fleet_burst=1))
        old = svc.query("v", Q_SUM).estimate
        vm.ingest("Log", inserts=grow_log(rng, 300, 6000, 400, device="cpu"), seq=0)
        svc.refresh()
        stale = svc.query("v", Q_SUM)
        assert stale.estimate.method.endswith("+shed")
        assert svc.result_cache.stale_hits == int(serve_stale)
        if serve_stale:
            assert stale.estimate.value == old.value
            assert stale.staleness.cache_stale_hits == 1


def test_widen_estimate_matches_jax():
    vm, rng = _vm()
    jvm, jrng = _jax_vm()
    est = vm.query("v", Q_SUM)
    jest = jvm.query("v", jcore.Query(agg="sum", col="totalBytes"))
    for pending in (0, 250, 10**6):
        for suffix in ("+degraded", "+shed"):
            g = widen_estimate(est, vm.views["v"], pending, suffix=suffix)
            w = jax_widen_estimate(jest, jvm.views["v"], pending, suffix=suffix)
            assert g.method == w.method
            for x, y in ((g.value, w.value), (g.stderr, w.stderr), (g.ci_low, w.ci_low),
                         (g.ci_high, w.ci_high)):
                assert float(x) == pytest.approx(float(y), rel=1e-5)
            assert widen_estimate(g, vm.views["v"], 0, suffix=suffix).method == g.method
    assert pending_delta_bound(vm.views["v"], 0) == 0.0


def test_a_quarantined_view_serves_stale_with_a_widened_interval():
    vm, rng = _vm()
    svc = _svc(vm, FakeClock(), cache_capacity=0, max_rows=100)
    ok = svc.query("v", Q_SUM).estimate
    vm.health.record_failure("v", RuntimeError("clean failed"))
    vm.ingest("Log", inserts=grow_log(rng, 300, 6000, 50, device="cpu"), seq=0)
    res = svc.query("v", Q_SUM)
    assert res.staleness.degraded and "v" in res.staleness.degraded_views
    assert res.estimate.method.endswith("+degraded")
    assert res.estimate.value == ok.value and res.estimate.ci_low < ok.ci_low


# ---------------------------------------------------------------------------
# Idempotent ingest
# ---------------------------------------------------------------------------

def test_offer_dedupe_makes_replay_bit_equal():
    def run(replay):
        vm, rng = _vm()
        svc = _svc(vm, FakeClock(), cache_capacity=0)
        batches = [grow_log(rng, 300, 6000 + 150 * i, 150, device="cpu") for i in range(4)]
        for i, b in enumerate(batches):
            svc.offer("Log", inserts=b, seq=i, key=f"batch-{i}")
            if replay:
                svc.offer("Log", inserts=b, seq=i, key=f"batch-{i}")
        svc.refresh()
        return float(svc.query("v", Q_SUM).estimate.value), svc.staleness()

    once, st_once = run(replay=False)
    twice, st_twice = run(replay=True)
    assert once == twice
    assert st_once.deduped_batches == 0
    assert st_twice.deduped_batches == 4 and st_twice.deduped_rows == 4 * 150


def test_dedupe_survives_drain_and_ignores_unkeyed():
    vm, rng = _vm()
    svc = _svc(vm, FakeClock(), cache_capacity=0)
    b = grow_log(rng, 300, 6000, 100, device="cpu")
    svc.offer("Log", inserts=b, seq=0, key="k0")
    svc.refresh()
    svc.offer("Log", inserts=b, seq=0, key="k0")
    assert svc.staleness().pending_rows == 0
    assert svc.logs["Log"].deduped_batches == 1
    b2 = grow_log(rng, 300, 6100, 100, device="cpu")
    svc.offer("Log", inserts=b2, seq=1)
    svc.offer("Log", inserts=b2, seq=1)
    assert svc.staleness().pending_batches == 2


def test_staleness_counters_are_monotone_over_a_workload():
    fields = ("shed_rows", "corrupt_batches", "spills", "deduped_batches", "deduped_rows",
              "throttled_queries", "shed_queries", "admitted_queries", "cache_hits",
              "cache_stale_hits", "cache_poison_rejected")
    vm, rng = _vm()
    svc = _svc(vm, FakeClock(), auto_refresh=False, admission=AdmissionConfig())
    prev = None
    for epoch in range(4):
        b = grow_log(rng, 300, 6000 + 30 * epoch, 30, device="cpu")
        svc.offer("Log", inserts=b, seq=epoch, key=f"e{epoch}")
        svc.offer("Log", inserts=b, seq=epoch, key=f"e{epoch}")  # at-least-once replay
        svc.refresh()
        svc.query_batch("v", [Q_SUM, Q_SUM])
        st = svc.staleness()
        cur = {f: getattr(st, f) for f in fields}
        assert all(isinstance(v, int) and v >= 0 for v in cur.values())
        if prev is not None:
            assert all(cur[f] >= prev[f] for f in fields)
        prev = cur
    assert prev["deduped_batches"] == 4 and prev["admitted_queries"] == 8
    assert vm.metrics.total("stream_queries") == 8.0
    assert vm.metrics.total("admission_verdicts") == 8.0


# ---------------------------------------------------------------------------
# Chaos kinds through a FaultPlan: duplicate_batch, slow_drain, cache_poison
# ---------------------------------------------------------------------------

def _twins(**cfg_kw):
    """The JAX and the port service over the same data, on one fake clock."""
    clock = FakeClock()
    (jvm, jrng), (tvm, trng) = _jax_vm(), _vm()
    jsvc = jvm.configure_streaming(JStreamConfig(**{"max_rows": 10**9, "max_age_s": 1e9,
                                                    **cfg_kw}), clock=clock)
    return clock, (jvm, jsvc, jrng), (tvm, _svc(tvm, clock, **cfg_kw), trng)


def _log(plan):
    return [(e, dataclasses.astuple(s), w) for e, s, w in plan.injected]


def test_duplicate_batch_fault_carries_key_and_is_absorbed():
    _, (jvm, jsvc, jrng), (tvm, tsvc, trng) = _twins(cache_capacity=0)
    jplan_ = JFaultPlan([JFaultSpec(epoch=0, kind="duplicate_batch", target="Log")]).attach(jvm)
    tplan_ = FaultPlan([FaultSpec(epoch=0, kind="duplicate_batch", target="Log")]).attach(tvm)
    jsvc.offer("Log", inserts=jax_grow_log(jrng, 300, 6000, 120), seq=0, key="k0")
    tsvc.offer("Log", inserts=grow_log(trng, 300, 6000, 120, device="cpu"), seq=0, key="k0")
    for svc in (jsvc, tsvc):
        assert svc.logs["Log"].deduped_batches == 1
        assert svc.staleness().pending_rows == 120
    assert _log(tplan_) == _log(jplan_) == [(0, (0, "duplicate_batch", "Log", 0.0), "offer:Log")]


def test_traffic_spike_multiplier_and_slow_drain_report():
    plans = [plan_t([spec_t(epoch=1, kind="traffic_spike", magnitude=10.0),
                     spec_t(epoch=1, kind="traffic_spike", magnitude=2.0),
                     spec_t(epoch=2, kind="slow_drain", magnitude=3.0)])
             for plan_t, spec_t in ((JFaultPlan, JFaultSpec), (FaultPlan, FaultSpec))]
    seen = []
    for plan in plans:
        got = [plan.traffic_multiplier()]
        plan.advance()
        got += [plan.traffic_multiplier(), plan.drain_latency_s()]
        plan.advance()
        got += [plan.traffic_multiplier(), plan.drain_latency_s()]
        seen.append((got, _log(plan)))
    assert seen[1] == seen[0]
    assert seen[1][0] == [1.0, 20.0, 0.0, 1.0, 3.0] and len(seen[1][1]) == 3


def test_slow_drain_fault_drives_overload_shedding():
    """An injected slow drain pushes the admission EWMA over budget so the
    next queries shed, in the port as in JAX."""
    adm = dict(tenant_qps=1e9, tenant_burst=1e9, fleet_qps=1e9, fleet_burst=1e9,
               drain_overload_s=5.0, drain_ewma_alpha=1.0)
    clock = FakeClock()
    (jvm, jrng), (tvm, trng) = _jax_vm(), _vm()
    jsvc = jvm.configure_streaming(JStreamConfig(max_rows=10**9, max_age_s=1e9,
                                                 cache_capacity=64,
                                                 admission=jserving.AdmissionConfig(**adm)),
                                   clock=clock)
    tsvc = _svc(tvm, clock, cache_capacity=64, admission=AdmissionConfig(**adm))
    JFaultPlan([JFaultSpec(epoch=0, kind="slow_drain", magnitude=60.0)]).attach(jvm)
    FaultPlan([FaultSpec(epoch=0, kind="slow_drain", magnitude=60.0)]).attach(tvm)
    out = []
    for svc, q, rows in ((jsvc, jcore.Query(agg="sum", col="totalBytes"),
                          lambda: jax_grow_log(jrng, 300, 6000, 50)),
                         (tsvc, Q_SUM, lambda: grow_log(trng, 300, 6000, 50, device="cpu"))):
        first = svc.query("v", q).estimate.method
        svc.offer("Log", inserts=rows(), seq=0)
        svc.refresh()
        r = svc.query("v", q)
        out.append((first, r.estimate.method, r.staleness.overloaded,
                    svc.admission.drain_ewma_s > 5.0))
    assert out[1] == out[0]
    assert out[1][1].endswith("+shed") and out[1][2] and out[1][3]
    assert not out[1][0].endswith(("+shed", "+throttled"))


def test_cache_poison_fault_fires_through_query_path():
    _, (jvm, jsvc, _), (tvm, tsvc, _) = _twins(cache_capacity=64)
    res = []
    for vm, svc, q, pkg in ((jvm, jsvc, jcore.Query(agg="sum", col="totalBytes"), "jax"),
                            (tvm, tsvc, Q_SUM, "port")):
        good = svc.query("v", q).estimate
        plan_t = (JFaultPlan if pkg == "jax" else FaultPlan)
        spec_t = (JFaultSpec if pkg == "jax" else FaultSpec)
        plan = plan_t([spec_t(epoch=1, kind="cache_poison", target="v")]).attach(vm)
        plan.advance()
        served = svc.query("v", q).estimate
        assert float(served.value) == float(good.value)
        assert svc.result_cache.poison_rejected >= 1
        res.append((svc.result_cache.poison_rejected, _log(plan), float(served.value)))
    assert res[1][:2] == res[0][:2] and res[1][1] == [(1, (1, "cache_poison", "v", 0.0),
                                                      "cache:v")]
    np.testing.assert_allclose(res[1][2], res[0][2], rtol=1e-5)
