"""The port's chaos layer (``repro_torch.robustness.faults``) against the JAX package's.

Each test runs the same fault plan through both packages on fleets built
from the same numpy arrays (JAX's ``tests/test_robustness.py`` fixture:
two group-by views over 400-row logs, m = 0.3) and holds the port to JAX:
fault plans, injection logs (epoch, spec, where) and health states
(failures, consecutive failures, backoff, retries left, degraded, the
error's type) are equal exactly; recovered samples have equal keys,
counts and membership, and float sums within ``rtol=1e-6, atol=1e-4``
(the fleet tolerance: the port's plain group-by adds in another order).
Within one package, a recovered fleet is bit-identical to its fault-free
twin, as JAX's acceptance test holds.  Tests set torch to one thread.
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.planner as jplanner
import repro.relational.plan as jplan
import repro.robustness as jrob
import repro.streaming as jstream
import repro.views as jviews
import repro_torch.core as tcore
import repro_torch.planner as tplanner
import repro_torch.relational.plan as tplan
import repro_torch.robustness as trob
import repro_torch.streaming as tstream
import repro_torch.views as tviews
from repro.relational.relation import from_columns as jax_from_columns
from repro.relational.relation import to_host as jax_to_host
from repro_torch.relational.relation import from_columns as torch_from_columns
from repro_torch.relational.relation import to_host as torch_to_host

torch.set_num_threads(1)


@dataclasses.dataclass(frozen=True)
class Pkg:
    name: str
    core: object
    plan: object
    rob: object
    stream: object
    views: object
    planner: object
    from_columns: object
    to_host: object
    dev: dict


JAX = Pkg("jax", jcore, jplan, jrob, jstream, jviews, jplanner, jax_from_columns, jax_to_host,
          {})
PORT = Pkg("port", tcore, tplan, trob, tstream, tviews, tplanner, torch_from_columns,
           torch_to_host, {"device": "cpu"})
PKGS = (JAX, PORT)


def _rows(start, n, groups, rng):
    return {"k": np.arange(start, start + n, dtype=np.int32),
            "g": rng.integers(0, groups, n).astype(np.int32),
            "v": rng.exponential(5.0, n).astype(np.float32)}


class FakeClock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t


def _fleet(pkg, n_views=2, n=400, groups=8, m=0.3, seed=3):
    """Both packages' managers read an equal injected clock that stands
    still, so the planner times an action by the latency its faults report
    and by nothing else (a first jitted clean on a busy host can run past
    the 0.5 s deadline floor on its own)."""
    rng = np.random.default_rng(seed)
    vm = pkg.views.ViewManager(clock=FakeClock(), **pkg.dev)
    for i in range(n_views):
        base = f"Log{i}"
        vm.register_base(base, pkg.from_columns(_rows(0, n, groups, rng), pk=["k"],
                                                capacity=2048, **pkg.dev))
        plan = pkg.plan.GroupByNode(child=pkg.plan.Scan(base, pk=("k",)), keys=("g",),
                                    aggs=(("total", "sum", "v"), ("cnt", "count", None)),
                                    num_groups=2 * groups)
        vm.register_view(pkg.core.ViewDef(f"v{i}", plan), delta_bases=(base,), m=m, seed=i,
                         delta_group_capacity=2 * groups)
    return vm, rng


def _delta(pkg, start, n, groups, rng):
    return pkg.from_columns(_rows(start, n, groups, rng), pk=["k"], **pkg.dev)


def _plan(pkg, *specs, seed=0):
    return pkg.rob.FaultPlan([pkg.rob.FaultSpec(**s) for s in specs], seed=seed)


def _health(vm):
    """Every view's health, exact, with the error's type (its message may
    carry a wall time)."""
    out = {}
    for name, h in vm.health.views.items():
        d = dataclasses.asdict(h)
        d["last_error"] = d["last_error"].split(":")[0]
        out[name] = d
    return out


def _log(plan):
    return [(e, dataclasses.astuple(s), w) for e, s, w in plan.injected]


def _sample(pkg, mv):
    h = pkg.to_host(mv.clean_sample)
    o = np.argsort(h["g"], kind="stable")
    return {c: np.asarray(v)[o] for c, v in h.items()}


def _same_samples(a, b, what):
    assert set(a) == set(b), what
    for c in a:
        if np.issubdtype(a[c].dtype, np.floating) and c != "cnt":
            np.testing.assert_allclose(a[c], b[c], rtol=1e-6, atol=1e-4, err_msg=f"{what}:{c}")
        else:
            np.testing.assert_array_equal(a[c], b[c], err_msg=f"{what}:{c}")


def _both(run):
    """``run(pkg)`` in each package → (jax result, port result)."""
    return run(JAX), run(PORT)


# ---------------------------------------------------------------------------
# FaultPlan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 11, 12])
def test_fault_plan_random_is_the_same_plan_in_both_packages(seed):
    kw = dict(views=["v0", "v1", "v2"], epochs=range(1, 9), rate=0.5, seed=seed,
              kinds=trob.FAULT_KINDS, magnitude=2.5, bases=["Log0", "Log1"])
    j, t = jrob.FaultPlan.random(**kw), trob.FaultPlan.random(**kw)
    assert [dataclasses.astuple(s) for s in t.specs] == [dataclasses.astuple(s) for s in j.specs]
    assert t.specs and t.specs == trob.FaultPlan.random(**kw).specs
    assert trob.FAULT_KINDS == jrob.FAULT_KINDS
    other = trob.FaultPlan.random(**{**kw, "seed": seed + 100})
    assert other.specs != t.specs


def test_fault_spec_rejects_unknown_kind():
    with pytest.raises(ValueError):
        trob.FaultSpec(epoch=1, kind="meteor_strike")


def test_fault_plan_fires_only_at_active_epoch_and_target():
    def run(pkg):
        plan = _plan(pkg, dict(epoch=2, kind="refresh_error", target="v0"),
                     dict(epoch=2, kind="latency", target="v1", magnitude=3.0))
        plan.advance()
        assert plan.fire("refresh", "v0") == 0.0
        plan.advance()
        assert plan.fire("refresh", "v1") == 3.0
        assert plan.fire("kernel", "v1") == 0.0  # latency is for refresh/maintain only
        with pytest.raises(pkg.rob.FaultInjected, match="refresh_error"):
            plan.fire("refresh", "v0")
        return _log(plan)

    j, t = _both(run)
    assert t == j and len(t) == 2


def test_serving_plane_hooks_compose_like_jax():
    def run(pkg):
        plan = _plan(pkg, dict(epoch=1, kind="traffic_spike", magnitude=10.0),
                     dict(epoch=1, kind="traffic_spike", magnitude=2.0),
                     dict(epoch=2, kind="slow_drain", magnitude=3.0),
                     dict(epoch=2, kind="clock_skew", magnitude=-7.5),
                     dict(epoch=3, kind="nan_panel", target="v1"))
        got = [plan.traffic_multiplier()]
        plan.advance()
        got += [plan.traffic_multiplier(), plan.drain_latency_s()]
        plan.advance()
        got += [plan.traffic_multiplier(), plan.drain_latency_s(), plan.clock_skew_s()]
        plan.advance()
        panel = plan.poison_features(["v0", "v1"], np.ones((2, 3), np.float32))
        return got, np.isnan(panel).tolist(), _log(plan)

    j, t = _both(run)
    assert t == j
    assert t[0] == [1.0, 20.0, 0.0, 1.0, 3.0, -7.5]
    assert t[1] == [[False] * 3, [True] * 3]


def test_corrupt_copy_poisons_the_first_non_key_float_column():
    rel = torch_from_columns({"k": np.arange(3, dtype=np.int32),
                              "g": np.zeros(3, np.int32),
                              "v": np.ones(3, np.float32), "w": np.ones(3, np.float32)},
                             pk=["k"], device="cpu")
    plan = trob.FaultPlan([trob.FaultSpec(epoch=0, kind="corrupt_batch", target="Log0")])
    offers = plan.mutate_offer("Log0", rel, None, 5, "key")
    assert len(offers) == 2 and offers[0] == (rel, None, 5, "key")
    bad = offers[1][0]
    assert torch.isnan(bad.col("v")).all() and not torch.isnan(bad.col("w")).any()
    assert torch.equal(bad.col("k"), rel.col("k")) and offers[1][2:] == (5, "key")


# ---------------------------------------------------------------------------
# Transactional per-view cleans + isolation
# ---------------------------------------------------------------------------

def test_failed_refresh_rolls_view_back_and_quarantines():
    def run(pkg):
        vm, rng = _fleet(pkg)
        vm.ingest("Log0", inserts=_delta(pkg, 1000, 40, 8, rng))
        before = (_sample(pkg, vm.views["v0"]), vm.views["v0"].sample_version)
        plan = _plan(pkg, dict(epoch=1, kind="refresh_error", target="v0")).attach(vm)
        plan.advance()
        with pytest.raises(pkg.rob.FaultInjected):
            vm.svc_refresh("v0")
        after = _sample(pkg, vm.views["v0"])
        for c in before[0]:
            np.testing.assert_array_equal(before[0][c], after[c])
        assert vm.views["v0"].sample_version == before[1]
        assert vm.health.is_degraded("v0")
        assert "FaultInjected" in vm.health.views["v0"].last_error
        return _health(vm), _log(plan)

    j, t = _both(run)
    assert t == j


def test_svc_refresh_many_isolates_failed_view():
    def run(pkg):
        vm, rng = _fleet(pkg)
        for i in range(2):
            vm.ingest(f"Log{i}", inserts=_delta(pkg, 1000, 40, 8, rng))
        v1_version = vm.views["v1"].sample_version
        plan = _plan(pkg, dict(epoch=1, kind="refresh_error", target="v0")).attach(vm)
        plan.advance()
        out = vm.svc_refresh_many(["v0", "v1"])
        assert out["v0"] == 0.0
        assert vm.health.is_degraded("v0") and not vm.health.is_degraded("v1")
        assert vm.views["v1"].sample_version > v1_version
        with pytest.raises(pkg.rob.FaultInjected):
            vm.svc_refresh_many(["v0", "v1"], isolate=False)
        return _health(vm), _log(plan), _sample(pkg, vm.views["v1"]), vm.fleet_merge_failures

    (jh, jl, js, jf), (th, tl, ts, tf) = _both(run)
    assert (th, tl, tf) == (jh, jl, jf)
    _same_samples(ts, js, "v1")


def test_kernel_fault_degrades_to_per_view_cleans():
    def run(pkg):
        vm, rng = _fleet(pkg)
        for i in range(2):
            vm.ingest(f"Log{i}", inserts=_delta(pkg, 1000, 40, 8, rng))
        plan = _plan(pkg, dict(epoch=1, kind="kernel_error")).attach(vm)
        plan.advance()
        vm.svc_refresh_many(["v0", "v1"])
        assert vm.fleet_merge_failures == 1
        assert not vm.health.is_degraded("v0") and not vm.health.is_degraded("v1")
        q = pkg.core.Query(agg="sum", col="total")
        truth = float(vm.query_exact_fresh("v0", q))
        est = float(vm.query("v0", q, record_traffic=False).value)
        assert est == pytest.approx(truth, rel=0.5)
        return (_health(vm), _log(plan), vm.metrics.snapshot()["fleet_merge_failures"],
                {n: _sample(pkg, mv) for n, mv in vm.views.items()})

    (jh, jl, jm, js), (th, tl, tm, ts) = _both(run)
    assert (th, tl, tm) == (jh, jl, jm) and tl == [(1, (1, "kernel_error", "*", 0.0), "kernel:None")]
    for name in js:
        _same_samples(ts[name], js[name], name)


def test_failed_maintain_rolls_back_and_quarantines():
    def run(pkg):
        vm, rng = _fleet(pkg)
        vm.ingest("Log0", inserts=_delta(pkg, 1000, 40, 8, rng))
        mv = vm.views["v0"]
        before = (np.asarray(pkg.to_host(mv.materialized)["g"]).copy(), mv.applied_seg,
                  mv.sample_version)
        plan = _plan(pkg, dict(epoch=1, kind="maintain_error", target="v0")).attach(vm)
        plan.advance()
        with pytest.raises(pkg.rob.FaultInjected):
            vm.maintain("v0")
        assert np.array_equal(before[0], np.asarray(pkg.to_host(mv.materialized)["g"]))
        assert (mv.applied_seg, mv.sample_version) == before[1:]
        assert vm.health.is_degraded("v0")
        return _health(vm), _log(plan)

    j, t = _both(run)
    assert t == j


def test_latency_fault_adds_its_seconds_to_the_clean_and_the_maintain():
    def run(pkg):
        vm, rng = _fleet(pkg)
        vm.ingest("Log0", inserts=_delta(pkg, 1000, 40, 8, rng))
        plan = _plan(pkg, dict(epoch=1, kind="latency", target="v0", magnitude=7.0),
                     dict(epoch=1, kind="latency", target="v1", magnitude=5.0)).attach(vm)
        plan.advance()
        dt_clean = vm.svc_refresh("v0")
        dt_maint = vm.maintain("v1")
        assert dt_clean >= 7.0 and dt_maint >= 5.0
        return _health(vm), _log(plan)

    j, t = _both(run)
    assert t == j and [w for _e, _s, w in t[1]] == ["refresh:v0", "maintain:v1"]


# ---------------------------------------------------------------------------
# Chaos through the streaming service
# ---------------------------------------------------------------------------

def test_corrupt_duplicate_cannot_displace_clean_copy():
    def run(pkg):
        vm, rng = _fleet(pkg)
        svc = pkg.stream.StreamingViewService(vm, pkg.stream.StreamConfig(auto_refresh=False))
        vm.stream = svc
        plan = _plan(pkg, dict(epoch=1, kind="corrupt_batch", target="Log0"),
                     dict(epoch=1, kind="duplicate_batch", target="Log0")).attach(vm)
        plan.advance()
        good = _delta(pkg, 1000, 4, 8, rng)
        svc.offer("Log0", inserts=good, seq=7)
        log = svc.logs["Log0"]
        assert log.corrupt_batches == 1
        ins, _ = log.drain()
        rows = pkg.to_host(ins)
        assert np.isfinite(rows["v"]).all()
        assert rows["k"].tolist() == pkg.to_host(good)["k"].tolist()
        return _log(plan), rows["k"].tolist(), log.corrupt_rows

    j, t = _both(run)
    assert t == j


def test_quarantined_view_serves_widened_ci_and_recovers():
    def run(pkg):
        vm, rng = _fleet(pkg)
        svc = pkg.stream.StreamingViewService(vm, pkg.stream.StreamConfig(auto_refresh=False))
        vm.stream = svc
        plan = _plan(pkg, dict(epoch=1, kind="refresh_error", target="v0")).attach(vm)
        plan.advance()
        svc.offer("Log0", inserts=_delta(pkg, 1000, 30, 8, rng), seq=0)
        svc.offer("Log1", inserts=_delta(pkg, 1000, 30, 8, rng), seq=0)
        svc.refresh()
        assert vm.health.is_degraded("v0")
        q = pkg.core.Query(agg="sum", col="total")
        se = svc.query("v0", q, record_traffic=False)
        assert "v0" in se.staleness.degraded_views
        assert se.estimate.method.endswith("+degraded")
        assert not svc.query("v1", q, record_traffic=False).estimate.method.endswith("+degraded")
        health_mid = _health(vm)
        plan.advance()
        svc.refresh()
        assert not vm.health.is_degraded("v0")
        se2 = svc.query("v0", q, record_traffic=False)
        assert not se2.estimate.method.endswith("+degraded")
        return health_mid, _health(vm), _log(plan), float(se.estimate.value), \
            float(se2.estimate.value)

    j, t = _both(run)
    assert t[:3] == j[:3]
    np.testing.assert_allclose(t[3:], j[3:], rtol=1e-5)


def _chaos_run(pkg, specs):
    """JAX's differential chaos run: 3 epochs of offers on both bases, the
    faults of ``specs``, then 2 fault-free recovery epochs."""
    vm, _ = _fleet(pkg)
    svc = pkg.stream.StreamingViewService(vm, pkg.stream.StreamConfig(auto_refresh=False))
    vm.stream = svc
    plan = _plan(pkg, *specs).attach(vm) if specs else None
    d_rng = np.random.default_rng(17)
    for epoch in range(3):
        if plan is not None:
            plan.advance()
        for i in range(2):
            svc.offer(f"Log{i}", inserts=_delta(pkg, 1000 + 100 * epoch, 25, 8, d_rng),
                      seq=epoch * 10 + i)
        svc.refresh()
    for _ in range(2):
        if plan is not None:
            plan.advance()
        svc.refresh()
    return vm, plan


CHAOS = (dict(epoch=1, kind="refresh_error", target="v0"),
         dict(epoch=2, kind="duplicate_batch", target="Log1"),
         dict(epoch=2, kind="corrupt_batch", target="Log0"))


def test_differential_recovered_fleet_is_bit_identical():
    """A chaos run (failed clean + corrupt + duplicate offers) converges to
    BIT-identical samples and estimates once the faults clear, within the
    port as in JAX; the recovered port fleet equals JAX's recovered fleet
    (keys, counts, membership exact; sums to the fleet tolerance)."""
    recovered = {}
    for pkg in PKGS:
        vm_a, plan = _chaos_run(pkg, CHAOS)
        vm_b, _ = _chaos_run(pkg, None)
        assert not vm_a.health.quarantined()
        q = pkg.core.Query(agg="sum", col="total")
        for name in ("v0", "v1"):
            a, b = _sample(pkg, vm_a.views[name]), _sample(pkg, vm_b.views[name])
            for c in a:
                np.testing.assert_array_equal(a[c], b[c], err_msg=f"{pkg.name}:{name}:{c}")
            ea = vm_a.query(name, q, record_traffic=False)
            eb = vm_b.query(name, q, record_traffic=False)
            assert (float(ea.value), float(ea.ci_low), float(ea.ci_high)) == \
                (float(eb.value), float(eb.ci_low), float(eb.ci_high))
        recovered[pkg.name] = ({n: _sample(pkg, mv) for n, mv in vm_a.views.items()},
                               _log(plan), _health(vm_a))
    (js, jl, jh), (ts, tl, th) = recovered["jax"], recovered["port"]
    assert tl == jl and len(tl) == 3
    assert th == jh
    for name in js:
        _same_samples(ts[name], js[name], name)


# ---------------------------------------------------------------------------
# Planner: poisoned features, deadlines, quarantine re-entry
# ---------------------------------------------------------------------------

def test_nan_panel_sanitized_and_quarantined_not_raised():
    def run(pkg):
        vm, rng = _fleet(pkg)
        vm.ingest("Log0", inserts=_delta(pkg, 1000, 20, 8, rng))
        cm = pkg.planner.CostModel(vm).attach()
        plan = _plan(pkg, dict(epoch=1, kind="nan_panel", target="v0")).attach(vm)
        plan.advance()
        out = cm.features()
        assert np.all(np.isfinite(out))
        assert cm.last_poisoned == ["v0"]
        assert vm.health.is_degraded("v0") and not vm.health.is_degraded("v1")
        return _health(vm), _log(plan), np.asarray(out)[0].tolist()

    j, t = _both(run)
    assert t[:2] == j[:2]
    np.testing.assert_allclose(t[2], j[2], rtol=1e-6)  # the neutral row keeps the EWMA costs


def _planner(pkg, vm, **kw):
    planner = pkg.planner.MaintenancePlanner(vm, budget_s=100.0, age_cap_s=1e9, **kw)
    planner.cost_model.pin_costs(refresh_s=0.01, maintain_s=0.05)
    return planner


def _acts(rep):
    return [(a.view, a.action, a.failed, a.overrun) for a in rep.actions]


def test_planner_skips_quarantined_view_and_retries_after_backoff():
    def run(pkg):
        vm, rng = _fleet(pkg)
        planner = _planner(pkg, vm)
        plan = _plan(pkg, dict(epoch=1, kind="refresh_error", target="v0")).attach(vm)
        for i in range(2):
            vm.ingest(f"Log{i}", inserts=_delta(pkg, 1000, 20, 8, rng))
        plan.advance()
        rep1 = planner.step()
        assert {a.view: a.failed for a in rep1.actions}.get("v0") is True
        assert vm.health.is_degraded("v0")
        health1 = _health(vm)
        plan.advance()
        rep2 = planner.step()
        assert "v0" in {a.view for a in rep2.actions if not a.failed}
        assert not vm.health.is_degraded("v0")
        return _acts(rep1), _acts(rep2), health1, _health(vm), _log(plan)

    j, t = _both(run)
    assert t == j


def test_latency_fault_trips_deadline_and_degrades():
    def run(pkg):
        vm, rng = _fleet(pkg)
        planner = _planner(pkg, vm)  # the deadline floor is 0.5 s in both
        plan = _plan(pkg, dict(epoch=1, kind="latency", target="v0", magnitude=5.0)).attach(vm)
        for i in range(2):
            vm.ingest(f"Log{i}", inserts=_delta(pkg, 1000, 20, 8, rng))
        plan.advance()
        rep = planner.step()
        acts = {a.view: a for a in rep.actions}
        assert acts["v0"].overrun and acts["v0"].actual_s > acts["v0"].deadline_s
        assert vm.health.is_degraded("v0")
        assert "TimeoutError" in vm.health.views["v0"].last_error
        return _acts(rep), _health(vm), _log(plan)

    j, t = _both(run)
    assert t == j


def test_plan_reports_quarantined_views():
    def run(pkg):
        vm, rng = _fleet(pkg)
        planner = _planner(pkg, vm, backoff_base=4)
        plan = _plan(pkg, dict(epoch=1, kind="refresh_error", target="v0")).attach(vm)
        for i in range(2):
            vm.ingest(f"Log{i}", inserts=_delta(pkg, 1000, 20, 8, rng))
        plan.advance()
        planner.step()
        plan.advance()
        rep = planner.step()
        assert rep.quarantined == ["v0"]
        assert all(a.view != "v0" for a in rep.actions) and "v0" in rep.skipped
        return _acts(rep), rep.skipped, _health(vm), _log(plan)

    j, t = _both(run)
    assert t == j


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_plan_over_planner_epochs_matches_jax(seed):
    """A random plan of every action-path kind over four planner epochs and
    two recovery epochs: the same plan fires the same faults at the same
    points and leaves the same health in both packages, and the recovered
    samples agree."""
    def run(pkg):
        vm, rng = _fleet(pkg, n_views=3)
        planner = _planner(pkg, vm)
        plan = pkg.rob.FaultPlan.random(
            ["v0", "v1", "v2"], epochs=range(1, 5), rate=0.4, seed=seed,
            kinds=("refresh_error", "maintain_error", "kernel_error", "latency", "nan_panel"),
            magnitude=0.2).attach(vm)
        d_rng = np.random.default_rng(seed + 40)
        reps = []
        for epoch in range(6):
            plan.advance()
            if epoch < 4:
                for i in range(3):
                    vm.ingest(f"Log{i}", inserts=_delta(pkg, 1000 + 50 * epoch, 20, 8, d_rng))
            reps.append(_acts(planner.step()))
        return reps, _health(vm), _log(plan), vm.fleet_merge_failures, \
            {n: _sample(pkg, mv) for n, mv in vm.views.items()}

    (jr, jh, jl, jf, js), (tr, th, tl, tf, ts) = _both(run)
    assert (tr, th, tl, tf) == (jr, jh, jl, jf)
    for name in js:
        _same_samples(ts[name], js[name], name)


# ---------------------------------------------------------------------------
# Degraded answers and a backwards clock
# ---------------------------------------------------------------------------

def test_query_degrades_instead_of_raising_on_refresh_failure():
    """A failing watermark refresh inside query()/query_batch() degrades the
    answer (widened CI, degraded staleness, the value kept) in the port as
    in JAX; the widened intervals agree to 1e-5 relative."""
    def run(pkg):
        vm, rng = _fleet(pkg)
        clock = FakeClock()
        svc = pkg.stream.StreamingViewService(
            vm, pkg.stream.StreamConfig(auto_refresh=True, max_rows=10_000, max_age_s=5.0),
            clock=clock)
        vm.stream = svc
        svc.offer("Log0", inserts=_delta(pkg, 1000, 30, 8, rng), seq=0)

        def boom(*a, **k):
            raise RuntimeError("disk full")

        vm._ingest_pending = boom
        clock.t = 100.0  # the age watermark is due: the query attempts the refresh
        q = pkg.core.Query(agg="sum", col="total")
        plain = vm.query("v0", q, record_traffic=False)
        se = svc.query("v0", q, record_traffic=False)
        assert se.staleness.degraded and "disk full" in se.staleness.refresh_error
        assert se.estimate.method.endswith("+degraded")
        assert se.estimate.ci_low < plain.ci_low and se.estimate.ci_high > plain.ci_high
        assert float(se.estimate.value) == float(plain.value)
        batch = svc.query_batch("v0", [q, pkg.core.Query(agg="count")], record_traffic=False)
        assert all(b.staleness.degraded for b in batch)
        return [float(x) for x in (se.estimate.value, se.estimate.ci_low, se.estimate.ci_high)]

    j, t = _both(run)
    np.testing.assert_allclose(t, j, rtol=1e-5)


def test_negative_clock_skew_clamps_ages():
    """A FaultPlan's backwards clock_skew: the harness moves its clock back
    past the last refresh and the last arrival; ages clamp to 0 in both."""
    def run(pkg):
        vm, rng = _fleet(pkg)
        clock = FakeClock(10.0)
        svc = pkg.stream.StreamingViewService(vm, pkg.stream.StreamConfig(auto_refresh=False),
                                              clock=clock)
        vm.stream = svc
        plan = _plan(pkg, dict(epoch=1, kind="clock_skew", magnitude=-60.0)).attach(vm)
        svc.refresh()
        svc.offer("Log0", inserts=_delta(pkg, 1000, 10, 8, rng), seq=0)
        plan.advance()
        clock.t += plan.clock_skew_s()
        st = svc.staleness()
        assert st.refresh_age_s == 0.0 and st.oldest_pending_s == 0.0
        assert svc.logs["Log0"].oldest_age_s() == 0.0
        return _log(plan), st.pending_rows

    j, t = _both(run)
    assert t == j and t[0] == [(1, (1, "clock_skew", "*", -60.0), "clock")]
