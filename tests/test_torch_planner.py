"""The budgeted maintenance planner in both packages, on the CPU.

The gate: the ``fig_planner_fleet`` quick fleet (12 views, 512 base rows,
32 groups, a Zipf query stream through ``query_batch``) runs 3 planner
epochs in ``repro`` and in ``repro_torch`` (``device="cpu"``) from the same
numpy data, with pinned costs and a fake clock; every epoch's
``PlanReport`` must hold the same actions, skipped views, recommended
ratios and estimator flips.  A JAX fleet carried into the port mid-run
(``from_arrays``) must plan and clean the same.  Also: the knapsack's tie
order, a quarantined view sitting out its backoff, the health arithmetic,
and ``record_traffic=False``.
"""

import numpy as np
import pytest

import repro.core as jcore
import repro.relational.plan as jplan
import repro_torch.core as tcore
import repro_torch.relational.plan as tplan
from repro.planner import MaintenancePlanner as JaxPlanner
from repro.relational.relation import from_columns as jax_from_columns
from repro.robustness.health import FleetHealth as JaxFleetHealth
from repro.views import ViewManager as JaxViewManager
from repro_torch.planner import MaintenancePlanner, PlannedAction, greedy_knapsack
from repro_torch.relational.relation import from_arrays, from_columns, to_host
from repro_torch.robustness import FleetHealth
from repro_torch.views import ViewManager

N_VIEWS, N_ROWS, GROUPS, D_ROWS, EPOCHS = 12, 512, 32, 160, 3  # fig_planner_fleet quick
CLEAN_S, MAINTAIN_S = 1.0, 4.0


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _traffic_weights(n_views):
    """benchmarks/fig_planner_fleet.py:59-70: Zipf over a permutation that
    parks the hottest views late in registration order."""
    rng = np.random.default_rng(123)
    rank = rng.permutation(n_views)
    back = [i for i in range(n_views) if i >= n_views // 2]
    for hot, pos in zip(np.argsort(rank)[:3], back[-3:]):
        rank[hot], rank[pos] = rank[pos], rank[hot]
    w = 1.0 / (1.0 + rank) ** 1.7
    return w / w.sum()


def _rows(start, n, rng):
    return {"sessionId": np.arange(start, start + n, dtype=np.int32),
            "videoId": rng.integers(0, GROUPS, n).astype(np.int32),
            "bytes": rng.exponential(10.0, n).astype(np.float32)}


def _fleet(vm, core, P, make_rel):
    rng = np.random.default_rng(1)
    for i in range(N_VIEWS):
        vm.register_base(f"Log{i}", make_rel(_rows(0, N_ROWS, rng), capacity=4096))
        plan = P.GroupByNode(child=P.Scan(f"Log{i}", pk=("sessionId",)), keys=("videoId",),
                             aggs=(("totalBytes", "sum", "bytes"), ("visits", "count", None)),
                             num_groups=2 * GROUPS)
        vm.register_view(core.ViewDef(f"v{i}", plan), delta_bases=(f"Log{i}",), m=0.25, seed=i,
                         delta_group_capacity=2 * GROUPS)


def _run(package):
    if package == "jax":
        vm, core, P, Planner = JaxViewManager(clock=FakeClock()), jcore, jplan, JaxPlanner

        def make_rel(cols, **kw):
            return jax_from_columns(cols, pk=["sessionId"], **kw)
    else:
        vm, core, P, Planner = ViewManager(device="cpu", clock=FakeClock()), tcore, tplan, \
            MaintenancePlanner

        def make_rel(cols, **kw):
            return from_columns(cols, pk=["sessionId"], device="cpu", **kw)
    _fleet(vm, core, P, make_rel)
    planner = Planner(vm, budget_s=MAINTAIN_S + 2.5 * CLEAN_S, age_cap_s=1e9, clock=FakeClock())
    planner.cost_model.pin_costs(refresh_s=CLEAN_S, maintain_s=MAINTAIN_S)
    weights = _traffic_weights(N_VIEWS)
    d_rng, t_rng = np.random.default_rng(7), np.random.default_rng(31)
    q = core.Query(agg="sum", col="totalBytes")
    start = 10 * N_ROWS
    reports = []
    for _ in range(EPOCHS):
        hits = t_rng.multinomial(240, weights)
        for i in range(N_VIEWS):
            if hits[i]:
                vm.query_batch(f"v{i}", [q] * int(hits[i]))
        for i in range(N_VIEWS):
            vm.ingest(f"Log{i}", inserts=make_rel(_rows(start, D_ROWS, d_rng)))
            start += D_ROWS
        reports.append(planner.step())
    return reports, vm


@pytest.fixture(scope="module")
def runs():
    return _run("jax"), _run("port")


def test_planner_epochs_match_jax_on_the_quick_fleet(runs):
    (want, _), (got, vm) = runs
    assert len(got) == EPOCHS
    for g, w in zip(got, want):
        assert [(a.view, a.action, a.forced) for a in g.actions] == \
            [(a.view, a.action, a.forced) for a in w.actions]
        assert g.skipped == w.skipped
        assert g.recommended_m == w.recommended_m
        assert g.corr_wins == w.corr_wins
        assert g.quarantined == w.quarantined == []
        np.testing.assert_allclose([a.score for a in g.actions], [a.score for a in w.actions],
                                   rtol=1e-5)
        assert g.predicted_spend_s == w.predicted_spend_s <= g.budget_s
        assert g.snapshot_s == g.schedule_s == g.act_s == 0.0  # the fake clock never moved
    assert any(a.action == "clean" for r in got for a in r.actions)
    assert vm.fleet_merge_failures == 0


def test_planner_served_answers_match_jax(runs):
    (_, jvm), (_, vm) = runs
    for i in range(N_VIEWS):
        name = f"v{i}"
        a = vm.query(name, tcore.Query(agg="sum", col="totalBytes"), record_traffic=False)
        b = jvm.query(name, jcore.Query(agg="sum", col="totalBytes"), record_traffic=False)
        assert a.method == b.method
        assert abs(float(a.value) - float(b.value)) <= 1e-5 * max(abs(float(b.value)), 1.0)
        assert vm.drift_rows(name, "clean") == jvm.drift_rows(name, "clean")


def test_greedy_knapsack_is_deterministic_under_ties():
    cands = [(2.0, "b", "clean", 1.0), (2.0, "a", "maintain", 1.0), (2.0, "a", "clean", 1.0),
             (1.0, "c", "clean", 1.0), (0.0, "d", "clean", 0.1), (5.0, "e", "maintain", 9.0)]
    picks = set()
    for seed in range(6):
        order = np.random.default_rng(seed).permutation(len(cands))
        chosen = {}
        left = greedy_knapsack([cands[i] for i in order], 2.0, chosen)
        picks.add(tuple((n, a.action) for n, a in sorted(chosen.items())))
        assert left == 0.0
    # ties broken by view then action; zero scores never picked; e never fits
    assert picks == {(("a", "clean"), ("b", "clean"))}
    seeded = {"a": PlannedAction(view="a", action="maintain", score=0.0, predicted_s=1.0)}
    greedy_knapsack(cands, 1.0, seeded)
    assert seeded["a"].action == "maintain" and set(seeded) == {"a", "b"}


def test_health_arithmetic_matches_jax():
    ours, theirs = FleetHealth(max_retries=3, backoff_cap=4), JaxFleetHealth(max_retries=3,
                                                                            backoff_cap=4)
    events = ["fail", "epoch", "fail", "epoch", "epoch", "fail", "fail", "epoch", "ok", "fail",
              "epoch", "suspend", "resume", "epoch"]
    for ev in events:
        for h in (ours, theirs):
            if ev == "fail":
                h.record_failure("v", RuntimeError("x"))
            elif ev == "ok":
                h.record_success("v")
            elif ev == "epoch":
                h.begin_epoch()
            elif ev == "suspend":
                h.suspend("v", "shard lost")
            else:
                h.resume("v")
        assert vars(ours.views["v"]) == vars(theirs.views["v"]), ev
        assert ours.blocked("v") == theirs.blocked("v")
        assert ours.retry_due("v") == theirs.retry_due("v")


def test_a_quarantined_view_sits_out_its_backoff():
    rng = np.random.default_rng(4)
    vm = ViewManager(device="cpu")
    _fleet_small(vm, rng, 3)
    planner = MaintenancePlanner(vm, budget_s=10.0, age_cap_s=1e9, backoff_base=2)
    planner.cost_model.pin_costs(refresh_s=1.0, maintain_s=5.0)
    vm.health.record_failure("v1", RuntimeError("clean failed"))  # backoff: 2 epochs
    seen = []
    for epoch in range(4):
        for i in range(3):
            vm.ingest(f"Log{i}", inserts=from_columns(_rows(9000 + 100 * epoch, 40, rng),
                                                      pk=["sessionId"], device="cpu"))
        rep = planner.step()
        seen.append(("v1" in rep.quarantined, "v1" in {a.view for a in rep.actions}))
    assert seen[0] == (True, False)
    assert seen[-1] == (False, True)
    assert not vm.health.is_degraded("v1")  # the retry succeeded


def _fleet_small(vm, rng, n):
    for i in range(n):
        vm.register_base(f"Log{i}", from_columns(_rows(0, 300, rng), pk=["sessionId"],
                                                 capacity=1024, device="cpu"))
        plan = tplan.GroupByNode(child=tplan.Scan(f"Log{i}", pk=("sessionId",)),
                                 keys=("videoId",),
                                 aggs=(("totalBytes", "sum", "bytes"), ("visits", "count", None)),
                                 num_groups=2 * GROUPS)
        vm.register_view(tcore.ViewDef(f"v{i}", plan), delta_bases=(f"Log{i}",), m=0.25, seed=i,
                         delta_group_capacity=2 * GROUPS)


def test_record_traffic_false_is_invisible_to_the_planner():
    vm = ViewManager(device="cpu")
    _fleet_small(vm, np.random.default_rng(2), 2)
    planner = MaintenancePlanner(vm, budget_s=1.0, age_cap_s=1e9)
    q = tcore.Query(agg="sum", col="totalBytes")
    before = planner.cost_model._stat("v0").traffic
    for _ in range(5):
        vm.query("v0", q, prefer="aqp", record_traffic=False)
        vm.query_batch("v0", [q] * 4, prefer="aqp", record_traffic=False)
    assert planner.cost_model._stat("v0").traffic == before
    vm.query("v0", q, prefer="aqp")
    assert planner.cost_model._stat("v0").traffic == before + 1


def _carry(rel):
    """A JAX relation → the port's, at full capacity (``from_arrays``)."""
    return from_arrays({k: np.asarray(v) for k, v in rel.columns.items()},
                       np.asarray(rel.valid), rel.schema.pk, "cpu")


def test_port_started_from_a_jax_fleet_plans_and_cleans_the_same():
    """Carry a JAX fleet after one planner epoch — bases, pending segments,
    views with their samples, versions, cursors and drift counters, the
    cost model's traffic — into the port, run one more epoch in both from
    the same numpy data, and compare."""
    n = 4

    def epoch_inputs(vm, core, make_rel, epoch):
        rng = np.random.default_rng(100 + epoch)
        for i in range(n):
            vm.query_batch(f"v{i}", [core.Query(agg="sum", col="totalBytes")] * (1 + 3 * i))
        for i in range(n):
            vm.ingest(f"Log{i}", inserts=make_rel(_rows(9000 + 200 * (epoch * n + i), 120, rng)))

    jvm = JaxViewManager(clock=FakeClock())
    rng = np.random.default_rng(5)
    for i in range(n):
        jvm.register_base(f"Log{i}", jax_from_columns(_rows(0, 300, rng), pk=["sessionId"],
                                                      capacity=1024))
        plan = jplan.GroupByNode(child=jplan.Scan(f"Log{i}", pk=("sessionId",)),
                                 keys=("videoId",),
                                 aggs=(("totalBytes", "sum", "bytes"), ("visits", "count", None)),
                                 num_groups=2 * GROUPS)
        jvm.register_view(jcore.ViewDef(f"v{i}", plan), delta_bases=(f"Log{i}",), m=0.25, seed=i,
                          delta_group_capacity=2 * GROUPS)
    jp = JaxPlanner(jvm, budget_s=2.5, age_cap_s=1e9, clock=FakeClock())
    jp.cost_model.pin_costs(refresh_s=1.0, maintain_s=1.0)
    jrel = lambda cols: jax_from_columns(cols, pk=["sessionId"])  # noqa: E731
    epoch_inputs(jvm, jcore, jrel, 0)
    first = jp.step()
    # maintained views folded their segments into the base; skipped ones
    # still hold theirs pending
    assert {a.action for a in first.actions} == {"maintain"} and first.skipped
    assert jvm.pending_segments

    vm = ViewManager(device="cpu", clock=FakeClock())
    for name, rel in jvm.base.items():
        vm.register_base(name, _carry(rel))
    for name, jmv in jvm.views.items():
        mv = vm.register_view(tcore.ViewDef(name, _port_plan(jmv.view.plan)), jmv.delta_bases,
                              m=jmv.m, seed=jmv.seed, delta_group_capacity=2 * GROUPS)
        for field in ("materialized", "stale_sample", "clean_sample"):
            setattr(mv, field, _carry(getattr(jmv, field)))
        for field in ("applied_seg", "sample_version", "stale_version", "refresh_s", "ivm_s",
                      "maintenance_s"):
            setattr(mv, field, getattr(jmv, field))
        mv.applied_rows, mv.cleaned_rows = dict(jmv.applied_rows), dict(jmv.cleaned_rows)
    vm.pending_segments = [
        tcore.DeltaSet(inserts={b: _carry(r) for b, r in seg.inserts.items()})
        for seg in jvm.pending_segments]
    vm.ingested_rows = dict(jvm.ingested_rows)
    vm._base_applied_rows = dict(jvm._base_applied_rows)
    tp = MaintenancePlanner(vm, budget_s=2.5, age_cap_s=1e9, clock=FakeClock())
    tp.cost_model.pin_costs(refresh_s=1.0, maintain_s=1.0)
    for name, st in jp.cost_model.stats.items():
        tp.cost_model._stat(name).traffic = st.traffic

    epoch_inputs(jvm, jcore, jrel, 1)
    epoch_inputs(vm, tcore, lambda cols: from_columns(cols, pk=["sessionId"], device="cpu"), 1)
    want, got = jp.step(), tp.step()
    assert [(a.view, a.action) for a in got.actions] == [(a.view, a.action) for a in want.actions]
    assert got.skipped == want.skipped and got.recommended_m == want.recommended_m
    for name, mv in vm.views.items():
        a = to_host(mv.clean_sample)
        b = {k: np.asarray(v)[np.asarray(jvm.views[name].clean_sample.valid)]
             for k, v in jvm.views[name].clean_sample.columns.items()}
        oa, ob = np.argsort(a["videoId"]), np.argsort(b["videoId"])
        assert np.array_equal(a["videoId"][oa], b["videoId"][ob])
        assert np.array_equal(a["visits"][oa], b["visits"][ob])
        np.testing.assert_allclose(a["totalBytes"][oa], b["totalBytes"][ob], rtol=1e-6, atol=1e-4)
        assert mv.sample_version == jvm.views[name].sample_version
        assert vm.drift_rows(name, "ivm") == jvm.drift_rows(name, "ivm")


def _port_plan(p):
    """The same group-by plan built from the port's plan nodes."""
    return tplan.GroupByNode(child=tplan.Scan(p.child.name, pk=p.child.pk), keys=p.keys,
                             aggs=p.aggs, num_groups=p.num_groups)
