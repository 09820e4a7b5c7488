"""The port's observatory — exported traces, reconciliation, the
observatory panel, and the spans of the manager and the planner — against
the JAX package's.

The same workloads run through both packages (fleets built from the same
numpy arrays, on one fake clock where a clock matters).  The traces must
carry the same records in the same order — kind, name, the parent's name
and the attribute names exact (wall-time attribute values differ) — and
both must reconcile.  ``repro_torch.obs.reconcile`` must give exactly the
problems JAX's gives on the same records, including records with injected
drift.  Tests set torch to one thread.
"""

import copy
import importlib

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.obs as jobs
import repro.planner as jplanner
import repro.relational.plan as jplan
import repro.robustness as jrob
import repro.serving as jserving
import repro.streaming as jstream
import repro.views as jviews
import repro_torch.core as tcore
import repro_torch.obs as tobs
import repro_torch.planner as tplanner
import repro_torch.relational.plan as tplan
import repro_torch.robustness as trob
import repro_torch.serving as tserving
import repro_torch.streaming as tstream
import repro_torch.views as tviews
from repro.relational.relation import from_columns as jax_from_columns
from repro_torch.relational.relation import from_columns as torch_from_columns
from torch_fresh_jax import fresh_jax_traces

torch.set_num_threads(1)
jrec = importlib.import_module("repro.obs.reconcile")
trec = importlib.import_module("repro_torch.obs.reconcile")


class P:
    """One package's entry points."""

    def __init__(self, core, obs, plan, rob, serving, stream, views, planner, from_columns,
                 dev):
        self.core, self.obs, self.plan, self.rob = core, obs, plan, rob
        self.serving, self.stream, self.views, self.planner = serving, stream, views, planner
        self.from_columns, self.dev = from_columns, dev


JAX = P(jcore, jobs, jplan, jrob, jserving, jstream, jviews, jplanner, jax_from_columns, {})
PORT = P(tcore, tobs, tplan, trob, tserving, tstream, tviews, tplanner, torch_from_columns,
         {"device": "cpu"})


@pytest.fixture(autouse=True)
def _bare():
    """Tracers and profilers are process-wide: every test starts and ends bare."""
    for pkg in (JAX, PORT):
        pkg.obs.set_tracer(None)
        pkg.obs.set_profiler(None)
    yield
    for pkg in (JAX, PORT):
        pkg.obs.set_tracer(None)
        pkg.obs.set_profiler(None)


def _rows(start, n, groups, rng):
    return {"k": np.arange(start, start + n, dtype=np.int32),
            "g": rng.integers(0, groups, n).astype(np.int32),
            "v": rng.exponential(5.0, n).astype(np.float32)}


def _fleet(pkg, n_views=2, n=300, groups=8, seed=3, clock=None):
    """JAX's observability fixture: group-by views over 300-row logs, m = 0.4."""
    rng = np.random.default_rng(seed)
    vm = pkg.views.ViewManager(clock=clock, **pkg.dev)
    for i in range(n_views):
        base = f"Log{i}"
        vm.register_base(base, pkg.from_columns(_rows(0, n, groups, rng), pk=["k"],
                                                capacity=2048, **pkg.dev))
        plan = pkg.plan.GroupByNode(child=pkg.plan.Scan(base, pk=("k",)), keys=("g",),
                                    aggs=(("total", "sum", "v"), ("cnt", "count", None)),
                                    num_groups=2 * groups)
        vm.register_view(pkg.core.ViewDef(f"v{i}", plan), delta_bases=(base,), m=0.4, seed=i,
                         delta_group_capacity=2 * groups)
    return vm, rng


def _delta(pkg, start, n, groups, rng):
    return pkg.from_columns(_rows(start, n, groups, rng), pk=["k"], **pkg.dev)


TIME_ATTRS = {"wall_s", "total_s", "act_s"}


def _shape(records):
    """The order-sensitive skeleton of a trace: kind, name, the parent's
    name, and every attribute but the wall times (by name only)."""
    names = {r["id"]: r["name"] for r in records if r["kind"] == "span"}
    out = []
    for r in records:
        attrs = r.get("attrs", {})
        out.append((r["kind"], r["name"], names.get(r.get("parent")),
                    tuple(sorted((k, v) for k, v in attrs.items()
                                 if k not in TIME_ATTRS and not isinstance(v, float))),
                    tuple(sorted(k for k in attrs if k in TIME_ATTRS))))
    return out


def _service_run(pkg, tmp_path, name):
    pkg.obs.trace.enable()
    vm, rng = _fleet(pkg)
    svc = pkg.stream.StreamingViewService(
        vm, pkg.stream.StreamConfig(auto_refresh=False, admission=pkg.serving.AdmissionConfig()))
    vm.stream = svc
    for epoch in range(3):
        svc.offer("Log0", inserts=_delta(pkg, 1000 + epoch * 30, 30, 8, rng), seq=epoch)
        svc.offer("Log1", inserts=_delta(pkg, 2000 + epoch * 30, 30, 8, rng), seq=epoch)
        svc.refresh()
        q = pkg.core.Query(agg="sum", col="total")
        svc.query_batch("v0", [q] * 2)
        svc.query("v1", pkg.core.Query(agg="avg", col="total"))
    path = tmp_path / name
    pkg.obs.export_service_trace(svc, str(path))
    pkg.obs.set_tracer(None)
    return pkg.obs.load_jsonl(str(path))


def test_service_trace_exports_and_reconciles_like_jax(tmp_path):
    jmeta, jrecords = _service_run(JAX, tmp_path, "j.jsonl")
    tmeta, trecords = _service_run(PORT, tmp_path, "t.jsonl")
    result = tobs.reconcile(tmeta, trecords)
    assert result["ok"], result["problems"]
    assert jobs.reconcile(tmeta, trecords) == result  # JAX's checks agree on the port's file
    assert _shape(trecords) == _shape(jrecords)
    assert tmeta["metrics"] == jmeta["metrics"] and tmeta["pending"] == jmeta["pending"]
    query_spans = [r for r in trecords if r["kind"] == "span" and r["name"] == "query"]
    assert sum(int(r["attrs"]["n"]) for r in query_spans) == 9
    epochs = {r["id"] for r in trecords if r["kind"] == "span" and r["name"] == "epoch"}
    drains = [r for r in trecords if r["kind"] == "span" and r["name"] == "drain"]
    assert drains and all(r["parent"] in epochs for r in drains)
    # the manager's spans nest where JAX's do
    shape = _shape(trecords)
    assert ("span", "merge", "epoch") in {s[:3] for s in shape}
    assert ("span", "estimate", "query") in {s[:3] for s in shape}


def _drop(name):
    def f(meta, records):
        i = next(i for i, r in enumerate(records) if r["name"] == name)
        return meta, records[:i] + records[i + 1:]
    return f


def _meta(**kw):
    def f(meta, records):
        return {**meta, **kw}, records
    return f


def _metric(name, delta):
    def f(meta, records):
        metrics = dict(meta["metrics"])
        metrics[name] = metrics.get(name, 0.0) + delta
        return {**meta, "metrics": metrics}, records
    return f


def _phantom_drain(meta, records):
    drain = next(r for r in records if r["name"] == "drain" and r["kind"] == "event")
    extra = copy.deepcopy(drain)
    extra["attrs"]["seqs"] = [999]
    return meta, records + [extra]


def _dangling(meta, records):
    records = copy.deepcopy(records)
    child = next(r for r in records if r.get("parent") is not None)
    child["parent"] = 10**9
    return meta, records


def _escape(meta, records):
    records = copy.deepcopy(records)
    child = next(r for r in records if r["kind"] == "span" and r.get("parent") is not None)
    child["t1"] += 1e3
    return meta, records


def _no_verdict(meta, records):
    records = copy.deepcopy(records)
    q = next(r for r in records if r["kind"] == "span" and r["name"] == "query")
    del q["attrs"]["verdict"]
    return meta, records


DRIFTS = {
    "none": lambda meta, records: (meta, records),
    "lost_drain": _drop("drain"),
    "phantom_drain": _phantom_drain,
    "dangling_parent": _dangling,
    "escaped_interval": _escape,
    "no_verdict": _no_verdict,
    "issued_queries": _metric("stream_queries", 3),
    "admitted_queries": _metric("admission_admitted", 1),
    "faults": _meta(faults_injected=2),
    "quarantines": _meta(quarantines=1),
    "pending": _meta(pending={"Log0": [0, 1, 2]}),
    "ring_dropped": _meta(dropped=5),
}


@pytest.mark.parametrize("drift", sorted(DRIFTS))
def test_reconcile_problems_equal_jax(tmp_path, drift):
    meta, records = _service_run(PORT, tmp_path, "t.jsonl")
    meta, records = DRIFTS[drift](meta, records)
    got = trec.reconcile(copy.deepcopy(meta), copy.deepcopy(records))
    want = jrec.reconcile(copy.deepcopy(meta), copy.deepcopy(records))
    assert got == want
    assert got["ok"] == (drift in ("none", "pending"))


def test_act_span_accounting_equal_jax():
    records = [
        {"kind": "span", "name": "act", "id": 1, "parent": None, "t0": 0.0, "t1": 2.0,
         "dur_s": 2.0},
        {"kind": "span", "name": "clean", "id": 2, "parent": 1, "t0": 0.0, "t1": 0.5,
         "dur_s": 0.5},
    ]
    for rel_tol in (0.5, 0.9):
        got = trec.check_span_accounting(records, rel_tol=rel_tol)
        assert got == jrec.check_span_accounting(records, rel_tol=rel_tol)
        assert bool(got) == (rel_tol == 0.5)


def test_observatory_panel_reconciles_live():
    fresh_jax_traces()  # the JAX panel's kernels then do not depend on earlier tests
    for pkg in (JAX, PORT):
        pkg.obs.trace.enable()
        pkg.obs.set_profiler(pkg.obs.KernelProfiler())
        vm, rng = _fleet(pkg)
        svc = pkg.stream.StreamingViewService(
            vm, pkg.stream.StreamConfig(auto_refresh=False,
                                        admission=pkg.serving.AdmissionConfig()))
        vm.stream = svc
        svc.offer("Log0", inserts=_delta(pkg, 1000, 30, 8, rng), seq=0)
        svc.refresh()
        svc.query_batch("v0", [pkg.core.Query(agg="sum", col="total")])
        panel = pkg.obs.observatory_panel(svc)
        assert set(panel) == {"metrics", "trace", "kernels", "staleness", "reconciliation"}
        assert panel["trace"]["enabled"] and panel["trace"]["records"] > 0
        assert panel["kernels"]
        assert panel["reconciliation"] == {"issued": 1, "verdicts": 1, "queries_ok": True}
        assert panel["metrics"]["stream_refreshes"] >= 1.0
        if pkg is PORT:
            port_panel = panel
        else:
            jax_panel = panel
        pkg.obs.set_tracer(None)
        pkg.obs.set_profiler(None)
    assert port_panel["metrics"] == jax_panel["metrics"]
    assert set(port_panel["staleness"]) == set(jax_panel["staleness"])
    assert port_panel["trace"]["records"] == jax_panel["trace"]["records"]
    assert all(st["fallbacks"] == st["dispatches"] for st in port_panel["kernels"].values())


def test_panel_without_admission_or_tracer():
    vm, _ = _fleet(PORT)
    svc = tstream.StreamingViewService(vm, tstream.StreamConfig(auto_refresh=False))
    vm.stream = svc
    panel = tobs.observatory_panel(svc)
    assert panel["trace"] == {"enabled": False} and panel["kernels"] is None
    assert panel["reconciliation"] == {"issued": 0, "verdicts": None, "queries_ok": True}
    with pytest.raises(RuntimeError, match="no tracer"):
        tobs.export_service_trace(svc, "unused.jsonl")


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 0.001  # every read advances: spans get distinct stamps
        return self.t


def _planner_epochs(pkg, tmp_path, specs, epochs=3):
    clock = FakeClock()
    pkg.obs.trace.enable(clock=clock)
    vm, rng = _fleet(pkg, n_views=3, clock=clock)
    planner = pkg.planner.MaintenancePlanner(vm, budget_s=100.0, age_cap_s=1e9, clock=clock)
    planner.cost_model.pin_costs(refresh_s=0.01, maintain_s=0.05)
    svc = pkg.stream.StreamingViewService(vm, pkg.stream.StreamConfig(auto_refresh=False),
                                          clock=clock)
    vm.stream = svc
    plan = pkg.rob.FaultPlan([pkg.rob.FaultSpec(**s) for s in specs]).attach(vm)
    d_rng = np.random.default_rng(5)
    for epoch in range(epochs):
        plan.advance()
        for i in range(3):
            svc.offer(f"Log{i}", inserts=_delta(pkg, 1000 + 40 * epoch, 20, 8, d_rng),
                      seq=epoch)
        svc.refresh()
        vm.health.begin_epoch()
        planner.step()
    path = tmp_path / "planner.jsonl"
    pkg.obs.export_service_trace(svc, str(path))
    pkg.obs.set_tracer(None)
    return pkg.obs.load_jsonl(str(path))


PLANNER_FAULTS = (dict(epoch=1, kind="refresh_error", target="v0"),
                  dict(epoch=2, kind="kernel_error"),
                  dict(epoch=2, kind="nan_panel", target="v2"),
                  dict(epoch=3, kind="maintain_error", target="v1"),
                  dict(epoch=3, kind="latency", target="v2", magnitude=0.25))


@pytest.mark.parametrize("faults", [(), PLANNER_FAULTS], ids=["fault_free", "faulted"])
def test_planner_and_manager_spans_match_jax(tmp_path, faults):
    """Streaming epochs plus planner epochs (snapshot → schedule → act →
    clean/merge/maintain) with a fault plan: the port's trace has JAX's
    records in JAX's order, its fault events equal JAX's, and it
    reconciles (one fault event per injection, one quarantine count per
    recorded failure)."""
    jmeta, jrecords = _planner_epochs(JAX, tmp_path, faults)
    tmeta, trecords = _planner_epochs(PORT, tmp_path, faults)
    assert _shape(trecords) == _shape(jrecords)
    names = {r["name"] for r in trecords}
    assert {"snapshot", "schedule", "act", "clean", "merge", "ingest"} <= names
    tfaults = [r["attrs"] for r in trecords if r["name"] == "fault"]
    assert tfaults == [r["attrs"] for r in jrecords if r["name"] == "fault"]
    # a fault fires at every point it is scheduled for that its epoch
    # reaches (a refresh_error in the streaming refresh and the planner's)
    assert len(tfaults) == tmeta["faults_injected"] >= len(faults)
    assert (tmeta["quarantines"], tmeta.get("faults_injected")) == \
        (jmeta["quarantines"], jmeta.get("faults_injected"))
    result = tobs.reconcile(tmeta, trecords)
    assert result["ok"], result["problems"]
    assert result == jobs.reconcile(jmeta, jrecords) | {"records": len(trecords)}
