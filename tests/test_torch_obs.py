"""The port's metrics registry and span tracer against the JAX package's.

``repro_torch.obs`` is a pure-Python copy of ``repro.obs.registry`` and
``repro.obs.trace``.  The same operations go through both and must give
the same snapshots and records; the port's JSONL export must read back
through JAX's ``load_jsonl``/``reconcile``.  ``ViewManager.metrics`` and
``fleet_merge_failures`` (a ``counter_attr`` over it, as in JAX) are
checked on a CPU manager.
"""

import numpy as np
import pytest

import repro.obs.registry as jreg
import repro.obs.trace as jtrace
import repro_torch.obs.registry as treg
import repro_torch.obs.trace as ttrace
from repro.obs.reconcile import load_jsonl, reconcile
import repro.relational.plan as jplan
import repro_torch.relational.plan as tplan
from repro.core import ViewDef as JViewDef
from repro.relational.relation import from_columns as jax_from_columns
from repro.robustness import FaultPlan, FaultSpec
from repro.views import ViewManager as JaxViewManager
from repro_torch.core import ViewDef
from repro_torch.relational.relation import from_columns
from repro_torch.views import ViewManager

PKGS = [pytest.param((jreg, jtrace), id="jax"), pytest.param((treg, ttrace), id="port")]


@pytest.fixture(autouse=True)
def _no_tracer():
    """Tracers are process-wide: every test starts and ends bare."""
    for t in (jtrace, ttrace):
        t.set_tracer(None)
    yield
    for t in (jtrace, ttrace):
        t.set_tracer(None)


def _registry_script(reg_mod):
    reg = reg_mod.MetricsRegistry(clock=lambda: 7.0)
    c = reg.counter("stream_refreshes")
    c.inc()
    c.inc(3.0)
    a = reg.counter("admission_verdicts", tenant="t0", verdict="admit")
    assert a is reg.counter("admission_verdicts", verdict="admit", tenant="t0")
    a.inc(2)
    reg.counter("admission_verdicts", tenant="t1", verdict="admit").inc(3)
    g = reg.gauge("pending_rows", base="Log")
    g.set(5)
    g.inc(-2)
    h = reg.histogram("planner_refresh_s", view="v0")
    for v in (0.5, 0.1, 0.9):
        h.observe(v)
    reg.histogram("empty_s")
    return reg


def test_registry_snapshot_and_totals_match_jax():
    j, t = _registry_script(jreg), _registry_script(treg)
    assert t.snapshot() == j.snapshot()
    assert t.total("admission_verdicts") == j.total("admission_verdicts") == 5.0
    assert t.now() == 7.0
    h = t.histogram("planner_refresh_s", view="v0")
    assert (h.count, h.min, h.max, h.last) == (3, 0.1, 0.9, 0.9)
    assert h.mean == pytest.approx(0.5)


@pytest.mark.parametrize("pkg", PKGS)
def test_counter_is_monotone_and_kinds_do_not_collide(pkg):
    reg = pkg[0].MetricsRegistry()
    c = reg.counter("stream_refreshes")
    with pytest.raises(ValueError):
        c.inc(-1.0)
    reg.counter("planner_traffic")
    with pytest.raises(TypeError):
        reg.gauge("planner_traffic")


@pytest.mark.parametrize("pkg", PKGS)
def test_counter_attr_is_bit_compatible_and_monotone(pkg):
    reg_mod = pkg[0]

    class Thing:
        hits = reg_mod.counter_attr()

        def __init__(self, reg):
            self._c_hits = reg.counter("cache_hits")

    reg = reg_mod.MetricsRegistry()
    t = Thing(reg)
    assert t.hits == 0 and isinstance(t.hits, int)
    t.hits += 1
    t.hits += 2
    assert t.hits == 3 and reg.counter("cache_hits").value == 3.0
    with pytest.raises(ValueError):
        t.hits -= 1


def _trace_script(trace_mod, tmp_path, name):
    clock = iter(float(i) for i in range(100))
    tr = trace_mod.enable(clock=lambda: next(clock))
    with trace_mod.span("epoch", epoch=1):
        with trace_mod.span("drain", base="Log0") as sp:
            sp.set(rows=7)
        trace_mod.event("offer", base="Log0", seq=3)
    with pytest.raises(RuntimeError):
        with trace_mod.span("clean", view="v0"):
            raise RuntimeError("boom")
    path = tmp_path / name
    n = tr.export_jsonl(str(path), meta={"extra": 1, "pending": {"Log0": [3]}})
    return tr, n, path


def test_tracer_records_and_export_match_jax(tmp_path):
    jt, jn, jpath = _trace_script(jtrace, tmp_path, "j.jsonl")
    tt, tn, tpath = _trace_script(ttrace, tmp_path, "t.jsonl")
    assert tn == jn == 4
    assert list(tt.records) == list(jt.records)
    assert tt.summary() == jt.summary()
    assert tpath.read_text() == jpath.read_text()
    meta, records = load_jsonl(str(tpath))
    by_name = {r["name"]: r for r in records}
    assert by_name["drain"]["parent"] == by_name["epoch"]["id"]
    assert by_name["clean"]["attrs"]["error"] == "RuntimeError"
    assert not reconcile(meta, records)["problems"]


@pytest.mark.parametrize("pkg", PKGS)
def test_tracer_disabled_is_a_shared_noop_and_the_ring_counts_drops(pkg):
    trace_mod = pkg[1]
    assert trace_mod.get_tracer() is None
    sp = trace_mod.span("epoch")
    assert sp is trace_mod.NOOP_SPAN
    with sp as inner:
        inner.set(anything=1)
    trace_mod.event("offer", seq=1)
    tr = trace_mod.enable(capacity=4)
    for i in range(10):
        trace_mod.event("offer", seq=i)
    assert len(tr.records) == 4 and tr.dropped == 6
    assert tr.summary()["dropped"] == 6 and len(tr.drain()) == 4 and len(tr) == 0


def _two_views(vm, from_cols, P, view_def, **dev):
    """Two group-by views over their own 300-row logs, 40 delta rows each."""
    rng = np.random.default_rng(3)
    for i in range(2):
        vm.register_base(f"Log{i}", from_cols(
            {"k": np.arange(300, dtype=np.int32),
             "g": rng.integers(0, 8, 300).astype(np.int32),
             "v": rng.exponential(5.0, 300).astype(np.float32)},
            pk=["k"], capacity=2048, **dev))
        plan = P.GroupByNode(child=P.Scan(f"Log{i}", pk=("k",)), keys=("g",),
                             aggs=(("total", "sum", "v"), ("cnt", "count", None)),
                             num_groups=16)
        vm.register_view(view_def(f"v{i}", plan), delta_bases=(f"Log{i}",), m=0.4, seed=i,
                         delta_group_capacity=16)
    for i in range(2):
        vm.ingest(f"Log{i}", inserts=from_cols(
            {"k": np.arange(1000, 1040, dtype=np.int32),
             "g": rng.integers(0, 8, 40).astype(np.int32),
             "v": rng.exponential(5.0, 40).astype(np.float32)}, pk=["k"], **dev))
    return vm


def test_fleet_merge_failures_reads_through_the_metrics_registry(monkeypatch):
    """A failed batched launch on a CPU manager counts once in both
    packages, and the count is the registry's ``fleet_merge_failures``."""
    import repro_torch.views.manager as M

    jvm = _two_views(JaxViewManager(), jax_from_columns, jplan, JViewDef)
    FaultPlan([FaultSpec(epoch=1, kind="kernel_error")]).attach(jvm).advance()
    jvm.svc_refresh_many(["v0", "v1"])

    def boom(jobs):
        raise RuntimeError("injected fleet failure")

    tvm = _two_views(ViewManager(device="cpu"), from_columns, tplan, ViewDef, device="cpu")
    assert tvm.metrics.snapshot()["fleet_merge_failures"] == 0.0
    monkeypatch.setattr(M, "fleet_clean_merge", boom)
    tvm.svc_refresh_many(["v0", "v1"])
    assert tvm.fleet_merge_failures == jvm.fleet_merge_failures == 1
    assert tvm.metrics.snapshot()["fleet_merge_failures"] == \
        jvm.metrics.snapshot()["fleet_merge_failures"] == 1.0
    with pytest.raises(ValueError):
        tvm.fleet_merge_failures = 0  # a counter never decreases
