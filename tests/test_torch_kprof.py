"""The port's kernel profiler (``repro_torch.obs.kprof``) against the JAX package's.

The same call sequences go through both packages' ``profiled`` hooks and
must give the same per-op ``dispatches``, ``compiles`` and ``fallbacks``
(exact) and the same row counts; occupancy differs only where the JAX
wrappers pad (the port pads nothing, so a port wrapper reads 1.0).  On
the CPU every port wrapper dispatches once per call under its op name,
as a fallback (its plain version ran).  One ``svc_refresh`` plus one
``query_batch`` gives equal dispatch counts for every op both packages
dispatch from the same call sites.  Tests set torch to one thread.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import repro.obs.kprof as jk
import repro.obs.trace as jtrace
import repro.relational.plan as jplan
import repro_torch.obs.kprof as tk
import repro_torch.obs.trace as ttrace
import repro_torch.relational.plan as tplan
from repro.core import Query as JQuery
from repro.core import ViewDef as JViewDef
from repro.relational.relation import from_columns as jax_from_columns
from repro.views import ViewManager as JaxViewManager
from repro_torch import kernels
from repro_torch.core import Query, ViewDef
from repro_torch.relational.relation import from_columns
from repro_torch.views import ViewManager
from torch_fresh_jax import fresh_jax_traces
from torch_wrapper_calls import wrapper_calls

torch.set_num_threads(1)
# the modules themselves: each package's ``obs`` re-exports a function
# named ``reconcile`` that shadows the submodule as an attribute
jrec = importlib.import_module("repro.obs.reconcile")
trec = importlib.import_module("repro_torch.obs.reconcile")

COUNTS = ("dispatches", "fallbacks", "compiles", "rows_real", "rows_padded")


@pytest.fixture(autouse=True)
def _bare():
    """Profilers and tracers are process-wide: every test starts and ends bare."""
    for mod in (jk, tk):
        mod.set_profiler(None)
    for mod in (jtrace, ttrace):
        mod.set_tracer(None)
    yield
    for mod in (jk, tk):
        mod.set_profiler(None)
    for mod in (jtrace, ttrace):
        mod.set_tracer(None)


def _counts(summary):
    return {op: {f: st[f] for f in COUNTS} for op, st in summary.items()}


def test_profiled_without_a_profiler_returns_the_callees_object():
    out = object()
    for mod in (jk, tk):
        assert mod.get_profiler() is None
        assert mod.profiled("fused_clean", lambda a, b: a + b, 2, 3) == 5
        assert mod.profiled("fused_clean", lambda: out, rows=4, padded=4) is out


def test_compile_execute_split_matches_jax():
    """JAX's test sequence: three calls of one shape, then a fallback of
    another; dispatches, compiles (one per shape key) and fallbacks equal."""
    summaries = []
    for mod, arr in ((jk, jnp.arange(8, dtype=jnp.float32)),
                     (tk, torch.arange(8, dtype=torch.float32))):
        prof = mod.set_profiler(mod.KernelProfiler())
        for _ in range(3):
            mod.profiled("fused_clean", lambda a: a * 2, arr, rows=6, padded=8)
        mod.profiled("fused_clean", lambda a: a, arr[:4], fallback=True, rows=4, padded=4)
        summaries.append(prof.summary())
    j, t = summaries
    assert _counts(t) == _counts(j)
    st = t["fused_clean"]
    assert (st["dispatches"], st["fallbacks"], st["compiles"]) == (4, 1, 2)
    assert st["occupancy"] == pytest.approx(22 / 28) == j["fused_clean"]["occupancy"]


def test_shape_key_sees_tensors_inside_tuples():
    """The port's wrappers pass key columns as a tuple: a new column shape
    inside it is a new compile, a repeat is an execute."""
    prof = tk.set_profiler(tk.KernelProfiler())
    a, b = torch.zeros(8, dtype=torch.int32), torch.zeros(9, dtype=torch.int32)
    for cols in ((a,), (a,), (b,), (a, a)):
        tk.profiled("hash_threshold", lambda c: c[0], cols, rows=8, padded=8)
    st = prof.summary()["hash_threshold"]
    assert (st["dispatches"], st["compiles"]) == (4, 3)


def test_injected_clock_splits_the_wall_exactly():
    ticks = iter([0.0, 1.5, 10.0, 10.25])
    prof = tk.set_profiler(tk.KernelProfiler(clock=lambda: next(ticks)))
    x = torch.ones(4)
    tk.profiled("corr_diff", lambda a: a, x)
    tk.profiled("corr_diff", lambda a: a, x)
    st = prof.summary()["corr_diff"]
    assert (st["compile_s"], st["execute_s"]) == (1.5, 0.25)


def test_fan_out_to_shards_matches_jax():
    sides = []
    for mod, arr in ((jk, jnp.arange(8, dtype=jnp.float32)),
                     (tk, torch.arange(8, dtype=torch.float32))):
        prof = mod.set_profiler(mod.KernelProfiler())
        mod.profiled("fleet_score_sharded", lambda a: a * 2, arr, rows=12, padded=16,
                     shards=[0, 1], shard_rows=[5, 7], shard_padded=[8, 8])
        sides.append(prof.shard_summary())
    j, t = sides
    for part in ("fleet",):
        assert _counts(t[part]) == _counts(j[part])
    assert {op: {s: {f: st[f] for f in COUNTS} for s, st in per.items()}
            for op, per in t["shards"].items()} == \
        {op: {s: {f: st[f] for f in COUNTS} for s, st in per.items()}
         for op, per in j["shards"].items()}
    per = t["shards"]["fleet_score_sharded"]
    wall = lambda st: st["compile_s"] + st["execute_s"]  # noqa: E731
    assert wall(per[0]) + wall(per[1]) == pytest.approx(wall(t["fleet"]["fleet_score_sharded"]))
    assert trec.check_shard_accounting(t) == [] == jrec.check_shard_accounting(j)


def test_shard_scope_matches_jax():
    sides = []
    for mod in (jk, tk):
        prof = mod.set_profiler(mod.KernelProfiler())
        assert mod.current_shard() is None
        with mod.shard_scope(2):
            assert mod.current_shard() == 2
            mod.profiled("fused_clean", lambda a, b: a + b, 2, 3, rows=4, padded=4)
            with mod.shard_scope(None):
                mod.profiled("fused_clean", lambda a, b: a + b, 2, 3, rows=4, padded=4)
        assert mod.current_shard() is None
        sides.append((prof.summary(), prof.shard_summary()))
    (js, jsh), (ts, tsh) = sides
    assert _counts(ts) == _counts(js)
    assert _counts(tsh["fleet"]) == _counts(jsh["fleet"])
    assert set(tsh["shards"]["fused_clean"]) == {2}
    assert trec.check_shard_accounting(tsh) == []


DRIFTS = {
    "ok": lambda s: s,
    "rows_real": lambda s: {"fleet": s["fleet"],
                            "shards": {"op": {0: dict(s["shards"]["op"][0], rows_real=5)}}},
    "fleet_only": lambda s: {"fleet": {"y": {}}, "shards": {}},
    "shards_only": lambda s: {"fleet": {}, "shards": {"x": {}}},
    "wall": lambda s: {"fleet": s["fleet"],
                       "shards": {"op": {0: dict(s["shards"]["op"][0], execute_s=0.5),
                                         1: s["shards"]["op"][1]}}},
}


@pytest.mark.parametrize("drift", sorted(DRIFTS))
def test_check_shard_accounting_problems_equal_jax(drift):
    ok = {"fleet": {"op": {"dispatches": 2, "rows_real": 10, "rows_padded": 12,
                           "compile_s": 0.5, "execute_s": 0.1}},
          "shards": {"op": {0: {"dispatches": 1, "rows_real": 4, "rows_padded": 6,
                                "compile_s": 0.25, "execute_s": 0.05},
                            1: {"dispatches": 1, "rows_real": 6, "rows_padded": 6,
                                "compile_s": 0.25, "execute_s": 0.05}}}}
    s = DRIFTS[drift](ok)
    got, want = trec.check_shard_accounting(s), jrec.check_shard_accounting(s)
    assert got == want
    assert bool(got) == (drift != "ok")


def test_every_wrapper_dispatches_once_per_call_as_its_op():
    """On the CPU each wrapper of ``kernels.wrappers()`` takes its plain
    version: one dispatch per call under ``kernels.op_names()``, a fallback
    every time, occupancy 1.0 (no padding)."""
    calls = wrapper_calls("cpu")
    ops = kernels.op_names()
    assert set(calls) == set(kernels.wrappers()) == set(ops)
    for name, call in calls.items():
        prof = kernels.set_profiler(tk.KernelProfiler())
        call()
        call()
        summary = prof.summary()
        assert list(summary) == [ops[name]], name
        st = summary[ops[name]]
        assert (st["dispatches"], st["fallbacks"], st["compiles"]) == (2, 2, 1), name
        assert st["occupancy"] == 1.0 and st["rows_real"] > 0
    kernels.set_profiler(None)
    assert tk.get_profiler() is None


def _fleet(vm, from_cols, P, view_def, **dev):
    """JAX's observability fixture: two group-by views over 300-row logs."""
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
    delta = {"k": np.arange(1000, 1040, dtype=np.int32),
             "g": rng.integers(0, 8, 40).astype(np.int32),
             "v": rng.exponential(5.0, 40).astype(np.float32)}
    return vm, from_cols(delta, pk=["k"], **dev)


def _jax_pipeline(profiler=None):
    """JAX's half of the pipeline: one ingest + svc_refresh + query_batch,
    under ``profiler`` when given; returns the profiler."""
    jvm, jdelta = _fleet(JaxViewManager(), jax_from_columns, jplan, JViewDef)
    if profiler is not None:
        jk.set_profiler(profiler)
    try:
        jvm.ingest("Log0", inserts=jdelta)
        jvm.svc_refresh("v0")
        jvm.query_batch("v0", [JQuery(agg="sum", col="total")])
    finally:
        jk.set_profiler(None)
    return profiler


def _compare_pipeline_dispatches():
    """One ingest + svc_refresh + query_batch under a profiler in each
    package: the ops both dispatch (fused_clean from the fused clean,
    multi_agg from the batched engine) count the same dispatches.  JAX
    traces afresh first: its fused clean dispatches ``fused_clean`` only
    while the cached, jitted ``_fused_eval_fn`` is traced."""
    fresh_jax_traces()
    jprof = _jax_pipeline(jk.KernelProfiler())
    tvm, tdelta = _fleet(ViewManager(device="cpu"), from_columns, tplan, ViewDef, device="cpu")
    tprof = tk.set_profiler(tk.KernelProfiler())
    try:
        tvm.ingest("Log0", inserts=tdelta)
        tvm.svc_refresh("v0")
        tvm.query_batch("v0", [Query(agg="sum", col="total")])
    finally:
        tk.set_profiler(None)
    j, t = jprof.summary(), tprof.summary()
    shared = set(j) & set(t)
    assert {"fused_clean", "multi_agg"} <= shared
    for op in shared:
        assert t[op]["dispatches"] == j[op]["dispatches"], op
    assert all(st["dispatches"] >= st["compiles"] for st in t.values())
    assert all(st["fallbacks"] == st["dispatches"] for st in t.values())  # CPU tensors
    assert all(st["occupancy"] == 1.0 for st in t.values())


def test_pipeline_dispatch_counts_match_jax():
    _compare_pipeline_dispatches()


def test_pipeline_dispatch_counts_match_jax_after_a_cached_trace():
    """The order of ``-n 6 --dist loadfile`` where ``tests/test_observability.py``
    ran first on the worker: JAX's half already ran once, unprofiled, in
    this process.  Its cached trace hides the fused clean's dispatch from a
    profiler (the hazard); the comparison traces afresh and still holds."""
    _jax_pipeline()
    cached = _jax_pipeline(jk.KernelProfiler()).summary()
    assert "fused_clean" not in cached and "multi_agg" in cached
    _compare_pipeline_dispatches()


def test_reconcile_includes_shard_checks_like_jax():
    """JAX's test on the port: a profiled shard-scoped dispatch plus a
    traced query reconcile; one drifted shard row is one problem."""
    sides = []
    for prof_mod, trace_mod, rec_mod, vm, Q in (
            (jk, jtrace, jrec, _fleet(JaxViewManager(), jax_from_columns, jplan, JViewDef)[0],
             JQuery),
            (tk, ttrace, trec, _fleet(ViewManager(device="cpu"), from_columns, tplan, ViewDef,
                                      device="cpu")[0], Query)):
        prof = prof_mod.set_profiler(prof_mod.KernelProfiler())
        with prof_mod.shard_scope(0):
            prof_mod.profiled("fused_clean", lambda a, b: a + b, 1, 2, rows=3, padded=3)
        tr = trace_mod.enable()
        vm.query("v0", Q(agg="sum", col="total"))
        meta = {"metrics": vm.metrics.snapshot(),
                "quarantines": sum(h.failures for h in vm.health.views.values())}
        rep = rec_mod.reconcile(meta, list(tr.records), shard_summary=prof.shard_summary())
        drifted = prof.shard_summary()
        drifted["shards"]["fused_clean"][0]["rows_real"] += 1
        bad = rec_mod.reconcile(meta, list(tr.records), shard_summary=drifted)
        sides.append((rep, bad, [r["name"] for r in tr.records]))
        trace_mod.set_tracer(None)
    (jrep, jbad, jnames), (trep, tbad, tnames) = sides
    assert trep["ok"] and trep["checks"]["shards"] == 0
    assert not tbad["ok"] and tbad["checks"]["shards"] == 1
    assert tbad["problems"] == jbad["problems"] and trep["problems"] == jrep["problems"]
    assert tnames == jnames == ["estimate"]
