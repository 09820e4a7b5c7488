"""Streaming refresh engine: the port against the JAX package.

DeltaLog and StreamingViewService semantics (mirroring
tests/test_streaming.py), then the streamed ``ViewManager`` of both
packages driven by the same offers and the same fake clock: the same
refresh points, the same drained windows, the same ``StalenessInfo`` row
counts and the same clean samples (keys and counts exact, sums within
1e-6 relative).  The sharded feed into ``distributed_svc`` and the
ServeEngine telemetry cases are not ported.
"""

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.relational.plan as jplan
import repro.streaming as jstream
import repro_torch.core as tcore
import repro_torch.relational.plan as tplan
import repro_torch.streaming as tstream
from repro.data.synthetic import grow_log as jax_grow_log
from repro.data.synthetic import make_log_video as jax_make_log_video
from repro.relational.relation import from_columns as jax_from_columns
from repro.relational.relation import to_host as jax_to_host
from repro.views import ViewManager as JaxViewManager
from repro_torch.data.synthetic import grow_log, make_log_video
from repro_torch.relational.relation import from_columns, to_host
from repro_torch.streaming import Backpressure, CorruptBatch, DeltaLog, StreamConfig
from repro_torch.views import ViewManager

from tests import oracle


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _rel(pks, vals):
    return from_columns({"k": np.asarray(pks, np.int32), "v": np.asarray(vals, np.float32)},
                        pk=["k"], device="cpu")


def _jrel(pks, vals):
    return jax_from_columns({"k": np.asarray(pks, np.int32), "v": np.asarray(vals, np.float32)},
                            pk=["k"])


def _rows(rel, host):
    h = host(rel)
    return sorted(zip(*(h[c].tolist() for c in sorted(h))))


def _same_rel(got, want):
    """Row for row, with the same arena capacity."""
    if want is None:
        assert got is None
        return
    assert got.capacity == want.valid.shape[0]
    assert _rows(got, to_host) == _rows(want, jax_to_host)


def _visit_plan(P):
    return P.GroupByNode(
        child=P.FKJoin(fact=P.Scan("Log", pk=("sessionId",)),
                       dim=P.Scan("Video", pk=("videoId",)), fact_key="videoId"),
        keys=("videoId",),
        aggs=(("visitCount", "count", None), ("totalBytes", "sum", "bytes")),
        num_groups=512,
    )


def _visit_vm(seed=5, m=0.2):
    rng = np.random.default_rng(0)
    log, video = make_log_video(rng, 300, 6000, device="cpu")
    vm = ViewManager(device="cpu")
    vm.register_base("Log", log)
    vm.register_base("Video", video)
    vm.register_view(tcore.ViewDef("v", _visit_plan(tplan)), delta_bases=("Log",), m=m,
                     seed=seed, delta_group_capacity=512)
    return vm, rng


def _jax_visit_vm(seed=5, m=0.2):
    rng = np.random.default_rng(0)
    log, video = jax_make_log_video(rng, 300, 6000)
    vm = JaxViewManager()
    vm.register_base("Log", log)
    vm.register_base("Video", video)
    vm.register_view(jcore.ViewDef("v", _visit_plan(jplan)), delta_bases=("Log",), m=m,
                     seed=seed, delta_group_capacity=512)
    return vm, rng


def _same_sample(got, want):
    a, b = to_host(got), jax_to_host(want)
    oa, ob = np.argsort(a["videoId"]), np.argsort(b["videoId"])
    assert set(a) == set(b)
    for col in a:
        if a[col].dtype.kind == "f" and col != "visitCount":
            np.testing.assert_allclose(a[col][oa], b[col][ob], rtol=1e-6, atol=0)
        else:
            np.testing.assert_array_equal(a[col][oa], b[col][ob])


# ---------------------------------------------------------------------------
# DeltaLog
# ---------------------------------------------------------------------------

def test_delta_log_coalesces_out_of_order_latest_wins():
    logs = (DeltaLog("t"), jstream.DeltaLog("t"))
    for log, rel in zip(logs, (_rel, _jrel)):
        log.offer(inserts=rel([1, 2], [10.0, 20.0]), seq=2)  # newest, first to arrive
        log.offer(inserts=rel([2, 3], [99.0, 30.0]), seq=0)
        log.offer(inserts=rel([3], [31.0]), seq=1)
    (ins, dels), (jins, jdels) = logs[0].drain(), logs[1].drain()
    assert dels is None and jdels is None
    _same_rel(ins, jins)
    rows = to_host(ins)
    assert dict(zip(rows["k"].tolist(), rows["v"].tolist())) == {1: 10.0, 2: 20.0, 3: 31.0}
    assert logs[0].drained_through_seq == 2 and logs[0].pending_batches() == 0


def test_delta_log_age_and_row_accounting():
    clock = FakeClock()
    log = DeltaLog("t", clock=clock)
    log.offer(inserts=_rel([1], [1.0]))
    clock.t = 3.0
    log.offer(inserts=_rel([2, 3], [1.0, 1.0]))
    assert log.pending_rows() == 3
    assert log.oldest_age_s() == pytest.approx(3.0)
    clock.t = -1.0  # a backwards clock step never gives a negative age
    assert log.oldest_age_s() == 0.0
    log.drain()
    assert log.pending_rows() == 0 and log.oldest_age_s() == 0.0


def test_delta_log_backpressure_bounds_memory():
    log = DeltaLog("t", max_batches=2)
    log.offer(inserts=_rel([1], [1.0]))
    log.offer(inserts=_rel([2], [1.0]))
    with pytest.raises(Backpressure):
        log.offer(inserts=_rel([3], [1.0]))
    log.drain()
    log.offer(inserts=_rel([3], [1.0]))  # fine after drain


SIGNED_CASES = {
    # an insert superseded by a delete+insert update inside one window
    "superseded": [((1, 10.0), None, 0), ((1, 20.0), (1, 10.0), 1)],
    # a delete of a pre-window row still flows through
    "pre_window_delete": [(None, (7, 3.0), 0), ((7, 4.0), None, 1)],
    # insert then delete inside the window: both sides vanish
    "in_window_cancel": [((9, 1.0), None, 0), (None, (9, 1.0), 1)],
    # delete-only window with a retried delete: the oldest wins
    "delete_only": [(None, (5, 1.0), 0), (None, (5, 2.0), 1), (None, (6, 3.0), 2)],
}


@pytest.mark.parametrize("case", sorted(SIGNED_CASES))
def test_coalesce_signed_matches_jax(case):
    logs = (DeltaLog("t"), jstream.DeltaLog("t"))
    for log, rel in zip(logs, (_rel, _jrel)):
        for ins, dels, seq in SIGNED_CASES[case]:
            log.offer(inserts=None if ins is None else rel([ins[0]], [ins[1]]),
                      deletes=None if dels is None else rel([dels[0]], [dels[1]]), seq=seq)
    (ins, dels), (jins, jdels) = logs[0].drain(), logs[1].drain()
    _same_rel(ins, jins)
    _same_rel(dels, jdels)
    expect = {
        "superseded": ({1: 20.0}, {}),
        "pre_window_delete": ({7: 4.0}, {7: 3.0}),
        "in_window_cancel": ({}, {}),
        "delete_only": (None, {5: 1.0, 6: 3.0}),
    }[case]
    for rel, want in zip((ins, dels), expect):
        if want is None:
            assert rel is None
        else:
            h = to_host(rel) if rel is not None else {"k": np.array([]), "v": np.array([])}
            assert dict(zip(h["k"].tolist(), h["v"].tolist())) == want


def test_spill_requeue_and_shed_account_like_jax():
    clock = FakeClock()
    logs = (DeltaLog("t", max_batches=3, clock=clock),
            jstream.DeltaLog("t", max_batches=3, clock=clock))
    for log, rel in zip(logs, (_rel, _jrel)):
        for seq in (2, 0, 1):
            clock.t = float(seq)
            log.offer(inserts=rel([seq, seq + 10], [float(seq), 1.0]), seq=seq)
        assert log.spill() == 2
        log.offer(inserts=rel([3], [3.0]), seq=3)
        assert log.shed_oldest() == 6  # the spilled window: its 6 rows
    assert [lg.pending_seqs() for lg in logs] == [[3], [3]]
    (ins, dels), (jins, jdels) = logs[0].drain(), logs[1].drain()
    _same_rel(ins, jins)
    for log, rel in zip(logs, (ins, jins)):
        log.requeue(rel, None)
        assert log.drained_through_seq == -1 and log.requeues == 1
    _same_rel(logs[0].drain()[0], logs[1].drain()[0])
    for name in ("spills", "shed_rows", "shed_batches", "total_offered"):
        assert getattr(logs[0], name) == getattr(logs[1], name), name


def test_corrupt_batches_are_rejected_with_accounting():
    log = DeltaLog("t")
    with pytest.raises(CorruptBatch):
        log.offer(inserts=_rel([1, 2], [1.0, float("nan")]))
    bad = _rel([1, 2], [1.0, float("inf")])
    bad.valid[1] = False  # a non-finite value on an INVALID row is fine
    log.offer(inserts=bad, key="k")
    assert log.corrupt_batches == 1 and log.corrupt_rows == 2
    assert log.offer(inserts=bad, key="k") is None  # replay absorbed
    assert (log.deduped_batches, log.deduped_rows, log.pending_rows()) == (1, 1, 1)


# ---------------------------------------------------------------------------
# StreamingViewService watermarks + staleness metadata
# ---------------------------------------------------------------------------

def _with_deletes_vm(make, from_cols, P, view_def, **dev):
    base = from_cols({"k": np.arange(8, dtype=np.int32),
                      "g": (np.arange(8) % 4).astype(np.int32),
                      "v": np.arange(8, dtype=np.float32)}, pk=["k"], capacity=64, **dev)
    plan = P.GroupByNode(child=P.Scan("T", pk=("k",)), keys=("g",),
                         aggs=(("total", "sum", "v"), ("n", "count", None)), num_groups=64)
    vm = make()
    vm.register_base("T", base)
    vm.register_view(view_def("dv", plan), delta_bases=("T",), m=1.0, delta_group_capacity=64,
                     with_deletes=True)
    return vm


def _row(from_cols, k, g, v, **dev):
    return from_cols({"k": np.asarray(k, np.int32), "g": np.asarray(g, np.int32),
                      "v": np.asarray(v, np.float32)}, pk=["k"], **dev)


EVENTS = [  # (inserts, deletes) micro-batches, in seq order
    (([100], [1], [50.0]), None),                        # ins k=100
    (([100], [1], [70.0]), ([100], [1], [50.0])),        # update k=100
    (([101], [2], [5.0]), ([3], [3], [3.0])),            # ins + del of a pre-window row
    (None, ([101], [2], [5.0])),                         # del of the in-window ins
]


@pytest.mark.parametrize("drain_every", [False, True])
def test_streaming_deletes_match_jax_at_any_watermark_boundary(drain_every):
    sides = []
    for make, fc, P, vd, dev, pkg in (
            (lambda: ViewManager(device="cpu"), from_columns, tplan, tcore.ViewDef,
             {"device": "cpu"}, tstream),
            (JaxViewManager, jax_from_columns, jplan, jcore.ViewDef, {}, jstream)):
        vm = _with_deletes_vm(make, fc, P, vd, **dev)
        svc = vm.configure_streaming(pkg.StreamConfig(max_rows=10**9, max_age_s=1e9,
                                                      auto_refresh=False))
        for seq, (ins, dels) in enumerate(EVENTS):
            vm.ingest("T", inserts=None if ins is None else _row(fc, *ins, **dev),
                      deletes=None if dels is None else _row(fc, *dels, **dev), seq=seq)
            if drain_every:
                svc.refresh()
        if not drain_every:
            svc.refresh()
        q = (tcore if pkg is tstream else jcore).Query(agg="sum", col="total")
        sides.append((float(svc.query("dv", q, prefer="aqp").value),
                      float(vm.query_exact_fresh("dv", q)), svc.refresh_count))
    (got, truth, n), (jgot, jtruth, jn) = sides
    assert n == jn
    np.testing.assert_allclose([got, truth], [jgot, jtruth], rtol=1e-6)
    np.testing.assert_allclose(got, truth, rtol=1e-6)


def test_with_deletes_view_refreshes_on_insert_only_window():
    vm = _with_deletes_vm(lambda: ViewManager(device="cpu"), from_columns, tplan,
                          tcore.ViewDef, device="cpu")
    svc = vm.configure_streaming(StreamConfig(max_rows=10**9, max_age_s=1e9, auto_refresh=False))
    vm.ingest("T", inserts=_row(from_columns, [100], [1], [50.0], device="cpu"), seq=0)
    svc.refresh()
    est = svc.query("dv", tcore.Query(agg="sum", col="total"), prefer="aqp")
    truth = float(vm.query_exact_fresh("dv", tcore.Query(agg="sum", col="total")))
    np.testing.assert_allclose(float(est.value), truth, rtol=1e-5)


def test_size_watermark_triggers_refresh():
    vm, rng = _visit_vm()
    svc = vm.configure_streaming(StreamConfig(max_rows=500, max_age_s=1e9))
    assert vm.ingest("Log", inserts=grow_log(rng, 300, 6000, 300, device="cpu"), seq=0) is False
    assert svc.staleness().pending_rows == 300
    assert svc.staleness().watermark_due is False
    assert vm.ingest("Log", inserts=grow_log(rng, 300, 6300, 300, device="cpu"), seq=1) is True
    st = svc.staleness()
    assert st.pending_rows == 0
    assert st.refreshed_through_seq["Log"] == 1
    assert svc.refresh_count == 1


def test_age_watermark_triggers_refresh():
    vm, rng = _visit_vm()
    clock = FakeClock()
    svc = vm.configure_streaming(StreamConfig(max_rows=10**9, max_age_s=5.0), clock=clock)
    vm.ingest("Log", inserts=grow_log(rng, 300, 6000, 100, device="cpu"), seq=0)
    assert svc.refresh_count == 0
    clock.t = 6.0  # now stale past the age watermark
    vm.ingest("Log", inserts=grow_log(rng, 300, 6100, 100, device="cpu"), seq=1)
    assert svc.refresh_count == 1


def test_query_carries_staleness_metadata():
    vm, rng = _visit_vm()
    svc = vm.configure_streaming(StreamConfig(max_rows=10**9, max_age_s=1e9, auto_refresh=False))
    vm.ingest("Log", inserts=grow_log(rng, 300, 6000, 250, device="cpu"), seq=7)
    res = svc.query("v", tcore.Query(agg="sum", col="totalBytes"))
    assert res.staleness.pending_rows == 250
    assert res.staleness.refresh_age_s == -1.0  # never refreshed
    assert res.staleness.refreshed_through_seq["Log"] == -1
    svc.refresh()
    res2 = svc.query("v", tcore.Query(agg="sum", col="totalBytes"))
    assert res2.staleness.pending_rows == 0
    assert res2.staleness.refreshed_through_seq["Log"] == 7
    assert float(res2.value) != 0.0


def test_streaming_refresh_matches_manual_flow():
    """Out-of-order micro-batched streaming == one manual ingest + refresh."""
    vm_s, _ = _visit_vm()
    vm_m, rng_m = _visit_vm()
    delta = grow_log(rng_m, 300, 6000, 900, device="cpu")
    vm_m.ingest("Log", inserts=delta)
    vm_m.svc_refresh("v")
    h = to_host(delta)
    svc = vm_s.configure_streaming(StreamConfig(max_rows=10**9, max_age_s=1e9,
                                                auto_refresh=False))
    for seq in (1, 0, 2):
        sl = slice(seq * 300, (seq + 1) * 300)
        vm_s.ingest("Log", inserts=from_columns({k: v[sl] for k, v in h.items()},
                                                pk=["sessionId"], device="cpu"), seq=seq)
    svc.refresh()
    assert oracle.rows_equal(oracle.from_relation(vm_s.views["v"].clean_sample),
                             oracle.from_relation(vm_m.views["v"].clean_sample),
                             keys=("videoId",))


def test_maintain_all_drains_buffered_batches():
    vm, rng = _visit_vm()
    vm.configure_streaming(StreamConfig(max_rows=10**9, max_age_s=1e9, auto_refresh=False))
    vm.ingest("Log", inserts=grow_log(rng, 300, 6000, 400, device="cpu"), seq=0)
    q = tcore.Query(agg="sum", col="visitCount")
    before = float(vm.query_stale("v", q))
    vm.maintain_all()
    assert float(vm.query_stale("v", q)) == before + 400  # the buffered sessions reached IVM
    assert vm.stream.staleness().pending_rows == 0


def test_streaming_query_batch_shares_one_snapshot():
    vm, rng = _visit_vm()
    svc = vm.configure_streaming(StreamConfig(max_rows=10**9, max_age_s=1e9, auto_refresh=False))
    vm.ingest("Log", inserts=grow_log(rng, 300, 6000, 300, device="cpu"), seq=0)
    svc.refresh()
    queries = [tcore.Query(agg="count"), tcore.Query(agg="sum", col="totalBytes"),
               tcore.Query(agg="avg", col="visitCount"), tcore.Query(agg="max", col="totalBytes")]
    batch = svc.query_batch("v", queries)
    assert len(batch) == len(queries)
    assert all(r.staleness is batch[0].staleness for r in batch)
    for q, r in zip(queries, batch):
        np.testing.assert_allclose(float(r.value), float(svc.query("v", q).value), rtol=1e-5)


# ---------------------------------------------------------------------------
# The streamed manager of both packages, offer by offer
# ---------------------------------------------------------------------------

STREAM = dict(max_rows=700, max_age_s=10.0, max_batches=3)
# (seq, rows, seconds the clock moves before the offer, replay of an earlier key)
OFFERS = [(1, 150, 1.0, False), (0, 200, 1.0, False), (3, 150, 1.0, True), (2, 100, 1.0, False),
          (4, 250, 1.0, False), (6, 80, 2.0, False), (5, 90, 12.0, False), (7, 60, 1.0, True),
          (9, 300, 1.0, False), (8, 350, 1.0, False), (10, 50, 1.0, False)]


def _staleness_counts(st):
    return (st.pending_rows, st.pending_batches, st.refreshed_through_seq, st.watermark_due,
            st.spills, st.deduped_batches, st.deduped_rows, st.shed_rows, st.corrupt_batches,
            st.oldest_pending_s, st.refresh_age_s)


def test_streamed_manager_matches_jax_offer_by_offer():
    clock = FakeClock()
    tvm, _ = _visit_vm()
    jvm, _ = _jax_visit_vm()
    tsvc = tvm.configure_streaming(StreamConfig(**STREAM), clock=clock)
    jsvc = jvm.configure_streaming(jstream.StreamConfig(**STREAM), clock=clock)
    drained = {"port": [], "jax": []}
    for name, vm in (("port", tvm), ("jax", jvm)):
        real = vm._ingest_pending

        def spy(base, inserts=None, deletes=None, _real=real, _out=drained[name]):
            _out.append(inserts)
            return _real(base, inserts=inserts, deletes=deletes)

        vm._ingest_pending = spy
    rng = np.random.default_rng(42)
    start = 6000
    for seq, n, dt, replay in OFFERS:
        clock.t += dt
        seed = int(rng.integers(1 << 30))
        t_ins = grow_log(np.random.default_rng(seed), 300, start, n, device="cpu")
        j_ins = jax_grow_log(np.random.default_rng(seed), 300, start, n)
        start += n
        key = f"b{seq}"
        got = tvm.ingest("Log", inserts=t_ins, seq=seq, key=key)
        want = jvm.ingest("Log", inserts=j_ins, seq=seq, key=key)
        assert got == want, seq
        if replay:  # an at-least-once retry, absorbed by its key
            assert tvm.ingest("Log", inserts=t_ins, seq=seq, key=key) == \
                jvm.ingest("Log", inserts=j_ins, seq=seq, key=key)
        assert tsvc.refresh_count == jsvc.refresh_count
        assert _staleness_counts(tsvc.staleness()) == _staleness_counts(jsvc.staleness())
        assert tvm.views["v"].sample_version == jvm.views["v"].sample_version
        if got:  # the samples move only when an offer refreshes
            _same_sample(tvm.views["v"].clean_sample, jvm.views["v"].clean_sample)
    assert tsvc.refresh_count >= 3 and tsvc.staleness().spills >= 1
    assert tsvc.staleness().deduped_batches == 2
    assert len(drained["port"]) == len(drained["jax"]) == tsvc.refresh_count
    for a, b in zip(drained["port"], drained["jax"]):
        _same_rel(a, b)
    # the metrics registries agree name for name
    tsnap, jsnap = tvm.metrics.snapshot(), jvm.metrics.snapshot()
    assert {k: v for k, v in tsnap.items() if k in jsnap} == \
        {k: v for k, v in jsnap.items() if k in tsnap}
    assert tsnap["stream_refreshes"] == tsvc.refresh_count
    # the age watermark honoured by a query, then full maintenance
    clock.t += 11.0
    t_ans = tsvc.query("v", tcore.Query("max", "totalBytes"))
    j_ans = jsvc.query("v", jcore.Query("max", "totalBytes"))
    assert tsvc.refresh_count == jsvc.refresh_count
    assert float(t_ans.value) == pytest.approx(float(j_ans.value), rel=1e-6)
    assert t_ans.staleness.pending_rows == j_ans.staleness.pending_rows == 0
    tvm.maintain_all()
    jvm.maintain_all()
    _same_sample(tvm.views["v"].materialized, jvm.views["v"].materialized)


@pytest.mark.parametrize("policy", ["drop_oldest", "spill"])
def test_shed_policies_match_jax(policy):
    clock = FakeClock()
    cfg = dict(max_rows=10**9, max_age_s=1e9, max_batches=2, shed_policy=policy)
    tvm, _ = _visit_vm()
    jvm, _ = _jax_visit_vm()
    tsvc = tvm.configure_streaming(StreamConfig(**cfg), clock=clock)
    jsvc = jvm.configure_streaming(jstream.StreamConfig(**cfg), clock=clock)
    for seq in range(5):
        clock.t += 1.0
        assert tvm.ingest("Log", inserts=grow_log(np.random.default_rng(seq), 300, 6000 + 100 * seq,
                                                  100, device="cpu"), seq=seq) == \
            jvm.ingest("Log", inserts=jax_grow_log(np.random.default_rng(seq), 300,
                                                   6000 + 100 * seq, 100), seq=seq)
        assert _staleness_counts(tsvc.staleness()) == _staleness_counts(jsvc.staleness())
    tsvc.refresh()
    jsvc.refresh()
    _same_sample(tvm.views["v"].clean_sample, jvm.views["v"].clean_sample)
    with pytest.raises(ValueError):
        tvm.configure_streaming(StreamConfig(shed_policy="nope"))


def test_a_failed_apply_requeues_the_window():
    vm, rng = _visit_vm()
    svc = vm.configure_streaming(StreamConfig(max_rows=10**9, max_age_s=1e9, auto_refresh=False))
    vm.ingest("Log", inserts=grow_log(rng, 300, 6000, 200, device="cpu"), seq=0)
    real = vm._ingest_pending

    def boom(*a, **k):
        raise RuntimeError("apply failed")

    vm._ingest_pending = boom
    with pytest.raises(RuntimeError):
        svc.refresh()
    assert svc.staleness().pending_rows == 200 and svc.logs["Log"].requeues == 1
    vm._ingest_pending = real
    svc.refresh()
    assert svc.staleness().pending_rows == 0 and svc.refresh_count == 1


def test_streamed_answers_and_the_non_mean_estimators_match_jax():
    """After a streamed refresh, min/max match JAX and the bootstrap's AQP
    point (which does not resample) matches; no aggregate raises."""
    tvm, _ = _visit_vm()
    jvm, _ = _jax_visit_vm()
    for vm, pkg, gl, dev in ((tvm, tstream, grow_log, {"device": "cpu"}),
                             (jvm, jstream, jax_grow_log, {})):
        svc = vm.configure_streaming(pkg.StreamConfig(max_rows=500, max_age_s=1e9))
        for seq in range(3):
            vm.ingest("Log", inserts=gl(np.random.default_rng(seq), 300, 6000 + 300 * seq, 300,
                                        **dev), seq=seq)
    for agg in ("min", "max"):
        got = tvm.stream.query("v", tcore.Query(agg, "totalBytes"))
        want = jvm.stream.query("v", jcore.Query(agg, "totalBytes"))
        assert float(got.value) == pytest.approx(float(want.value), rel=1e-6)
        assert float(got.estimate.stderr) == pytest.approx(float(want.estimate.stderr), rel=1e-6)
    for agg, q in (("median", 0.5), ("percentile", 0.9)):
        got = tvm.query("v", tcore.Query(agg, "totalBytes", q=q), prefer="aqp")
        want = jvm.query("v", jcore.Query(agg, "totalBytes", q=q), prefer="aqp")
        assert float(got.value) == pytest.approx(float(want.value), rel=1e-6)
        assert got.method == want.method == "SVC+AQP(bootstrap)"
        corr = tvm.query("v", tcore.Query(agg, "totalBytes", q=q))
        assert corr.method == "SVC+CORR(bootstrap)"
        assert float(corr.ci_low) <= float(corr.ci_high)
        again = tvm.query("v", tcore.Query(agg, "totalBytes", q=q),
                          rng=torch.Generator().manual_seed(0))
        assert float(again.ci_low) == float(corr.ci_low)  # rng=None is seed 0
