"""The fleet path in both packages from the same numpy data, on the CPU.

Fleets of 3–6 group-by views (≤ 512 base rows, ≤ 64 groups) are built in
``repro`` and in ``repro_torch`` (``device="cpu"``) from the same numpy
arrays.  The port's FleetPanel channels and moments must match the JAX
panel's (and its own per-view reference loop) to 1e-6; its
``svc_refresh_many`` must match the JAX one and the port's own per-view
``svc_refresh`` with the JAX tolerance — keys and counts exact, floats
``rtol=1e-6, atol=1e-4`` (the batched aggregation adds in another order).
"""

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.relational.plan as jplan
import repro_torch.core as tcore
import repro_torch.relational.plan as tplan
from repro.planner import CostModel as JaxCostModel
from repro.relational.relation import from_columns as jax_from_columns
from repro.relational.relation import to_host as jax_to_host
from repro.views import ViewManager as JaxViewManager
from repro_torch.kernels.fleet_score import N_FEATURES
from repro_torch.planner import CostModel, canonical_query
from repro_torch.relational.relation import from_columns, to_host
from repro_torch.views import ViewManager

EXACT_COLS = ("videoId", "visits")


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class Twin:
    """One fleet built in both packages from the same numpy arrays."""

    def __init__(self):
        self.jax = JaxViewManager()
        self.port = ViewManager(device="cpu")

    def base(self, name, cols, capacity=None):
        self.jax.register_base(name, jax_from_columns(cols, pk=["sessionId"], capacity=capacity))
        self.port.register_base(name, from_columns(cols, pk=["sessionId"], capacity=capacity,
                                                   device="cpu"))

    def view(self, name, base, groups, m, seed, with_deletes=False, aggs=None):
        aggs = aggs or (("totalBytes", "sum", "bytes"), ("visits", "count", None))
        for vm, core, P in ((self.jax, jcore, jplan), (self.port, tcore, tplan)):
            plan = P.GroupByNode(child=P.Scan(base, pk=("sessionId",)), keys=("videoId",),
                                 aggs=aggs, num_groups=2 * groups)
            vm.register_view(core.ViewDef(name, plan), delta_bases=(base,), m=m, seed=seed,
                             delta_group_capacity=2 * groups, with_deletes=with_deletes)

    def ingest(self, base, inserts=None, deletes=None):
        def rel(cols, make, **kw):
            return None if cols is None else make(cols, pk=["sessionId"], **kw)

        self.jax.ingest(base, inserts=rel(inserts, jax_from_columns),
                        deletes=rel(deletes, jax_from_columns))
        self.port.ingest(base, inserts=rel(inserts, from_columns, device="cpu"),
                         deletes=rel(deletes, from_columns, device="cpu"))

    def outlier_index(self, view, base, k):
        self.jax.register_outlier_index(view, base, "bytes", k=k)
        self.port.register_outlier_index(view, base, "bytes", k=k)


def _rows(start, n, groups, rng):
    return {"sessionId": np.arange(start, start + n, dtype=np.int32),
            "videoId": rng.integers(0, groups, n).astype(np.int32),
            "bytes": rng.exponential(10.0, n).astype(np.float32)}


def _ragged(seed=0, n_views=5):
    """Bases of very different sizes and key domains: ragged capacities."""
    rng = np.random.default_rng(seed)
    tw = Twin()
    for i in range(n_views):
        rows = 60 + 90 * i
        tw.base(f"Log{i}", _rows(0, rows, 8 * (i + 1), rng), capacity=max(64, 2 * rows))
        tw.view(f"v{i}", f"Log{i}", 8 * (i + 1), m=0.25 if i % 2 == 0 else 0.5, seed=i)
    return tw, rng


def _uniform(n_views, seed, groups=32, rows=400):
    rng = np.random.default_rng(seed)
    tw = Twin()
    for i in range(n_views):
        tw.base(f"Log{i}", _rows(0, rows, groups, rng), capacity=2 * rows)
        tw.view(f"v{i}", f"Log{i}", groups, m=0.25, seed=i)
    return tw, rng


def _sorted(h, key="videoId"):
    o = np.argsort(h[key], kind="stable")
    return {k: v[o] for k, v in h.items()}


def assert_same_samples(got, want, name):
    a, b = _sorted(got), _sorted(want)
    assert set(a) == set(b), name
    for col in a:
        if col in EXACT_COLS or np.issubdtype(a[col].dtype, np.integer):
            np.testing.assert_array_equal(a[col], b[col], err_msg=f"{name}:{col}")
        else:
            np.testing.assert_allclose(a[col], b[col], rtol=1e-6, atol=1e-4,
                                       err_msg=f"{name}:{col}")


def _features(vm, make, use_panel):
    """Features with pinned costs (the wall-time seeds differ run to run) and
    a frozen clock."""
    cm = make(vm, clock=FakeClock(), use_panel=use_panel)
    cm.pin_costs(refresh_s=1.0, maintain_s=4.0)
    return cm.features()


def assert_feature_parity(got, want):
    assert got.shape == want.shape
    for col in range(want.shape[1]):
        np.testing.assert_allclose(
            got[:, col], want[:, col], rtol=1e-6,
            atol=1e-6 * max(1.0, float(np.max(np.abs(want[:, col])))), err_msg=f"column {col}")


def assert_panel_matches_jax(tw):
    got = [c.numpy() for c in tw.port.fleet_panel().channels()]
    want = [np.asarray(c) for c in tw.jax.fleet_panel().channels()]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
    f_port = _features(tw.port, CostModel, True)
    assert_feature_parity(f_port, _features(tw.jax, JaxCostModel, True))
    assert_feature_parity(f_port, _features(tw.port, CostModel, False))
    assert f_port.shape[1] == N_FEATURES
    return f_port


# ---------------------------------------------------------------------------
# FleetPanel: channels and moments against the JAX panel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_panel_channels_and_moments_match_jax_on_a_ragged_fleet(seed):
    tw, rng = _ragged(seed)
    for i in range(5):
        tw.ingest(f"Log{i}", inserts=_rows(5000, 40 + 30 * i, 8 * (i + 1), rng))
    for i in (0, 2):  # some views refreshed, some drifting
        tw.jax.svc_refresh(f"v{i}")
        tw.port.svc_refresh(f"v{i}")
    assert_panel_matches_jax(tw)
    tw.jax.maintain("v3")
    tw.port.maintain("v3")
    assert_panel_matches_jax(tw)


def test_panel_slots_built_from_the_query_cache_match_jax():
    tw, rng = _ragged(3)
    tw.ingest("Log0", inserts=_rows(5000, 80, 8, rng))
    for vm in (tw.jax, tw.port):
        vm.svc_refresh("v0")
        vm.query("v0", jcore.Query(agg="sum", col="totalBytes") if vm is tw.jax
                 else tcore.Query(agg="sum", col="totalBytes"))
    assert tw.port.views["v0"].corr_cache is not None
    cold = tw.port.fleet_panel().moments()
    assert_panel_matches_jax(tw)
    tw.port._panel = None  # rebuild without the cache: the join path
    tw.port.views["v0"].corr_cache = None
    np.testing.assert_allclose(tw.port.fleet_panel().moments(), cold, rtol=1e-6, atol=1e-4)


def test_panel_handles_an_empty_view_and_an_all_outlier_view():
    rng = np.random.default_rng(8)
    tw = Twin()
    tw.base("Log0", _rows(0, 120, 6, rng), capacity=240)
    tw.view("v0", "Log0", 6, m=0.25, seed=0)
    tw.base("Empty", _rows(0, 0, 4, rng), capacity=64)
    tw.view("vEmpty", "Empty", 4, m=0.5, seed=9)
    tw.outlier_index("v0", "Log0", k=120)  # pins every group of v0
    f = assert_panel_matches_jax(tw)
    assert f[0, 3] == 0.0 and f[0, 4] == 0.0 and f[0, 0] > 0.0  # HT variances 0, N̂ > 0
    assert not f[1, :5].any()  # the empty view: all-zero moments


def test_panel_slots_invalidate_per_view():
    tw, rng = _ragged()
    panel = tw.port.fleet_panel()
    panel.channels()
    before = dict(panel._slots)
    tw.ingest("Log1", inserts=_rows(5000, 50, 16, rng))
    tw.port.svc_refresh("v1")
    assert "v1" not in panel._slots
    panel.channels()
    for name, slab in panel._slots.items():
        assert name == "v1" or slab is before[name], name


def test_canonical_query_is_the_first_value_column():
    tw, _ = _ragged(n_views=1)
    q = canonical_query(tw.port.views["v0"])
    assert (q.agg, q.col) == ("sum", "totalBytes")


# ---------------------------------------------------------------------------
# svc_refresh_many against JAX and against the port's per-view refresh
# ---------------------------------------------------------------------------

def _diff_refresh(make, bumps=1):
    """Batched in both packages, per view in a port twin; all must agree.
    ``bumps``: sample-version moves per view (a retune adds one)."""
    tw = make()
    seq = make().port
    versions = {n: v.sample_version for n, v in tw.port.views.items()}
    dts = tw.port.svc_refresh_many(list(tw.port.views))
    tw.jax.svc_refresh_many(list(tw.jax.views))
    for name in seq.views:
        seq.svc_refresh(name)
    assert set(dts) == set(tw.port.views)
    for name, mv in tw.port.views.items():
        got = to_host(mv.clean_sample)
        assert mv.clean_sample.capacity == tw.jax.views[name].clean_sample.capacity
        assert_same_samples(got, jax_to_host(tw.jax.views[name].clean_sample), name)
        assert_same_samples(got, to_host(seq.views[name].clean_sample), name)
        assert mv.sample_version == versions[name] + bumps
        assert tw.port.drift_rows(name, since="clean") == 0
        assert dts[name] > 0.0
    assert tw.port.fleet_merge_failures == 0
    return tw


def test_svc_refresh_many_matches_jax_and_per_view_refresh():
    def make():
        tw, _ = _uniform(4, seed=5)
        d = np.random.default_rng(99)
        for i in range(4):
            tw.ingest(f"Log{i}", inserts=_rows(5000, 150, 32, d))
        return tw

    _diff_refresh(make)


def test_differential_empty_delta_windows():
    def make():
        tw, _ = _uniform(4, seed=31)
        d = np.random.default_rng(41)
        for i in (1, 3):  # v0 and v2 have nothing pending
            tw.ingest(f"Log{i}", inserts=_rows(5000, 90, 32, d))
        return tw

    _diff_refresh(make)


def test_differential_duplicate_group_keys():
    def make():
        tw, _ = _uniform(3, seed=51, groups=4, rows=300)
        d = np.random.default_rng(52)
        for i in range(3):
            tw.ingest(f"Log{i}", inserts=_rows(5000, 200, 4, d))
        return tw

    _diff_refresh(make)


@pytest.mark.parametrize("delete_only", [True, False])
def test_differential_all_delete_microbatches(delete_only):
    def make():
        rng = np.random.default_rng(61)
        tw = Twin()
        bases = []
        for i in range(3):
            cols = _rows(0, 400, 16, rng)
            bases.append(cols)
            tw.base(f"Log{i}", cols, capacity=800)
            tw.view(f"v{i}", f"Log{i}", 16, m=0.25, seed=i, with_deletes=True)
        d = np.random.default_rng(62)
        for i in range(3):
            pick = d.choice(400, 60, replace=False)
            dels = {k: v[pick] for k, v in bases[i].items()}
            ins = None if delete_only else _rows(5000, 80, 16, d)
            tw.ingest(f"Log{i}", inserts=ins, deletes=dels)
        return tw

    _diff_refresh(make)


def test_differential_outlier_view_falls_back_inside_the_batch():
    def make():
        rng = np.random.default_rng(71)
        tw = Twin()
        for i in range(3):
            tw.base(f"Log{i}", _rows(0, 120, 6, rng), capacity=240)
            tw.view(f"v{i}", f"Log{i}", 6, m=0.25, seed=i)
        tw.outlier_index("v0", "Log0", k=120)  # every row pinned: per-view path
        d = np.random.default_rng(72)
        for i in range(3):
            tw.ingest(f"Log{i}", inserts=_rows(5000, 50, 6, d))
        return tw

    tw = _diff_refresh(make)
    assert to_host(tw.port.views["v0"].clean_sample)["__outlier"].all()


def test_recommended_m_retunes_on_the_batched_path():
    def make():
        tw, _ = _uniform(3, seed=9)
        d = np.random.default_rng(23)
        for i in range(3):
            tw.ingest(f"Log{i}", inserts=_rows(5000, 120, 32, d))
        for vm in (tw.jax, tw.port):
            vm.adaptive_m = True
            for i in range(3):
                vm.views[f"v{i}"].recommended_m = 0.5
        return tw

    tw = _diff_refresh(make, bumps=2)
    for mv in tw.port.views.values():
        assert mv.m == 0.5 and mv.recommended_m is None


def test_epoch_runs_one_fleet_merge_per_shape_group(monkeypatch):
    """A uniform fleet's epoch is ONE fleet_merge launch; a fleet mixing two
    aggregate counts is two, one per (Rp, A) shape group."""
    import repro_torch.kernels.fleet_merge as FM

    calls = []
    orig = FM.fleet_merge

    def spy(*args, **kwargs):
        calls.append(tuple(args[2].shape))
        return orig(*args, **kwargs)

    monkeypatch.setattr(FM, "fleet_merge", spy)
    tw, rng = _uniform(4, seed=81)
    for i in range(4):
        tw.ingest(f"Log{i}", inserts=_rows(5000, 100, 32, rng))
    tw.port.svc_refresh_many(list(tw.port.views))
    assert len(calls) == 1 and calls[0][0] == 4

    calls.clear()
    tw = Twin()
    for i in range(4):
        tw.base(f"Log{i}", _rows(0, 200, 16, rng), capacity=400)
        aggs = (("totalBytes", "sum", "bytes"),) if i % 2 else None
        tw.view(f"v{i}", f"Log{i}", 16, m=0.5, seed=i, aggs=aggs)
        tw.ingest(f"Log{i}", inserts=_rows(5000, 50, 16, rng))
    tw.port.svc_refresh_many(list(tw.port.views))
    assert sorted(c[0] for c in calls) == [2, 2] and sorted(c[2] for c in calls) == [1, 2]


def test_merge_slots_hold_the_valid_stale_rows_in_one_pow2_bucket():
    """A merge slot is its view's valid stale rows, key-sorted, then SENTINEL
    padding up to one pow2 bucket of the fleet's largest valid count (not the
    stale arena), and a stale sample that grows past the bucket moves it."""
    from repro_torch.relational.relation import SENTINEL_KEY, next_pow2

    tw, rng = _ragged(seed=23)
    vm = tw.port
    panel = vm.fleet_panel()
    live = {n: int(mv.stale_sample.valid.sum()) for n, mv in vm.views.items()}
    for name, mv in vm.views.items():
        keys, valid, vals = panel.merge_slot(name, "videoId", ("totalBytes", "visits"))
        rp = next_pow2(max(max(live.values()), 1))
        assert panel.merge_pad_rows == rp < max(m.stale_sample.capacity for m in vm.views.values())
        assert keys.shape == valid.shape == (rp,) and vals.shape == (rp, 2)
        n = live[name]
        assert bool(valid[:n].all()) and not bool(valid[n:].any())
        h = _sorted(to_host(mv.stale_sample))
        np.testing.assert_array_equal(keys[:n].numpy(), h["videoId"])
        np.testing.assert_array_equal(vals[:n, 0].numpy(), h["totalBytes"])
        assert bool((keys[n:] == int(SENTINEL_KEY)).all()) and not bool(vals[n:].any())
    # v3's key domain doubles and its ratio steps to 1: every group is live
    tw.ingest("Log3", inserts=_rows(10_000, 400, 64, rng))
    vm.maintain("v3")
    vm.adaptive_m = True
    vm.views["v3"].recommended_m = 1.0
    vm.svc_refresh("v3")
    grown = int(vm.views["v3"].stale_sample.valid.sum())
    panel.merge_slot("v3", "videoId", ("totalBytes", "visits"))
    assert panel.merge_pad_rows == next_pow2(grown) > next_pow2(max(live.values()))


def test_a_failed_batched_launch_falls_back_to_per_view_cleans(monkeypatch):
    """The JAX semantics of isolate=True, kept for CPU managers only: the
    epoch degrades to per-view cleans, counted in fleet_merge_failures, with
    the same samples.  On the card the failure propagates
    (test_torch_cuda.test_a_failed_batched_launch_raises_on_the_card)."""
    import repro_torch.views.manager as M

    def boom(jobs):
        raise RuntimeError("injected fleet failure")

    tw, rng = _uniform(3, seed=13)
    for i in range(3):
        tw.ingest(f"Log{i}", inserts=_rows(5000, 100, 32, rng))
    monkeypatch.setattr(M, "fleet_clean_merge", boom)
    tw.port.svc_refresh_many(list(tw.port.views))
    assert tw.port.fleet_merge_failures == 1
    with pytest.raises(RuntimeError, match="injected"):
        tw.port.svc_refresh_many(list(tw.port.views), isolate=False)
    tw.jax.svc_refresh_many(list(tw.jax.views))
    for name, mv in tw.port.views.items():
        assert_same_samples(to_host(mv.clean_sample), jax_to_host(tw.jax.views[name].clean_sample),
                            name)
        assert not tw.port.health.is_degraded(name)


def test_a_failing_view_is_quarantined_and_the_rest_commit(monkeypatch):
    tw, rng = _uniform(3, seed=17)
    for i in range(3):
        tw.ingest(f"Log{i}", inserts=_rows(5000, 100, 32, rng))
    vm = tw.port
    old = vm.views["v1"].clean_sample
    orig = vm._after_clean

    def flaky(mv, name, *a):
        if name == "v1":
            raise ValueError("injected")
        return orig(mv, name, *a)

    monkeypatch.setattr(vm, "_after_clean", flaky)
    dts = vm.svc_refresh_many(list(vm.views))
    assert dts["v1"] == 0.0 and dts["v0"] > 0.0
    assert vm.views["v1"].clean_sample is old
    assert vm.health.quarantined() == ["v1"]
    assert vm.drift_rows("v1", since="clean") > 0 and vm.drift_rows("v0", since="clean") == 0


def test_manager_timers_and_drift_counters_match_jax():
    tw, rng = _uniform(2, seed=3)
    for i in range(2):
        tw.ingest(f"Log{i}", inserts=_rows(5000, 70, 32, rng))
    for vm in (tw.jax, tw.port):
        assert vm.ingested_rows == {"Log0": 70, "Log1": 70}
        vm.maintain("v0")
        vm.svc_refresh("v1")
    for name in ("v0", "v1"):
        j, p = tw.jax.views[name], tw.port.views[name]
        assert (p.sample_version, p.stale_version) == (j.sample_version, j.stale_version)
        for since in ("ivm", "clean"):
            assert tw.port.drift_rows(name, since) == tw.jax.drift_rows(name, since)
        assert p.maintenance_s > 0.0
    assert tw.port.views["v0"].ivm_s > 0.0 and tw.port.views["v1"].refresh_s > 0.0
    assert isinstance(tw.port.views["v0"].clean_sample.valid, torch.Tensor)
