"""The sharded fleet (§7.5) in both packages, on the CPU.

Each test of ``tests/test_distributed_fleet.py`` that drives
``ShardedFleet`` runs here in ``repro`` and in ``repro_torch``
(``device="cpu"``) from the same numpy arrays, and the two are held to
each other: placement, suspension, a sharded plan bit-identical to the
flat ``MaintenancePlanner`` (in each package) with the same actions and
skips across packages, answers equal to the flat epoch (across packages to
the fleet tolerance ``rtol=1e-6, atol=1e-4``: the port's plain group-by
adds in another order), shard loss and recovery, budget and skips.  Also:
``FleetMonitor`` / ``plan_elastic_mesh`` (``tests/test_training_infra.py``
and ``tests/test_robustness.py``), ``LocalMesh``, ``fleet_scores_sharded``
(bit-equal to ``fleet_scores`` on the host path and on a ``LocalMesh`` of
CPU devices, and to JAX's op-by-op reference), the sharded delta
group-bys against JAX's (``tests/test_streaming.py:293``: counts equal,
sums ``rtol=1e-5, atol=1e-4``), ``stack_shard_deltas``,
``merge_delta_into_sample`` and the per-shard reconcile
(``tests/test_observability.py:306``).  Tests set torch to one thread.
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.distributed as jdist
import repro.obs.kprof as jkprof
import repro.planner.scheduler as jsched
import repro.relational.plan as jplan
import repro.views as jviews
import repro_torch.core as tcore
import repro_torch.distributed as tdist
import repro_torch.obs.kprof as tkprof
import repro_torch.planner.scheduler as tsched
import repro_torch.relational.plan as tplan
import repro_torch.views as tviews
from repro.distributed.ft import FleetMonitor as JaxFleetMonitor
from repro.distributed.ft import plan_elastic_mesh as jax_plan_elastic_mesh
from repro.kernels.fleet_score import fleet_score_ref as jax_fleet_score_ref
from repro.kernels.fleet_score import fleet_scores_sharded as jax_fleet_scores_sharded
from repro.obs import trace as jtrace
from repro.obs.reconcile import check_shard_accounting as jax_check_shard_accounting
from repro.relational.relation import from_columns as jax_from_columns
from repro.relational.relation import to_host as jax_to_host
from repro.streaming import PartitionedDeltaLog as JaxPartitionedDeltaLog
from repro_torch.core import distributed_svc as tsvc
from repro_torch.distributed.ft import FleetMonitor, plan_elastic_mesh
from repro_torch.kernels.fleet_score import N_FEATURES, N_SCORES, fleet_scores, fleet_scores_sharded
from repro_torch.launch.mesh import LocalMesh, make_local_mesh
from repro_torch.obs import trace as ttrace
from repro_torch.obs.reconcile import check_shard_accounting
from repro_torch.relational.relation import from_columns, to_host
from repro_torch.streaming import PartitionedDeltaLog
from torch_fresh_jax import fresh_jax_traces

torch.set_num_threads(1)


class FakeClock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t


@dataclasses.dataclass(frozen=True)
class Pkg:
    name: str
    core: object
    dist: object
    plan: object
    views: object
    sched: object
    kprof: object
    check_shard_accounting: object
    trace: object
    from_columns: object
    to_host: object
    dev: dict


JAX = Pkg("jax", jcore, jdist, jplan, jviews, jsched, jkprof, jax_check_shard_accounting, jtrace,
          jax_from_columns, jax_to_host, {})
PORT = Pkg("port", tcore, tdist, tplan, tviews, tsched, tkprof, check_shard_accounting, ttrace,
           from_columns, to_host, {"device": "cpu"})
PKGS = (JAX, PORT)
BOTH = pytest.mark.parametrize("pkg", PKGS, ids=lambda p: p.name)


def _rel(pkg, cols, **kw):
    return pkg.from_columns(cols, **kw, **pkg.dev)


def _group_plan(pkg, base, groups=8):
    return pkg.plan.GroupByNode(
        child=pkg.plan.Scan(base, pk=("k",)), keys=("g",),
        aggs=(("total", "sum", "v"), ("cnt", "count", None)),
        num_groups=2 * groups,
    )


def _base_cols(rng, n=300, groups=8, start=0):
    return {"k": np.arange(start, start + n, dtype=np.int32),
            "g": rng.integers(0, groups, n).astype(np.int32),
            "v": rng.exponential(5.0, n).astype(np.float32)}


def _make_fleet(pkg, n_shards, n_views=4, clock=None, budget_s=10.0, **kw):
    fleet = pkg.dist.ShardedFleet(n_shards=n_shards, budget_s=budget_s, clock=clock,
                                  heartbeat_timeout_s=1e9, **kw, **pkg.dev)
    for i in range(n_views):
        base = f"Log{i}"
        fleet.register_base(base, _rel(pkg, _base_cols(np.random.default_rng(100 + i)),
                                       pk=["k"], capacity=2048))
        fleet.register_view(pkg.core.ViewDef(f"v{i}", _group_plan(pkg, base)),
                            delta_bases=(base,), m=0.4, seed=i, delta_group_capacity=16)
    return fleet


def _flat(pkg, clock, budget_s, n_views=4):
    flat = pkg.views.ViewManager(clock=clock, **pkg.dev)
    planner = pkg.sched.MaintenancePlanner(flat, budget_s=budget_s, age_cap_s=1e9, clock=clock)
    for i in range(n_views):
        base = f"Log{i}"
        flat.register_base(base, _rel(pkg, _base_cols(np.random.default_rng(100 + i)),
                                      pk=["k"], capacity=2048))
        flat.register_view(pkg.core.ViewDef(f"v{i}", _group_plan(pkg, base)),
                           delta_bases=(base,), m=0.4, seed=i, delta_group_capacity=16)
    return flat, planner


def _delta(pkg, i, start, n=40, groups=8):
    rng = np.random.default_rng(500 + i)
    return _rel(pkg, {"k": np.arange(start, start + n, dtype=np.int32),
                      "g": rng.integers(0, groups, n).astype(np.int32),
                      "v": rng.exponential(5.0, n).astype(np.float32)}, pk=["k"])


def _both(run):
    return run(JAX), run(PORT)


# ---------------------------------------------------------------------------
# FleetMonitor and the elastic plan
# ---------------------------------------------------------------------------

def _monitor_runs(mon_cls):
    out = []
    mon = mon_cls(n_hosts=4, timeout_s=10.0)
    now = 1000.0
    for h in range(4):
        mon.heartbeat(h, now)
    out.append(mon.sweep(now + 5))
    for h in (0, 1, 2):
        mon.heartbeat(h, now + 20)
    out.append(mon.sweep(now + 20))
    out.append(mon.alive_hosts())
    mon = mon_cls(n_hosts=4, timeout_s=1e9, straggler_factor=2.0, strikes=2)
    for step in range(4):
        for h in range(4):
            mon.heartbeat(h, 1000.0 + step)
            mon.report_step(h, 1.0 if h != 2 else 5.0)
        out.append(mon.sweep(1000.0 + step))
    return out


def test_fleet_monitor_detects_failures_and_stragglers_as_jax():
    t = _monitor_runs(FleetMonitor)
    assert t == _monitor_runs(JaxFleetMonitor)
    assert t[0] == ([], []) and t[1] == ([3], []) and t[2] == [0, 1, 2]
    assert ([], [2]) in t[3:]


def _clocked_runs(mon_cls):
    out = []
    clock = FakeClock()
    mon = mon_cls(3, timeout_s=5.0, clock=clock)
    clock.t = 4.0
    mon.heartbeat(0)
    mon.heartbeat(1)
    clock.t = 8.0
    out += [mon.sweep(), mon.alive_hosts()]
    clock = FakeClock(100.0)
    mon = mon_cls(1, timeout_s=5.0, clock=clock)
    mon.heartbeat(0)
    clock.t = 0.0  # the sweep's clock behind the last heartbeat: not a timeout
    out.append(mon.sweep())
    clock = FakeClock()
    mon = mon_cls(2, timeout_s=1.0, clock=clock)
    mon.report_step(0, 10.0)
    clock.t = 5.0
    mon.heartbeat(1)
    out.append(mon.sweep())
    mon.revive(0)
    h = mon.hosts[0]
    out += [mon.alive_hosts(), h.strikes, list(h.step_times), h.last_beat]
    return out


def test_fleet_monitor_injectable_clock_skew_and_revive_as_jax():
    t = _clocked_runs(FleetMonitor)
    assert t == _clocked_runs(JaxFleetMonitor)
    assert t[:3] == [([2], []), [0, 1], ([], [])]
    assert t[3] == ([0], []) and t[4:] == [[0, 1], 0, [], 5.0]


@pytest.mark.parametrize("alive,chips,mp,dp", [
    (list(range(96)), 4, 16, 32), ([0], 4, 16, 32), (list(range(7)), 8, 4, 64),
    ([5, 1, 3], 2, 1, 2)])
def test_plan_elastic_mesh_matches_jax(alive, chips, mp, dp):
    got = plan_elastic_mesh(alive, chips, mp, dp)
    want = jax_plan_elastic_mesh(alive, chips, mp, dp)
    assert (got is None) == (want is None)
    if got is not None:
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
    if alive == list(range(96)):
        assert (got.model_parallel, got.data_parallel, got.microbatch_factor) == (16, 16, 2)


# ---------------------------------------------------------------------------
# LocalMesh
# ---------------------------------------------------------------------------

def test_local_mesh_shape_and_axis_devices():
    mesh = make_local_mesh(data=3, model=2, device="cpu")
    assert mesh.shape == {"data": 3, "model": 2} and list(mesh.shape) == ["data", "model"]
    assert len(mesh.devices) == 6 and mesh.axis_devices("data") == [torch.device("cpu")] * 3
    m = LocalMesh(["cpu", "cuda:0", "cpu", "cuda:1"], {"data": 2, "model": 2})
    assert m.axis_devices("data") == [torch.device("cpu"), torch.device("cpu")]
    assert m.axis_devices("model") == [torch.device("cpu"), torch.device("cuda", 0)]
    with pytest.raises(ValueError, match="devices for a mesh"):
        LocalMesh(["cpu"] * 3, {"data": 2})
    if torch.cuda.device_count() < 2:
        with pytest.raises(RuntimeError, match="CUDA devices"):
            make_local_mesh(data=2, device="cuda")


# ---------------------------------------------------------------------------
# fleet_scores_sharded
# ---------------------------------------------------------------------------

def _stacked(S=4, vmax=16, seed=0):
    rng = np.random.default_rng(seed)
    stacked = rng.exponential(5.0, (S, vmax, N_FEATURES)).astype(np.float32)
    stacked[2, 10:] = 0.0  # padding lanes: all-zero features
    return stacked


@pytest.mark.parametrize("use_mesh", [False, True], ids=["host", "cpu_mesh"])
def test_fleet_scores_sharded_is_bit_equal_to_flat_op_and_jax_ref(use_mesh):
    S, vmax = 4, 16
    stacked = _stacked(S, vmax)
    mesh = make_local_mesh(data=S, device="cpu") if use_mesh else None
    got = fleet_scores_sharded(torch.from_numpy(stacked), mesh=mesh,
                               shard_views=[16, 16, 10, 16]).numpy()
    flat = fleet_scores(torch.from_numpy(stacked.reshape(S * vmax, N_FEATURES))).numpy()
    assert got.shape == (S, vmax, N_SCORES)
    assert np.array_equal(got.reshape(S * vmax, -1).view(np.int32), flat.view(np.int32))
    for s in range(S):  # JAX's op-by-op reference, shard by shard
        want = np.asarray(jax_fleet_score_ref(stacked[s]))
        assert np.array_equal(got[s].view(np.int32), want.view(np.int32))
    # JAX's sharded host path is jitted (XLA contracts a·b + c into an fma
    # on the CPU): within its own 2e-6, with the same decisions
    jitted = np.asarray(jax_fleet_scores_sharded(stacked, shard_views=[16, 16, 10, 16]))
    np.testing.assert_allclose(got, jitted, rtol=2e-6, atol=1e-6)
    assert np.array_equal(np.argmax(got[..., :4], -1), np.argmax(jitted[..., :4], -1))
    assert not got[2, 10:, :4].any()  # padding lanes never win an action


def test_fleet_scores_sharded_validates_shape():
    with pytest.raises(ValueError, match="stacked"):
        fleet_scores_sharded(torch.zeros((4, N_FEATURES)))
    with pytest.raises(ValueError, match="stacked"):
        fleet_scores_sharded(torch.zeros((2, 3, N_FEATURES - 1)))
    with pytest.raises(TypeError):
        fleet_scores_sharded(torch.zeros((2, 3, N_FEATURES), dtype=torch.float64))


@pytest.mark.parametrize("use_mesh", [False, True], ids=["host", "cpu_mesh"])
def test_fleet_scores_sharded_fills_the_per_shard_ledger(use_mesh):
    stacked = torch.from_numpy(_stacked(3, 8))
    mesh = make_local_mesh(data=3, device="cpu") if use_mesh else None
    prof = tkprof.set_profiler(tkprof.KernelProfiler())
    try:
        fleet_scores_sharded(stacked, mesh=mesh, shard_views=[8, 5, 0])
        fleet_scores_sharded(stacked, mesh=mesh, shard_views=[8, 5, 0])
    finally:
        tkprof.set_profiler(None)
    st = prof.summary()["fleet_score_sharded"]
    assert (st["dispatches"], st["fallbacks"], st["compiles"]) == (2, 2, 1)  # the plain version
    assert (st["rows_real"], st["rows_padded"]) == (26, 48)
    s = prof.shard_summary()
    per = s["shards"]["fleet_score_sharded"]
    assert sorted(per) == [0, 1, 2]
    assert [per[i]["rows_real"] for i in range(3)] == [16, 10, 0]
    assert all(per[i]["rows_padded"] == 16 and per[i]["dispatches"] == 2 for i in range(3))
    assert check_shard_accounting(s) == []


# ---------------------------------------------------------------------------
# Sharded delta group-bys (§7.5) against JAX's
# ---------------------------------------------------------------------------

def _session_rel(pkg, rng, start, n, G):
    return _rel(pkg, {"sessionId": np.arange(start, start + n, dtype=np.int32),
                      "videoId": rng.integers(0, G, n).astype(np.int32),
                      "bytes": rng.exponential(10, n).astype(np.float32)}, pk=["sessionId"])


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("n_shards", [1, 4])
def test_partitioned_log_feeds_sharded_groupbys_as_jax(n_shards):
    import jax
    from jax.sharding import Mesh

    from repro.core.distributed_svc import make_sharded_delta_groupby as jax_groupby
    from repro.core.distributed_svc import make_sharded_fused_delta_groupby as jax_fused
    from repro.core.distributed_svc import stack_shard_deltas as jax_stack

    G, R, m, seed = 64, 512, 0.3, 7
    per = R // n_shards
    # JAX's side on its one device; the port's on n_shards CPU "devices"
    jlog = JaxPartitionedDeltaLog("Log", n_shards=1)
    jlog.offer(0, inserts=_session_rel(JAX, np.random.default_rng(0), 0, R, G), seq=0)
    jk, jv, jvals = jax_stack(jlog.drain(), "videoId", ["bytes"], rows_per_shard=R)
    jmesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    jf = jax_fused(jmesh, "data", G, m, seed, ["bytes"])(jk, jv, jvals)
    ju = jax_groupby(jmesh, "data", G, m, seed, ["bytes"])(jk, jv, jvals)

    rel = _session_rel(PORT, np.random.default_rng(0), 0, R, G)
    plog = PartitionedDeltaLog("Log", n_shards=n_shards)
    for s in range(n_shards):
        rows = torch.arange(s * per, (s + 1) * per)
        plog.offer(s, inserts=from_columns({c: rel.col(c)[rows] for c in rel.schema.columns},
                                           pk=["sessionId"]), seq=0)
    keys, valid, values = tsvc.stack_shard_deltas(plog.drain(), "videoId", ["bytes"],
                                                  rows_per_shard=per)
    assert keys.shape == (R,) and int(valid.sum()) == R
    mesh = make_local_mesh(data=n_shards, device="cpu")
    tf = tsvc.make_sharded_fused_delta_groupby(mesh, "data", G, m, seed, ["bytes"])(
        keys, valid, values)
    tu = tsvc.make_sharded_delta_groupby(mesh, "data", G, m, seed, ["bytes"])(
        keys, valid, values)
    for got in (tf, tu):
        assert sorted(got) == ["bytes", "count"]
        for want in (jf, ju):
            np.testing.assert_array_equal(_np(got["count"]), _np(want["count"]))
            np.testing.assert_allclose(_np(got["bytes"]), _np(want["bytes"]), rtol=1e-5,
                                       atol=1e-4)
    np.testing.assert_array_equal(_np(tf["count"]), _np(tu["count"]))
    np.testing.assert_allclose(_np(tf["bytes"]), _np(tu["bytes"]), rtol=1e-5, atol=1e-4)
    assert 0 < float(tf["count"].sum()) < R


@BOTH
def test_stack_shard_deltas_pads_and_rejects_deletes(pkg):
    svc = (__import__("repro.core.distributed_svc", fromlist=["x"]) if pkg is JAX else tsvc)
    plog = (JaxPartitionedDeltaLog if pkg is JAX else PartitionedDeltaLog)("Log", n_shards=2)
    rel = _rel(pkg, {"sessionId": np.arange(4, dtype=np.int32),
                     "videoId": np.asarray([0, 1, 0, 1], np.int32),
                     "bytes": np.asarray([1.0, 2.0, 3.0, 4.0], np.float32)}, pk=["sessionId"])
    plog.offer(0, inserts=rel, seq=0)
    keys, valid, values = svc.stack_shard_deltas(plog.drain(), "videoId", ["bytes"],
                                                 rows_per_shard=8)
    assert tuple(keys.shape) == (16,) and tuple(valid.shape) == (16,)
    assert int(_np(valid)[8:].sum()) == 0  # partition 1 drained empty: fully padded
    assert int(_np(valid).sum()) == 4
    assert _np(values["bytes"])[:4].tolist() == [1.0, 2.0, 3.0, 4.0]
    plog.offer(0, inserts=rel, seq=1)
    with pytest.raises(ValueError, match="rows_per_shard"):
        svc.stack_shard_deltas(plog.drain(), "videoId", ["bytes"], rows_per_shard=2)
    plog.offer(0, inserts=rel, seq=2)
    plog.offer(0, deletes=_rel(pkg, {"sessionId": np.asarray([1], np.int32),
                                     "videoId": np.asarray([1], np.int32),
                                     "bytes": np.asarray([1.0], np.float32)},
                                pk=["sessionId"]), seq=3)
    with pytest.raises(ValueError, match="insert-only"):
        svc.stack_shard_deltas(plog.drain(), "videoId", ["bytes"], rows_per_shard=8)


def test_merge_delta_into_sample_matches_jax_but_keeps_key_zero():
    """Equal to JAX on every group but key 0: JAX marks membership with a
    scatter-set in which every padding row writes False at index 0, so a
    sampled group 0 drops out of its result; the port marks only valid keys."""
    from repro.core.distributed_svc import merge_delta_into_sample as jax_merge

    G, m, seed = 64, 0.3, 7
    rng = np.random.default_rng(4)
    keys = np.full(32, 2**31 - 1, np.int32)
    keys[:12] = np.concatenate([[0], rng.choice(np.arange(1, G), 11, replace=False)])
    vals = {"count": np.where(keys < G, rng.integers(1, 9, 32), 0).astype(np.float32),
            "bytes": np.where(keys < G, rng.exponential(5.0, 32), 0).astype(np.float32)}
    delta = {"count": (rng.uniform(size=G) < 0.4).astype(np.float32) * 3,
             "bytes": rng.exponential(5.0, G).astype(np.float32)}
    jk, jv = jax_merge(keys, vals, delta, m, seed, G)
    tk, tv = tsvc.merge_delta_into_sample(
        torch.from_numpy(keys), {c: torch.from_numpy(v) for c, v in vals.items()},
        {c: torch.from_numpy(v) for c, v in delta.items()}, m, seed, G)
    jk, tk = np.asarray(jk), tk.numpy()
    np.testing.assert_array_equal(tk[1:], jk[1:])
    for c in vals:
        np.testing.assert_array_equal(tv[c].numpy()[1:], np.asarray(jv[c])[1:])
    assert tk[0] == 0 and jk[0] == 2**31 - 1
    assert tv["count"][0] == vals["count"][0] + delta["count"][0]


# ---------------------------------------------------------------------------
# FleetHealth.suspend
# ---------------------------------------------------------------------------

def test_suspend_blocks_planning_and_counts_as_quarantine():
    def run(pkg):
        tr = pkg.trace.enable()
        try:
            vm = pkg.views.ViewManager(**pkg.dev)
            vm.health.begin_epoch()
            h = vm.health.suspend("v0", RuntimeError("shard 2 lost"))
            got = [h.suspended, h.degraded, h.failures, vm.health.blocked("v0"),
                   vm.health.is_degraded("v0"), vm.health.retry_due("v0"),
                   len([r for r in tr.records if r["kind"] == "event"
                        and r["name"] == "quarantine"])]
            vm.health.resume("v0")
            got += [vm.health.blocked("v0"), vm.health.is_degraded("v0")]
            vm.health.record_success("v0")
            return got + [vm.health.is_degraded("v0")]
        finally:
            pkg.trace.set_tracer(None)

    j, t = _both(run)
    assert t == j == [True, True, 1, True, True, False, 1, False, True, False]


# ---------------------------------------------------------------------------
# ShardedFleet
# ---------------------------------------------------------------------------

def test_placement_colocates_with_the_owning_base():
    def run(pkg):
        fleet = _make_fleet(pkg, n_shards=2, n_views=2)
        got = [dict(fleet.view_shard)]
        fleet.register_view(pkg.core.ViewDef("v0b", _group_plan(pkg, "Log0")),
                            delta_bases=("Log0",), m=0.4, seed=9, delta_group_capacity=16)
        got.append(fleet.shard_of("v0b") == fleet.shard_of("v0"))
        with pytest.raises(ValueError, match="owned by shard"):
            fleet.register_view(pkg.core.ViewDef("v0c", _group_plan(pkg, "Log0")),
                                delta_bases=("Log0",), m=0.4, seed=10,
                                delta_group_capacity=16, shard=1)
        with pytest.raises(ValueError, match="already registered"):
            fleet.register_view(pkg.core.ViewDef("v0", _group_plan(pkg, "Log0")),
                                delta_bases=("Log0",), m=0.4, seed=0)
        with pytest.raises(ValueError, match="out of range"):
            fleet.register_view(pkg.core.ViewDef("v9", _group_plan(pkg, "Log1")),
                                delta_bases=(), m=0.4, seed=0, shard=5)
        return got + [fleet.shard_views(0), sorted(fleet.vms[0].base), dict(fleet.base_owner)]

    j, t = _both(run)
    assert t == j
    assert t[0] == {"v0": 0, "v1": 1} and t[1] is True


def test_port_fleet_places_shards_on_the_mesh_devices():
    mesh = make_local_mesh(data=2, device="cpu")
    fleet = _make_fleet(PORT, n_shards=2, n_views=2, mesh=mesh)
    assert fleet.devices == [torch.device("cpu")] * 2
    assert [vm.device for vm in fleet.vms] == mesh.axis_devices("data")
    assert [vm.obs_attrs for vm in fleet.vms] == [{"shard": 0}, {"shard": 1}]
    with pytest.raises(RuntimeError, match="no CUDA device") if not torch.cuda.is_available() \
            else _nothing():
        tdist.ShardedFleet(n_shards=2)  # the card by default


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _plan_parity(pkg, mesh=None):
    clock = FakeClock()
    kw = {"mesh": mesh} if mesh is not None else {}
    fleet = _make_fleet(pkg, n_shards=2, n_views=4, clock=clock, budget_s=0.3, **kw)
    flat, planner = _flat(pkg, clock, 0.3)
    for cm in fleet.cost_models + [planner.cost_model]:
        cm.pin_costs(0.05, 0.25)
    for i in range(4):
        d = _delta(pkg, i, 1000)
        fleet.vms[fleet.shard_of(f"v{i}")].ingest(f"Log{i}", inserts=d)
        flat.ingest(f"Log{i}", inserts=d)
    sharded = fleet.epoch_step(execute=False)
    single = planner.plan()
    assert (sorted((a.view, a.action) for a in sharded.actions)
            == sorted((a.view, a.action) for a in single.actions))
    for a in sharded.actions:
        want = next(x for x in single.actions if x.view == a.view)
        assert a.score == want.score and a.predicted_s == want.predicted_s
        assert a.shard == fleet.shard_of(a.view)
    assert sorted(sharded.skipped) == sorted(single.skipped)
    assert fleet.epoch == 0 and fleet.pending_rows() == 0  # a preview moves nothing
    return sorted((a.view, a.action, a.shard, a.predicted_s) for a in sharded.actions), \
        sorted(sharded.skipped), {a.view: a.score for a in sharded.actions}


def test_sharded_plan_is_bit_identical_to_flat_planner():
    (ja, jskip, jscore), (ta, tskip, tscore) = _both(_plan_parity)
    assert ta == ja and tskip == jskip and ta
    np.testing.assert_allclose([tscore[v] for v in sorted(tscore)],
                               [jscore[v] for v in sorted(jscore)], rtol=2e-6)
    # the port's multi-device branch: shards on a LocalMesh of CPU devices
    assert _plan_parity(PORT, mesh=make_local_mesh(data=2, device="cpu")) == (ta, tskip, tscore)


def test_sharded_epoch_answers_match_flat_epoch():
    def run(pkg):
        clock = FakeClock()
        fleet = _make_fleet(pkg, n_shards=2, n_views=4, clock=clock)
        flat, planner = _flat(pkg, clock, 10.0)
        for cm in fleet.cost_models + [planner.cost_model]:
            cm.pin_costs(0.05, 0.25)
        for i in range(4):
            d = _delta(pkg, i, 1000)
            fleet.ingest(f"Log{i}", inserts=d, seq=0, key=f"e{i}")
            flat.ingest(f"Log{i}", inserts=d)
        rep = fleet.epoch_step()
        flat_rep = planner.step()
        assert {a.view for a in rep.actions} == {"v0", "v1", "v2", "v3"}
        assert (sorted((a.view, a.action) for a in rep.actions)
                == sorted((a.view, a.action) for a in flat_rep.actions))
        q = pkg.core.Query(agg="sum", col="total")
        got = {}
        for i in range(4):
            got[f"v{i}"] = float(fleet.query(f"v{i}", q).value)
            assert got[f"v{i}"] == float(flat.query(f"v{i}", q).value)
        return sorted((a.view, a.action, a.shard) for a in rep.actions), got, rep.to_dict()

    (ja, jv, jrep), (ta, tv, trep) = _both(run)
    assert ta == ja
    np.testing.assert_allclose([tv[k] for k in sorted(tv)], [jv[k] for k in sorted(jv)],
                               rtol=1e-6, atol=1e-4)
    assert sorted(trep) == sorted(jrep)
    for k in ("epoch", "budget_s", "skipped", "quarantined", "excluded_shards", "suspended"):
        assert trep[k] == jrep[k], k


def test_shard_loss_degrades_to_serve_stale_and_recovers():
    def run(pkg):
        fleet = _make_fleet(pkg, n_shards=2, n_views=4)
        for i in range(4):
            fleet.ingest(f"Log{i}", inserts=_delta(pkg, i, 1000), seq=0)
        fleet.epoch_step()
        q = pkg.core.Query(agg="sum", col="total")
        before = {f"v{i}": float(fleet.query(f"v{i}", q).value) for i in range(4)}

        fleet.kill_shard(1)
        for i in range(4):
            fleet.ingest(f"Log{i}", inserts=_delta(pkg, i, 2000), seq=1)
        rep = fleet.epoch_step()
        lost = set(fleet.shard_views(1))
        assert rep.excluded_shards == [1]
        assert set(rep.suspended) == lost
        assert {a.view for a in rep.actions} == set(fleet.shard_views(0))
        assert fleet.pending_rows() == 80  # the lost shard's partitions keep queueing
        during = {}
        for i in range(4):
            name = f"v{i}"
            est = float(fleet.query(name, q).value)
            during[name] = est
            assert np.isfinite(est)
            if name in lost:
                assert fleet.is_degraded(name)
                assert est == before[name]  # last good sample, unmoved
            else:
                assert not fleet.is_degraded(name)
        assert set(fleet.degraded_views()) == lost
        failures = {n: fleet.vms[1].health.views[n].failures for n in lost}
        fleet.epoch_step()  # a second epoch does not re-suspend
        assert all(fleet.vms[1].health.views[n].failures == failures[n] for n in lost)

        fleet.revive_shard(1)
        rep = fleet.epoch_step()
        assert rep.excluded_shards == []
        assert {a.view for a in rep.actions} >= lost  # the drain epoch catches up
        assert fleet.pending_rows() == 0
        after = {}
        for name in sorted(lost):
            assert not fleet.is_degraded(name)
            after[name] = float(fleet.query(name, q).value)
            assert after[name] != before[name]
        return sorted(lost), before, during, after, failures

    (jl, jb, jd, ja, jf), (tl, tb, td, ta, tf) = _both(run)
    assert (tl, tf) == (jl, jf)
    for j, t in ((jb, tb), (jd, td), (ja, ta)):
        np.testing.assert_allclose([t[k] for k in sorted(t)], [j[k] for k in sorted(j)],
                                   rtol=1e-6, atol=1e-4)


def test_epoch_respects_budget_and_skips():
    def run(pkg):
        clock = FakeClock()
        fleet = _make_fleet(pkg, n_shards=2, n_views=4, clock=clock, budget_s=0.05)
        for cm in fleet.cost_models:
            cm.pin_costs(0.05, 0.25)
        for i in range(4):
            fleet.ingest(f"Log{i}", inserts=_delta(pkg, i, 1000), seq=0)
        rep = fleet.epoch_step()
        assert len(rep.actions) == 1  # one clean fits the 0.05 s budget
        assert rep.predicted_spend_s <= 0.05 + 1e-9
        assert len(rep.skipped) == 3
        return [(a.view, a.action, a.shard) for a in rep.actions], sorted(rep.skipped)

    j, t = _both(run)
    assert t == j


def test_sharded_fleet_epoch_reconciles_per_shard():
    def run(pkg):
        prof = pkg.kprof.set_profiler(pkg.kprof.KernelProfiler())
        try:
            fleet = pkg.dist.ShardedFleet(n_shards=2, budget_s=10.0, heartbeat_timeout_s=1e9,
                                          **pkg.dev)
            rng = np.random.default_rng(7)
            for i in range(2):
                base = f"Log{i}"
                n = 200
                fleet.register_base(base, _rel(pkg, {
                    "k": np.arange(n, dtype=np.int32),
                    "g": rng.integers(0, 8, n).astype(np.int32),
                    "v": rng.exponential(4.0, n).astype(np.float32)}, pk=["k"], capacity=1024))
                fleet.register_view(pkg.core.ViewDef(f"v{i}", _group_plan(pkg, base)),
                                    delta_bases=(base,), m=0.4, seed=i, delta_group_capacity=16)
                fleet.ingest(base, inserts=_rel(pkg, {
                    "k": np.arange(1000, 1040, dtype=np.int32),
                    "g": rng.integers(0, 8, 40).astype(np.int32),
                    "v": rng.exponential(4.0, 40).astype(np.float32)}, pk=["k"]))
            rep = fleet.epoch_step()
            assert rep.actions
            s = prof.shard_summary()
            assert any(per for per in s["shards"].values())
            assert pkg.check_shard_accounting(s) == []
            seen = {sh for per in s["shards"].values() for sh in per}
            assert seen and seen <= {0, 1}
            return (sorted(s["shards"]), sorted(seen),
                    {sh: v["rows_real"] for sh, v
                     in s["shards"]["fleet_score_sharded"].items()})
        finally:
            pkg.kprof.set_profiler(None)

    fresh_jax_traces()  # JAX profiles the fused clean only while it traces
    j, t = _both(run)
    # both ledgers hold the score combine and each shard's clean (one view a
    # shard: svc_refresh_many cleans it per view); the port also profiles
    # the η mask, which JAX leaves unprofiled
    assert {"fleet_score_sharded", "fused_clean"} <= set(j[0]) <= set(t[0])
    assert t[1] == j[1] == [0, 1] and t[2] == j[2] == {0: 1, 1: 1}
