"""The fleet kernels' plain versions against the JAX package, on the CPU.

For each kernel of the fleet path — fleet_merge, fleet_score,
fleet_moments and the fused_clean fleet entry — the port's wrapper (which
takes its plain PyTorch version for CPU tensors) gets the same numpy
inputs as the JAX reference (``ref.py``) and the JAX op with
``use_pallas=True`` (the Pallas kernel in interpret mode; the fused_clean
fleet entry has no Pallas kernel, so its JAX op is the XLA pass).

Tolerances: fleet_merge bit-equal to all three (its float order is the
executor's ``(stale + ins) − del``); so is the plain version of its
kernel's rank computation (``fleet_merge_rank_ref``: the stale sort, a
prefix sum and a binary search instead of a sort of the output), also on
stale panels with duplicate, negative, ≥ G and SENTINEL-keyed valid keys.  fleet_score bit-equal to the JAX
``ref.py`` run op by op, where every op rounds once as every torch op and
the CUDA kernel do (the scorer feeds the knapsack's tie order); the jitted
JAX paths (XLA and Pallas interpret) contract ``a·b + c`` into one fma on
the CPU, so against them the scores are held to the JAX package's own
tolerance (rtol 2e-6, atol 1e-6, ``tests/test_kernels.py``) and the
CORR_WINS and REC_M decisions exactly.  fleet_moments ≤ 1e-6 relative
(sums in another order); fused_clean fleet counts exact and sums ≤ 1e-6
relative.

The planner's host entries (``fleet_scores_host``,
``fleet_scores_sharded_host``: a numpy panel in, numpy scores out) take
the plain version on a CPU device: bit-equal to the device-panel op and
to the JAX ref, shard by shard for the stack.  ``score_fleet`` on a CPU
manager, through the host entry, is bit-equal to JAX's ``score_fleet``
fed the same feature panel with its scorer run op by op (the JAX ref),
and within the tolerance above of its jitted scorer; two successive
``FleetScores`` share no memory.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fleet_merge import fleet_merge as jax_fleet_merge
from repro.kernels.fleet_merge import fleet_merge_ref as jax_fleet_merge_ref
from repro.kernels.fleet_moments import fleet_moments as jax_fleet_moments
from repro.kernels.fleet_moments import fleet_moments_ref as jax_fleet_moments_ref
from repro.kernels.fleet_score import fleet_score_ref as jax_fleet_score_ref
from repro.kernels.fleet_score import fleet_scores as jax_fleet_scores
from repro.kernels.fused_clean.ops import fused_clean_groupby_fleet as jax_fused_fleet
from repro_torch.kernels.fleet_merge import (
    fleet_merge,
    fleet_merge_rank_ref,
    fleet_merge_ref,
    merge_slots,
    sort_by_key,
)
from repro_torch.kernels.fleet_moments import fleet_moments
from repro_torch.kernels.fleet_score import (
    CORR_WINS,
    N_FEATURES,
    N_SCORES,
    REC_M,
    fleet_score_ref,
    fleet_scores,
    fleet_scores_host,
    fleet_scores_sharded_host,
)
from repro_torch.kernels.fused_clean import fused_clean_groupby, fused_clean_groupby_fleet

SENTINEL = np.iinfo(np.int32).max
T = torch.from_numpy


def _np(x):
    return np.asarray(x)


# ---------------------------------------------------------------------------
# fleet_merge: bit-equal
# ---------------------------------------------------------------------------

def _merge_panels(seed, V, R, G, A, stale_p=0.7, ins_p=0.4, del_p=0.2):
    rng = np.random.default_rng(seed)
    svalid = rng.uniform(size=(V, R)) < stale_p
    skeys = np.array([rng.permutation(max(G + 8, R))[:R] for _ in range(V)],
                     np.int32).reshape(V, R)
    skeys[:, :3] = [SENTINEL, -1, G + 3]  # never index: sentinel, negative, past G
    skeys = np.where(svalid, skeys, SENTINEL).astype(np.int32)
    return dict(
        stale_keys=skeys, stale_valid=svalid,
        stale_vals=np.where(svalid[..., None], rng.normal(0, 50, (V, R, A)), 0).astype(np.float32),
        ins_valid=rng.uniform(size=(V, G)) < ins_p,
        ins_vals=rng.normal(0, 50, (V, G, A)).astype(np.float32),
        del_valid=rng.uniform(size=(V, G)) < del_p,
        del_vals=rng.normal(0, 50, (V, G, A)).astype(np.float32),
    )


def _assert_bits(got, want):
    for g, w in zip(got, want):
        g, w = g.numpy(), _np(w)
        assert g.shape == w.shape
        if g.dtype == np.float32:
            assert np.array_equal(g.view(np.int32), w.astype(np.float32).view(np.int32))
        else:
            assert np.array_equal(g, w.astype(g.dtype))


MERGE_SHAPES = [(3, 300, 40, 2), (1, 17, 5, 1), (4, 64, 256, 3), (2, 130, 129, 2)]


@pytest.mark.parametrize("V,R,G,A", MERGE_SHAPES)
def test_fleet_merge_plain_is_bit_equal_to_jax_ref_and_pallas(V, R, G, A):
    p = _merge_panels(V * 1000 + R, V, R, G, A)
    tp = {k: T(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    _assert_bits(fleet_merge_ref(**tp), jax_fleet_merge_ref(**jp))
    got = fleet_merge(**tp)
    _assert_bits(got, jax_fleet_merge(**jp, use_pallas=True))
    _assert_bits(got, jax_fleet_merge(**jp, use_pallas=False))
    _assert_bits(sort_by_key(*fleet_merge_ref(**tp)), got)


def _dup_panels(seed, V, R, G, A):
    """Stale keys drawn with replacement (duplicates), below 0, at or past
    G and SENTINEL on valid rows."""
    p = _merge_panels(seed, V, R, G, A)
    rng = np.random.default_rng(seed + 1)
    keys = rng.integers(-4, G + 8, (V, R)).astype(np.int32)
    keys[:, :4] = [SENTINEL, -1, G, G + 7]
    keys[:, 4:8] = keys[:, 8:12]  # duplicates of other rows' keys
    valid = rng.uniform(size=(V, R)) < 0.8
    valid[:, :12] = True
    p["stale_valid"] = valid
    p["stale_keys"] = np.where(valid, keys, SENTINEL).astype(np.int32)
    return p


RANK_CASES = [("unique",) + s for s in MERGE_SHAPES] + [
    ("duplicates", 3, 300, 40, 2), ("duplicates", 2, 64, 200, 1), ("duplicates", 1, 40, 9, 3)]


@pytest.mark.parametrize("case,V,R,G,A", RANK_CASES)
def test_fleet_merge_rank_plain_is_bit_equal_to_jax(case, V, R, G, A):
    make = _merge_panels if case == "unique" else _dup_panels
    p = make(V * 1000 + R + 17, V, R, G, A)
    tp = {k: T(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    got = fleet_merge_rank_ref(**tp)
    _assert_bits(got, jax_fleet_merge(**jp, use_pallas=True))
    _assert_bits(got, jax_fleet_merge(**jp, use_pallas=False))
    _assert_bits(got, sort_by_key(*fleet_merge_ref(**tp)))
    _assert_bits(fleet_merge(**tp), got)  # the CPU wrapper's plain version
    if case == "duplicates":
        assert (np.diff(np.sort(p["stale_keys"][0][p["stale_valid"][0]])) == 0).any()


@pytest.mark.parametrize("case,V,R,G,A", RANK_CASES[-3:] + [("empty", 2, 0, 12, 1)])
def test_fleet_merge_slots_take_every_output_row_once(case, V, R, G, A):
    if R:
        p = _dup_panels(5, V, R, G, A)
        sk, sv, iv, dv = (T(p[k]) for k in ("stale_keys", "stale_valid", "ins_valid",
                                             "del_valid"))
    else:  # an empty stale panel: every live group is delta-only
        sk, sv = torch.zeros((V, 0), dtype=torch.int32), torch.zeros((V, 0), dtype=torch.bool)
        iv = T(np.random.default_rng(5).uniform(size=(V, G)) < 0.5)
        dv = torch.zeros((V, G), dtype=torch.bool)
    perm, skeys, stale_slot, group_slot, only = merge_slots(sk, sv, iv, dv)
    slots = torch.sort(torch.cat([stale_slot, group_slot], dim=1), dim=1).values
    assert torch.equal(slots, torch.arange(R + G).expand(V, R + G))
    assert torch.equal(skeys, torch.sort(skeys, dim=1).values)
    # delta-only rows sit in [0, R + D), the padding after them
    D = only.sum(dim=1, keepdim=True)
    assert bool((group_slot[~only] >= (R + D).expand(V, G)[~only]).all())


def test_fleet_merge_without_a_delete_side_matches_jax():
    p = _merge_panels(5, 2, 100, 30, 2)
    for k in ("del_valid", "del_vals"):
        p.pop(k)
    _assert_bits(fleet_merge(**{k: T(v) for k, v in p.items()}),
                 jax_fleet_merge(**{k: jnp.asarray(v) for k, v in p.items()}, use_pallas=True))


@pytest.mark.parametrize("case", ["V0", "G0", "A0", "all_invalid", "all_sentinel"])
def test_fleet_merge_degenerate_panels_match_jax(case):
    V, R, G, A = {"V0": (0, 20, 8, 2), "G0": (2, 20, 0, 2), "A0": (2, 20, 8, 0)}.get(
        case, (3, 50, 16, 2))
    p = _merge_panels(7, V, R, G, A)
    if case == "all_invalid":
        p["stale_valid"][:] = False
        p["stale_keys"][:] = SENTINEL
        p["stale_vals"][:] = 0.0
        p["ins_valid"][:] = False
        p["del_valid"][:] = False
    if case == "all_sentinel":  # valid rows whose keys never index
        p["stale_valid"][:] = True
        p["stale_keys"][:] = SENTINEL
    got = fleet_merge(**{k: T(v) for k, v in p.items()})
    _assert_bits(got, jax_fleet_merge(**{k: jnp.asarray(v) for k, v in p.items()},
                                      use_pallas=True))
    if case in ("V0", "G0", "A0", "all_invalid"):
        assert not bool(got[2].any())


def test_fleet_merge_delete_cancellation_rows():
    """A group only on the delete side, with no stale partner, emits 0 − del."""
    keys = T(np.array([[0, 2, SENTINEL]], np.int32))
    valid = T(np.array([[True, True, False]]))
    vals = T(np.array([[[1.0], [2.0], [0.0]]], np.float32))
    iv = T(np.array([[True, False, False, False]]))
    ix = T(np.array([[[10.0], [0.0], [0.0], [0.0]]], np.float32))
    dv = T(np.array([[False, False, True, True]]))
    dx = T(np.array([[[0.0], [0.0], [0.5], [4.0]]], np.float32))
    k, x, v = fleet_merge(keys, valid, vals, iv, ix, dv, dx)
    assert k[0, :3].tolist() == [0, 2, 3] and v[0].tolist() == [True] * 3 + [False] * 4
    assert x[0, :3, 0].tolist() == [11.0, 1.5, -4.0]


# ---------------------------------------------------------------------------
# fleet_score: bit-equal
# ---------------------------------------------------------------------------

def _features(seed, V):
    rng = np.random.default_rng(seed)
    f = np.zeros((V, N_FEATURES), np.float32)
    f[:, 0] = rng.uniform(0, 5000, V)                 # n
    f[:, 1] = rng.uniform(0, 400, V)                  # ex2
    f[:, 2] = rng.uniform(-20, 20, V)                 # mean
    f[:, 3] = rng.uniform(0, 1e5, V) * (rng.uniform(size=V) < 0.8)  # ht_aqp, some 0
    f[:, 4] = rng.uniform(0, 1e5, V)                  # ht_corr
    f[:, 5] = rng.integers(0, 500, V)                 # drift clean
    f[:, 6] = rng.integers(0, 900, V)                 # drift ivm
    f[:, 7] = rng.uniform(0, 50, V)                   # traffic
    f[:, 8] = rng.uniform(0, 2, V) * (rng.uniform(size=V) < 0.9)   # costs, some 0
    f[:, 9] = rng.uniform(0, 5, V)
    f[:, 10] = rng.uniform(0, 100, V)
    f[:, 11] = rng.choice([0.0, 1.0 / 512, 1.0 / 256, 0.0625, 0.25, 0.5, 1.0, 1.5], V)
    f[:, 12] = rng.uniform(0, 3, V)
    return f


@pytest.mark.parametrize("V", [1, 16, 600])
def test_fleet_score_plain_is_bit_equal_to_jax_ref_and_close_to_pallas(V):
    f = _features(V, V)
    got = fleet_scores(T(f)).numpy()
    want = _np(jax_fleet_score_ref(jnp.asarray(f)))
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    assert np.array_equal(fleet_score_ref(T(f)).numpy(), got)
    for up in (True, False):
        jitted = _np(jax_fleet_scores(f, use_pallas=up))
        np.testing.assert_allclose(got, jitted, rtol=2e-6, atol=1e-6)
        assert np.array_equal(got[:, CORR_WINS], jitted[:, CORR_WINS])
        assert np.array_equal(got[:, REC_M], jitted[:, REC_M])


def test_fleet_score_degenerate_panels_match_jax():
    for f in (np.zeros((0, N_FEATURES), np.float32), np.zeros((5, N_FEATURES), np.float32)):
        got = fleet_scores(T(f)).numpy()
        want = _np(jax_fleet_scores(f, use_pallas=True)) if len(f) else np.zeros((0, 6))
        assert got.shape == (len(f), 6)
        assert np.array_equal(got, want)
    with pytest.raises(ValueError):
        fleet_scores(T(np.zeros((3, 12), np.float32)))


@pytest.mark.parametrize("V", [0, 1, 16, 129])
def test_fleet_scores_host_on_the_cpu_is_the_plain_score(V):
    f = _features(100 + V, V)
    got = fleet_scores_host(f, "cpu")
    assert isinstance(got, np.ndarray) and got.dtype == np.float32 and got.shape == (V, N_SCORES)
    assert np.array_equal(got.view(np.int32), fleet_scores(T(f)).numpy().view(np.int32))
    if V:
        want = _np(jax_fleet_score_ref(jnp.asarray(f)))
        assert np.array_equal(got.view(np.int32), want.view(np.int32))
    assert not np.shares_memory(got, f)


@pytest.mark.parametrize("S,vmax", [(4, 4), (3, 7), (1, 16)])
@pytest.mark.parametrize("per_shard", [False, True])
def test_fleet_scores_sharded_host_on_the_cpu_is_bit_equal_shard_by_shard(S, vmax, per_shard):
    stacked = _features(S * vmax, S * vmax).reshape(S, vmax, N_FEATURES)
    stacked[-1, vmax // 2:] = 0.0  # a short last shard: zero padding scores zero
    devices = [torch.device("cpu")] * S if per_shard else "cpu"
    got = fleet_scores_sharded_host(stacked, devices, shard_views=[vmax] * (S - 1) + [vmax // 2])
    assert got.shape == (S, vmax, N_SCORES) and got.dtype == np.float32
    for s in range(S):
        want = _np(jax_fleet_score_ref(jnp.asarray(stacked[s])))
        assert np.array_equal(got[s].view(np.int32), want.view(np.int32))


def test_fleet_scores_host_checks_its_panel():
    with pytest.raises(ValueError):
        fleet_scores_host(np.zeros((3, 12), np.float32), "cpu")
    with pytest.raises(TypeError):
        fleet_scores_host(np.zeros((3, N_FEATURES), np.float64), "cpu")
    with pytest.raises(TypeError):
        fleet_scores_host(torch.zeros((3, N_FEATURES)), "cpu")
    with pytest.raises(ValueError):
        fleet_scores_sharded_host(np.zeros((3, N_FEATURES), np.float32), "cpu")
    with pytest.raises(ValueError):
        fleet_scores_sharded_host(np.zeros((2, 3, N_FEATURES), np.float32), ["cpu"] * 3)


def _tiny_fleet(package):
    """Three group-by views over 256-row logs in either package, a delta
    ingested into each, some query traffic, the planner's costs pinned:
    (its manager, a cost model on it)."""
    if package == "jax":
        from repro.core import Query, ViewDef
        from repro.planner.costs import CostModel
        from repro.relational.plan import GroupByNode, Scan
        from repro.relational.relation import from_columns
        from repro.views import ViewManager
        vm, kw = ViewManager(clock=lambda: 0.0), {}
    else:
        from repro_torch.core import Query, ViewDef
        from repro_torch.planner.costs import CostModel
        from repro_torch.relational.plan import GroupByNode, Scan
        from repro_torch.relational.relation import from_columns
        from repro_torch.views import ViewManager
        vm, kw = ViewManager(device="cpu", clock=lambda: 0.0), {"device": "cpu"}
    rng = np.random.default_rng(5)

    def rows(start, n):
        return {"sessionId": np.arange(start, start + n, dtype=np.int32),
                "videoId": rng.integers(0, 16, n).astype(np.int32),
                "bytes": rng.exponential(10.0, n).astype(np.float32)}

    for i in range(3):
        vm.register_base(f"Log{i}", from_columns(rows(0, 256), pk=["sessionId"], capacity=1024,
                                                 **kw))
        plan = GroupByNode(child=Scan(f"Log{i}", pk=("sessionId",)), keys=("videoId",),
                           aggs=(("totalBytes", "sum", "bytes"), ("visits", "count", None)),
                           num_groups=32)
        vm.register_view(ViewDef(f"v{i}", plan), delta_bases=(f"Log{i}",), m=0.25, seed=i,
                         delta_group_capacity=32)
    for i in range(3):
        vm.query_batch(f"v{i}", [Query(agg="sum", col="totalBytes")] * (i + 1))
        vm.ingest(f"Log{i}", inserts=from_columns(rows(1000 + 100 * i, 40 + 10 * i),
                                                  pk=["sessionId"], **kw))
    cm = CostModel(vm, clock=lambda: 5.0)
    cm.pin_costs(refresh_s=1.0, maintain_s=4.0)
    return vm, cm


def test_score_fleet_through_the_host_entry_matches_jax(monkeypatch):
    import repro.planner.score as jax_score
    from repro_torch.planner import score_fleet

    _vm, cm = _tiny_fleet("port")
    fs = score_fleet(cm)
    assert fs.features.shape == (3, N_FEATURES) and fs.scores.shape == (3, N_SCORES)
    assert bool((fs.scores[:, 1:3] > 0).any())  # a view worth cleaning or maintaining
    _jvm, jcm = _tiny_fleet("jax")
    monkeypatch.setattr(jcm, "features", lambda names=None, use_pallas=None: fs.features.copy())
    jitted = jax_score.score_fleet(jcm)  # JAX's scorer as its planner runs it (jitted)
    np.testing.assert_allclose(fs.scores, jitted.scores, rtol=2e-6, atol=1e-6)
    assert np.array_equal(fs.scores[:, CORR_WINS], jitted.scores[:, CORR_WINS])
    assert np.array_equal(fs.scores[:, REC_M], jitted.scores[:, REC_M])
    monkeypatch.setattr(jax_score, "fleet_scores",
                        lambda feats, use_pallas=None: jax_fleet_score_ref(jnp.asarray(feats)))
    want = jax_score.score_fleet(jcm)  # the same composition, its scorer op by op
    assert fs.names == list(want.names)
    assert np.array_equal(fs.scores.view(np.int32), np.asarray(want.scores).view(np.int32))


def test_successive_fleet_scores_share_no_memory():
    from repro_torch.planner import score_fleet

    _vm, cm = _tiny_fleet("port")
    a, b = score_fleet(cm), score_fleet(cm)
    assert np.array_equal(a.scores, b.scores) and np.array_equal(a.features, b.features)
    assert not np.shares_memory(a.scores, b.scores)
    assert not np.shares_memory(a.features, b.features)


# ---------------------------------------------------------------------------
# fleet_moments: ≤ 1e-6 relative
# ---------------------------------------------------------------------------

def _channels(seed, V, R, ragged=True):
    rng = np.random.default_rng(seed)
    out = []
    lengths = rng.integers(0, R + 1, V) if ragged else np.full(V, R)
    live = np.arange(R)[None, :] < lengths[:, None]
    for _side in range(2):
        v = (rng.uniform(size=(V, R)) < 0.7) & live
        pin = rng.uniform(size=(V, R)) < 0.1
        x = np.where(v, rng.exponential(10.0, (V, R)), 0.0)
        w = np.where(live, np.where(pin, 1.0, 4.0), 0.0)
        o = np.where(live, np.where(pin, 0.0, 0.75), 0.0)
        out += [x, v, w, o]
    return [a.astype(np.float32) for a in out]


def _close_rel(got, want, rtol=1e-6):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = np.maximum(np.abs(want), 1e-30)
    assert np.all(np.abs(got - want) <= rtol * scale + 1e-30), np.max(np.abs(got - want) / scale)


@pytest.mark.parametrize("V,R", [(1, 7), (5, 300), (3, 1024)])
def test_fleet_moments_plain_matches_jax_ref_and_pallas(V, R):
    ch = _channels(V + R, V, R)
    got = fleet_moments(*[T(c) for c in ch]).numpy()
    _close_rel(got, jax_fleet_moments_ref(*[jnp.asarray(c) for c in ch]))
    _close_rel(got, jax_fleet_moments(*ch, use_pallas=True))


def test_fleet_moments_takes_strided_views_of_one_slab():
    ch = _channels(3, 4, 200)
    slab = T(np.stack(ch, axis=1))  # (V, 8, R): channels are strided views
    got = fleet_moments(*slab.unbind(1)).numpy()
    _close_rel(got, jax_fleet_moments(*ch, use_pallas=True))


def test_fleet_moments_degenerate_panels():
    z = np.zeros((0, 16), np.float32)
    assert fleet_moments(*[T(z)] * 8).shape == (0, 5)
    ch = _channels(9, 3, 64)
    ch = [np.zeros_like(c) for c in ch]  # all-padding views
    assert not fleet_moments(*[T(c) for c in ch]).any()
    with pytest.raises(ValueError, match="ragged"):
        fleet_moments(*[T(c) for c in _channels(1, 2, 8)[:7]], T(np.zeros((2, 9), np.float32)))


# ---------------------------------------------------------------------------
# fused_clean fleet entry: counts exact, sums ≤ 1e-6 relative
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("V,R,C,G", [(3, 500, 2, 64), (1, 100, 1, 128), (4, 256, 0, 64),
                                     (2, 64, 1, 64)])
def test_fused_clean_fleet_plain_matches_jax(V, R, C, G):
    rng = np.random.default_rng(V * R + C)
    gid = rng.integers(0, G, (V, R)).astype(np.int32)
    valid = rng.uniform(size=(V, R)) < 0.8
    if R == 64:
        valid[:] = False  # all-invalid
    vals = rng.exponential(10.0, (V, R, C)).astype(np.float32)
    ms = tuple(float(m) for m in rng.choice([0.1, 0.25, 0.5, 1.0], V))
    seeds = tuple(range(3, 3 + V))
    counts, sums = fused_clean_groupby_fleet(T(gid), T(vals), T(valid), ms, seeds, G)
    jc, js = jax_fused_fleet(jnp.asarray(gid), jnp.asarray(vals), jnp.asarray(valid), ms, seeds, G)
    assert np.array_equal(counts.numpy(), _np(jc))
    _close_rel(sums.numpy(), _np(js))
    for v in range(V):  # each view's slice is its own per-view fused clean
        c1, s1 = fused_clean_groupby(T(gid[v]), T(vals[v]), T(valid[v]), ms[v], seeds[v], G)
        assert np.array_equal(c1.numpy(), counts[v].numpy())
        _close_rel(s1.numpy(), sums[v].numpy())


def test_fused_clean_fleet_drops_out_of_range_keys():
    gid = T(np.array([[0, 5, -1, 70, 3]], np.int32))
    counts, _ = fused_clean_groupby_fleet(gid, torch.ones((1, 5, 1)), torch.ones((1, 5), dtype=torch.bool),
                                          (1.0,), (0,), 64)
    assert counts.shape == (1, 64) and float(counts.sum()) == 3.0
