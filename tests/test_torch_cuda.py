"""The port's CUDA kernels against their plain versions, on the card.

Needs an NVIDIA GPU (Hopper, sm_90a); every test here carries the ``cuda``
marker and skips where ``torch.cuda.is_available()`` is false.  Run on a
machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Imports only torch, numpy and repro_torch, so it runs without JAX.
Masks, codes and counts must be exact; float sums within 1e-5 relative
plus, for atomically accumulated group sums, the float32 bound
4·2^-24·sqrt(n) relative of a sum of n terms added in another order.
fleet_merge and fleet_score must equal their plain versions bit for bit;
fleet_moments within 1e-6 relative.  segment_sum's counts are exact and
its sums within γ_{n−1}·Σ|x| of the float64 sums (the bound of a float32
sum of n terms in any order); corr_moments' count is exact, its sums
within 1e-6 of Σ|x| of the float64 sums, and the same bits run to run.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.fleet_merge import fleet_merge, fleet_merge_ref, sort_by_key
from repro_torch.kernels.fleet_moments import fleet_moments, fleet_moments_ref
from repro_torch.kernels.fleet_score import N_FEATURES, fleet_score_ref, fleet_scores
from repro_torch.kernels.fused_clean.ops import fused_clean_groupby, fused_clean_groupby_fleet
from repro_torch.kernels.fused_clean.ref import fused_clean_fleet_ref, fused_clean_ref
from repro_torch.kernels.hash_threshold.ops import hash_threshold
from repro_torch.kernels.hash_threshold.ref import hash_threshold_ref
from repro_torch.kernels.multi_agg.ops import multi_agg_one, multi_agg_two
from repro_torch.kernels.multi_agg.ref import K_D, K_NEW, K_OLD, S_D, S_NEW, S_OLD, multi_agg_ref
from repro_torch.kernels.outlier_member.ops import outlier_codes
from repro_torch.kernels.outlier_member.ref import outlier_codes_ref
from repro_torch.relational.relation import SENTINEL_KEY

pytestmark = pytest.mark.cuda

I32 = np.iinfo(np.int32)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _keys(rng, n, ncols, dev, high=None):
    cols = []
    for _ in range(ncols):
        if high is None:
            k = rng.integers(I32.min, I32.max, n, dtype=np.int64, endpoint=True).astype(np.int32)
            k[:5] = [0, 1, -1, I32.min, I32.max]
        else:
            k = rng.integers(0, high, n).astype(np.int32)
        cols.append(torch.from_numpy(k).to(dev))
    return tuple(cols)


@pytest.mark.parametrize("ncols", [1, 2, 3, 4])
@pytest.mark.parametrize("m", [0.1, 0.5, 1.0])
def test_hash_threshold_kernel_matches_plain(dev, ncols, m):
    cols = _keys(np.random.default_rng(ncols), 100_003, ncols, dev)
    before = hash_threshold.launches
    got = hash_threshold(cols, m, 7)
    torch.cuda.synchronize()
    assert hash_threshold.launches == before + 1
    assert torch.equal(got, hash_threshold_ref(cols, m, 7))


@pytest.mark.parametrize("pin", [False, True])
@pytest.mark.parametrize("C", [0, 1, 3])
def test_fused_clean_kernel_matches_plain(dev, pin, C):
    rng = np.random.default_rng(C + 10 * pin)
    R, G = 200_000, 4096
    gid = rng.integers(-1, G + 16, R).astype(np.int32)
    candidates = torch.arange(G, dtype=torch.int32)
    hot = int(candidates[hash_threshold_ref((candidates,), 0.3, 2)][0])
    gid[: R // 5] = hot  # a sampled hot group: atomics on one address
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    gid, valid = t(gid), t(rng.uniform(size=R) < 0.9)
    vals = t(rng.uniform(0.5, 100.0, (R, C)).astype(np.float32))
    pin_mask = t(rng.uniform(size=R) < 0.05) if pin else None
    counts, sums = fused_clean_groupby(gid, vals, valid, 0.3, 2, G, pin_mask=pin_mask)
    pc, ps = fused_clean_ref(gid, vals, valid, 0.3, 2, G, pin_mask)
    assert torch.equal(counts, pc)
    rtol = (1e-5 + 4 * 2.0 ** -24 * pc.clamp(min=1).sqrt())[:, None]
    assert bool(((sums - ps).abs() <= rtol * ps.abs()).all())
    assert pc[hot] > R // 10


@pytest.mark.parametrize("K", [1, 1000, 2048, 2049, 50_000])
@pytest.mark.parametrize("ncols", [1, 3])
def test_outlier_member_kernel_matches_plain(dev, K, ncols):
    rng = np.random.default_rng(K + ncols)
    keys = _keys(rng, K, ncols, dev, high=5000)
    probe = list(_keys(rng, 300_000, ncols, dev, high=5000))
    hits = torch.from_numpy(rng.integers(0, K, 1000)).to(dev)
    for c in range(ncols):
        probe[c][10:1010] = keys[c][hits]  # planted members
    probe[0][:10] = int(SENTINEL_KEY)  # never members
    for m in (0.0, 0.2):
        got = outlier_codes(probe, keys, m, 4)
        want = outlier_codes_ref(probe, keys, m, 4)
        assert torch.equal(got, want)
        assert not bool((got[:10] & 2).any())
        assert bool((got & 2).any())


def _panel(rng, R, C, dev):
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    pin = rng.uniform(size=R) < 0.1
    return (t(rng.uniform(0.0, 20.0, (R, C)).astype(np.float32)),
            t(rng.uniform(size=R) < 0.7),
            t(np.where(pin, 1.0, 10.0).astype(np.float32)),
            t(np.where(pin, 0.0, 0.9).astype(np.float32)))


def _batch(rng, C, Q, P, dev):
    sel = np.zeros(((1 + P) * C, Q), np.float32)
    meta = np.zeros((2 + 4 * P, Q), np.float32)
    meta[2::4], meta[3::4], meta[4::4], meta[5::4] = -np.inf, -np.inf, np.inf, np.inf
    for q in range(Q):
        if q % 3 == 1:
            meta[0, q] = 1.0
        else:
            sel[rng.integers(0, C), q] = 1.0
            meta[1, q] = float(q % 3 == 2)
        for p in range(q % (P + 1)):
            sel[(1 + p) * C + rng.integers(0, C), q] = 1.0
            lo = rng.uniform(0.0, 10.0)
            meta[2 + 4 * p, q], meta[4 + 4 * p, q] = lo, lo + rng.uniform(2.0, 10.0)
    return torch.from_numpy(sel).to(dev), torch.from_numpy(meta).to(dev)


def _close(got, want):
    for k in (K_NEW, K_OLD, K_D):
        assert torch.equal(got[k], want[k]), k
    scale = want.abs()
    scale[S_D] = want[S_NEW].abs() + want[S_OLD].abs()
    assert bool(((got - want).abs() <= 1e-5 * scale + 1e-6).all())


@pytest.mark.parametrize("R", [1, 1000, 1_000_003])
def test_multi_agg_kernels_match_plain(dev, R):
    rng = np.random.default_rng(R)
    C, Q, P = 3, 16, 2
    new, old = _panel(rng, R, C, dev), _panel(rng, R, C, dev)
    sel, meta = _batch(rng, C, Q, P, dev)
    _close(multi_agg_two(*new, sel, meta, *old), multi_agg_ref(*new, sel, meta, *old))
    one = multi_agg_one(*new, sel, meta)
    _close(one, multi_agg_ref(*new, sel, meta))
    assert bool((one[4:] == 0).all())
    assert torch.equal(multi_agg_two(*new, sel, meta, *old), multi_agg_two(*new, sel, meta, *old))


def test_wrappers_raise_instead_of_falling_back(dev):
    cols = (torch.arange(10, dtype=torch.int32, device=dev),)
    with pytest.raises(TypeError):
        hash_threshold((cols[0].float(),), 0.5)
    with pytest.raises(ValueError):
        hash_threshold((cols[0], torch.arange(10, dtype=torch.int32)), 0.5)  # mixed devices
    with pytest.raises(ValueError):
        outlier_codes((cols[0][::2],), cols, 0.5, 0)  # not contiguous


def _bits(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and bool(
        (a.view(torch.int32) == b.view(torch.int32)).all() if a.dtype == torch.float32
        else (a == b).all())


@pytest.mark.parametrize("V,R,G,A", [(16, 4096, 1024, 2), (3, 1000, 5000, 1), (1, 7, 3, 3)])
def test_fleet_merge_kernel_is_bit_equal_to_plain(dev, V, R, G, A):
    rng = np.random.default_rng(V + R + G)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    svalid = rng.uniform(size=(V, R)) < 0.7
    skeys = rng.integers(0, G + 16, (V, R)).astype(np.int32)
    skeys[:, 0] = np.iinfo(np.int32).max
    skeys[:, 1] = -5
    skeys = np.where(svalid, skeys, np.iinfo(np.int32).max).astype(np.int32)
    args = (t(skeys), t(svalid), t(rng.normal(0, 1e3, (V, R, A)).astype(np.float32)),
            t(rng.uniform(size=(V, G)) < 0.4), t(rng.normal(0, 1e3, (V, G, A)).astype(np.float32)),
            t(rng.uniform(size=(V, G)) < 0.2), t(rng.normal(0, 1e3, (V, G, A)).astype(np.float32)))
    before = fleet_merge.launches
    got = fleet_merge(*args)
    torch.cuda.synchronize()
    assert fleet_merge.launches == before + 1
    want = sort_by_key(*fleet_merge_ref(*args))
    for g, w in zip(got, want):
        assert _bits(g, w)


@pytest.mark.parametrize("V", [1, 16, 1000])
def test_fleet_score_kernel_is_bit_equal_to_plain(dev, V):
    rng = np.random.default_rng(V)
    f = np.abs(rng.normal(0, 1, (V, N_FEATURES))).astype(np.float32) * np.array(
        [5e3, 400, 20, 1e5, 1e5, 500, 900, 50, 2, 5, 100, 0.5, 3], np.float32)
    f[::3, 3] = 0.0  # zero AQP variance: hold the ratio
    f[::5] = 0.0     # all-zero rows score zero
    f[1::4, 11] = rng.choice([1.0 / 512, 1.0, 1.5], len(f[1::4]))
    feats = torch.from_numpy(f).to(dev)
    got = fleet_scores(feats)
    assert _bits(got, fleet_score_ref(feats))


@pytest.mark.parametrize("V,R", [(16, 1 << 16), (3, 100_003), (1, 5)])
def test_fleet_moments_kernel_matches_plain_and_is_deterministic(dev, V, R):
    rng = np.random.default_rng(R)
    slab = np.zeros((V, 8, R), np.float32)
    for side in (0, 4):
        v = rng.uniform(size=(V, R)) < 0.7
        pin = rng.uniform(size=(V, R)) < 0.1
        slab[:, side] = np.where(v, rng.exponential(10.0, (V, R)), 0.0)
        slab[:, side + 1] = v
        slab[:, side + 2] = np.where(pin, 1.0, 10.0)
        slab[:, side + 3] = np.where(pin, 0.0, 0.9)
    panels = torch.from_numpy(slab).to(dev).unbind(1)  # strided views of one slab
    got = fleet_moments(*panels)
    want = fleet_moments_ref(*panels)
    assert bool(((got - want).abs() <= 1e-6 * want.abs() + 1e-30).all())
    assert torch.equal(got, fleet_moments(*panels))


def test_fused_clean_fleet_kernel_matches_plain(dev):
    rng = np.random.default_rng(3)
    V, R, C, G = 4, 200_000, 1, 4096
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    gid = t(rng.integers(-1, G + 8, (V, R)).astype(np.int32))
    valid = t(rng.uniform(size=(V, R)) < 0.9)
    vals = t(rng.uniform(0.5, 100.0, (V, R, C)).astype(np.float32))
    ms, seeds = (0.1, 0.25, 0.5, 1.0), (0, 1, 2, 3)
    counts, sums = fused_clean_groupby_fleet(gid, vals, valid, ms, seeds, G)
    pc, ps = fused_clean_fleet_ref(gid, vals, valid, ms, seeds, G)
    assert torch.equal(counts, pc)
    rtol = (1e-5 + 4 * 2.0 ** -24 * pc.clamp(min=1).sqrt())[..., None]
    assert bool(((sums - ps).abs() <= rtol * ps.abs()).all())
    for v in range(V):  # each view's slice is its own per-view clean
        c1, _ = fused_clean_groupby(gid[v].contiguous(), vals[v].contiguous(),
                                    valid[v].contiguous(), ms[v], seeds[v], G)
        assert torch.equal(c1, counts[v])


def _small_fleet(device):
    """Four group-by views over their own 20k-session logs (two with
    deletes), each with a 5k-session insert delta pending."""
    from repro_torch.core import ViewDef
    from repro_torch.relational.plan import GroupByNode, Scan
    from repro_torch.relational.relation import from_columns
    from repro_torch.views import ViewManager

    rng = np.random.default_rng(11)
    vm = ViewManager(device=device)
    for i in range(4):
        n = 20_000
        vm.register_base(f"Log{i}", from_columns(
            {"sessionId": np.arange(n, dtype=np.int32),
             "videoId": rng.integers(0, 3000, n).astype(np.int32),
             "bytes": rng.exponential(10.0, n).astype(np.float32)},
            pk=["sessionId"], capacity=2 * n, device=device))
        plan = GroupByNode(child=Scan(f"Log{i}", pk=("sessionId",)), keys=("videoId",),
                           aggs=(("totalBytes", "sum", "bytes"), ("visits", "count", None)),
                           num_groups=6000)
        vm.register_view(ViewDef(f"v{i}", plan), delta_bases=(f"Log{i}",), m=0.25, seed=i,
                         delta_group_capacity=6000, with_deletes=i >= 2)
    for i in range(4):
        vm.ingest(f"Log{i}", inserts=from_columns(
            {"sessionId": np.arange(10**6, 10**6 + 5000, dtype=np.int32),
             "videoId": rng.integers(0, 3000, 5000).astype(np.int32),
             "bytes": rng.exponential(10.0, 5000).astype(np.float32)},
            pk=["sessionId"], device=device))
    return vm


def test_svc_refresh_many_on_the_card_matches_the_cpu(dev):
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.relational.relation import to_host

    gpu, cpu = _small_fleet("cuda"), _small_fleet("cpu")
    reset_launches()
    gpu.svc_refresh_many(list(gpu.views))
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["fleet_merge"] == 1 and counts["fused_clean_fleet"] >= 1
    cpu.svc_refresh_many(list(cpu.views))
    for name in cpu.views:
        a, b = to_host(gpu.views[name].clean_sample), to_host(cpu.views[name].clean_sample)
        assert np.array_equal(a["videoId"], b["videoId"])
        assert np.array_equal(a["visits"], b["visits"])
        np.testing.assert_allclose(a["totalBytes"], b["totalBytes"], rtol=1e-5)


def test_a_failed_batched_launch_raises_on_the_card(dev, monkeypatch):
    """On the card a failing fleet kernel is an error even with
    isolate=True: the epoch never falls back to the plain per-view path."""
    from repro_torch.kernels import _build

    real = _build.launch

    def failing(name, *args):
        if name == "svc_fleet_merge":
            raise RuntimeError("svc_fleet_merge: CUDA error 1 (injected)")
        return real(name, *args)

    vm = _small_fleet("cuda")
    before = {n: mv.clean_sample for n, mv in vm.views.items()}
    monkeypatch.setattr(_build, "launch", failing)
    with pytest.raises(RuntimeError, match="svc_fleet_merge"):
        vm.svc_refresh_many(list(vm.views), isolate=True)
    assert vm.fleet_merge_failures == 0
    assert all(vm.views[n].clean_sample is s for n, s in before.items())


def _gamma_bound(n):
    """γ_{n−1}: a float32 sum of n terms in any order lies within γ·Σ|x|."""
    k = (n.double() - 1.0).clamp(min=0.0) * 2.0 ** -24
    return k / (1.0 - k)


@pytest.mark.parametrize("R,C,G", [(1, 1, 1), (100_003, 1, 4096), (1_000_000, 2, 1_500_000),
                                   (300_000, 3, 70)])
@pytest.mark.parametrize("sort", [False, True])
def test_segment_sum_kernel_matches_plain(dev, R, C, G, sort):
    """Random and sorted gids (the group-by's order: long runs of one group,
    crossing warps), a hot group, out-of-range ids among them."""
    from repro_torch.kernels.segment_aggsum import segment_sum, segment_sum_ref

    rng = np.random.default_rng(R + C)
    gid = rng.integers(-2, G + 3, R).astype(np.int32)  # -2, -1 and ≥ G all drop
    gid[: R // 4] = G // 2  # a hot group: atomics on one address
    gid[:3] = [-1, G, G + 2][: min(3, R)]
    if sort:
        gid = np.sort(gid)
    vals = rng.uniform(-50.0, 100.0, (R, C)).astype(np.float32)
    vals[:, 0] = 1.0  # a count column
    gid_t, vals_t = torch.from_numpy(gid).to(dev), torch.from_numpy(vals).to(dev)
    before = segment_sum.launches
    got = segment_sum(gid_t, vals_t, G)
    torch.cuda.synchronize()
    assert segment_sum.launches == before + 1
    want = segment_sum_ref(gid_t, vals_t, G)
    assert got.shape == (G, C)
    assert torch.equal(got[:, 0], want[:, 0])  # counts exact
    keep = (gid_t >= 0) & (gid_t < G)
    g = torch.where(keep, gid_t.long(), torch.full_like(gid_t, G, dtype=torch.int64))
    exact = torch.zeros((G + 1, C), dtype=torch.float64, device=dev).index_add_(
        0, g, vals_t.double())[:G]
    abs_sum = torch.zeros((G + 1, C), dtype=torch.float64, device=dev).index_add_(
        0, g, vals_t.double().abs())[:G]
    bound = _gamma_bound(want[:, :1].double()) * abs_sum
    assert bool(((got.double() - exact).abs() <= bound).all())
    one = segment_sum(gid_t, vals_t[:, 0].contiguous(), G)
    assert one.shape == (G,) and torch.equal(one, want[:, 0])


@pytest.mark.parametrize("n", [1, 4095, 4097, 16384, 2_000_003])
@pytest.mark.parametrize("mask_dtype", [torch.bool, torch.int8])
def test_corr_moments_kernel_matches_plain_and_is_deterministic(dev, n, mask_dtype):
    from repro_torch.kernels.corr_diff import corr_diff_ref, corr_moments

    rng = np.random.default_rng(n)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    t_new = t(rng.normal(5.0, 20.0, n).astype(np.float32))
    t_old = t(rng.normal(4.0, 20.0, n).astype(np.float32))
    mask = t(rng.uniform(size=n) < 0.7).to(mask_dtype)
    before = corr_moments.launches
    got = torch.stack(corr_moments(t_new, t_old, mask))
    torch.cuda.synchronize()
    assert corr_moments.launches == before + 1
    want = torch.stack(corr_diff_ref(t_new, t_old, mask))
    assert torch.equal(got[2], want[2])  # the count
    d = (t_new - t_old) * mask.to(torch.float32)  # per-row rounding as the kernel's
    exact = torch.stack([d.double().sum(), (d * d).double().sum()])
    scale = torch.stack([d.double().abs().sum(), (d * d).double().sum()])
    assert bool(((got[:2].double() - exact).abs() <= 1e-6 * scale + 1e-30).all())
    bound = _gamma_bound(torch.tensor(float(n), device=dev)) * scale
    assert bool(((want[:2].double() - exact).abs() <= bound + 1e-30).all())
    assert torch.equal(got, torch.stack(corr_moments(t_new, t_old, mask)))  # same bits


def test_new_wrappers_raise_instead_of_falling_back(dev):
    from repro_torch.kernels.corr_diff import corr_moments
    from repro_torch.kernels.segment_aggsum import segment_sum

    gid = torch.zeros(8, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        segment_sum(gid, torch.ones(8, 2, dtype=torch.float64, device=dev), 4)
    with pytest.raises(ValueError):
        segment_sum(gid, torch.ones(2, 8, device=dev).t(), 4)  # not contiguous
    with pytest.raises(ValueError):
        corr_moments(torch.ones(8, device=dev), torch.ones(8), torch.ones(8, dtype=torch.bool,
                                                                      device=dev))
    with pytest.raises(TypeError):
        corr_moments(torch.ones(8, device=dev), torch.ones(8, device=dev),
                     torch.ones(8, device=dev))
