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
sum of n terms in any order); over sorted ids (segment_groupby, the
group-by's) counts are exact in int32 and each sum is its float64 sum
rounded once, within 2^-24·|S| + 1e-8·Σ|x| and 1e-6·Σ|x|, the same bits
on every call; corr_moments' count is exact, its sums
within 1e-6 of Σ|x| of the float64 sums, and the same bits run to run.
flash_attention within 1e-4 in float32 (the same f32 sums in another
order) and 1e-2 in bfloat16 (an output may round to the neighbouring bf16
value); the f32 smoke model on the card within 1e-4 of the CPU.  Under a
kernel profiler every wrapper dispatches once per call and never takes
its plain version; an injected kernel_error degrades the batched clean on
the card to per-view cleans whose samples equal a fault-free manager's
(keys and counts exact, sums within 1e-5 relative), while a real failure
still raises.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.fleet_merge import (
    SORT_MAX,
    fleet_merge,
    fleet_merge_rank_ref,
    fleet_merge_ref,
    sort_by_key,
)
from repro_torch.kernels.fleet_moments import fleet_moments, fleet_moments_ref
from repro_torch.kernels.fleet_score import N_FEATURES, fleet_score_ref, fleet_scores
from repro_torch.kernels.fused_clean.ops import fused_clean_groupby, fused_clean_groupby_fleet
from repro_torch.kernels.fused_clean.ref import fused_clean_fleet_ref, fused_clean_ref
from repro_torch.kernels.hash_threshold.ops import hash_threshold
from repro_torch.kernels.hash_threshold.ref import hash_threshold_ref
from repro_torch.kernels.multi_agg.ops import (
    TILE,
    multi_agg_one,
    multi_agg_two,
    selector_indices,
)
from repro_torch.kernels.multi_agg.ref import K_D, K_NEW, K_OLD, S_D, S_NEW, S_OLD, multi_agg_ref
from repro_torch.kernels.outlier_member.ops import (
    MAX_SMEM_KEYS,
    digest_table,
    outlier_codes,
    pinned_hash,
)
from repro_torch.kernels.outlier_member.ref import (
    outlier_codes_ref,
    pinned_hash_ref,
    sorted_digest_table,
)
from repro_torch.relational.relation import SENTINEL_KEY

pytestmark = pytest.mark.cuda

I32 = np.iinfo(np.int32)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _device_launches(fn, calls: int = 3, tries: int = 3) -> float:
    """Kernels, copies and memsets the card ran per call of ``fn``: the
    profiler's device rows over ``calls`` calls after one warm-up step, the
    largest of ``tries`` profiles (the profiler at times drops a call's
    kernels, never adds one)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    best = 0.0
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=calls, repeat=1)) as prof:
            for _ in range(calls + 1):
                fn()
                torch.cuda.synchronize()
                prof.step()
        best = max(best, sum(e.count for e in prof.key_averages()
                             if e.device_type == torch.autograd.DeviceType.CUDA
                             and not e.key.startswith("ProfilerStep")) / calls)
    return best


def _keys(rng, n, ncols, dev, high=None):
    cols = []
    for _ in range(ncols):
        if high is None:
            k = rng.integers(I32.min, I32.max, n, dtype=np.int64, endpoint=True).astype(np.int32)
            k[:5] = [0, 1, -1, I32.min, I32.max][:n]
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


EDGE_SIZES = [1, 3, 4, 15, 16, 17, 100_003]


def _at(t, offset):
    """A copy of ``t`` viewed ``offset`` elements into a fresh buffer (its
    data_ptr shifted by offset·itemsize from the allocator's alignment)."""
    buf = torch.empty(t.shape[0] + offset, dtype=t.dtype, device=t.device)
    view = buf[offset:]
    view.copy_(t)
    return view


def _route_counts(wrapper, fn):
    """(result, {route: launches}) of one call of ``fn``."""
    before = dict(wrapper.routes)
    out = fn()
    torch.cuda.synchronize()
    return out, {k: wrapper.routes[k] - before[k] for k in before}


@pytest.mark.parametrize("ncols", [1, 2, 3, 4])
@pytest.mark.parametrize("n", EDGE_SIZES)
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_hash_threshold_routes_match_plain(dev, ncols, n, offset):
    """Aligned columns take the vector route, columns viewed 4, 8 or 12
    bytes into their storage the scalar one; both are bit-equal to the
    plain version, bare and narrowing a validity, across the ragged tail."""
    rng = np.random.default_rng(100 * ncols + n + offset)
    cols = tuple(_at(c, offset) for c in _keys(rng, n, ncols, dev))
    valid = _at(torch.from_numpy(rng.random(n) < 0.6).to(dev), offset)
    route = "vector" if offset == 0 else "scalar"
    want = hash_threshold_ref(cols, 0.3, 5)
    got, counts = _route_counts(hash_threshold, lambda: hash_threshold(cols, 0.3, 5))
    assert counts == {"vector": 0, "scalar": 0, route: 1}
    assert torch.equal(got, want)
    got, counts = _route_counts(hash_threshold, lambda: hash_threshold(cols, 0.3, 5, valid))
    assert counts == {"vector": 0, "scalar": 0, route: 1}
    assert torch.equal(got, valid & want)


@pytest.mark.parametrize("offsets,valid_offset,route", [
    ((0, 1, 2, 3), 0, "scalar"),   # four columns, four alignments
    ((0, 4, 8), 0, "vector"),      # every column 16-byte aligned
    ((0, 0), 1, "scalar"),         # the validity one byte off
    ((0, 0), 2, "scalar"),
    ((0, 0), 4, "vector"),         # the validity 4-byte aligned suffices
    ((4, 2), 4, "scalar"),
])
@pytest.mark.parametrize("n", [4, 17, 1_000_003])
def test_hash_threshold_columns_of_different_alignments(dev, offsets, valid_offset, route, n):
    rng = np.random.default_rng(n + valid_offset)
    cols = tuple(_at(c, o) for c, o in zip(_keys(rng, n, len(offsets), dev), offsets))
    valid = _at(torch.from_numpy(rng.random(n) < 0.5).to(dev), valid_offset)
    got, counts = _route_counts(hash_threshold, lambda: hash_threshold(cols, 0.6, 9, valid))
    assert counts == {"vector": 0, "scalar": 0, route: 1}
    assert torch.equal(got, valid & hash_threshold_ref(cols, 0.6, 9))


def test_hash_threshold_of_no_rows_launches_nothing(dev):
    cols = (torch.empty(0, dtype=torch.int32, device=dev),)
    before = hash_threshold.launches
    assert hash_threshold(cols, 0.5).shape == (0,)
    assert hash_threshold.launches == before


@pytest.mark.parametrize("offset", [0, 1])
def test_apply_hash_without_a_pin_is_one_launch(dev, offset):
    """η and the narrowed validity come from one kernel on the card."""
    from repro_torch.core.hashing import apply_hash
    from repro_torch.relational.relation import Relation, from_columns

    rng = np.random.default_rng(offset)
    n = 1_500_000
    rel = from_columns({"k": rng.integers(0, 1 << 30, n).astype(np.int32),
                        "j": rng.integers(-50, 50, n).astype(np.int32)},
                       pk=["k", "j"], valid=rng.random(n) < 0.1, capacity=n + 7, device=dev)
    if offset:
        rel = Relation({c: _at(v, offset) for c, v in rel.columns.items()},
                       _at(rel.valid, offset), rel.schema)
    got = apply_hash(rel, ("k", "j"), 0.2, 3)
    want = rel.valid & hash_threshold_ref((rel.col("k"), rel.col("j")), 0.2, 3)
    assert torch.equal(got.valid, want)
    assert _device_launches(lambda: apply_hash(rel, ("k", "j"), 0.2, 3)) == 1


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


@pytest.mark.parametrize("K", [0, 1, 1000, 2049, 50_000])
@pytest.mark.parametrize("ncols", [1, 3])
def test_digest_table_entry_equals_the_plain_table(dev, K, ncols):
    keys = _keys(np.random.default_rng(K + ncols), K, ncols, dev)
    before = digest_table.launches
    got = digest_table(keys)
    torch.cuda.synchronize()
    assert digest_table.launches == before + (1 if K else 0)
    assert torch.equal(got, sorted_digest_table(keys))


@pytest.mark.parametrize("K", [1, 1000, MAX_SMEM_KEYS, MAX_SMEM_KEYS + 1, 50_000])
@pytest.mark.parametrize("ncols", [1, 2])
@pytest.mark.parametrize("shift", [0, 1])
def test_pinned_hash_is_one_launch_equal_to_the_plain_composition(dev, K, ncols, shift):
    """Validity and ``__outlier`` of the masked probe against the plain
    pinned hash, the table in shared memory (K ≤ 2,048) and in device
    memory; rows four at a time with a tail of three (shift 0), and one at
    a time from columns that start off a 16-byte boundary (shift 1)."""
    rng = np.random.default_rng(K * 3 + ncols)
    n = 300_003 + shift
    keys = _keys(rng, K, ncols, dev, high=5000)
    cols = list(_keys(rng, n, ncols, dev, high=5000))
    hits = torch.from_numpy(rng.integers(0, K, 1000)).to(dev)
    for c in range(ncols):
        cols[c][10:1010] = keys[c][hits]  # planted members
    cols[0][:5] = int(SENTINEL_KEY)  # valid rows keyed SENTINEL: never members
    valid = torch.from_numpy(rng.uniform(size=n) < 0.8).to(dev)
    valid[:5] = True
    cols, valid = [c[shift:] for c in cols], valid[shift:]
    table = digest_table(keys)
    for m in (0.0, 0.2):
        before = pinned_hash.launches
        got_v, got_f = pinned_hash(cols, valid, m, 4, table)
        torch.cuda.synchronize()
        assert pinned_hash.launches == before + 1
        want_v, want_f = pinned_hash_ref(cols, valid, m, 4, table)
        assert torch.equal(got_v, want_v) and torch.equal(got_f, want_f)
        assert got_f.dtype == torch.int8 and bool(got_f.any())
        assert not bool(got_f[:5 - shift].any())
        assert not bool((got_v & ~valid).any())
    assert _device_launches(lambda: pinned_hash(cols, valid, 0.2, 4, table)) == 1


def test_pinned_refresh_on_the_card_builds_the_table_once(dev):
    """A pinned svc_refresh launches the pinned hash and builds no table;
    the samples equal the CPU manager's."""
    from repro_torch.relational.relation import to_host

    vms = {d: _small_fleet(d) for d in ("cuda", "cpu")}
    for vm in vms.values():
        vm.register_outlier_index("v0", "Log0", "bytes", k=50)
    builds, hashes = digest_table.launches, pinned_hash.launches
    vms["cuda"].svc_refresh("v0")
    torch.cuda.synchronize()
    assert digest_table.launches == builds
    assert pinned_hash.launches > hashes
    vms["cpu"].svc_refresh("v0")
    a, b = (to_host(vms[d].views["v0"].clean_sample) for d in ("cuda", "cpu"))
    for col in ("videoId", "visits", "__outlier"):
        assert np.array_equal(a[col], b[col]), col
    assert a["__outlier"].sum() > 0
    np.testing.assert_allclose(a["totalBytes"], b["totalBytes"], rtol=1e-5)


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


@pytest.mark.parametrize("R", [1, TILE - 1, TILE + 1, 1_000_003])
@pytest.mark.parametrize("Q", [8, 16, 32, 64])
@pytest.mark.parametrize("P", [1, 2, 4])
@pytest.mark.parametrize("C", [1, 3, 4, 8])
def test_multi_agg_kernel_over_tile_edges(dev, R, Q, P, C):
    rng = np.random.default_rng(R + 7 * Q + 31 * P + C)
    new, old = _panel(rng, R, C, dev), _panel(rng, R, C, dev)
    sel, meta = _batch(rng, C, Q, P, dev)
    idx = selector_indices(sel, C)
    two = multi_agg_two(*new, sel, meta, *old, sel_idx=idx)
    _close(two, multi_agg_ref(*new, sel, meta, *old))
    assert torch.equal(two, multi_agg_two(*new, sel, meta, *old))
    one = multi_agg_one(*new, sel, meta, sel_idx=idx)
    _close(one, multi_agg_ref(*new, sel, meta))
    assert bool((one[4:] == 0).all())


@pytest.mark.parametrize("R", [1000, 300_001])
def test_multi_agg_kernel_reads_terms_past_four_from_the_table(dev, R):
    rng = np.random.default_rng(R)
    C, Q, P = 8, 16, 8
    new, old = _panel(rng, R, C, dev), _panel(rng, R, C, dev)
    sel, meta = _batch(rng, C, Q, P, dev)
    idx = selector_indices(sel, C)
    assert int((idx[1:] >= 0).sum(0).max()) > 4
    _close(multi_agg_two(*new, sel, meta, *old, sel_idx=idx), multi_agg_ref(*new, sel, meta, *old))
    _close(multi_agg_one(*new, sel, meta, sel_idx=idx), multi_agg_ref(*new, sel, meta))


@pytest.mark.parametrize("layout", ["front", "holes", "none"])
def test_multi_agg_kernel_skips_tiles_without_valid_rows(dev, layout):
    """Valid rows in front (as the engine's panels keep them), in random
    runs with whole invalid tiles between, or none: the same answers."""
    rng = np.random.default_rng(17)
    R, C, Q, P = 1_000_003, 3, 16, 2
    new, old = _panel(rng, R, C, dev), _panel(rng, R, C, dev)
    keep = np.zeros(R, bool)
    if layout == "front":
        keep[: R // 20] = True
    elif layout == "holes":
        for start in rng.choice(R // TILE, 40, replace=False) * TILE:
            keep[start:start + int(rng.integers(1, 3 * TILE))] = True
    mask = torch.from_numpy(keep).to(dev)
    new = (new[0], new[1] & mask, new[2], new[3])
    old = (old[0], old[1] & mask, old[2], old[3])
    sel, meta = _batch(rng, C, Q, P, dev)
    idx = selector_indices(sel, C)
    _close(multi_agg_two(*new, sel, meta, *old, sel_idx=idx), multi_agg_ref(*new, sel, meta, *old))
    _close(multi_agg_one(*new, sel, meta, sel_idx=idx), multi_agg_ref(*new, sel, meta))


def test_multi_agg_interval_bounds_are_exact(dev):
    """Strict and closed bounds at, and one ulp beside, the row values;
    infinite, NaN and denormal bounds and values: counts equal the plain
    version's."""
    f = np.float32
    tiny, big = np.finfo(f).tiny * f(0.5), np.finfo(f).max
    vals = np.array([-np.inf, -big, -1.0, np.nextafter(f(-1.0), f(0.0)), -0.0, 0.0, tiny,
                     1.0, np.nextafter(f(1.0), f(2.0)), big, np.inf, np.nan], f)
    x = np.tile(vals, 40)[:, None]
    R = x.shape[0]
    preds = [("gt", 1.0), ("ge", 1.0), ("lt", 1.0), ("le", 1.0), ("eq", 0.0), ("gt", -np.inf),
             ("lt", np.inf), ("gt", np.inf), ("lt", -np.inf), ("ge", np.nan), ("le", np.nan),
             ("gt", big), ("lt", -big), ("gt", 0.0), ("ge", -np.inf), ("le", np.inf),
             ("gt", -1.0), ("lt", tiny), ("ge", np.inf), ("le", -np.inf), ("eq", np.inf)]
    Q = 32
    sel = np.zeros((2, Q), f)
    meta = np.zeros((6, Q), f)
    meta[0] = 1.0  # counts
    meta[2], meta[3], meta[4], meta[5] = -np.inf, -np.inf, np.inf, np.inf
    for q, (op, b) in enumerate(preds):
        sel[1, q] = 1.0
        rows = {"gt": (3,), "ge": (2,), "lt": (5,), "le": (4,), "eq": (2, 4)}[op]
        for r in rows:
            meta[r, q] = b
    side = (torch.from_numpy(x).to(dev), torch.ones(R, dtype=torch.bool, device=dev),
            torch.ones(R, device=dev), torch.zeros(R, device=dev))
    sel_t, meta_t = torch.from_numpy(sel).to(dev), torch.from_numpy(meta).to(dev)
    got = multi_agg_two(*side, sel_t, meta_t, *side)
    want = multi_agg_ref(*side, sel_t, meta_t, *side)
    assert torch.equal(got[K_NEW], want[K_NEW]) and torch.equal(got[S_NEW], want[S_NEW])
    assert torch.equal(got[K_OLD], want[K_OLD]) and torch.equal(got[S_D], want[S_D])


def test_multi_agg_is_one_launch_without_a_host_sync(dev):
    rng = np.random.default_rng(5)
    R, C, Q, P = 300_000, 3, 16, 2
    new, old = _panel(rng, R, C, dev), _panel(rng, R, C, dev)
    sel, meta = _batch(rng, C, Q, P, dev)
    idx = selector_indices(sel, C)
    assert _device_launches(lambda: multi_agg_two(*new, sel, meta, *old, sel_idx=idx)) == 1
    assert _device_launches(lambda: multi_agg_one(*new, sel, meta, sel_idx=idx)) == 1
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        multi_agg_two(*new, sel, meta, *old, sel_idx=idx)
        multi_agg_one(*new, sel, meta, sel_idx=idx)
        with pytest.raises(RuntimeError):  # the mode does catch the decode's read
            multi_agg_two(*new, sel, meta, *old)
    finally:
        torch.cuda.set_sync_debug_mode(0)


def test_multi_agg_tickets_reset_between_calls(dev):
    """Many calls in a row, and two shapes interleaved (one of them four
    query chunks), give the same bits: every launch leaves its tickets at 0."""
    rng = np.random.default_rng(11)
    shapes = []
    for R, C, Q, P in ((400_000, 3, 16, 2), (5_000, 4, 64, 4)):
        new, old = _panel(rng, R, C, dev), _panel(rng, R, C, dev)
        sel, meta = _batch(rng, C, Q, P, dev)
        idx = selector_indices(sel, C)
        shapes.append(lambda new=new, old=old, sel=sel, meta=meta, idx=idx:
                      multi_agg_two(*new, sel, meta, *old, sel_idx=idx))
    first = [call() for call in shapes]
    for _ in range(20):
        assert torch.equal(shapes[0](), first[0])
    for _ in range(5):
        for call, want in zip(shapes, first):
            assert torch.equal(call(), want)


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


# (16, 4096, 1024): one tile holds ~3,600 stale keys, more than the 2,048
# staged in shared memory; (4, 8192, 65541): 17 tiles, the last partial;
# (2, 20000, 300): R above the block sort's SORT_MAX (the torch sort) and
# all 20,000 keys in one tile
@pytest.mark.parametrize("V,R,G,A", [(16, 4096, 1024, 2), (3, 1000, 5000, 1), (1, 7, 3, 3),
                                     (4, 8192, 65541, 2), (2, 20000, 300, 2)])
@pytest.mark.parametrize("deletes", [True, False])
def test_fleet_merge_kernel_is_bit_equal_to_plain(dev, V, R, G, A, deletes):
    """Duplicate, negative, ≥ G and SENTINEL-keyed valid stale rows."""
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
    if not deletes:
        args = args[:5] + (torch.zeros_like(args[5]), torch.zeros_like(args[6]))
    before = fleet_merge.launches
    got = fleet_merge(*args) if deletes else fleet_merge(*args[:5])
    torch.cuda.synchronize()
    assert fleet_merge.launches == before + 1
    want = sort_by_key(*fleet_merge_ref(*args))
    for g, w, r in zip(got, want, fleet_merge_rank_ref(*args)):
        assert _bits(g, w)
        assert _bits(r, w)
    # sort, count and scatter: three launches and nothing else when the
    # block sort takes R
    if R <= SORT_MAX:
        assert _device_launches(lambda: fleet_merge(*args)) == 3


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


def _corr_inputs(rng, n, mask_dtype, dev, offsets=(0, 0, 0)):
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    t_new = t(rng.normal(5.0, 20.0, n).astype(np.float32))
    t_old = t(rng.normal(4.0, 20.0, n).astype(np.float32))
    mask = t(rng.uniform(size=n) < 0.7).to(mask_dtype)
    if mask_dtype == torch.int8:
        mask[: n // 3] *= 3  # int8 masks convert by value, as astype(float32) does
    return tuple(_at(x, o) for x, o in zip((t_new, t_old, mask), offsets))


def _hold_corr(got, t_new, t_old, mask):
    """The count exact; Σd and Σd² within 1e-6·Σ|x| of the float64 sums."""
    d = (t_new - t_old) * mask.to(torch.float32)  # per-row rounding as the kernel's
    assert float(got[2]) == float(mask.to(torch.float64).sum())
    exact = torch.stack([d.double().sum(), (d * d).double().sum()])
    scale = torch.stack([d.double().abs().sum(), (d * d).double().sum()])
    assert bool(((got[:2].double() - exact).abs() <= 1e-6 * scale + 1e-30).all())


@pytest.mark.parametrize("n", EDGE_SIZES)
@pytest.mark.parametrize("offsets,route", [
    ((0, 0, 0), "vector"),
    ((1, 1, 1), "scalar"),
    ((2, 2, 2), "scalar"),
    ((3, 3, 3), "scalar"),
    ((0, 0, 1), "scalar"),   # the mask one byte off
    ((0, 0, 4), "vector"),   # a 4-byte aligned mask suffices
    ((0, 2, 0), "scalar"),   # t_old 8 bytes off
])
@pytest.mark.parametrize("mask_dtype", [torch.bool, torch.int8])
def test_corr_moments_routes_match_plain(dev, n, offsets, route, mask_dtype):
    from repro_torch.kernels.corr_diff import corr_moments

    args = _corr_inputs(np.random.default_rng(n + sum(offsets)), n, mask_dtype, dev, offsets)
    got, counts = _route_counts(corr_moments, lambda: torch.stack(corr_moments(*args)))
    assert counts == {"vector": 0, "scalar": 0, route: 1}
    _hold_corr(got, *args)
    assert torch.equal(got, torch.stack(corr_moments(*args)))  # same bits


@pytest.mark.parametrize("rows", ["inf_minus_inf", "inf_times_zero", "nan", "inf", "neg_inf"])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("mask_dtype", [torch.bool, torch.int8])
def test_corr_moments_non_finite_rows_as_plain(dev, rows, offset, mask_dtype):
    """inf − inf and inf · 0 make the sums NaN, a lone ±inf makes them ±inf,
    masked or not, as in the plain version (NaN-aware equality)."""
    from repro_torch.kernels.corr_diff import corr_diff_ref, corr_moments

    n = 100_003
    t_new, t_old, mask = (x.clone() for x in
                          _corr_inputs(np.random.default_rng(3), n, mask_dtype, dev))
    i = 77_777  # inside the vector body
    if rows == "inf_minus_inf":
        t_new[i] = t_old[i] = float("inf")
        mask[i] = 1
    elif rows == "inf_times_zero":
        t_new[i] = float("inf")
        mask[i] = 0
    elif rows == "nan":
        t_old[n - 1] = float("nan")  # the ragged tail
    else:
        t_new[i] = float("inf") if rows == "inf" else float("-inf")
        mask[i] = 1
    args = tuple(_at(x, offset) for x in (t_new, t_old, mask))
    got = torch.stack(corr_moments(*args))
    want = torch.stack(corr_diff_ref(*args))
    assert torch.equal(got.isnan(), want.isnan())
    assert not bool(got[:2].isfinite().any())
    inf = want.isinf()
    assert torch.equal(got[inf], want[inf])
    assert torch.equal(got[2], want[2])


def test_corr_moments_repeats_bit_equal_across_grid_fills(dev):
    """Sizes whose grids range from one block to every resident block, on
    the current stream and on a second one (its own workspace), in turns:
    each call gives the bits of its first, so each left its ticket at 0."""
    from repro_torch.kernels.corr_diff import corr_moments

    rng = np.random.default_rng(11)
    sizes = [5, 4097, 100_003, 2_000_003, 20_000_001]
    inputs = [_corr_inputs(rng, n, torch.bool, dev) for n in sizes]
    first = [torch.stack(corr_moments(*a)) for a in inputs]
    for a, f in zip(inputs, first):
        _hold_corr(f, *a)
    side = torch.cuda.Stream()
    for _ in range(2):
        for a, f in zip(reversed(inputs), reversed(first)):
            assert torch.equal(torch.stack(corr_moments(*a)), f)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            again = [torch.stack(corr_moments(*a)) for a in inputs]
        torch.cuda.current_stream().wait_stream(side)
        assert all(torch.equal(g, f) for g, f in zip(again, first))


def test_corr_moments_is_one_launch_and_allocates_only_its_output(dev):
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.corr_diff import corr_moments

    args = _corr_inputs(np.random.default_rng(2), 2_097_152, torch.bool, dev)
    assert _device_launches(lambda: corr_moments(*args)) == 1
    corr_moments(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        corr_moments(*args)
    empties = sum(e.count for e in prof.key_averages() if e.key in ("aten::empty", "aten::zeros"))
    assert empties == 1
    zero = corr_moments(*(a[:0] for a in args))
    assert [float(x) for x in zero] == [0.0, 0.0, 0.0]


# ---------------------------------------------------------------------------
# The sorted reduce-by-key (segment_groupby, segment_sum with
# indices_are_sorted=True): counts exact, each sum its float64 sum rounded
# once (within 2^-24·|S| + 1e-8·Σ|x| of the float64 sum, hence within
# F64_SUM_RTOL·Σ|x| = 1e-6·Σ|x|), the same bits on every call
# ---------------------------------------------------------------------------

def _hold_sorted(counts, sums, gid, vals, G):
    keep = (gid >= 0) & (gid < G)
    g = torch.where(keep, gid.long(), torch.full_like(gid, G, dtype=torch.int64))
    C = vals.shape[1]
    exact_n = torch.zeros(G + 1, dtype=torch.int64, device=gid.device).index_add_(
        0, g, torch.ones_like(g))[:G]
    if counts is not None:
        assert counts.dtype == torch.int32
        assert torch.equal(counts.long(), exact_n)
    exact = torch.zeros((G + 1, C), dtype=torch.float64, device=gid.device).index_add_(
        0, g, vals.double())[:G]
    abs_sum = torch.zeros((G + 1, C), dtype=torch.float64, device=gid.device).index_add_(
        0, g, vals.double().abs())[:G]
    err = (sums.double() - exact).abs()
    assert bool((err <= 2.0 ** -24 * exact.abs() + 1e-8 * abs_sum).all()), float(err.max())
    assert bool((err <= 1e-6 * abs_sum).all())
    assert bool((sums[exact_n == 0] == 0).all())  # absent groups read 0


def _sorted_ids(rng, R, G, kind):
    if kind == "uniform":
        return np.sort(rng.integers(-2, G + 3, R)).astype(np.int32)
    if kind == "groupby":  # dense ranks, Zipf-sized, then the overflow slot
        sizes = np.minimum(rng.zipf(1.6, G), R)
        ids = np.repeat(np.arange(G), sizes)[: R - R // 4]
        return np.concatenate([ids, np.full(R - len(ids), G)]).astype(np.int32)
    if kind == "one_group":
        return np.full(R, G // 2, np.int32)
    if kind == "out_of_range":
        return np.sort(np.where(rng.uniform(size=R) < 0.5, -1, G + 1)).astype(np.int32)
    raise ValueError(kind)


@pytest.mark.parametrize("C", [1, 2, 3, 8])
@pytest.mark.parametrize("edge", ["one", "tile-1", "tile", "tile+1", "1000003"])
@pytest.mark.parametrize("kind", ["uniform", "groupby"])
def test_segment_groupby_kernel_over_tile_edges(dev, C, edge, kind):
    from repro_torch.kernels.segment_aggsum import segment_groupby, segment_groupby_ref

    tile = 256 * (16 if C <= 2 else 8 if C <= 4 else 4)  # rows of a chunk (rows_per_thread)
    R = {"one": 1, "tile-1": tile - 1, "tile": tile, "tile+1": tile + 1,
         "1000003": 1_000_003}[edge]
    G = max(1, R // 7)
    rng = np.random.default_rng(R + C)
    gid = torch.from_numpy(_sorted_ids(rng, R, G, kind)).to(dev)
    vals = torch.from_numpy(rng.uniform(-50.0, 100.0, (R, C)).astype(np.float32)).to(dev)
    before = segment_groupby.launches
    counts, sums = segment_groupby(gid, vals, G)
    torch.cuda.synchronize()
    assert segment_groupby.launches == before + 1
    _hold_sorted(counts, sums, gid, vals, G)
    want_n, want_s = segment_groupby_ref(gid, vals, G)
    assert torch.equal(counts, want_n)
    assert bool(((sums.double() - want_s.double()).abs()
                 <= (_gamma_bound(want_n[:, None].double()) + 1e-6)
                 * segment_groupby_ref(gid, vals.abs(), G)[1].double()).all())
    again = segment_groupby(gid, vals, G)
    assert torch.equal(again[0], counts) and torch.equal(again[1].view(torch.int32),
                                                         sums.view(torch.int32))


@pytest.mark.parametrize("R,C", [(4096 * 300 + 17, 1), (1_000_003, 2), (200_000, 8)])
def test_segment_groupby_one_group_spans_every_tile(dev, R, C):
    from repro_torch.kernels.segment_aggsum import segment_groupby

    rng = np.random.default_rng(R)
    G = 5
    gid = torch.from_numpy(_sorted_ids(rng, R, G, "one_group")).to(dev)
    vals = torch.from_numpy(rng.gamma(2.0, 4e6, (R, C)).astype(np.float32)).to(dev)
    counts, sums = segment_groupby(gid, vals, G)
    _hold_sorted(counts, sums, gid, vals, G)
    assert counts.tolist() == [0, 0, R, 0, 0]


@pytest.mark.parametrize("C", [0, 1, 3])
def test_segment_groupby_every_id_out_of_range(dev, C):
    from repro_torch.kernels.segment_aggsum import segment_groupby

    rng = np.random.default_rng(C)
    R, G = 300_001, 1000
    gid = torch.from_numpy(_sorted_ids(rng, R, G, "out_of_range")).to(dev)
    vals = torch.from_numpy(rng.normal(size=(R, C)).astype(np.float32)).to(dev)
    counts, sums = segment_groupby(gid, vals, G)
    assert not bool(counts.any()) and not bool(sums.any())
    assert tuple(sums.shape) == (G, C)


def test_segment_groupby_empty_tail_reads_zero(dev):
    """The group-by's capacity far above its groups: every slot past the
    last group (and any left by a call before) must read 0."""
    from repro_torch.kernels.segment_aggsum import segment_groupby

    rng = np.random.default_rng(7)
    R, G = 2_000_000, 1_500_000
    gid = np.sort(rng.integers(0, 40_000, R)).astype(np.int32)
    gid[-R // 3:] = G  # invalid rows in the overflow slot
    gid_t = torch.from_numpy(gid).to(dev)
    vals = torch.from_numpy(rng.normal(size=(R, 2)).astype(np.float32)).to(dev)
    segment_groupby(torch.zeros(R, dtype=torch.int32, device=dev) + 39_999, vals, G)
    counts, sums = segment_groupby(gid_t, vals, G)
    _hold_sorted(counts, sums, gid_t, vals, G)
    assert not bool(counts[40_000:].any()) and not bool(sums[40_000:].any())


def test_segment_groupby_counts_one_group_past_2_24(dev):
    """17,000,000 rows of one group: int32 counts stay exact where a float32
    count column stops at 2^24."""
    from repro_torch.kernels.segment_aggsum import segment_groupby

    R = 17_000_000
    gid = torch.full((R,), 3, dtype=torch.int32, device=dev)
    vals = torch.ones((R, 1), dtype=torch.float32, device=dev)
    counts, sums = segment_groupby(gid, vals, 4)
    assert counts.tolist() == [0, 0, 0, R]
    assert sums[:, 0].tolist() == [0.0, 0.0, 0.0, float(R)]  # 17,000,000 is a float32


@pytest.mark.parametrize("C", [1, 2, 8, 11])
def test_sorted_segment_sum_matches_plain_and_repeats_bit_equal(dev, C):
    from repro_torch.kernels.segment_aggsum import segment_groupby, segment_sum, segment_sum_ref

    rng = np.random.default_rng(C)
    R, G = 1_500_007, 200_000
    gid = torch.from_numpy(_sorted_ids(rng, R, G, "groupby")).to(dev)
    vals = torch.from_numpy(rng.normal(0.0, 1e3, (R, C)).astype(np.float32)).to(dev)
    before = segment_groupby.launches, segment_sum.launches
    got = segment_sum(gid, vals, G, indices_are_sorted=True)
    torch.cuda.synchronize()
    assert segment_groupby.launches == before[0] + -(-C // 8)  # one launch per 8 columns
    assert segment_sum.launches == before[1]  # the unsorted route's counter
    _hold_sorted(None, got, gid, vals, G)
    plain = segment_sum_ref(gid, vals, G).double()
    n = segment_sum_ref(gid, torch.ones_like(vals[:, :1]), G).double()
    bound = (_gamma_bound(n) + 1e-6) * segment_sum_ref(gid, vals.abs(), G).double()
    assert bool(((got.double() - plain).abs() <= bound).all())
    for _ in range(3):
        assert torch.equal(segment_sum(gid, vals, G, indices_are_sorted=True).view(torch.int32),
                           got.view(torch.int32))
    one = segment_sum(gid, vals[:, 0].contiguous(), G, indices_are_sorted=True)
    assert one.shape == (G,)


def test_sorted_segment_sum_ids_out_of_order_count_exactly(dev):
    """The sorted route given shuffled ids: every row is still summed once
    (counts exact, sums within the float32 bound); only the bits may vary."""
    from repro_torch.kernels.segment_aggsum import segment_groupby

    rng = np.random.default_rng(11)
    R, G = 500_000, 3000
    gid = torch.from_numpy(rng.permutation(_sorted_ids(rng, R, G, "uniform"))).to(dev)
    vals = torch.from_numpy(rng.uniform(0.0, 10.0, (R, 2)).astype(np.float32)).to(dev)
    counts, sums = segment_groupby(gid, vals, G)
    keep = (gid >= 0) & (gid < G)
    g = torch.where(keep, gid.long(), torch.full_like(gid, G, dtype=torch.int64))
    exact = torch.zeros((G + 1, 2), dtype=torch.float64, device=dev).index_add_(
        0, g, vals.double())[:G]
    assert torch.equal(counts.long(), torch.bincount(g, minlength=G + 1)[:G])
    bound = _gamma_bound(counts[:, None].double()) * exact  # values ≥ 0: Σ|x| = Σx
    assert bool(((sums.double() - exact).abs() <= bound + 1e-6 * exact).all())


def test_segment_groupby_is_one_kernel_after_two_memsets(dev):
    from repro_torch.kernels.segment_aggsum import segment_groupby, segment_sum

    rng = np.random.default_rng(0)
    R, G = 1_000_000, 50_000
    gid = torch.from_numpy(_sorted_ids(rng, R, G, "groupby")).to(dev)
    vals = torch.from_numpy(rng.normal(size=(R, 2)).astype(np.float32)).to(dev)
    # counts and sums zeroed by memsets, then one launch
    assert _device_launches(lambda: segment_groupby(gid, vals, G)) == 3
    assert _device_launches(lambda: segment_sum(gid, vals, G, indices_are_sorted=True)) == 2


@pytest.mark.parametrize("aggs_kind", ["sum_count", "all"])
def test_groupby_on_the_card_matches_the_cpu(dev, aggs_kind):
    from repro_torch.kernels.segment_aggsum import segment_groupby
    from repro_torch.relational import ops
    from repro_torch.relational.expr import Bin, Col, Lit
    from repro_torch.relational.relation import from_columns

    rng = np.random.default_rng(5)
    n, cap, nk = 3_000_000, 3_500_000, 200_000
    cols = {"id": np.arange(n, dtype=np.int32),
            "k": (rng.zipf(1.6, n) % nk).astype(np.int32),
            "val": rng.gamma(2.0, 4e6, n).astype(np.float32),
            "w": rng.normal(size=n).astype(np.float32)}
    valid = rng.uniform(size=n) < 0.9
    cpu = from_columns(cols, pk=["id"], valid=valid, capacity=cap, device="cpu")
    card = from_columns(cols, pk=["id"], valid=valid, capacity=cap, device=dev)
    aggs = {"n": ("count", None), "s": ("sum", "val")}
    if aggs_kind == "all":
        aggs.update({"mu": ("mean", "w"), "mn": ("min", "val"), "mx": ("max", "w"),
                     "s2": ("sum", Bin("mul", Col("w"), Lit(3.0)))})
    G = len(np.unique(cols["k"][valid])) // 2  # fewer slots than groups: the rest overflow
    before = segment_groupby.launches
    got = ops.groupby(card, ("k",), aggs, G)
    torch.cuda.synchronize()
    assert segment_groupby.launches == before + 1
    want = ops.groupby(cpu, ("k",), aggs, G)
    assert bool(want.valid.all())
    assert torch.equal(got.valid.cpu(), want.valid)
    assert torch.equal(got.col("k").cpu(), want.col("k"))
    assert torch.equal(got.col("n").cpu(), want.col("n"))
    for c in ("mn", "mx"):
        if c in aggs:
            assert torch.equal(got.col(c).cpu(), want.col(c))
    # sums against the float64 sums of the CPU's own sorted rows
    order, _sk, sv, _st, gid = ops.group_ids(cpu, ("k",), G)
    for c, expr in (("s", cpu.col("val")), ("s2", cpu.col("w") * 3.0), ("mu", cpu.col("w"))):
        if c not in aggs:
            continue
        x = torch.where(sv, expr[order].double(), torch.zeros((), dtype=torch.float64))
        g = gid.long()
        exact = torch.zeros(G + 1, dtype=torch.float64).index_add_(0, g, x)[:G]
        abs_sum = torch.zeros(G + 1, dtype=torch.float64).index_add_(0, g, x.abs())[:G]
        if c == "mu":
            cnt = want.col("n").double().clamp(min=1)
            exact, abs_sum = exact / cnt, abs_sum / cnt
        err = (got.col(c).cpu().double() - exact).abs()
        assert bool((err <= 1e-6 * abs_sum + 1e-30).all()), (c, float(err.max()))
    prof = _kernel_rows(lambda: ops.groupby(card, ("k",), aggs, G))
    assert any("segment_sorted" in k for k in prof)
    assert not any("index_add" in k for k in prof)


def _kernel_rows(fn):
    """Names of the device rows (kernels, copies, memsets) of one call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.key for e in prof.key_averages()]


def test_segment_groupby_raises_instead_of_falling_back(dev):
    from repro_torch.kernels.segment_aggsum import segment_groupby

    gid = torch.zeros(8, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        segment_groupby(gid.long(), torch.ones(8, 2, device=dev), 4)
    with pytest.raises(ValueError):
        segment_groupby(gid, torch.ones(8, 2), 4)  # values on the CPU
    with pytest.raises(ValueError):
        segment_groupby(gid, torch.ones(2, 8, device=dev).t(), 4)  # not contiguous


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


# ---------------------------------------------------------------------------
# flash_attention: the kernel against its plain version (float32 within
# 1e-4, another order of the same f32 sums; bfloat16 within 1e-2 relative
# and absolute, the two may round an output to neighbouring bf16 values)
# ---------------------------------------------------------------------------

FLASH_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def _qkv(B, S, T, H, K, hd, dtype, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=dev).to(dtype)
            for shape in ((B, S, H, hd), (B, T, K, hd), (B, T, K, hd))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,T,H,K,hd,causal", [
    (2, 128, 128, 4, 4, 64, True), (1, 300, 300, 8, 2, 32, True), (2, 256, 256, 4, 1, 128, True),
    (1, 64, 64, 2, 2, 16, True), (1, 256, 256, 8, 1, 256, True), (2, 40, 72, 4, 2, 96, True),
    (8, 1, 200, 8, 1, 256, False), (3, 1, 5000, 32, 8, 64, False), (2, 1, 33, 32, 32, 96, False),
    (4, 7, 130, 16, 4, 128, False)])
def test_flash_attention_kernel_matches_plain(dev, dtype, B, S, T, H, K, hd, causal):
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref

    q, k, v = _qkv(B, S, T, H, K, hd, dtype, dev)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.dtype == dtype and tuple(got.shape) == (B, S, H, hd)
    want = flash_attention_ref(q, k, v, causal=causal)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_on_a_cache_slice(dev, dtype):
    """Decode reads a strided view of the (L, B, T, K, hd) cache, and an
    unaligned one (a slice of the head dim's storage) takes scalar loads."""
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref

    cache = torch.randn(2, 8, 1024, 1, 256, device=dev).to(dtype)
    q = torch.randn(8, 1, 8, 256, device=dev).to(dtype)
    for pos in (0, 31, 32, 290, 1023):
        ks, vs = cache[1, :, :pos + 1], cache[0, :, :pos + 1]
        got = flash_attention(q, ks, vs, causal=False)
        want = flash_attention_ref(q, ks, vs, causal=False)
        tol = FLASH_TOL[dtype]
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    wide = torch.randn(2, 50, 2, 65, device=dev).to(dtype)
    k = wide[..., 1:]  # rows start one element in: not 16-byte aligned
    qq = torch.randn(2, 50, 4, 64, device=dev).to(dtype)
    torch.testing.assert_close(flash_attention(qq, k, k).float(),
                               flash_attention_ref(qq, k, k).float(),
                               rtol=FLASH_TOL[dtype], atol=FLASH_TOL[dtype])


def test_flash_attention_raises_instead_of_falling_back(dev):
    from repro_torch.kernels.flash_attention import flash_attention

    q16 = torch.ones(1, 4, 2, 64, dtype=torch.float16, device=dev)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention(q16, q16, q16)
    q48 = torch.ones(1, 4, 2, 48, device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q48, q48, q48)
    q = torch.ones(1, 4, 2, 64, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q, q.transpose(1, 3).contiguous().transpose(1, 3), q)
    with pytest.raises(ValueError):
        flash_attention(q, q.cpu(), q)


def test_smoke_model_on_the_card_matches_the_cpu(dev):
    """gemma-2b-smoke (f32) from one set of weights: forward and 8 decode
    steps on the card equal the CPU's within 1e-4."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import get_model

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config("gemma-2b")
    cpu, card = get_model(cfg, device="cpu"), get_model(cfg, device=dev)
    p_cpu = cpu.init(0)
    p_card = card.init(0)
    p_card.load_state_dict(p_cpu.state_dict())
    toks = torch.randint(0, cfg.vocab, (2, 24), generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(card.forward(p_card, {"tokens": toks.to(dev)})[0].cpu(),
                               cpu.forward(p_cpu, {"tokens": toks})[0], rtol=1e-4, atol=1e-4)
    c_cpu, c_card = cpu.init_cache(2, 32), card.init_cache(2, 32)
    for i in range(8):
        lc, c_cpu = cpu.decode_step(p_cpu, c_cpu, toks[:, i:i + 1], i)
        lg, c_card = card.decode_step(p_card, c_card, toks[:, i:i + 1].to(dev), i, rows=None)
        torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# fused_clean, redesigned: per-block tables instead of one atomic per row.
# Counts exact; sums within γ_{n−1}·Σ|x| of the float64 sums over the same
# kept rows (the bound of a float32 sum in any order).
# ---------------------------------------------------------------------------

def _grow_log_keys(rng, n, n_videos):
    """visitView's delta keys as ``grow_log`` draws them: half Zipf(1.6)
    over all videos (video 1 alone ~22% of those), half uniform over the
    newest 10%, in arrival order."""
    hot = rng.random(n) < 0.5
    newest = rng.integers(int(n_videos * 0.9), n_videos, n)
    zipf = (rng.zipf(1.6, size=n) % n_videos).astype(np.int64)
    return np.where(hot, newest, zipf).astype(np.int32)


def _hold_to_f64(counts, sums, gid, vals, keep, G, dev):
    g = torch.where(keep, gid.long(), torch.full_like(gid, G, dtype=torch.int64))
    x = torch.where(keep[:, None], vals.double(), torch.zeros_like(vals, dtype=torch.float64))
    exact = torch.zeros((G + 1, vals.shape[1]), dtype=torch.float64, device=dev).index_add_(
        0, g, x)[:G]
    abs_sum = torch.zeros((G + 1, vals.shape[1]), dtype=torch.float64, device=dev).index_add_(
        0, g, x.abs())[:G]
    n = torch.bincount(g, minlength=G + 1)[:G]
    assert torch.equal(counts.double(), n.double())
    assert bool(((sums.double() - exact).abs() <= _gamma_bound(n.double())[:, None] * abs_sum).all())


@pytest.mark.parametrize("keys", ["grow_log", "sorted", "one_group", "uniform_2^20"])
@pytest.mark.parametrize("C", [0, 1, 3])
@pytest.mark.parametrize("pin", [False, True])
def test_fused_clean_tables_hold_skewed_and_uniform_keys(dev, keys, C, pin):
    from repro_torch.kernels.fused_clean.ops import overflow_counter

    rng = np.random.default_rng(C + 7 * pin)
    R, G, m, seed = 1_000_003, 1 << 20, 0.3, 4
    if keys == "uniform_2^20":
        gid = rng.integers(0, G, R).astype(np.int32)
    elif keys == "one_group":
        cand = torch.arange(1000, dtype=torch.int32)
        gid = np.full(R, int(cand[hash_threshold_ref((cand,), m, seed)][0]), np.int32)
    else:
        gid = _grow_log_keys(rng, R, G)
        if keys == "sorted":
            gid = np.sort(gid)
    gid[:4] = [-1, G, G + 5, -7]  # out of range: dropped
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    gid_t, valid = t(gid), t(rng.uniform(size=R) < 0.95)
    vals = t(rng.uniform(-20.0, 100.0, (R, C)).astype(np.float32))
    pin_mask = t(rng.uniform(size=R) < 0.05) if pin else None
    ovf = overflow_counter(dev)
    ovf.zero_()
    before = fused_clean_groupby.launches
    counts, sums = fused_clean_groupby(gid_t, vals, valid, m, seed, G, pin_mask=pin_mask)
    torch.cuda.synchronize()
    assert fused_clean_groupby.launches == before + 1
    pc, _ = fused_clean_ref(gid_t, vals, valid, m, seed, G, pin_mask)
    assert torch.equal(counts, pc)
    keep = hash_threshold_ref((gid_t,), m, seed)
    if pin:
        keep = keep | pin_mask
    keep = keep & valid & (gid_t >= 0) & (gid_t < G)
    _hold_to_f64(counts, sums, gid_t, vals, keep, G, dev)
    spilled = int(ovf.item())
    assert 0 <= spilled <= int(keep.sum())
    if keys == "one_group":
        assert spilled == 0  # one slot a block
    if keys == "uniform_2^20":
        assert spilled > 0  # ~2.9k kept groups a chunk against 2,048 slots


def test_fused_clean_fleet_with_a_hot_group_per_view(dev):
    rng = np.random.default_rng(5)
    V, R, C, G = 5, 300_001, 2, 1 << 16
    ms, seeds = (0.1, 0.25, 0.5, 1.0, 0.3), (0, 1, 2, 3, 4)
    gid = np.stack([_grow_log_keys(rng, R, G) for _ in range(V)])
    for v in range(V):  # a sampled hot group per view: 30% of its rows
        cand = torch.arange(100, dtype=torch.int32)
        hot = int(cand[hash_threshold_ref((cand,), ms[v], seeds[v])][0])
        gid[v, rng.uniform(size=R) < 0.3] = hot
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    gid_t, valid = t(gid), t(rng.uniform(size=(V, R)) < 0.9)
    vals = t(rng.uniform(0.5, 100.0, (V, R, C)).astype(np.float32))
    counts, sums = fused_clean_groupby_fleet(gid_t, vals, valid, ms, seeds, G)
    pc, _ = fused_clean_fleet_ref(gid_t, vals, valid, ms, seeds, G)
    assert torch.equal(counts, pc)
    for v in range(V):
        keep = hash_threshold_ref((gid_t[v],), ms[v], seeds[v]) & valid[v] & (gid_t[v] >= 0) \
            & (gid_t[v] < G)
        _hold_to_f64(counts[v], sums[v], gid_t[v], vals[v], keep, G, dev)
        assert float(counts[v].max()) > 0.25 * R * 0.9


# ---------------------------------------------------------------------------
# flash_attention, redesigned: bf16 on the tensor cores (one launch, the key
# split merged in place), f32 on the CUDA cores.  Same tolerances as above.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hd", [16, 32, 64, 96, 128, 256])
@pytest.mark.parametrize("S,T", [(200, 333), (333, 333)])
def test_flash_bf16_causal_every_head_dim(dev, hd, S, T):
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref
    from repro_torch.kernels.flash_attention.ops import plan

    q, k, v = _qkv(2, S, T, 8, 2, hd, torch.bfloat16, dev, seed=hd)
    assert plan(torch.bfloat16, 2, S, T, 8, 2, hd, True).route == "tensor_cores"
    got = flash_attention(q, k, v, causal=True)
    want = flash_attention_ref(q, k, v, causal=True)
    tol = FLASH_TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("G", [1, 4, 8, 16])
@pytest.mark.parametrize("T", [1, 31, 249, 4097])
def test_flash_bf16_decode(dev, G, T):
    """One query per sequence against T keys of a strided (B, 1024+, K, hd)
    cache slice, G query heads per KV head."""
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref

    B, K, hd = 3, 2, 128
    gen = torch.Generator(device=dev).manual_seed(G * 7 + T)
    cache = torch.randn(2, B, max(T, 1024) + 3, K, hd, generator=gen, device=dev).to(torch.bfloat16)
    q = torch.randn(B, 1, G * K, hd, generator=gen, device=dev).to(torch.bfloat16)
    ks, vs = cache[0, :, :T], cache[1, :, :T]
    before = flash_attention.launches
    got = flash_attention(q, ks, vs, causal=False)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = flash_attention_ref(q, ks, vs, causal=False)
    tol = FLASH_TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("shape", [(1, 1, 4097, 8, 1, 256, False), (1, 1024, 1024, 2, 2, 64, True)])
def test_flash_bf16_key_split_merges_in_place_twice(dev, shape):
    """Split keys merged by the last block to arrive: two calls in a row
    (and a third on other data) agree with the plain version, so the
    arrival counters were reset; causal splits past a tile's last query
    hold no keys."""
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref
    from repro_torch.kernels.flash_attention.ops import plan

    B_, S, T, H, K, hd, causal = shape
    assert plan(torch.bfloat16, B_, S, T, H, K, hd, causal).nsplit > 1
    tol = FLASH_TOL[torch.bfloat16]
    for seed in (0, 0, 1):
        q, k, v = _qkv(B_, S, T, H, K, hd, torch.bfloat16, dev, seed=seed)
        got = flash_attention(q, k, v, causal=causal)
        torch.testing.assert_close(got.float(), flash_attention_ref(q, k, v, causal).float(),
                                   rtol=tol, atol=tol)


def test_flash_f32_stays_on_the_cuda_cores(dev):
    """float32 at the serve decode's shape takes the CUDA-core route (two
    launches when split) within its 1e-4."""
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref
    from repro_torch.kernels.flash_attention.ops import plan

    pl = plan(torch.float32, 8, 1, 249, 8, 1, 256, False)
    assert pl.route == "cuda_cores" and pl.nsplit > 1
    cache = torch.randn(2, 8, 1024, 1, 256, device=dev)
    q = torch.randn(8, 1, 8, 256, device=dev)
    got = flash_attention(q, cache[0, :, :249], cache[1, :, :249], causal=False)
    want = flash_attention_ref(q, cache[0, :, :249], cache[1, :, :249], causal=False)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# The kernel profiler and the chaos layer on the card
# ---------------------------------------------------------------------------

def test_every_wrapper_under_the_profiler_launches_its_kernel(dev):
    """On CUDA tensors every wrapper dispatches once per call under its op
    name, never as a fallback, and launches its kernel; the profiler's
    wall covers the synchronized launch."""
    from torch_wrapper_calls import wrapper_calls

    from repro_torch import kernels
    from repro_torch.obs.kprof import KernelProfiler

    calls = wrapper_calls(dev)
    ops = kernels.op_names()
    assert set(calls) == set(kernels.wrappers())
    try:
        for name, call in calls.items():
            call()  # built and warm
            prof = kernels.set_profiler(KernelProfiler())
            before = kernels.launch_counts()
            for _ in range(3):
                call()
            launched = {k: n - before[k] for k, n in kernels.launch_counts().items() if n > before[k]}
            summary = prof.summary()
            assert list(summary) == [ops[name]], name
            st = summary[ops[name]]
            assert (st["dispatches"], st["fallbacks"]) == (3, 0), name
            assert st["compiles"] == 1 and st["compile_s"] + st["execute_s"] > 0.0
            assert launched.get(name, 0) >= 3 and {ops[k] for k in launched} == {ops[name]}
    finally:
        kernels.set_profiler(None)


def test_profiled_without_a_profiler_returns_the_launch_output(dev, monkeypatch):
    """No profiler installed: the wrapper returns its launch's own tensor."""
    import repro_torch.kernels.hash_threshold.ops as H
    from repro_torch.obs.kprof import get_profiler

    assert get_profiler() is None
    made = []
    real = H._launch

    def spy(*args):
        made.append(real(*args))
        return made[-1]

    monkeypatch.setattr(H, "_launch", spy)
    out = hash_threshold((torch.arange(1000, dtype=torch.int32, device=dev),), 0.5, 3)
    assert out is made[0]


def test_an_injected_kernel_error_degrades_on_the_card(dev, monkeypatch):
    """An injected kernel_error is a designed failure point: the epoch
    falls back to per-view cleans (which launch the card's kernels), counted
    in fleet_merge_failures, with the samples a fault-free CUDA manager
    gets; a real failure of the batched clean still propagates."""
    import repro_torch.views.manager as M
    from repro_torch import kernels
    from repro_torch.relational.relation import to_host
    from repro_torch.robustness import FaultPlan, FaultSpec

    vm, twin = _small_fleet("cuda"), _small_fleet("cuda")
    plan = FaultPlan([FaultSpec(epoch=1, kind="kernel_error")]).attach(vm)
    plan.advance()
    kernels.reset_launches()
    vm.svc_refresh_many(list(vm.views))
    counts = kernels.launch_counts()
    assert vm.fleet_merge_failures == 1 and counts["fleet_merge"] == 0
    assert counts["fused_clean"] >= len(vm.views)  # the per-view cleans launched
    assert not vm.health.quarantined() and len(plan.injected) == 1
    twin.svc_refresh_many(list(twin.views))
    for name in vm.views:
        a, b = to_host(vm.views[name].clean_sample), to_host(twin.views[name].clean_sample)
        assert np.array_equal(a["videoId"], b["videoId"])
        assert np.array_equal(a["visits"], b["visits"])
        np.testing.assert_allclose(a["totalBytes"], b["totalBytes"], rtol=1e-5)

    def boom(jobs):
        raise RuntimeError("a real fleet failure")

    plan.advance()  # no fault scheduled: the pending deltas batch again
    monkeypatch.setattr(M, "fleet_clean_merge", boom)
    with pytest.raises(RuntimeError, match="a real fleet failure"):
        vm.svc_refresh_many(list(vm.views), isolate=True)
    assert vm.fleet_merge_failures == 1
