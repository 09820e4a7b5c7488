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
value); the f32 smoke models (dense, moe, vlm, encdec) and the MoE FFN
on the card within 1e-4 of the CPU, the FFN's keep mask and load exact.  Under a
kernel profiler every wrapper dispatches once per call and never takes
its plain version; an injected kernel_error degrades the batched clean on
the card to per-view cleans whose samples equal a fault-free manager's
(keys and counts exact, sums within 1e-5 relative), while a real failure
still raises.  Training (``-k train``): the flash gradient on the card
within 1e-4 (f32) and 2^-7 (bf16) of each gradient's largest magnitude
from the CPU's autograd of the plain version, one train step of the
gemma-2b smoke config within 1e-5 (loss, grad norm) and 1e-4 (each
gradient, of its leaf's largest) of the CPU's, the backward's bf16
products accumulated in f32, 2 × n_layers flash launches a step under
remat, and a served decode step that casts no parameter.  The hybrid, ssm
and encdec smoke configs' train steps on the card within the same limits of
the CPU's, and the flash forward and gradient at the banded (window
128), encoder (non-causal) and cross (S != T) training shapes within
1e-4 (f32) and 2^-7 (bf16) of the plain version's largest magnitude.
The backward kernel (``-k flash_bwd``): dq, dk, dv against autograd of
the plain version within 1e-5 relative L2 in float32 and 1e-2 in bf16
(the outputs rounded to bf16), and in bf16 no farther from it than SDPA's
backward, for every mask mode, K = 1 and K = H and head dims
16 to 256, and on the warpgroup route (bf16 at head_dim 64, 128, 256) at
ragged key and query counts, grouped heads and a wrapped ring; the four
training shapes on that route; two calls bit-equal; the forward's
log-sum-exp within 1e-5 of the plain one, and written only by the
training forward.  Several cards (``-k "card or mesh"``): every wrapper
on ``torch.device("cuda")`` equal to ``cuda:0`` (integer and boolean
outputs exact, floats within 1e-5 of the largest magnitude, 1e-4 for the
attention), the library's runtime on the card PyTorch made current, the
sharded fleet over ``[cuda:0] * 2`` equal to the stacked fleet; and, with
two or more cards (else skipped, saying how many were seen), every
wrapper on the last card against its plain version, the fleet and both
sharded group-bys one shard a card against the same on ``cuda:0`` (plan
and counts exact, sums within 1e-5), and both launchers on the last card.
AdamW (``-k adamw``): the kernel's norm and update against the plain
version over a tree of odd sizes (a leaf at an offset of one element among
them), four steps through warm-up and the cosine, the clip on and off:
step exact, lr, grad_norm, clip_scale, bc1, bc2 within 1e-6 relative,
every p, m, v within 2 ulp or 1e-6 of the leaf's largest magnitude; two
runs bit-equal; one launch of each kernel a step for 3 leaves and for 500,
and for 1,500 (past one launch's table) ⌈1,500 / 704⌉ of each, held to the
plain version as above;
no synchronize; a raise for a non-float32 leaf, a CPU leaf and an int64
step; leaves on the last card launch there (two or more cards) and leaves
on two cards raise; gemma-2b's smoke config trained three steps on the
card and the CPU within the smoke's limits (loss and grad norm 1e-5, lr
and clip_scale 1e-6, the parameters 2e-2 of the update's norm).
The sLSTM's recurrence (``-k slstm``): the forward and backward kernels
against the plain version at xlstm-1.3b's widths over 512 steps (hs, the
last state, the saved gates and states, dwx and dR within SLSTM_TOL of
each one's largest magnitude), at ragged rows from a given state and the
decode's one step with rows within SLSTM_CPU_TOL of the CPU's; two runs
bit-equal; the resident route's every output ``torch.equal`` to the
per-step route's at (8, 512, 2,048), (17, 48, 128), (3, 100, 64) and
(2, 512, 2,048); resident calls on two streams at once equal to the same
calls in series; the route rule's launches a call (1 resident, S
per-step) and no synchronize; a cooperative grid the card cannot hold
refused and raised; a width that is not a multiple of 64 refused; xlstm's
smoke config trained one step under each remat mode within the train
step's limits of the CPU's.
The cross-entropy (``-k cross_entropy``): the forward and backward kernels
against the plain version at V = 50,304, 256,000 and 256,206 (rows off the
16-byte grid in bf16) over 37 rows, float32 and bf16, int32 and int64
labels, wrapped and out-of-range labels, a row of -inf and a row of ties:
lse and nll within CE_TOL of their largest magnitude, NaN and infinities
where the plain version has them, the gradient within 1e-6 of each row's
largest (float32) or one bf16 ulp; 8,400 rows of 256,000 (past 2^31
elements); two runs bit-equal; one launch of each a call through
``train_step.cross_entropy`` with no synchronize; a raise, and no
launch, for what the kernels do not take; the last card (two or more).
"""

import ctypes

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
from repro_torch.kernels.fleet_score import N_FEATURES, N_SCORES, fleet_score_ref, fleet_scores
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
    from repro_torch.kernels.outlier_member import pin_table

    builds, hashes = (digest_table.launches, pin_table.launches), pinned_hash.launches
    vms["cuda"].svc_refresh("v0")
    torch.cuda.synchronize()
    assert (digest_table.launches, pin_table.launches) == builds
    assert pinned_hash.launches > hashes
    vms["cpu"].svc_refresh("v0")
    a, b = (to_host(vms[d].views["v0"].clean_sample) for d in ("cuda", "cpu"))
    for col in ("videoId", "visits", "__outlier"):
        assert np.array_equal(a[col], b[col]), col
    assert a["__outlier"].sum() > 0
    np.testing.assert_allclose(a["totalBytes"], b["totalBytes"], rtol=1e-5)


# arenas of (slots, valid slots, key columns): visitView's pin (1.5M slots,
# 104 valid), tables of 2,047, 2,048 and 2,049 entries, every slot valid,
# none valid, one valid
PIN_ARENAS = [(1_500_000, 104, 1), (5_000, 2_046, 2), (5_000, 2_047, 1), (2_048, 2_048, 3),
              (5_000, 2_048, 4), (300, 0, 1), (300, 1, 2), (1, 1, 1)]


def _pin_arena(slots, n_valid, ncols, dev, seed=0):
    rng = np.random.default_rng(seed + slots + n_valid)
    cols = tuple(torch.from_numpy(rng.integers(-50, 1_000_000, slots).astype(np.int32)).to(dev)
                 for _ in range(ncols))
    valid = np.zeros(slots, bool)
    valid[rng.choice(slots, n_valid, replace=False)] = True
    return cols, torch.from_numpy(valid).to(dev)


@pytest.mark.parametrize("slots,n_valid,ncols", PIN_ARENAS)
@pytest.mark.parametrize("offset", [0, 1])
def test_pin_table_is_one_launch_equal_to_its_plain_version(dev, slots, n_valid, ncols, offset):
    """One launch over the arena and one host wait, no torch synchronize,
    the table ``torch.equal`` to the plain version's and to the composed
    table; past 2,048 entries the composed route, two launches.  At
    ``offset`` 1 the arena starts one slot into its columns, so its
    validity is not 16-byte aligned and the kernel reads it a byte a lane."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.outlier_member import compact_pin_keys, pin_launches, pin_table
    from repro_torch.kernels.outlier_member.ref import pin_table_ref

    cols, valid = _pin_arena(slots + offset, n_valid, ncols, dev)
    if offset:
        cols, valid = tuple(c[offset:] for c in cols), valid[offset:]
        n_valid = int(valid.sum())
    args = (cols, valid)
    entries = n_valid + int(n_valid < slots)
    want = pin_table_ref(*args)
    assert want.shape == (entries,)
    assert torch.equal(want, sorted_digest_table(compact_pin_keys(*args)))
    pin_table(*args)  # built and warm
    torch.cuda.synchronize()
    before, routes, waits = pin_table.launches, dict(pin_table.routes), _build.wait.calls
    if entries <= MAX_SMEM_KEYS:
        torch.cuda.set_sync_debug_mode("error")
    try:
        got = pin_table(*args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert pin_table.launches - before == pin_launches(entries)
    assert pin_table.routes["arena"] - routes["arena"] == 1
    assert pin_table.routes["sort"] - routes["sort"] == int(entries > MAX_SMEM_KEYS)
    assert _build.wait.calls - waits == 1
    assert got.device == want.device and torch.equal(got, want)
    assert torch.equal(pin_table(*args), got)  # the workspace is zero again
    if entries <= MAX_SMEM_KEYS:
        assert _device_launches(lambda: pin_table(*args)) == 1


@pytest.mark.parametrize("K", [1, 2, 105, 1000, MAX_SMEM_KEYS])
@pytest.mark.parametrize("ncols", [1, 4])
def test_digest_table_block_route_is_one_launch(dev, K, ncols):
    """Up to 2,048 key tuples one block digests and sorts them: one device
    launch, no sort, the plain table."""
    from repro_torch.kernels.outlier_member import table_route

    keys = _keys(np.random.default_rng(K + 10 * ncols), K, ncols, dev, high=3000)
    assert table_route(K) == "block"
    before = dict(digest_table.routes)
    got = digest_table(keys)
    torch.cuda.synchronize()
    assert digest_table.routes["block"] == before["block"] + 1
    assert digest_table.routes["sort"] == before["sort"]
    assert torch.equal(got, sorted_digest_table(keys))
    assert _device_launches(lambda: digest_table(keys)) == 1


def test_pin_tables_of_two_streams_at_once(dev):
    """Two pins' tables built on two streams, each with its own workspace,
    equal the same builds in series."""
    from repro_torch.kernels.outlier_member import pin_table

    a = _pin_arena(1_500_000, 104, 1, dev, seed=1)
    b = _pin_arena(200_000, 1_500, 2, dev, seed=2)
    want = [pin_table(*a), pin_table(*b)]
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    torch.cuda.synchronize()
    with torch.cuda.stream(s1):
        got_a = pin_table(*a)
    with torch.cuda.stream(s2):
        got_b = pin_table(*b)
    torch.cuda.synchronize()
    assert torch.equal(got_a, want[0]) and torch.equal(got_b, want[1])


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
# the moe, vlm and encdec families: flash at their shapes, the MoE FFN and
# each family's smoke model on the card against the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,T,H,K,hd,causal", [
    (8, 1, 80, 24, 8, 64, False),          # granite-moe-3b-a800m decode
    (2, 512, 512, 64, 8, 128, True),       # qwen2-vl-72b causal prefill
    (4, 1024, 1024, 16, 16, 64, False),    # seamless encoder, bidirectional
    (4, 8, 1024, 16, 16, 64, False),       # seamless cross attention, prefill
    (4, 1, 1024, 16, 16, 64, False)])      # seamless cross attention, decode
def test_flash_attention_kernel_at_the_new_family_shapes(dev, dtype, B, S, T, H, K, hd, causal):
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref

    q, k, v = _qkv(B, S, T, H, K, hd, dtype, dev, seed=S + T)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = flash_attention_ref(q, k, v, causal=causal)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("arch,n_tokens", [("granite-moe-3b-a800m", 8),
                                           ("granite-moe-3b-a800m", 96), ("grok-1-314b", 40)])
def test_moe_ffn_on_the_card_matches_the_cpu(dev, arch, n_tokens):
    """The smoke config's MoE FFN (f32, TF32 off) on the card: keep mask
    and load exact, y within 1e-4 of the CPU; and it never synchronizes
    with the host (sync debug mode raises on any synchronizing op)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.moe import moe_capacity, moe_ffn_local, route

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config(arch)
    g = torch.Generator().manual_seed(n_tokens)
    E, d, F = cfg.moe_experts, cfg.d_model, cfg.d_ff
    x = torch.randn(n_tokens, d, generator=g)
    ws = [torch.randn(shape, generator=g) * shape[-2] ** -0.5
          for shape in ((d, E), (E, d, F), (E, d, F), (E, F, d))]
    cap = moe_capacity(cfg, n_tokens)
    y_cpu, load_cpu = moe_ffn_local(x, *ws, cfg, cap)
    xd, wd = x.to(dev), [w.to(dev) for w in ws]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y, load = moe_ffn_local(xd, *wd, cfg, cap)
        r = route(xd, wd[0], cfg, cap)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(load.cpu(), load_cpu)
    assert torch.equal(r.keep.cpu(), route(x, ws[0], cfg, cap).keep)
    torch.testing.assert_close(y.cpu(), y_cpu, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "qwen2-vl-72b", "seamless-m4t-large-v2"])
def test_new_family_smoke_models_on_the_card_match_the_cpu(dev, arch):
    """Each new family's smoke config (f32) from one set of weights:
    forward (qwen2-vl with its vision stub, seamless over stub frames),
    prefill and 8 decode steps on the card equal the CPU's within 1e-4."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import get_model

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config(arch)
    cpu, card = get_model(cfg, device="cpu"), get_model(cfg, device=dev)
    p_cpu, p_card = cpu.init(0), card.init(0)
    p_card.load_state_dict(p_cpu.state_dict())
    g = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 12), generator=g)}
    if cfg.n_vision_tokens:
        batch["vision_embeds"] = torch.randn(2, cfg.n_vision_tokens, 1024, generator=g)
    if cfg.family == "encdec":
        batch["frames"] = torch.randn(2, 20, cfg.d_model, generator=g)
    on_card = {k: t.to(dev) for k, t in batch.items()}
    torch.testing.assert_close(card.forward(p_card, on_card)[0].cpu(),
                               cpu.forward(p_cpu, batch)[0], rtol=1e-4, atol=1e-4)
    lc, c_cpu = cpu.prefill(p_cpu, batch, cache_len=24)
    lg, c_card = card.prefill(p_card, on_card, cache_len=24)
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)
    for i in range(8):
        tok = batch["tokens"][:, i:i + 1]
        lc, c_cpu = cpu.decode_step(p_cpu, c_cpu, tok, 12 + i)
        lg, c_card = card.decode_step(p_card, c_card, tok.to(dev), 12 + i, rows=[0, 1])
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


# ---------------------------------------------------------------------------
# The sharded fleet on the card
# ---------------------------------------------------------------------------

def _sharded_features(S, vmax, seed=0):
    rng = np.random.default_rng(seed)
    f = rng.exponential(5.0, (S, vmax, N_FEATURES)).astype(np.float32)
    f[-1, vmax // 2:] = 0.0  # the last shard's padding lanes
    return f


@pytest.mark.parametrize("S,vmax", [(1, 1), (4, 4), (4, 16), (3, 700)])
def test_fleet_scores_sharded_is_one_launch_bit_equal_shard_by_shard(dev, S, vmax):
    """On one card the (S, Vmax, F) stack is one launch, bit-equal to the
    plain score of each shard's panel; under the profiler it dispatches
    once as fleet_score_sharded, never as a fallback."""
    from repro_torch.kernels.fleet_score import fleet_scores_sharded
    from repro_torch.obs.kprof import KernelProfiler, get_profiler, set_profiler

    f = _sharded_features(S, vmax)
    x = torch.from_numpy(f).to(dev)
    before = fleet_scores_sharded.launches
    got = fleet_scores_sharded(x)
    assert fleet_scores_sharded.launches == before + 1
    for s in range(S):
        want = fleet_score_ref(x[s].contiguous())
        assert torch.equal(got[s].view(torch.int32), want.view(torch.int32))
    assert torch.equal(got.reshape(S * vmax, -1), fleet_scores(x.reshape(S * vmax, N_FEATURES)))
    prof = set_profiler(KernelProfiler())
    try:
        fleet_scores_sharded(x, shard_views=[vmax] * S)
    finally:
        set_profiler(None)
    st = prof.summary()["fleet_score_sharded"]
    assert (st["dispatches"], st["fallbacks"]) == (1, 0)
    assert sorted(prof.shard_summary()["shards"]["fleet_score_sharded"]) == list(range(S))
    assert get_profiler() is None


def test_fleet_scores_sharded_on_a_mesh_of_the_card_scores_each_shard(dev):
    """A LocalMesh whose data axis repeats cuda:0: one launch per shard
    through the staging pair, the scores on the mesh's first device in
    shard order, bit-equal to the one-launch path."""
    from repro_torch.kernels.fleet_score import fleet_scores_sharded
    from repro_torch.launch.mesh import LocalMesh

    x = torch.from_numpy(_sharded_features(4, 16)).to(dev)
    mesh = LocalMesh([dev] * 4, {"data": 4})
    before = fleet_scores_sharded.launches
    got = fleet_scores_sharded(x, mesh=mesh)
    assert fleet_scores_sharded.launches == before + 4
    assert got.device == x.device
    assert torch.equal(got.view(torch.int32), fleet_scores_sharded(x).view(torch.int32))


@pytest.mark.parametrize("V", [1, 16, 129, 4096])
def test_staged_fleet_score_is_bit_equal_to_plain(dev, V):
    """The planner's entry: a numpy panel through the card's mapped staging
    pair, one device launch and one host wait a score, no torch copy or
    synchronize, bit-equal to the plain score; each call's scores are its
    own array."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.fleet_score import fleet_scores_host

    rng = np.random.default_rng(V)
    f = np.abs(rng.normal(0, 1, (V, N_FEATURES))).astype(np.float32) * np.array(
        [5e3, 400, 20, 1e5, 1e5, 500, 900, 50, 2, 5, 100, 0.5, 3], np.float32)
    f[::3, 3] = 0.0
    f[::5] = 0.0
    f[1::4, 11] = rng.choice([1.0 / 512, 1.0, 1.5], len(f[1::4]))
    want = fleet_score_ref(torch.from_numpy(f)).numpy()
    fleet_scores_host(f, dev)  # built and warm
    before, waits = fleet_scores_host.launches, _build.wait.calls
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = fleet_scores_host(f, dev)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert fleet_scores_host.launches == before + 1 and _build.wait.calls == waits + 1
    assert isinstance(got, np.ndarray) and got.shape == (V, N_SCORES)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    other = fleet_scores_host(f[::-1].copy(), dev)  # the pair written over
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    assert not np.shares_memory(got, other)
    assert np.array_equal(other.view(np.int32), want[::-1].view(np.int32))
    assert _device_launches(lambda: fleet_scores_host(f, dev)) == 1


@pytest.mark.parametrize("S,vmax", [(1, 1), (4, 4), (4, 16), (3, 700)])
@pytest.mark.parametrize("per_device", [False, True])
def test_staged_sharded_score_is_bit_equal_shard_by_shard(dev, S, vmax, per_device):
    """The sharded fleet's score combine through one staging pair: one
    launch over the stack, or one a shard on its device (here every shard
    on this card), one host wait, bit-equal to the plain score of each
    shard's panel; under the profiler one dispatch, never a fallback."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.fleet_score import fleet_scores_sharded_host
    from repro_torch.obs.kprof import KernelProfiler, set_profiler

    f = _sharded_features(S, vmax)
    devices = [dev] * S if per_device else dev
    fleet_scores_sharded_host(f, devices)
    before, waits = fleet_scores_sharded_host.launches, _build.wait.calls
    got = fleet_scores_sharded_host(f, devices)
    launches = S if per_device else 1
    assert fleet_scores_sharded_host.launches == before + launches
    assert _build.wait.calls == waits + 1
    for s in range(S):
        want = fleet_score_ref(torch.from_numpy(f[s]))
        assert np.array_equal(got[s].view(np.int32), want.numpy().view(np.int32))
    prof = set_profiler(KernelProfiler())
    try:
        fleet_scores_sharded_host(f, devices, shard_views=[vmax] * S)
    finally:
        set_profiler(None)
    st = prof.summary()["fleet_score_sharded"]
    assert (st["dispatches"], st["fallbacks"]) == (1, 0)
    assert sorted(prof.shard_summary()["shards"]["fleet_score_sharded"]) == list(range(S))
    assert _device_launches(lambda: fleet_scores_sharded_host(f, devices)) == launches


def test_a_profiled_staged_dispatch_covers_its_launch(dev):
    """A profiled dispatch of a host entry times its wait: behind a spin
    kernel on the stream, each dispatch's recorded wall covers the spin,
    and its result is complete when it returns."""
    from repro_torch.kernels.fleet_score import fleet_scores_host
    from repro_torch.kernels.outlier_member import pin_table
    from repro_torch.kernels.outlier_member.ref import pin_table_ref
    from repro_torch.obs.kprof import KernelProfiler, set_profiler

    f = _sharded_features(1, 16)[0]
    keys, valid = _pin_arena(1_500_000, 104, 1, dev)
    want_scores = fleet_score_ref(torch.from_numpy(f)).numpy()
    want_table = pin_table_ref(keys, valid)
    cycles = 20_000_000
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    torch.cuda.synchronize()
    spin_s = start.elapsed_time(end) / 1e3
    assert spin_s > 1e-3
    for op, call, check in (
            ("fleet_score", lambda: fleet_scores_host(f, dev),
             lambda out: np.array_equal(out.view(np.int32), want_scores.view(np.int32))),
            ("outlier_digest", lambda: pin_table(keys, valid),
             lambda out: torch.equal(out, want_table))):
        call()  # built and warm
        prof = set_profiler(KernelProfiler())
        try:
            for _ in range(2):  # a compile, then an execute
                torch.cuda.synchronize()
                torch.cuda._sleep(cycles)
                assert check(call()), op
        finally:
            set_profiler(None)
        st = prof.summary()[op]
        assert (st["dispatches"], st["fallbacks"], st["compiles"]) == (2, 0, 1), op
        assert st["compile_s"] >= 0.5 * spin_s and st["execute_s"] >= 0.5 * spin_s, (op, st)


def _sharded_delta(G, R, seed=0):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, G, R).astype(np.int32)
    keys[: R // 8] = 3  # one hot group
    valid = rng.uniform(size=R) < 0.9
    vals = rng.exponential(10.0, R).astype(np.float32)
    return keys, valid, vals


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_sharded_delta_groupbys_on_the_card_match_the_cpu(dev, fused):
    """Both sharded group-bys over four shards of cuda:0 against the same
    calls over four CPU shards: counts equal, sums within rtol=1e-5,
    atol=1e-4 (JAX's tolerance between its two group-bys); each shard
    launches its kernels."""
    from repro_torch import kernels
    from repro_torch.core import distributed_svc as svc
    from repro_torch.launch.mesh import LocalMesh, make_local_mesh

    G, R, m, seed = 4096, 4 * 65_536, 0.3, 7
    keys, valid, vals = _sharded_delta(G, R)
    make = svc.make_sharded_fused_delta_groupby if fused else svc.make_sharded_delta_groupby

    def run(mesh, d):
        return make(mesh, "data", G, m, seed, ["bytes"])(
            torch.from_numpy(keys).to(d), torch.from_numpy(valid).to(d),
            {"bytes": torch.from_numpy(vals).to(d)})

    kernels.reset_launches()
    got = run(LocalMesh([dev] * 4, {"data": 4}), dev)
    counts = kernels.launch_counts()
    want = run(make_local_mesh(data=4, device="cpu"), "cpu")
    if fused:
        assert counts["fused_clean"] == 4
    else:
        assert counts["hash_threshold"] == 4 and counts["segment_aggsum_unsorted"] == 4
    assert torch.equal(got["count"].cpu(), want["count"])
    np.testing.assert_allclose(got["bytes"].cpu().numpy(), want["bytes"].numpy(), rtol=1e-5,
                               atol=1e-4)
    assert 0 < float(want["count"].sum()) < R


def test_sharded_fleet_epoch_on_the_card_matches_the_cpu(dev):
    """A two-shard fleet on the card: the epoch's plan equals the CPU
    fleet's, its score combine is one fleet_score_sharded launch with no
    fallback, and every view answers as on the CPU (sums within 1e-5)."""
    from repro_torch import kernels
    from repro_torch.core import Query, ViewDef
    from repro_torch.distributed import ShardedFleet
    from repro_torch.obs.kprof import KernelProfiler, set_profiler
    from repro_torch.relational.plan import GroupByNode, Scan
    from repro_torch.relational.relation import from_columns

    def fleet_on(device):
        clock = lambda: 0.0  # noqa: E731
        fleet = ShardedFleet(n_shards=2, budget_s=10.0, clock=clock, heartbeat_timeout_s=1e9,
                             device=device)
        rng = np.random.default_rng(5)
        for i in range(4):
            n = 20_000
            fleet.register_base(f"Log{i}", from_columns(
                {"sessionId": np.arange(n, dtype=np.int32),
                 "videoId": rng.integers(0, 3000, n).astype(np.int32),
                 "bytes": rng.exponential(10.0, n).astype(np.float32)},
                pk=["sessionId"], capacity=2 * n, device=device))
            plan = GroupByNode(child=Scan(f"Log{i}", pk=("sessionId",)), keys=("videoId",),
                               aggs=(("totalBytes", "sum", "bytes"), ("visits", "count", None)),
                               num_groups=6000)
            fleet.register_view(ViewDef(f"v{i}", plan), delta_bases=(f"Log{i}",), m=0.25,
                                seed=i, delta_group_capacity=6000)
        for cm in fleet.cost_models:
            cm.pin_costs(0.05, 0.25)
        for i in range(4):
            fleet.ingest(f"Log{i}", inserts=from_columns(
                {"sessionId": np.arange(10**6, 10**6 + 5000, dtype=np.int32),
                 "videoId": rng.integers(0, 3000, 5000).astype(np.int32),
                 "bytes": rng.exponential(10.0, 5000).astype(np.float32)},
                pk=["sessionId"], device=device), seq=0)
        return fleet

    card, cpu = fleet_on("cuda"), fleet_on("cpu")
    kernels.reset_launches()
    prof = set_profiler(KernelProfiler())
    try:
        rep = card.epoch_step()
    finally:
        set_profiler(None)
    want = cpu.epoch_step()
    # the score combine through the staging pair: one launch over the stack
    counts = kernels.launch_counts()
    assert (counts["fleet_score_sharded_host"], counts["fleet_score_sharded"]) == (1, 0)
    assert all(st["fallbacks"] == 0 for st in prof.summary().values())
    assert [(a.view, a.action, a.shard) for a in rep.actions] == \
        [(a.view, a.action, a.shard) for a in want.actions]
    assert card.pending_rows() == cpu.pending_rows() == 0
    q = Query("sum", "totalBytes")
    for i in range(4):
        a, b = card.query(f"v{i}", q), cpu.query(f"v{i}", q)
        np.testing.assert_allclose(float(a.value), float(b.value), rtol=1e-5)


# ---------------------------------------------------------------------------
# Several cards: every wrapper on the card that holds its tensors
# ---------------------------------------------------------------------------

@pytest.fixture
def last_card():
    """The last of two or more visible cards; skips with the count seen."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"needs two or more CUDA devices, {n} visible")
    return torch.device("cuda", n - 1)


def _leaves(x):
    if isinstance(x, (torch.Tensor, np.ndarray)):
        return [x]
    return [t for y in x for t in _leaves(y)]


def _hold_outputs(name, got, want, device):
    """Every output of ``got`` on ``device`` (a host entry's numpy output on
    the host); integer and boolean outputs equal to ``want``'s, float ones
    within 1e-5 of the largest magnitude (1e-4 for the attention: f32 sums
    in another order)."""
    got, want = _leaves(got), _leaves(want)
    assert len(got) == len(want), name
    for a, b in zip(got, want):
        if isinstance(a, np.ndarray):
            assert isinstance(b, np.ndarray), name
            a, b = torch.from_numpy(a), torch.from_numpy(b)
        else:
            assert a.device == device, (name, a.device)
        a, b = a.cpu(), b.cpu()
        if not b.is_floating_point():
            assert torch.equal(a, b), name
            continue
        if b.numel() == 0:
            continue
        tol = (1e-4 if name.startswith("flash") else 1e-5) * max(1.0, float(b.abs().max()))
        assert float((a.double() - b.double()).abs().max()) <= tol, name


def test_every_wrapper_on_cuda_without_an_index_is_cuda_0(dev):
    """Tensors made on ``torch.device("cuda")`` launch on the current card
    (card 0) and equal the same call on ``cuda:0``: the per-card caches key
    both as cuda:0."""
    from torch_wrapper_calls import wrapper_calls

    from repro_torch import kernels
    from repro_torch.kernels import _build
    from repro_torch.kernels.fused_clean.ops import overflow_counter

    assert torch.cuda.current_device() == 0
    cuda0 = torch.device("cuda", 0)
    bare, zero = wrapper_calls(torch.device("cuda")), wrapper_calls(cuda0)
    for name in bare:
        before = kernels.launch_counts()[name]
        got = bare[name]()
        assert kernels.launch_counts()[name] > before, name
        _hold_outputs(name, got, zero[name](), cuda0)
    assert overflow_counter(torch.device("cuda")) is overflow_counter(cuda0)
    assert _build.check_cuda(torch.device("cuda")) == 0
    assert _build.stream(torch.device("cuda")) == torch.cuda.current_stream(0).cuda_stream
    assert 0 in _build._runtime_checked
    with pytest.raises(ValueError, match="not a visible CUDA device"):
        _build.check_cuda(torch.device("cuda", torch.cuda.device_count()))


def test_the_librarys_runtime_follows_the_current_card(dev):
    """The library's own CUDA runtime reports the card PyTorch made
    current, on every visible card."""
    from repro_torch.kernels import _build

    lib = _build.library()
    lib.svc_current_device.restype = ctypes.c_int
    for i in range(torch.cuda.device_count()):
        with torch.cuda.device(i):
            assert lib.svc_current_device() == i
    assert lib.svc_current_device() == torch.cuda.current_device()


def test_sharded_fleet_over_a_mesh_of_the_card_equals_the_stacked_fleet(dev):
    """ShardedFleet over LocalMesh([cuda:0] * 2): each shard's panel scored
    in a launch of its own (the per-device branch), the plan and every
    answer equal to the same fleet without a mesh, whose score combine is
    one launch over the stack."""
    from repro_torch import kernels
    from repro_torch.core import Query
    from repro_torch.launch.mesh import LocalMesh

    mesh = LocalMesh([torch.device("cuda", 0)] * 2, {"data": 2})
    plain, meshed = _fleet_on_card("cuda"), _fleet_on_card("cuda", mesh=mesh)
    assert meshed.devices == [torch.device("cuda", 0)] * 2
    kernels.reset_launches()
    got = meshed.epoch_step()
    counts = kernels.launch_counts()
    assert (counts["fleet_score_sharded_host"], counts["fleet_score_sharded"]) == (2, 0)
    want = plain.epoch_step()
    assert [(a.view, a.action, a.shard, a.score) for a in got.actions] == \
        [(a.view, a.action, a.shard, a.score) for a in want.actions]
    q = Query("sum", "totalBytes")
    for i in range(4):
        assert float(meshed.query(f"v{i}", q).value) == float(plain.query(f"v{i}", q).value)


def _fleet_on_card(device, mesh=None, n_views=4):
    from repro_torch.core import ViewDef
    from repro_torch.distributed import ShardedFleet
    from repro_torch.relational.plan import GroupByNode, Scan
    from repro_torch.relational.relation import from_columns

    fleet = ShardedFleet(n_shards=2 if mesh is None else len(mesh.devices), budget_s=10.0,
                         clock=lambda: 0.0, heartbeat_timeout_s=1e9, device=device, mesh=mesh)
    rng = np.random.default_rng(5)
    for i in range(n_views):
        n = 20_000
        fleet.register_base(f"Log{i}", from_columns(
            {"sessionId": np.arange(n, dtype=np.int32),
             "videoId": rng.integers(0, 3000, n).astype(np.int32),
             "bytes": rng.exponential(10.0, n).astype(np.float32)},
            pk=["sessionId"], capacity=2 * n, device="cpu"))
        plan = GroupByNode(child=Scan(f"Log{i}", pk=("sessionId",)), keys=("videoId",),
                           aggs=(("totalBytes", "sum", "bytes"), ("visits", "count", None)),
                           num_groups=6000)
        fleet.register_view(ViewDef(f"v{i}", plan), delta_bases=(f"Log{i}",), m=0.25,
                            seed=i, delta_group_capacity=6000)
    for cm in fleet.cost_models:
        cm.pin_costs(0.05, 0.25)
    for i in range(n_views):
        fleet.ingest(f"Log{i}", inserts=from_columns(
            {"sessionId": np.arange(10**6, 10**6 + 5000, dtype=np.int32),
             "videoId": rng.integers(0, 3000, 5000).astype(np.int32),
             "bytes": rng.exponential(10.0, 5000).astype(np.float32)},
            pk=["sessionId"], device="cpu"), seq=0)
    return fleet


def test_every_wrapper_on_the_last_card_matches_its_plain_version(last_card):
    """Each wrapper of ``torch_wrapper_calls`` on tensors of the last card
    launches there, counted once a call, and equals its plain version."""
    from torch_wrapper_calls import wrapper_calls

    from repro_torch import kernels
    from repro_torch.kernels import _build
    from repro_torch.obs.kprof import KernelProfiler

    calls, plain = wrapper_calls(last_card), wrapper_calls("cpu")
    ops = kernels.op_names()
    try:
        for name, call in calls.items():
            call()
            prof = kernels.set_profiler(KernelProfiler())
            before = kernels.launch_counts()[name]
            got = call()
            assert kernels.launch_counts()[name] > before, name
            assert prof.summary()[ops[name]]["fallbacks"] == 0
            kernels.set_profiler(None)
            _hold_outputs(name, got, plain[name](), last_card)
            assert torch.cuda.current_device() == 0  # switched back after the launch
    finally:
        kernels.set_profiler(None)
    assert last_card.index in _build._runtime_checked


def test_sharded_fleet_across_cards_matches_the_flat_twin(last_card):
    """One shard a card (up to four): every shard's bases and samples on
    its card, one fleet_score launch per shard, and the plan and answers
    of the fleet with every shard on cuda:0."""
    from repro_torch import kernels
    from repro_torch.core import Query
    from repro_torch.launch.mesh import make_local_mesh

    S = min(4, torch.cuda.device_count())
    mesh = make_local_mesh(data=S)
    spread, flat = _fleet_on_card("cuda", mesh=mesh), _fleet_on_card(
        "cuda", mesh=type(mesh)([torch.device("cuda", 0)] * S, {"data": S}))
    for s, vm in enumerate(spread.vms):
        for rel in list(vm.base.values()) + [mv.clean_sample for mv in vm.views.values()]:
            assert rel.valid.device == torch.device("cuda", s)
    kernels.reset_launches()
    got = spread.epoch_step()
    counts = kernels.launch_counts()
    assert (counts["fleet_score_sharded_host"], counts["fleet_score_sharded"]) == (S, 0)
    want = flat.epoch_step()
    assert [(a.view, a.action, a.shard, a.score) for a in got.actions] == \
        [(a.view, a.action, a.shard, a.score) for a in want.actions]
    assert spread.pending_rows() == flat.pending_rows() == 0
    q = Query("sum", "totalBytes")
    for i in range(4):
        a, b = spread.query(f"v{i}", q), flat.query(f"v{i}", q)
        np.testing.assert_allclose(float(a.value), float(b.value), rtol=1e-5)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_sharded_delta_groupbys_across_cards_match_one_card(last_card, fused):
    """Both sharded group-bys with one shard a card against the same calls
    over shards of cuda:0: counts equal, sums within rtol=1e-5, atol=1e-4."""
    from repro_torch.core import distributed_svc as svc
    from repro_torch.launch.mesh import LocalMesh, make_local_mesh

    S = min(4, torch.cuda.device_count())
    G, R, m, seed = 4096, S * 65_536, 0.3, 7
    keys, valid, vals = _sharded_delta(G, R)
    make = svc.make_sharded_fused_delta_groupby if fused else svc.make_sharded_delta_groupby
    args = (torch.from_numpy(keys).to(dev := torch.device("cuda", 0)),
            torch.from_numpy(valid).to(dev), {"bytes": torch.from_numpy(vals).to(dev)})
    got = make(make_local_mesh(data=S), "data", G, m, seed, ["bytes"])(*args)
    want = make(LocalMesh([dev] * S, {"data": S}), "data", G, m, seed, ["bytes"])(*args)
    assert got["count"].device == dev
    assert torch.equal(got["count"], want["count"])
    np.testing.assert_allclose(got["bytes"].cpu().numpy(), want["bytes"].cpu().numpy(),
                               rtol=1e-5, atol=1e-4)


def test_the_serve_launcher_runs_on_the_last_card(last_card):
    from repro_torch.launch.serve import main

    """``--device cuda:N``: the model, its cache and every launch on card N;
    card 0 gains nothing, and is current again after."""
    torch.cuda.reset_peak_memory_stats(last_card)
    on_0 = torch.cuda.memory_allocated(0)
    out = main(["--smoke", "--device", str(last_card), "--requests", "4", "--max-new", "4"])
    assert out["completed"] == 4 and torch.cuda.current_device() == 0
    assert torch.cuda.max_memory_allocated(last_card) > 0
    assert torch.cuda.memory_allocated(0) == on_0


def test_the_train_launcher_runs_on_the_last_card(last_card):
    """``--device cuda:N`` trains on card N: the flash forward and backward
    launch there, card 0 gains nothing, and card 0 is current again after."""
    from repro_torch import kernels
    from repro_torch.launch import train

    on_0 = torch.cuda.memory_allocated(0)
    kernels.reset_launches()
    out = train.main(["--arch", "gemma-2b", "--smoke", "--device", str(last_card), "--steps",
                      "3", "--batch", "2", "--seq", "64", "--svc-every", "2"])
    launches = kernels.launch_counts()
    assert out["steps"] == 3 and np.isfinite(out["last_loss"])
    assert launches["flash_attention"] > 0 and launches["flash_attention_bwd"] > 0
    assert torch.cuda.current_device() == 0 and torch.cuda.memory_allocated(0) == on_0


# ---------------------------------------------------------------------------
# the hybrid and ssm families: flash's banded window and ring-buffer
# (key_pos) masks on both routes, the earlier modes byte for byte, and each
# family's smoke model on the card against the CPU
# ---------------------------------------------------------------------------

def _ring_positions(W, pos, holes, seed, dev):
    """A (W,) int32 pos_buf after decodes up to ``pos`` (slot p % W holds
    the newest p), ``holes`` slots other than pos's emptied (-1), rotated."""
    buf = torch.full((W,), -1, dtype=torch.int32)
    for p in range(max(0, pos - W + 1), pos + 1):
        buf[p % W] = p
    g = torch.Generator().manual_seed(seed)
    others = torch.tensor([s for s in range(W) if s != pos % W])
    buf[others[torch.randperm(len(others), generator=g)[:holes]]] = -1
    return buf.to(dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,T,H,K,hd,window,qpos", [
    (2, 40, 40, 4, 1, 16, 16, 0),          # the hybrid smoke config's forward
    (4, 3, 40, 16, 1, 16, 5, 37),          # three queries at an offset, key splits
    (2, 33, 50, 16, 1, 16, 8, 17),
    (1, 600, 600, 16, 1, 256, 128, 0),     # recurrentgemma's heads, a window of 128
    (3, 1, 300, 16, 1, 256, 64, 299),      # one query, banded
    (1, 100, 100, 16, 1, 256, 1, 0)])      # window 1: the diagonal alone
def test_flash_banded_window_matches_plain(dev, dtype, B, S, T, H, K, hd, window, qpos):
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref

    q, k, v = _qkv(B, S, T, H, K, hd, dtype, dev, seed=S * 7 + window)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=True, window=window, qpos=qpos)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = flash_attention_ref(q, k, v, True, window, None, qpos)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("M", [4, 64])
def test_bf16_products_accumulate_in_f32_under_the_entry_points(dev, M):
    """xlstm-1.3b's mLSTM gate projection (K = 4,096, N = 4), which cuBLAS
    takes by split-K: under ``f32_accumulation`` (every model entry point)
    each bf16 output is the float32 product rounded once, or the bf16
    value next to it where the two float32 sums straddle a rounding."""
    from repro_torch.models.layers import f32_accumulation

    g = torch.Generator(device=dev).manual_seed(M)
    xu = torch.randn(M, 4096, generator=g, device=dev).bfloat16()
    w = (torch.randn(4096, 4, generator=g, device=dev) / 64).bfloat16()
    ref = xu.float() @ w.float()
    with f32_accumulation():
        got = (xu @ w).float()
    step = ref.abs() * 2.0 ** -7 + 1e-30
    assert bool(((got - ref).abs() <= step).all())
    assert float((got == ref.bfloat16().float()).float().mean()) >= 0.9


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_window_past_the_keys_raises_without_a_launch(dev, dtype):
    """An index-position window that leaves the last row no key raises on
    the card as the plain version does, and launches nothing."""
    from repro_torch.kernels.flash_attention import flash_attention

    q, k, v = _qkv(1, 3, 40, 16, 1, 256, dtype, dev, seed=5)
    before = flash_attention.launches
    with pytest.raises(ValueError, match="keeps no key"):
        flash_attention(q, k, v, causal=True, window=5, qpos=42)
    assert flash_attention.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,W,H,K,hd,pos,holes", [
    (2, 16, 4, 1, 16, 37, 3),              # the smoke config's ring, wrapped
    (3, 16, 16, 1, 16, 9, 0),              # not yet full: empty slots at -1
    (4, 2048, 16, 1, 256, 4095, 7),        # recurrentgemma-9b's ring, wrapped, key splits
    (1, 2048, 16, 1, 256, 3000, 100)])
def test_flash_ring_decode_matches_plain(dev, dtype, B, W, H, K, hd, pos, holes):
    """One query at ``pos`` against the ring's W slots through key_pos (on
    a strided cache view), as rglru's decode calls it."""
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref

    g = torch.Generator(device=dev).manual_seed(W + pos)
    cache = torch.randn(2, 2, B, W, K, hd, generator=g, device=dev).to(dtype)
    k, v = cache[1, 0], cache[1, 1]
    q = torch.randn(B, 1, H, hd, generator=g, device=dev).to(dtype)
    kp = _ring_positions(W, pos, holes, pos, dev)
    before = flash_attention.launches
    got = flash_attention(q, k, v, key_pos=kp, qpos=pos, window=W)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = flash_attention_ref(q, k, v, True, W, kp, pos)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    # the slots the mask drops do not matter: scrambling them changes nothing
    drop = (kp < 0) | (kp > pos) | (kp <= pos - W)
    if bool(drop.any()):
        k2 = k.clone()
        k2[:, drop] = 1e4
        assert torch.equal(flash_attention(q, k2, v, key_pos=kp, qpos=pos, window=W), got)


def test_flash_default_modes_give_the_bytes_of_the_previous_kernel(dev):
    """The causal and non-causal modes, on both routes, with and without key
    splits, give the bytes the kernel gave before the masks were added
    (``torch_flash_cases.DIGESTS``)."""
    from torch_flash_cases import DIGESTS, flash_digests

    assert flash_digests(str(dev)) == DIGESTS


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "xlstm-1.3b"])
def test_recurrent_smoke_models_on_the_card_match_the_cpu(dev, arch):
    """Each recurrent family's smoke config (f32, TF32 off) from one set of
    weights: forward over 24 tokens (past the hybrid's window of 16) and 24
    decode steps (the ring wraps), the last 8 for rows [0, 1] of 3, on the
    card equal the CPU's within 1e-4, logits and every cache leaf."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import get_model

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config(arch)
    cpu, card = get_model(cfg, device="cpu"), get_model(cfg, device=dev)
    p_cpu, p_card = cpu.init(0), card.init(0)
    p_card.load_state_dict(p_cpu.state_dict())
    toks = torch.randint(0, cfg.vocab, (3, 24), generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(card.forward(p_card, {"tokens": toks.to(dev)})[0].cpu(),
                               cpu.forward(p_cpu, {"tokens": toks})[0], rtol=1e-4, atol=1e-4)
    c_cpu, c_card = cpu.init_cache(3, 32), card.init_cache(3, 32)
    for i in range(24):
        rows = [0, 1] if i >= 16 else None
        lc, c_cpu = cpu.decode_step(p_cpu, c_cpu, toks[:, i:i + 1], i, rows)
        lg, c_card = card.decode_step(p_card, c_card, toks[:, i:i + 1].to(dev), i, rows)
        torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)
    leaves = [(k, v) for k, v in c_cpu.items() if v is not None]
    for key, leaf in leaves:
        for a, b in zip(leaf if isinstance(leaf, tuple) else (leaf,),
                        c_card[key] if isinstance(leaf, tuple) else (c_card[key],)):
            torch.testing.assert_close(b.cpu(), a, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# training: the flash gradient, the train step, the served decode's casts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,K,hd,window", [(2, 200, 8, 1, 256, 0), (2, 77, 8, 2, 64, 0),
                                               (1, 96, 4, 4, 32, 0), (1, 130, 4, 1, 64, 40)])
def test_train_flash_gradient_on_the_card_matches_the_cpu(dev, dtype, B, S, H, K, hd, window):
    """dq, dk, dv through ``autograd.FlashAttention`` on the card against the
    CPU's autograd of the plain version on the same values: one forward
    launch, and one launch of the backward kernel (its own counter)."""
    from repro_torch.kernels.flash_attention import (flash_attention, flash_attention_bwd,
                                                     flash_attention_ref)

    g = torch.Generator().manual_seed(B * S + hd)
    cpu = [torch.randn(shape, generator=g).to(dtype) for shape in
           ((B, S, H, hd), (B, S, K, hd), (B, S, K, hd), (B, S, H, hd))]
    ins = [t.to(dev).requires_grad_(True) for t in cpu[:3]]
    before, before_bwd = flash_attention.launches, flash_attention_bwd.launches
    out = flash_attention(*ins, causal=True, window=window)
    assert flash_attention.launches == before + 1
    out.backward(cpu[3].to(dev))
    assert flash_attention.launches == before + 1
    assert flash_attention_bwd.launches == before_bwd + 1
    ref = [t.clone().requires_grad_(True) for t in cpu[:3]]
    flash_attention_ref(*ref, True, window).backward(cpu[3])
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -7
    for name, a, b in zip("qkv", ins, ref):
        assert a.grad.dtype == dtype
        err = float((a.grad.cpu().float() - b.grad.float()).abs().max())
        assert err <= tol * float(b.grad.float().abs().max()), (name, err)


def test_train_step_on_the_card_matches_the_cpu(dev):
    """gemma-2b's smoke config (f32, TF32 off), one step from the same
    masters on the same batch: loss and grad norm within 1e-5 relative,
    every gradient within 1e-4 of its leaf's largest."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import get_model
    from repro_torch.training import AdamWConfig, init_train_state, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config("gemma-2b")
    toks = torch.randint(0, cfg.vocab, (4, 32), generator=torch.Generator().manual_seed(0),
                         dtype=torch.int32)
    models = [get_model(cfg, device=device, train=True) for device in ("cpu", dev)]
    states = [init_train_state(m, 0) for m in models]
    states[1].params.load_state_dict(states[0].params.state_dict())
    runs = []
    for model, state in zip(models, states):
        d = model.device
        batch = {"tokens": toks.to(d), "labels": toks.roll(-1, 1).to(d),
                 "domain": torch.arange(4, dtype=torch.int32, device=d)}
        runs.append(make_train_step(model, AdamWConfig(lr=1e-3))(state, batch))
    (cs, cm), (ds, dm) = runs
    for key in ("loss", "grad_norm"):
        assert abs(float(dm[key]) - float(cm[key])) <= 1e-5 * abs(float(cm[key])), key
    cpu = dict(cs.params.named_parameters())
    for name, p in ds.params.named_parameters():
        want = cpu[name].grad
        assert float((p.grad.cpu() - want).abs().max()) <= 1e-4 * float(want.abs().max()), name


@pytest.mark.parametrize("F", [4, 64])
def test_train_backward_accumulates_bf16_products_in_f32(dev, F):
    """A skinny projection's weight gradient, dW = x^T·dy of (F, 4,096) by
    (4,096, 4), K = 4,096 tokens and N = 4 (the backward's analogue of the
    mLSTM gate projection, split-K on the card): inside the train step's
    ``f32_accumulation`` each bf16 value is the float32 product rounded once
    (or its neighbour where the two float32 sums straddle a rounding), as
    ``test_bf16_products_accumulate_in_f32_under_the_entry_points`` holds
    the forward; and a real train step runs its backward with cuBLAS's bf16
    reduction off."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import get_model
    from repro_torch.models.layers import f32_accumulation
    from repro_torch.training import AdamWConfig, init_train_state, make_train_step

    g = torch.Generator(device=dev).manual_seed(F)
    x = torch.randn(4096, F, generator=g, device=dev).bfloat16().requires_grad_(True)
    w = (torch.randn(F, 4, generator=g, device=dev) / 64).requires_grad_(True)  # f32 master
    dy = torch.randn(4096, 4, generator=g, device=dev).bfloat16()
    with f32_accumulation(), torch.enable_grad():
        (x @ w.to(torch.bfloat16)).backward(dy)
    ref = x.detach().float().T @ dy.float()
    got = w.grad
    assert bool(((got - ref).abs() <= ref.abs() * 2.0 ** -7 + 1e-30).all())
    assert float((got == ref.bfloat16().float()).float().mean()) >= 0.9

    seen = []
    cfg = dataclasses.replace(get_smoke_config("gemma-2b"), compute_dtype="bfloat16")
    model = get_model(cfg, device=dev, train=True)
    state = init_train_state(model, 0)
    state.params.layers[0].wq.register_hook(lambda grad: seen.append(
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction))
    toks = torch.zeros((2, 16), dtype=torch.int32, device=dev)
    make_train_step(model, AdamWConfig())(state, {"tokens": toks, "labels": toks})
    assert seen == [False]
    assert torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction


def test_train_step_launches_flash_twice_a_layer_under_remat(dev):
    """remat="full": each layer's forward and its recompute in the backward
    launch the kernel; the backward itself launches none."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import get_model
    from repro_torch.training import AdamWConfig, init_train_state, make_train_step

    for remat, per_layer in (("full", 2), ("none", 1)):
        cfg = dataclasses.replace(get_smoke_config("gemma-2b"), compute_dtype="bfloat16",
                                  remat=remat)
        model = get_model(cfg, device=dev, train=True)
        state = init_train_state(model, 0)
        step = make_train_step(model, AdamWConfig())
        toks = torch.randint(0, cfg.vocab, (2, 64), device=dev, dtype=torch.int32)
        before = flash_attention.launches
        state, _ = step(state, {"tokens": toks, "labels": toks})
        torch.cuda.synchronize()
        assert flash_attention.launches - before == per_layer * cfg.n_layers, remat


def test_served_decode_casts_no_parameter(dev):
    """Cast at use is free for the served module: in a bf16 decode step no
    ``aten._to_copy`` reads a parameter (``.to`` of a leaf already in the
    activations' dtype returns the leaf)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import get_model
    from torch.utils._python_dispatch import TorchDispatchMode
    import dataclasses

    cfg = dataclasses.replace(get_smoke_config("grok-1-314b"), compute_dtype="bfloat16")
    model = get_model(cfg, device=dev)
    params = model.init(0)
    leaves = {p.data_ptr() for p in params.parameters() if p.dtype == torch.bfloat16}
    read = []

    class Casts(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten._to_copy.default:
                read.append(args[0].data_ptr())
            return func(*args, **(kwargs or {}))

    cache = model.init_cache(2, 8)
    toks = torch.zeros((2, 1), dtype=torch.int32, device=dev)
    with Casts():
        model.decode_step(params, cache, toks, 0)
    assert read and not leaves & set(read)


# ---------------------------------------------------------------------------
# training the hybrid, ssm and encdec families
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "xlstm-1.3b", "seamless-m4t-large-v2"])
def test_train_family_step_on_the_card_matches_the_cpu(dev, arch):
    """The arch's smoke config (f32, TF32 off; the encdec batch with a
    seeded frames stub), one step from the same masters on the same batch:
    loss and grad norm within 1e-5 relative, every gradient within 1e-4 of
    its leaf's largest, and as many flash launches as the step's
    attentions (none for xlstm)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import get_model
    from repro_torch.training import AdamWConfig, init_train_state, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config(arch)
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (4, 32), generator=g, dtype=torch.int32)
    frames = torch.randn((4, 32, cfg.d_model), generator=g)
    models = [get_model(cfg, device=device, train=True) for device in ("cpu", dev)]
    states = [init_train_state(m, 0) for m in models]
    states[1].params.load_state_dict(states[0].params.state_dict())
    runs = []
    for model, state in zip(models, states):
        d = model.device
        batch = {"tokens": toks.to(d), "labels": toks.roll(-1, 1).to(d),
                 "domain": torch.arange(4, dtype=torch.int32, device=d)}
        if cfg.family == "encdec":
            batch["frames"] = frames.to(d)
        before = flash_attention.launches
        runs.append(make_train_step(model, AdamWConfig(lr=1e-3))(state, batch))
    attentions = {"hybrid": cfg.n_layers // 3, "ssm": 0,
                  "encdec": cfg.enc_layers + 2 * cfg.dec_layers}[cfg.family]
    assert flash_attention.launches - before == attentions  # remat "none": once each
    (cs, cm), (ds, dm) = runs
    for key in ("loss", "grad_norm"):
        assert abs(float(dm[key]) - float(cm[key])) <= 1e-5 * abs(float(cm[key])), key
    cpu = dict(cs.params.named_parameters())
    for name, p in ds.params.named_parameters():
        want = cpu[name].grad
        assert float((p.grad.cpu() - want).abs().max()) <= 1e-4 * float(want.abs().max()), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,T,H,K,hd,causal,window", [
    (1, 300, 300, 4, 1, 256, True, 128),  # the hybrid's banded self attention
    (2, 77, 77, 4, 4, 64, False, 0),  # the encoder's non-causal self attention
    (2, 77, 130, 4, 4, 64, False, 0),  # the cross attention, S_tgt != S_src
])
def test_train_flash_family_shapes_on_the_card(dev, dtype, B, S, T, H, K, hd, causal, window):
    """The training shapes of the hybrid and encdec families: the forward
    (one launch) and dq, dk, dv through ``autograd.FlashAttention`` against
    the CPU's plain version and its autograd, within 1e-4 (f32) and 2^-7
    (bf16) of each output's largest magnitude."""
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref

    g = torch.Generator().manual_seed(S + T + hd)
    cpu = [torch.randn(shape, generator=g).to(dtype) for shape in
           ((B, S, H, hd), (B, T, K, hd), (B, T, K, hd), (B, S, H, hd))]
    ins = [t.to(dev).requires_grad_(True) for t in cpu[:3]]
    before = flash_attention.launches
    out = flash_attention(*ins, causal=causal, window=window)
    out.backward(cpu[3].to(dev))
    assert flash_attention.launches == before + 1
    ref = [t.clone().requires_grad_(True) for t in cpu[:3]]
    want = flash_attention_ref(*ref, causal, window)
    want.backward(cpu[3])
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -7
    for name, a, b in [("out", out.detach(), want.detach())] + [
            ("d" + n, x.grad, y.grad) for n, x, y in zip("qkv", ins, ref)]:
        assert a.dtype == dtype
        err = float((a.cpu().float() - b.float()).abs().max())
        assert err <= tol * float(b.float().abs().max()), (name, err)


# ---------------------------------------------------------------------------
# the attention's backward (csrc/flash_attention_bwd.cu): the kernel against
# autograd of the plain version, SDPA's backward beside it in bf16; the
# forward's log-sum-exp; determinism and dispatch
# ---------------------------------------------------------------------------

# mode → (S, T, window, qpos, ring): every mask the forward takes
BWD_MODES = {
    "causal": (77, 77, 0, 0, False),
    "causal_qpos": (40, 100, 0, 60, False),   # a chunk of queries after 60 cached keys
    "cross": (77, 130, 0, 0, False),          # non-causal, S_tgt != S_src
    "window": (150, 150, 40, 0, False),       # the hybrid's banded self attention
    "ring": (4, 64, 64, 97, True),            # key_pos ring slots, four queries at 97..100
}


def _bwd_case(mode, B, H, K, hd, dtype, dev, seed):
    S, T, window, qpos, ring = BWD_MODES[mode]
    causal = mode != "cross"
    q, k, v = _qkv(B, S, T, H, K, hd, dtype, dev, seed=seed)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    dout = torch.randn(q.shape, generator=g, device=dev).to(dtype)
    key_pos = _ring_positions(T, qpos + S - 1, 5, seed, dev) if ring else None
    return q, k, v, dout, dict(causal=causal, window=window, key_pos=key_pos, qpos=qpos)


def _rel_l2(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30))


def _sdpa_grads(q, k, v, dout, mask):
    """dq, dk, dv of scaled_dot_product_attention (the yardstick; the port
    never calls it) with the kernel's mask as an explicit boolean one."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ref import keep_mask

    S, T = q.shape[1], k.shape[1]
    ins = [t.detach().transpose(1, 2).requires_grad_(True) for t in (q, k, v)]
    kw = {}
    if mask["causal"]:
        kw["attn_mask"] = keep_mask(S, T, mask["window"], mask["key_pos"], mask["qpos"],
                                    device=q.device)
    out = F.scaled_dot_product_attention(*ins, enable_gqa=q.shape[2] != k.shape[2], **kw)
    return [t.transpose(1, 2) for t in torch.autograd.grad(out, ins, dout.transpose(1, 2))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [16, 64, 96, 128, 256])
@pytest.mark.parametrize("mode", list(BWD_MODES))
@pytest.mark.parametrize("H,K", [(4, 1), (4, 4)], ids=["K1", "KH"])
def test_flash_bwd_kernel_matches_the_plain_backward(dev, dtype, hd, mode, H, K):
    """dq, dk, dv of the kernel, through the training forward (which writes
    the log-sum-exp), against autograd of the plain version on the same
    inputs: float32 within 1e-5 relative L2 (the same f32 sums in other
    orders); bf16 within 1e-2 relative L2 (the gradients rounded to bf16,
    D taken from the bf16 output) and no farther from it than SDPA's
    backward."""
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd
    from repro_torch.kernels.flash_attention.autograd import plain_grad

    q, k, v, dout, mask = _bwd_case(mode, 2, H, K, hd, dtype, dev, seed=hd + H * K)
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = flash_attention_bwd.launches
    flash_attention(*ins, **mask).backward(dout)
    assert flash_attention_bwd.launches == before + 1
    want = plain_grad(q, k, v, dout, mask["causal"], mask["window"], mask["key_pos"],
                      mask["qpos"])
    errs = [_rel_l2(t.grad, w) for t, w in zip(ins, want)]
    for t in ins:
        assert t.grad.dtype == dtype and t.grad.is_contiguous()
    if dtype == torch.float32:
        assert max(errs) <= 1e-5, errs
        return
    lib = [_rel_l2(a, w) for a, w in zip(_sdpa_grads(q, k, v, dout, mask), want)]
    assert max(errs) <= 1e-2, (errs, lib)
    assert all(e <= s for e, s in zip(errs, lib)), (errs, lib)


@pytest.mark.parametrize("B,S,T,H,K,hd,causal,window,qpos,ring", [
    (2, 100, 93, 6, 2, 256, True, 0, 0, False),      # T and S·G (300) off the 64-row tiles
    (1, 70, 130, 3, 1, 64, False, 0, 0, False),      # non-causal, 3 heads a group
    (2, 33, 200, 16, 1, 128, True, 0, 167, False),   # a chunk after 167 cached keys
    (1, 190, 190, 16, 1, 256, True, 37, 0, False),   # a narrow band across tiles
    (2, 3, 128, 8, 1, 256, True, 128, 300, True),    # a wrapped 128-slot ring at hd 256
    (1, 2, 2048, 16, 1, 256, True, 2048, 3000, True)])  # the hybrid's ring, wrapped
def test_flash_bwd_warpgroup_route_at_ragged_shapes(dev, B, S, T, H, K, hd, causal, window, qpos,
                                                    ring):
    """The warpgroup route where the tiles do not divide the shape: keys
    past T and queries past S (TMA's zero fill, masked), grouped heads
    that do not divide 64, a ring that wrapped: dq, dk, dv within 1e-2
    relative L2 of autograd through the plain version and no farther
    from it than SDPA's backward."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    from repro_torch.kernels.flash_attention.autograd import plain_grad
    from repro_torch.kernels.flash_attention.ops import _dispatch, bwd_plan

    assert bwd_plan(torch.bfloat16, B, S, T, H, K, hd).route == "wgmma"
    q, k, v = _qkv(B, S, T, H, K, hd, torch.bfloat16, dev, seed=S + T)
    dout = torch.randn(q.shape, generator=torch.Generator(device=dev).manual_seed(3),
                       device=dev).bfloat16()
    key_pos = _ring_positions(T, qpos + S - 1, 7, T, dev) if ring else None
    mask = dict(causal=causal, window=window, key_pos=key_pos, qpos=qpos)
    lse = torch.empty((B, H, S), device=dev)
    o = _dispatch(q, k, v, causal, window, key_pos, qpos, lse)
    got = flash_attention_bwd(q, k, v, o, lse, dout, **mask)
    want = plain_grad(q, k, v, dout, causal, window, key_pos, qpos)
    errs = [_rel_l2(a, w) for a, w in zip(got, want)]
    lib = [_rel_l2(a, w) for a, w in zip(_sdpa_grads(q, k, v, dout, mask), want)]
    assert max(errs) <= 1e-2, (errs, lib)
    assert all(e <= s for e, s in zip(errs, lib)), (errs, lib)


@pytest.mark.parametrize("B,S,T,H,K,hd,causal,window", [
    (8, 512, 512, 8, 1, 256, True, 0),          # gemma-2b
    (1, 4096, 4096, 16, 1, 256, True, 2048),    # recurrentgemma-9b's banded self attention
    (8, 512, 512, 16, 16, 64, False, 0),        # seamless's encoder and its cross attention
    (8, 512, 1024, 16, 16, 64, False, 0)])      # cross attention against a longer source
def test_flash_bwd_takes_the_warpgroup_route_at_the_training_shapes(dev, B, S, T, H, K, hd,
                                                                     causal, window):
    """``bwd_plan`` puts the training shapes on the wgmma route, and a call
    there launches the backward once, encodes its TMA tensor maps and runs
    the warpgroup kernel (its name in a profile of the call: the profiler
    at times drops a call's rows, so the first of three that has any)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.flash_attention import flash_attention_bwd, flash_attention_ref
    from repro_torch.kernels.flash_attention.ops import bwd_plan, bwd_tensor_map_us

    assert bwd_plan(torch.bfloat16, B, S, T, H, K, hd).route == "wgmma"
    q, k, v = _qkv(B, S, T, H, K, hd, torch.bfloat16, dev, seed=7)
    o, lse = flash_attention_ref(q, k, v, causal, window, return_lse=True)
    o = o.bfloat16()
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, o, lse, torch.ones_like(q), causal, window)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 1
    assert bwd_tensor_map_us() > 0
    names = set()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            flash_attention_bwd(q, k, v, o, lse, torch.ones_like(q), causal, window)
            torch.cuda.synchronize()
        names = {e.key for e in prof.key_averages() if "flash_bwd" in e.key}
        if names:
            break
    assert any("flash_bwd_wg" in n for n in names), names  # both passes, one launch
    assert all(bool(t.isfinite().all()) for t in got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,T,H,K,hd,causal,window", [
    (8, 512, 512, 8, 1, 256, True, 0),      # gemma-2b's training shape
    (1, 600, 600, 16, 1, 256, True, 128),   # the hybrid's heads, banded
    (2, 200, 300, 16, 16, 64, False, 0)])   # seamless's cross attention
def test_flash_bwd_kernel_repeats_bit_equal(dev, dtype, B, S, T, H, K, hd, causal, window):
    """Two calls on the same inputs give the same bits (no float atomics)."""
    from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                     flash_attention_bwd_ref,
                                                     flash_attention_ref)

    q, k, v = _qkv(B, S, T, H, K, hd, dtype, dev, seed=S + hd)
    dout = torch.randn(q.shape, generator=torch.Generator(device=dev).manual_seed(1),
                       device=dev).to(dtype)
    o, lse = flash_attention_ref(q, k, v, causal, window, return_lse=True)
    a = flash_attention_bwd(q, k, v, o, lse, dout, causal, window)
    b = flash_attention_bwd(q, k, v, o, lse, dout, causal, window)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    # and the kernel's form of the plain backward on the same o and lse
    want = flash_attention_bwd_ref(q, k, v, o, lse, dout, causal, window)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    assert max(_rel_l2(x, w) for x, w in zip(a, want)) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,T,H,K,hd,causal,window,qpos,ring", [
    (2, 77, 77, 4, 1, 64, True, 0, 0, False),
    (8, 1, 249, 8, 1, 256, False, 0, 0, False),       # the serve decode: split keys
    (2, 3, 4096, 8, 2, 128, False, 0, 0, False),       # split keys, GQA
    (1, 600, 600, 16, 1, 256, True, 128, 0, False),
    (2, 4, 64, 4, 1, 16, True, 64, 97, True),
    (1, 2, 2048, 16, 1, 256, True, 2048, 3000, True)])  # the ring at full width, split
def test_flash_forward_lse_matches_the_plain_one(dev, dtype, B, S, T, H, K, hd, causal, window,
                                                 qpos, ring):
    """The forward's log-sum-exp, written in the same launch (by the merging
    block under a key split), against the plain version's, within 1e-5
    relative plus 1e-5; the output is the one the call without lse gives."""
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref
    from repro_torch.kernels.flash_attention.ops import _dispatch

    q, k, v = _qkv(B, S, T, H, K, hd, dtype, dev, seed=T + hd)
    key_pos = _ring_positions(T, qpos + S - 1, 3, T, dev) if ring else None
    mask = (causal, window, key_pos, qpos)
    lse = torch.full((B, H, S), float("nan"), device=dev)
    before = flash_attention.launches
    out = _dispatch(q, k, v, *mask, lse)
    assert flash_attention.launches == before + 1
    want_o, want = flash_attention_ref(q, k, v, *mask, return_lse=True)
    torch.testing.assert_close(lse, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(out, flash_attention(q, k, v, *mask))


def test_flash_serve_calls_write_no_lse_and_launch_once(dev, monkeypatch):
    """Without grad, and with grad on but no input that requires it, the
    forward launches once with a null lse, as before the backward."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention

    seen = []
    real = _build.launch

    def spy(name, argtypes, *args):
        if name == "svc_flash_attention":
            seen.append(args[-2])  # lse, just before the stream
        return real(name, argtypes, *args)

    monkeypatch.setattr(_build, "launch", spy)
    q, k, v = _qkv(8, 1, 249, 8, 1, 256, torch.bfloat16, dev)
    before = flash_attention.launches
    with torch.no_grad():
        flash_attention(q, k, v, causal=False)
    flash_attention(q, k, v, causal=False)
    assert flash_attention.launches == before + 2 and seen == [None, None]


def test_flash_backward_on_the_card_takes_the_kernel_only(dev, monkeypatch):
    """A backward on CUDA tensors launches the backward kernel once (its
    counter moves, the forward's moves once), dispatches as
    ``flash_attention_bwd`` with no fallback under the kernel profiler, and
    no CUDA tensor reaches the plain version."""
    import repro_torch.kernels.flash_attention.autograd as A
    import repro_torch.kernels.flash_attention.ops as O
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd
    from repro_torch.obs.kprof import KernelProfiler

    def no_cuda(fn):
        def guarded(*args, **kw):
            assert not any(isinstance(t, torch.Tensor) and t.is_cuda for t in args), fn.__name__
            return fn(*args, **kw)
        return guarded

    for mod, name in ((A, "flash_attention_ref"), (O, "flash_attention_ref"),
                      (O, "flash_attention_bwd_ref"), (A, "plain_grad")):
        monkeypatch.setattr(mod, name, no_cuda(getattr(mod, name)))
    q, k, v = _qkv(2, 100, 100, 8, 1, 256, torch.bfloat16, dev)
    ins = [t.requires_grad_(True) for t in (q, k, v)]
    fwd, bwd = flash_attention.launches, flash_attention_bwd.launches
    prof = kernels.set_profiler(KernelProfiler())
    try:
        flash_attention(*ins, causal=True).sum().backward()
    finally:
        kernels.set_profiler(None)
    ops = prof.summary()
    assert (flash_attention.launches - fwd, flash_attention_bwd.launches - bwd) == (1, 1)
    assert ops["flash_attention_bwd"]["dispatches"] == 1
    assert ops["flash_attention_bwd"]["fallbacks"] == 0
    assert all(t.grad is not None and bool(t.grad.isfinite().all()) for t in ins)


@pytest.mark.parametrize("B,S,T,H,K,hd,causal,window", [
    (8, 512, 512, 8, 1, 256, True, 0),      # gemma-2b's training shape: 5 runs
    (1, 600, 600, 16, 1, 256, True, 128),   # banded: runs of unequal rows
    (2, 300, 300, 4, 1, 64, True, 0)])
def test_flash_bwd_row_split_matches_one_block_per_key_tile(dev, monkeypatch, B, S, T, H, K, hd,
                                                            causal, window):
    """The dK/dV pass with each key tile's rows cut over blocks (f32
    partials summed in run order) against the same pass with one block per
    key tile: dq bit-equal, dk and dv within one bf16 rounding (2^-8 of
    each element, plus 2^-8 of the largest for the sums' other order)."""
    import repro_torch.kernels.flash_attention.ops as O
    from repro_torch.kernels.flash_attention import flash_attention_bwd, flash_attention_ref

    q, k, v = _qkv(B, S, T, H, K, hd, torch.bfloat16, dev, seed=S + 3)
    dout = torch.randn(q.shape, generator=torch.Generator(device=dev).manual_seed(2),
                       device=dev).bfloat16()
    o, lse = flash_attention_ref(q, k, v, causal, window, return_lse=True)
    o = o.bfloat16()
    split = flash_attention_bwd(q, k, v, o, lse, dout, causal, window)
    plan = O.bwd_plan(torch.bfloat16, B, S, T, H, K, hd)
    assert plan.kv_splits > 1
    real = O.bwd_plan
    monkeypatch.setattr(O, "bwd_plan", lambda *a: real(*a)._replace(
        kv_splits=1, kv_blocks=plan.kv_blocks // plan.kv_splits, workspace_bytes=0))
    whole = flash_attention_bwd(q, k, v, o, lse, dout, causal, window)
    assert torch.equal(split[0], whole[0])
    for a, b in zip(split[1:], whole[1:]):
        a, b = a.float(), b.float()
        assert bool(((a - b).abs() <= 2.0 ** -8 * (b.abs() + b.abs().max())).all())


# ---------------------------------------------------------------------------
# AdamW (``-k adamw``): the norm and the update over every leaf, two launches
# ---------------------------------------------------------------------------

# leaf shapes: odd sizes, rank 1 and 2, one of them placed at an offset of
# one element (not 16-byte aligned: the kernel's scalar route)
ADAMW_ODD = ((1,), (7,), (4099,), (1025, 3), (64, 33))
ADAMW_OFFSET = 2  # the (4099,) leaf


def _adamw_tree(shapes, dev, seed, offset=None):
    """p, m, v (v ≥ 0) and a decay flag per leaf (rank ≥ 2), float32 on
    ``dev`` from a numpy seed; the leaf ``offset`` one element into its
    storage."""
    rng = np.random.default_rng(seed)

    def put(a, at):
        if not at:
            return torch.from_numpy(a).to(dev)
        buf = torch.empty(a.size + 1, dtype=torch.float32, device=dev)
        out = buf[1:].view(a.shape)
        out.copy_(torch.from_numpy(a))
        return out

    leaves = []
    for i, s in enumerate(shapes):
        at = i == offset
        leaves.append((put(rng.normal(size=s).astype(np.float32), at),
                       put(rng.normal(scale=1e-2, size=s).astype(np.float32), at),
                       put(rng.uniform(0.0, 1e-4, s).astype(np.float32), at)))
    ps, ms, vs = (list(x) for x in zip(*leaves))
    return ps, ms, vs, [len(s) >= 2 for s in shapes]


def _adamw_grads(shapes, dev, seed, offset=None, scale=0.1):
    rng = np.random.default_rng(seed)
    out = []
    for i, s in enumerate(shapes):
        a = rng.normal(scale=scale, size=s).astype(np.float32)
        if i == offset:
            g = torch.empty(a.size + 1, dtype=torch.float32, device=dev)[1:].view(a.shape)
            g.copy_(torch.from_numpy(a))
        else:
            g = torch.from_numpy(a).to(dev)
        out.append(g)
    return out


def _adamw_close(got, want, what):
    """Every element within 2 ulp of the plain version's or within 1e-6 of
    the leaf's largest magnitude."""
    got, want = got.double().cpu(), want.double().cpu()
    ulp = torch.from_numpy(np.spacing(np.abs(want.float().numpy()))).double()
    err = (got - want).abs()
    ok = (err <= 2 * ulp) | (err <= 1e-6 * float(want.abs().max()))
    assert bool(ok.all()), (what, float(err.max()))


@pytest.mark.parametrize("clip", [1e9, 0.05])
def test_adamw_kernel_matches_the_plain_version(dev, clip):
    """Four steps (warm-up and cosine) over the odd tree, the kernel's copy
    and the plain version's from the same values: step, lr, grad_norm and
    clip_scale within 1e-6 relative, every p, m, v within 2 ulp or 1e-6 of
    the leaf's largest magnitude; then the kernel's update fed the plain
    version's scalars, against the plain update from the same state."""
    from repro_torch.kernels.adamw import (adamw_apply, adamw_norm, adamw_norm_ref,
                                           adamw_update_ref)
    from repro_torch.training import AdamWConfig

    cfg = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=4, clip_norm=clip)
    kern = _adamw_tree(ADAMW_ODD, dev, 0, ADAMW_OFFSET)
    plain = _adamw_tree(ADAMW_ODD, dev, 0, ADAMW_OFFSET)
    kstep = pstep = torch.zeros((), dtype=torch.int32, device=dev)
    for i in range(4):
        g = _adamw_grads(ADAMW_ODD, dev, 10 + i, ADAMW_OFFSET)
        a, b = adamw_norm(cfg, g, kstep), adamw_norm_ref(cfg, g, pstep)
        assert int(a.step) == int(b.step) == i + 1 and a.step.dtype == torch.int32
        for name in ("lr", "grad_norm", "clip_scale", "bc1", "bc2"):
            x, y = float(getattr(a, name)), float(getattr(b, name))
            assert abs(x - y) <= 1e-6 * abs(y), (i, name, x, y)
        assert (float(a.clip_scale) < 1.0) == (clip < 1.0)
        adamw_apply(cfg, kern[0], g, kern[1], kern[2], kern[3], a)
        adamw_update_ref(cfg, plain[0], g, plain[1], plain[2], plain[3], b)
        for what, xs, ys in zip("pmv", kern[:3], plain[:3]):
            for j, (x, y) in enumerate(zip(xs, ys)):
                _adamw_close(x, y, (i, what, ADAMW_ODD[j]))
        kstep, pstep = a.step, b.step
    # one more update from equal states and the same scalars
    for xs, ys in zip(kern[:3], plain[:3]):
        for x, y in zip(xs, ys):
            x.copy_(y)
    g = _adamw_grads(ADAMW_ODD, dev, 20, ADAMW_OFFSET)
    sc = adamw_norm_ref(cfg, g, pstep)
    adamw_apply(cfg, kern[0], g, kern[1], kern[2], kern[3], sc)
    adamw_update_ref(cfg, plain[0], g, plain[1], plain[2], plain[3], sc)
    for what, xs, ys in zip("pmv", kern[:3], plain[:3]):
        for j, (x, y) in enumerate(zip(xs, ys)):
            _adamw_close(x, y, ("same scalars", what, ADAMW_ODD[j]))


def test_adamw_repeats_bit_for_bit(dev):
    """Two runs of the kernel from the same state and gradients: the same
    bits in every scalar and every p, m, v."""
    from repro_torch.kernels.adamw import adamw_apply, adamw_norm
    from repro_torch.training import AdamWConfig

    shapes = ADAMW_ODD + ((2048, 1000),)  # enough chunks to spread over the card
    cfg = AdamWConfig(warmup_steps=0, total_steps=10, clip_norm=0.5)
    runs = []
    for _ in range(2):
        ps, ms, vs, decay = _adamw_tree(shapes, dev, 1, ADAMW_OFFSET)
        step = torch.full((), 5, dtype=torch.int32, device=dev)
        for i in range(2):
            g = _adamw_grads(shapes, dev, 30 + i, ADAMW_OFFSET, scale=1.0)
            sc = adamw_norm(cfg, g, step)
            adamw_apply(cfg, ps, g, ms, vs, decay, sc)
            step = sc.step
        runs.append([t.clone() for t in sc] + ps + ms + vs)
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n_leaves", [3, 500])
def test_adamw_launches_once_a_step_each(dev, n_leaves):
    """One launch of each kernel a step for 3 leaves and for 500 (more than
    xlstm-1.3b's ~450): the wrappers' counts and the card's own launches."""
    from repro_torch import kernels
    from repro_torch.kernels.adamw import launches_per_call, max_leaves
    from repro_torch.training import AdamWConfig, adamw_init, adamw_update

    assert max_leaves() >= 500 and launches_per_call(n_leaves) == 1
    rng = np.random.default_rng(n_leaves)
    sizes = rng.integers(1, 3000, n_leaves)
    params = {f"l{i}": torch.randn(int(n), device=dev) for i, n in enumerate(sizes)}
    grads = {k: torch.randn_like(p) for k, p in params.items()}
    state = adamw_init(params)
    ranks = {k: 1 + i % 2 for i, k in enumerate(params)}
    cfg = AdamWConfig()

    def step():
        adamw_update(cfg, params, grads, state, ranks)

    step()
    before = kernels.launch_counts()
    step()
    after = kernels.launch_counts()
    assert (after["adamw_norm"] - before["adamw_norm"],
            after["adamw_update"] - before["adamw_update"]) == (1, 1)
    assert _device_launches(step) == 2


def test_adamw_splits_past_the_parameter_block(dev):
    """1,500 leaves (more than a launch's table holds; qwen2-vl-72b has
    723): ``launches_per_call`` launches of each kernel, the norm summed
    over every group's partials, and every scalar and leaf against the
    plain version as for one group."""
    from repro_torch import kernels
    from repro_torch.kernels.adamw import (adamw_apply, adamw_norm, adamw_norm_ref,
                                           adamw_update_ref, launches_per_call, max_leaves)
    from repro_torch.training import AdamWConfig

    shapes = tuple((int(n),) if i % 3 else (int(n), 3) for i, n in
                   enumerate(np.random.default_rng(6).integers(1, 700, 1500)))
    groups = launches_per_call(len(shapes))
    assert groups == -(-1500 // max_leaves()) > 1
    cfg = AdamWConfig(lr=1e-2, warmup_steps=0, total_steps=4, clip_norm=0.5)
    kern, plain = _adamw_tree(shapes, dev, 7, 5), _adamw_tree(shapes, dev, 7, 5)
    g = _adamw_grads(shapes, dev, 8, 5)
    step = torch.zeros((), dtype=torch.int32, device=dev)
    before = kernels.launch_counts()
    a = adamw_norm(cfg, g, step)
    adamw_apply(cfg, kern[0], g, kern[1], kern[2], kern[3], a)
    after = kernels.launch_counts()
    assert after["adamw_norm"] - before["adamw_norm"] == groups
    assert after["adamw_update"] - before["adamw_update"] == groups
    b = adamw_norm_ref(cfg, g, step)
    for name in ("lr", "grad_norm", "clip_scale"):
        x, y = float(getattr(a, name)), float(getattr(b, name))
        assert abs(x - y) <= 1e-6 * abs(y), (name, x, y)
    assert float(a.clip_scale) < 1.0
    adamw_update_ref(cfg, plain[0], g, plain[1], plain[2], plain[3], b)
    for what, xs, ys in zip("pmv", kern[:3], plain[:3]):
        for j, (x, y) in enumerate(zip(xs, ys)):
            _adamw_close(x, y, (what, j, shapes[j]))


def test_adamw_does_not_synchronize(dev):
    """A warm train step's update under set_sync_debug_mode("error")."""
    from repro_torch.training import AdamWConfig, adamw_init, adamw_update

    params = {"w": torch.randn(300, 7, device=dev), "b": torch.randn(7, device=dev)}
    grads = {k: torch.randn_like(p) for k, p in params.items()}
    state = adamw_init(params)
    adamw_update(AdamWConfig(), params, grads, state, {"w": 2, "b": 1})  # built and warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, state, met = adamw_update(AdamWConfig(), params, grads, state, {"w": 2, "b": 1})
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert int(state["step"]) == 2 and all(v.is_cuda for v in met.values())


@pytest.mark.parametrize("case", ["a bfloat16 leaf", "a float64 gradient", "a leaf on the CPU",
                                  "an int64 step"])
def test_adamw_refuses_what_the_kernel_does_not_take(dev, case):
    from repro_torch.kernels.adamw import adamw_apply, adamw_norm
    from repro_torch.training import AdamWConfig

    cfg = AdamWConfig()
    ps, ms, vs, decay = _adamw_tree(ADAMW_ODD[:3], dev, 2)
    g = _adamw_grads(ADAMW_ODD[:3], dev, 3)
    step = torch.zeros((), dtype=torch.int32, device=dev)
    sc = adamw_norm(cfg, g, step)
    if case == "a bfloat16 leaf":
        with pytest.raises(TypeError, match="bfloat16"):
            adamw_apply(cfg, [ps[0].bfloat16()] + ps[1:], g, ms, vs, decay, sc)
    elif case == "a float64 gradient":
        with pytest.raises(TypeError, match="float64"):
            adamw_norm(cfg, [g[0].double()] + g[1:], step)
    elif case == "a leaf on the CPU":
        with pytest.raises(ValueError, match="on cpu"):
            adamw_apply(cfg, ps, g, ms, [vs[0].cpu()] + vs[1:], decay, sc)
        with pytest.raises(ValueError, match="on cpu"):
            adamw_norm(cfg, g[:2] + [g[2].cpu()], step)
    else:
        with pytest.raises(TypeError, match="step"):
            adamw_norm(cfg, g, step.long())


def test_adamw_launches_on_the_last_card(last_card):
    """Leaves on the last card launch there and equal the plain version's
    update on that card; leaves on two cards raise."""
    from repro_torch import kernels
    from repro_torch.kernels.adamw import (adamw_apply, adamw_norm, adamw_norm_ref,
                                           adamw_update_ref)
    from repro_torch.training import AdamWConfig

    cfg = AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=4)
    kern = _adamw_tree(ADAMW_ODD, last_card, 4, ADAMW_OFFSET)
    plain = _adamw_tree(ADAMW_ODD, last_card, 4, ADAMW_OFFSET)
    g = _adamw_grads(ADAMW_ODD, last_card, 5, ADAMW_OFFSET)
    step = torch.zeros((), dtype=torch.int32, device=last_card)
    before = kernels.launch_counts()
    sc = adamw_norm(cfg, g, step)
    adamw_apply(cfg, kern[0], g, kern[1], kern[2], kern[3], sc)
    after = kernels.launch_counts()
    assert after["adamw_norm"] - before["adamw_norm"] == 1
    assert after["adamw_update"] - before["adamw_update"] == 1
    assert all(t.device == last_card for t in sc)
    ref = adamw_norm_ref(cfg, g, step)
    assert abs(float(sc.grad_norm) - float(ref.grad_norm)) <= 1e-6 * float(ref.grad_norm)
    adamw_update_ref(cfg, plain[0], g, plain[1], plain[2], plain[3], ref)
    for what, xs, ys in zip("pmv", kern[:3], plain[:3]):
        for j, (x, y) in enumerate(zip(xs, ys)):
            _adamw_close(x, y, (what, ADAMW_ODD[j]))
    with pytest.raises(ValueError, match="expected"):
        adamw_norm(cfg, [g[0].to("cuda:0")] + g[1:], step)


def test_adamw_train_steps_on_the_card_match_the_cpu(dev):
    """gemma-2b's smoke config (f32, TF32 off), three steps from the same
    masters on the same batches, the card's update through the kernel: loss
    and grad norm within 1e-5 relative, lr and clip_scale within 1e-6, all
    the parameters after each step within 2e-2 of the step's update norm
    over every leaf (the smoke's train_device_vs_cpu limits)."""
    from repro_torch import kernels
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import get_model
    from repro_torch.training import AdamWConfig, init_train_state, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config("gemma-2b")
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=3)
    models = [get_model(cfg, device=device, train=True) for device in ("cpu", dev)]
    states = [init_train_state(m, 0) for m in models]
    states[1].params.load_state_dict(states[0].params.state_dict())
    steps = [make_train_step(m, opt) for m in models]
    gen = torch.Generator().manual_seed(0)
    for i in range(3):
        toks = torch.randint(0, cfg.vocab, (4, 32), generator=gen, dtype=torch.int32)
        prev = {n: p.detach().clone() for n, p in states[0].params.named_parameters()}
        mets = []
        before = kernels.launch_counts()
        for j, (model, step) in enumerate(zip(models, steps)):
            d = model.device
            batch = {"tokens": toks.to(d), "labels": toks.roll(-1, 1).to(d),
                     "domain": torch.arange(4, dtype=torch.int32, device=d)}
            states[j], met = step(states[j], batch)
            mets.append(met)
        after = kernels.launch_counts()
        assert after["adamw_norm"] - before["adamw_norm"] == 1
        assert after["adamw_update"] - before["adamw_update"] == 1
        (cm, dm) = mets
        for key, tol in (("loss", 1e-5), ("grad_norm", 1e-5), ("lr", 1e-6), ("clip_scale", 1e-6)):
            assert abs(float(dm[key]) - float(cm[key])) <= tol * abs(float(cm[key])), (i, key)
        cpu = dict(states[0].params.named_parameters())
        err2 = upd2 = 0.0
        for name, p in states[1].params.named_parameters():
            err2 += float((p.detach().cpu() - cpu[name].detach()).norm()) ** 2
            upd2 += float((cpu[name].detach() - prev[name]).norm()) ** 2
        assert err2 ** 0.5 <= 2e-2 * upd2 ** 0.5, (i, err2 ** 0.5, upd2 ** 0.5)
        assert int(states[1].opt_state["step"]) == i + 1


# ---------------------------------------------------------------------------
# the sLSTM's recurrence (``-k slstm``): one launch a time step, forward and
# backward, held to the plain version (kernels/slstm/ref.py)
# ---------------------------------------------------------------------------

SLSTM_SHAPE = (8, 512, 2048)  # xlstm-1.3b's training batch and width: B, S, d
# of each output's largest magnitude: the kernels against the plain version
# on the same card (measured on an H100 at xlstm-1.3b's widths over 512
# steps by the smoke's slstm lines: at most 3.4e-7 forward, 2.8e-7
# backward: the dot products' sums in another order, CUDA's
# expf/tanhf/log1pf), and the decode against the CPU
SLSTM_TOL = 5e-6
SLSTM_CPU_TOL = 1e-5


def _slstm_inputs(dev, B, S, d, seed=0, state=False):
    """wx (B, S, 4d) ~ N(0, 1), R at 4× the init scale (2/sqrt(d)), dhs
    ~ N(0, 1) and, with ``state``, a state (h, c, n ≥ 1, m)."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def rn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    wx, R, dhs = rn(B, S, 4 * d), rn(4, d // 4, d, scale=2.0 / d ** 0.5), rn(B, S, d)
    st = None
    if state:
        st = [rn(B, d), rn(B, d), 1.0 + rn(B, d).abs(), rn(B, d)]
    return wx, R, dhs, st


def _slstm_rel(a, b):
    """|a − b|'s largest element over b's largest magnitude (|a|'s largest
    where b is all zeros, as dR of one step from the zero state is)."""
    scale = b.double().abs().max()
    err = (a.double() - b.double()).abs().max()
    return float(err / scale if scale > 0 else err)


def test_slstm_fwd_kernel_matches_the_plain_version(dev):
    """At xlstm-1.3b's widths over 512 steps: hs, the last state and every
    saved gate pre-activation and state within SLSTM_TOL of the plain
    version's largest magnitude."""
    from repro_torch.kernels.slstm import slstm_fwd, slstm_scan_ref

    B, S, d = SLSTM_SHAPE
    wx, R, _, _ = _slstm_inputs(dev, B, S, d)
    hs, last, saved = slstm_fwd(wx, R, save=True)
    rhs, rlast, rsaved = slstm_scan_ref(wx, R, save=True)
    errs = {"hs": _slstm_rel(hs, rhs)}
    errs.update({f"last {n}": _slstm_rel(a, b) for n, a, b in zip("hcnm", last, rlast)})
    errs.update({f"saved {n}": _slstm_rel(a, b) for n, a, b in zip("gcnm", saved, rsaved)})
    assert all(e <= SLSTM_TOL for e in errs.values()), errs


def test_slstm_bwd_kernel_matches_the_plain_version(dev):
    """dwx and dR from the kernel's saved forward against ``slstm_bwd_ref``
    on the same saved tensors, within SLSTM_TOL."""
    from repro_torch.kernels.slstm import slstm_bwd, slstm_bwd_ref, slstm_fwd

    B, S, d = SLSTM_SHAPE
    wx, R, dhs, _ = _slstm_inputs(dev, B, S, d, seed=1)
    hs, _, saved = slstm_fwd(wx, R, save=True)
    dwx, dR = slstm_bwd(dhs, R, hs, saved)
    rwx, rR = slstm_bwd_ref(dhs, R, hs, saved)
    errs = {"dwx": _slstm_rel(dwx, rwx), "dR": _slstm_rel(dR, rR)}
    assert all(e <= SLSTM_TOL for e in errs.values()), errs


@pytest.mark.parametrize("B,S,d", [(3, 7, 64), (9, 5, 128), (1, 2, 2048), (8, 1, 2048)])
def test_slstm_kernels_at_ragged_rows_from_a_given_state(dev, B, S, d):
    """Rows past a block's 8 and short of it, one step and a few: the
    forward from a given state, and the backward of the forward from the
    zero state (the only one that takes a gradient), within SLSTM_TOL."""
    from repro_torch.kernels.slstm import slstm_bwd, slstm_bwd_ref, slstm_fwd, slstm_scan_ref

    wx, R, dhs, st = _slstm_inputs(dev, B, S, d, seed=2, state=True)
    hs, last = slstm_fwd(wx, R, st)
    rhs, rlast = slstm_scan_ref(wx, R, st)
    assert _slstm_rel(hs, rhs) <= SLSTM_TOL
    for a, b in zip(last, rlast):
        assert _slstm_rel(a, b) <= SLSTM_TOL
    hs, _, saved = slstm_fwd(wx, R, save=True)
    got, want = slstm_bwd(dhs, R, hs, saved), slstm_bwd_ref(dhs, R, hs, saved)
    for a, b in zip(got, want):
        assert _slstm_rel(a, b) <= SLSTM_TOL


def test_slstm_decode_with_rows_matches_the_cpu(dev):
    """``SLSTMBlock.decode`` at xlstm-1.3b's width (one step, the kernel)
    for rows [0, 2] of 4 equals the CPU block's (f32, TF32 off): output
    and every state within SLSTM_CPU_TOL, rows 1 and 3 untouched."""
    import copy

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models.xlstm import SLSTMBlock

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("xlstm-1.3b")
    d = cfg.d_model
    cpu = SLSTMBlock(cfg, device="cpu", masters=True)
    with torch.no_grad():
        for p in cpu.parameters():
            p.copy_(torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel()))
                    / p.shape[-1] ** 0.5)
    card = copy.deepcopy(cpu).to(dev)
    g = torch.Generator().manual_seed(3)
    x = torch.randn((4, 1, d), generator=g)
    states = [torch.randn((4, d), generator=g), torch.randn((4, d), generator=g),
              1.0 + torch.randn((4, d), generator=g).abs(), torch.randn((4, d), generator=g)]
    on_card = [s.to(dev) for s in states]
    rows = [0, 2]
    before = kernels.launch_counts()["slstm_fwd"]
    with torch.no_grad():
        got = card.decode(x.to(dev), on_card, torch.tensor(rows, device=dev))
        want = cpu.decode(x, states, torch.tensor(rows))
    assert kernels.launch_counts()["slstm_fwd"] - before == 1
    assert _slstm_rel(got.cpu(), want) <= SLSTM_CPU_TOL
    for a, b in zip(on_card, states):
        assert _slstm_rel(a.cpu(), b) <= SLSTM_CPU_TOL
        assert torch.equal(a.cpu()[[1, 3]], b[[1, 3]])


def test_slstm_repeats_bit_for_bit(dev):
    from repro_torch.kernels.slstm import slstm_bwd, slstm_fwd

    B, S, d = SLSTM_SHAPE
    wx, R, dhs, _ = _slstm_inputs(dev, B, 64, d, seed=4)
    outs = []
    for _ in range(2):
        hs, last, saved = slstm_fwd(wx, R, save=True)
        outs.append([hs, *last, *saved, *slstm_bwd(dhs, R, hs, saved)])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_slstm_launches_once_a_step_without_a_synchronize(dev, monkeypatch):
    """The route rule's launches of each kernel a call: one on the resident
    route (xlstm's width and a narrow one over 48 steps), S on the per-step
    route (one step, as every decode, and a width past the resident
    route's), whatever B: the wrappers' counters and their routes' exactly,
    and every device row of each call under the profiler, which at times
    drops up to one kernel a call and never adds one (the backward's with
    its dR product after the loop taken out: a plain ``torch.bmm`` whose
    cuBLAS rows in the call's profile need not match a profile of the
    product alone); neither wrapper synchronizes."""
    from repro_torch import kernels
    from repro_torch.kernels.slstm import ops, slstm_bwd, slstm_fwd

    cases = (((8, 48, 2048), "resident", 1), ((17, 48, 128), "resident", 1),
             ((8, 1, 2048), "step", 1), ((2, 3, 4096), "step", 3))
    for (B, S, d), route, want in cases:
        assert ops.route_on(B, S, d, torch.cuda.current_device()) == route, (B, S, d)
        assert ops.launches_per_call(B, S, d, torch.cuda.current_device()) == want
        wx, R, dhs, _ = _slstm_inputs(dev, B, S, d, seed=5)
        before, routes = kernels.launch_counts(), kernels.route_counts()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            hs, _, saved = slstm_fwd(wx, R, save=True)
            slstm_bwd(dhs, R, hs, saved)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        after, routes_after = kernels.launch_counts(), kernels.route_counts()
        for name in ("slstm_fwd", "slstm_bwd"):
            assert after[name] - before[name] == want
            assert {k: routes_after[name][k] - routes[name][k] for k in ops.ROUTES} == {
                k: (want if k == route else 0) for k in ops.ROUTES}
        assert want - 1 <= _device_launches(lambda: slstm_fwd(wx, R)) <= want
        with monkeypatch.context() as m:
            m.setattr(ops, "slstm_dR", lambda hs, dG: None)
            assert want - 1 <= _device_launches(lambda: slstm_bwd(dhs, R, hs, saved)) <= want


SLSTM_ROUTE_SHAPES = [(8, 512, 2048), (17, 48, 128), (3, 100, 64), (2, 512, 2048)]


@pytest.mark.parametrize("B,S,d", SLSTM_ROUTE_SHAPES)
def test_slstm_resident_route_gives_the_step_routes_bits(dev, B, S, d):
    """The resident route (one cooperative launch a call) against the
    per-step route (one launch a step) on the same inputs: the forward with
    and without save, from the zero state and from a given one (hs, the
    last state, the saved gates and c, n, m), and the backward (dwx, dR),
    ``torch.equal`` throughout: the two take every sum in the same order."""
    from repro_torch.kernels.slstm import ops, slstm_fwd

    assert ops.route_on(B, S, d, torch.cuda.current_device()) == "resident"
    wx, R, dhs, st = _slstm_inputs(dev, B, S, d, seed=8, state=True)
    for state in (None, st):
        for save in (True, False):
            got = ops._launch_fwd(wx, R, state, save, "resident")
            want = ops._launch_fwd(wx, R, state, save, "step")
            flat = [got[0], *got[1], *(got[2] if save else ())]
            ref = [want[0], *want[1], *(want[2] if save else ())]
            assert all(torch.equal(a, b) for a, b in zip(flat, ref)), (state is None, save)
    hs, _, saved = slstm_fwd(wx, R, save=True)
    got = ops._launch_bwd(dhs, R, hs, saved, "resident")
    want = ops._launch_bwd(dhs, R, hs, saved, "step")
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("B,S,d", [(8, 512, 2048), (2, 64, 256)])
def test_slstm_resident_calls_on_two_streams_at_once_equal_the_calls_in_series(dev, B, S, d):
    """Two resident forwards and backwards on two streams at once (each its
    own barrier counter; at xlstm's width the second grid cannot start
    until the first has left the card, at d = 256 both hold the card
    together) equal the same calls made one after the other."""
    from repro_torch.kernels.slstm import slstm_bwd, slstm_fwd

    inputs = [_slstm_inputs(dev, B, S, d, seed=20 + i) for i in range(2)]

    def call(wx, R, dhs):
        hs, last, saved = slstm_fwd(wx, R, save=True)
        return [hs, *last, *saved, *slstm_bwd(dhs, R, hs, saved)]

    series = [call(*x[:3]) for x in inputs]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(dev) for _ in inputs]
    outs = []
    for s, x in zip(streams, inputs):
        s.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(s):
            outs.append(call(*x[:3]))
    torch.cuda.synchronize()
    for got, want in zip(outs, series):
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_slstm_a_grid_the_card_cannot_hold_is_refused_and_raised(dev):
    """A cooperative grid past what the card holds at once is refused by
    the runtime and raised, never run (a barrier across it would wait for
    blocks that never start), and the counter's count stays; a resident
    call at a shape past the route's limits is refused by its entry."""
    from repro_torch.kernels.slstm import ops

    card = torch.cuda.current_device()
    ws = ops._barrier(card, torch.cuda.current_stream(card).cuda_stream)
    counted = ws[1]
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    with pytest.raises(RuntimeError, match="svc_slstm_barrier_probe"):
        ops.barrier_probe(dev, 64 * sms, 1)
    assert ws[1] == counted
    blocks = 128
    ops.barrier_probe(dev, blocks, 3)  # a grid it holds passes its barriers
    torch.cuda.synchronize()
    assert ws[1] == counted + 3 * blocks
    assert int(ws[0].item()) == ws[1]
    wx, R, _, _ = _slstm_inputs(dev, 2, 3, 4096)
    with pytest.raises(RuntimeError, match="svc_slstm_fwd_resident"):
        ops._launch_fwd(wx, R, None, False, "resident")


def test_slstm_wrappers_refuse_a_width_the_kernel_does_not_take(dev):
    from repro_torch.kernels.slstm import slstm_fwd

    wx, R, _, _ = _slstm_inputs(dev, 2, 3, 96)
    with pytest.raises(ValueError, match="multiple of 64"):
        slstm_fwd(wx, R)


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_slstm_train_step_on_the_card_matches_the_cpu_under_remat(dev, remat):
    """xlstm's smoke config, one train step from the same masters under
    each remat mode: loss and grad norm within 1e-5 relative, every
    gradient within 1e-4 of its leaf's largest; the card calls the
    forward kernel once a layer (twice under remat, which recomputes the
    loop) and the backward kernel once, each call the route rule's
    launches (one on the resident route, 32 on the per-step route)."""
    import dataclasses

    from repro_torch import kernels
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.slstm import ops
    from repro_torch.models import get_model
    from repro_torch.training import AdamWConfig, init_train_state, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_smoke_config("xlstm-1.3b"), remat=remat)
    toks = torch.randint(0, cfg.vocab, (4, 32), generator=torch.Generator().manual_seed(6),
                         dtype=torch.int32)
    models = [get_model(cfg, device=device, train=True) for device in ("cpu", dev)]
    states = [init_train_state(m, 0) for m in models]
    states[1].params.load_state_dict(states[0].params.state_dict())
    runs = []
    for model, state in zip(models, states):
        d = model.device
        batch = {"tokens": toks.to(d), "labels": toks.roll(-1, 1).to(d),
                 "domain": torch.arange(4, dtype=torch.int32, device=d)}
        before = kernels.launch_counts()
        runs.append(make_train_step(model, AdamWConfig(lr=1e-3))(state, batch))
        after = kernels.launch_counts()
    layers = cfg.n_layers // cfg.slstm_every
    per_call = ops.launches_per_call(4, 32, cfg.d_model, torch.cuda.current_device())
    assert per_call == 1  # the smoke config's width takes the resident route
    assert after["slstm_fwd"] - before["slstm_fwd"] == layers * per_call * (
        1 if remat == "none" else 2)
    assert after["slstm_bwd"] - before["slstm_bwd"] == layers * per_call
    (cs, cm), (ds, dm) = runs
    for key in ("loss", "grad_norm"):
        assert abs(float(dm[key]) - float(cm[key])) <= 1e-5 * abs(float(cm[key])), key
    cpu = dict(cs.params.named_parameters())
    for name, p in ds.params.named_parameters():
        want = cpu[name].grad
        assert float((p.grad.cpu() - want).abs().max()) <= 1e-4 * float(want.abs().max()), name


# ---------------------------------------------------------------------------
# the cross-entropy over the vocabulary (csrc/cross_entropy.cu)
# ---------------------------------------------------------------------------

# the forward's lse and nll against the plain version's: float32 sums of the
# row's exps in another order (~1,000 terms a thread, then 256 partials), an
# absolute error of a few 1e-6 on an lse of ~12
CE_TOL = 1e-5
CE_VOCABS = (50_304, 256_000, 256_206)  # xlstm-1.3b, gemma-2b, seamless-m4t-large-v2


def _ce_inputs(dev, N, V, dtype, seed, label_dtype=torch.int32):
    """(logits (N, V), labels (N,)): seeded normal logits times 3; row 0 a
    row of -inf, row 1 V equal values (ties), labels at random with rows
    2–5 wrapped (−1, −V) and out of range (V, −V − 1)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn((N, V), generator=g) * 3.0
    x[0] = -float("inf")
    x[1] = 7.0
    lab = torch.randint(0, V, (N,), generator=g)
    lab[2:6] = torch.tensor([-1, -V, V, -V - 1])
    return x.to(dtype).to(dev), lab.to(label_dtype).to(dev)


def _hold_ce_forward(got, want, what):
    """(lse, nll) or (nll,) against the plain version's: NaN and infinities
    where it has them, the rest within CE_TOL of its largest magnitude (at
    least 1)."""
    for name, a, b in zip(("lse", "nll"), got, want):
        a, b = a.cpu().double(), b.cpu().double()
        assert torch.equal(a.isnan(), b.isnan()), (what, name)
        ok = ~b.isnan()
        assert torch.equal(a[ok].isinf(), b[ok].isinf()) and torch.equal(
            a[ok & a.isinf()], b[ok & b.isinf()]), (what, name)
        fin = ok & ~b.isinf()
        err = float((a[fin] - b[fin]).abs().max())
        assert err <= CE_TOL * max(1.0, float(b[fin].abs().max())), (what, name, err)


def _hold_ce_backward(got, want, what):
    """float32 within 1e-6 of each row's largest |gradient|, bf16 within one
    bf16 ulp of the plain version's (both round one float32 value once);
    NaN where it has NaN (a row of -inf)."""
    assert got.dtype == want.dtype and got.shape == want.shape
    a, b = got.cpu().double(), want.cpu().double()
    assert torch.equal(a.isnan(), b.isnan()), what
    rows = ~b.isnan().any(-1)
    a, b = a[rows], b[rows]
    err = (a - b).abs()
    if got.dtype == torch.float32:
        scale = b.abs().amax(-1, keepdim=True)
        assert bool((err <= 1e-6 * scale).all()), (what, float((err / scale).max()))
    else:
        ulp = torch.exp2(torch.floor(torch.log2(b.abs().clamp(min=1e-38))) - 7)
        assert bool((err <= ulp).all()), (what, float((err / ulp).max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("V", CE_VOCABS)
def test_cross_entropy_kernels_match_the_plain_version(dev, V, dtype):
    """An odd row count, int32 labels at 50,304 and int64 elsewhere; the
    backward from the kernel's own lse against the plain backward on it."""
    from repro_torch.kernels.cross_entropy import (cross_entropy_bwd, cross_entropy_bwd_ref,
                                                   cross_entropy_fwd, cross_entropy_ref)

    x, lab = _ce_inputs(dev, 37, V, dtype, seed=V,
                        label_dtype=torch.int32 if V == 50_304 else torch.int64)
    got = cross_entropy_fwd(x, lab)
    _hold_ce_forward(got, cross_entropy_ref(x, lab), ("fwd", V, dtype))
    assert float(got[0][0]) == -float("inf") and got[1].isnan()[[0, 4, 5]].all()
    lse = got[0]
    g = torch.Generator(device="cpu").manual_seed(1)
    g_lse, g_nll = (torch.randn(37, generator=g).to(dev) for _ in range(2))
    d = cross_entropy_bwd(x, lab, lse, g_lse, g_nll)
    _hold_ce_backward(d, cross_entropy_bwd_ref(x, lab, lse, g_lse, g_nll), ("bwd", V, dtype))


def test_cross_entropy_past_two_to_the_31_elements(dev):
    """8,400 rows of 256,000 bf16 logits (2.15e9 elements): the last rows,
    past element 2^31, against the plain version on those rows alone."""
    from repro_torch.kernels.cross_entropy import (cross_entropy_bwd, cross_entropy_bwd_ref,
                                                   cross_entropy_fwd, cross_entropy_ref)

    N, V = 8_400, 256_000
    assert N * V > 2 ** 31
    x = torch.empty((N, V), dtype=torch.bfloat16, device=dev)
    x.normal_(generator=torch.Generator(device=dev).manual_seed(2))
    lab = torch.randint(0, V, (N,), device=dev)
    lse, nll = cross_entropy_fwd(x, lab)
    tail = slice(N - 5, N)
    _hold_ce_forward((lse[tail], nll[tail]), cross_entropy_ref(x[tail], lab[tail]), "past 2^31")
    ones = torch.ones(N, device=dev)
    d = cross_entropy_bwd(x, lab, lse, ones, ones)
    _hold_ce_backward(d[tail], cross_entropy_bwd_ref(x[tail], lab[tail], lse[tail], ones[tail],
                                                     ones[tail]), "past 2^31")


def test_cross_entropy_repeats_bit_for_bit(dev):
    from repro_torch.kernels.cross_entropy import cross_entropy_bwd, cross_entropy_fwd

    x, lab = _ce_inputs(dev, 33, 256_206, torch.bfloat16, seed=3)
    ones = torch.ones(33, device=dev)
    outs = []
    for _ in range(2):
        lse, nll = cross_entropy_fwd(x, lab)
        outs.append((lse, nll, cross_entropy_bwd(x, lab, lse, ones, ones)))
    for a, b in zip(*outs):
        assert torch.equal(a.isnan(), b.isnan())
        assert torch.equal(a.nan_to_num(), b.nan_to_num())


def test_cross_entropy_launches_once_each_without_a_synchronize(dev):
    """``train_step.cross_entropy`` on the card: one launch of each kernel a
    forward and backward (the wrappers' counts, exactly; the profiler's
    device rows at most one a wrapper call: no copy or memset beside the
    kernel, and late in a long test run the profiler drops rows, never adds
    one), no synchronize; its loss and gradient against the CPU's plain
    composition."""
    from repro_torch import kernels
    from repro_torch.kernels.cross_entropy import cross_entropy_bwd, cross_entropy_fwd
    from repro_torch.training.train_step import cross_entropy

    x, lab = _ce_inputs(dev, 64, 50_304, torch.bfloat16, seed=4)
    x[0] = 0.0  # a finite loss
    lab[2:6] = torch.tensor([-1, -50_304, 7, 9], device=dev)
    lab = lab.reshape(4, 16)
    x = x.reshape(4, 16, -1)
    a = x.clone().requires_grad_()
    cross_entropy(a, lab)[0].backward()  # built and warm
    a.grad = None
    before = kernels.launch_counts()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss, nll = cross_entropy(a, lab)
        loss.backward()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    after = kernels.launch_counts()
    assert (after["cross_entropy_fwd"] - before["cross_entropy_fwd"],
            after["cross_entropy_bwd"] - before["cross_entropy_bwd"]) == (1, 1)
    c = x.cpu().clone().requires_grad_()
    closs, cnll = cross_entropy(c, lab.cpu())
    closs.backward()
    assert abs(float(loss.detach()) - float(closs)) <= 1e-6 * abs(float(closs))
    _hold_ce_forward((nll.reshape(-1),), (cnll.reshape(-1),), "train_step nll")
    _hold_ce_backward(a.grad.reshape(64, -1), c.grad.reshape(64, -1), "train_step")
    lse, _ = cross_entropy_fwd(x, lab)
    ones = torch.ones_like(lse)
    assert _device_launches(lambda: cross_entropy_fwd(x, lab)) <= 1
    assert _device_launches(lambda: cross_entropy_bwd(x, lab, lse, ones, ones)) <= 1


@pytest.mark.parametrize("case", ["float16 logits", "float64 logits", "float labels",
                                  "labels on the CPU", "a float64 gradient"])
def test_cross_entropy_refuses_what_the_kernel_does_not_take(dev, case):
    """A raise, no launch and no plain fallback."""
    from repro_torch import kernels
    from repro_torch.kernels.cross_entropy import CrossEntropy, cross_entropy_bwd, cross_entropy_fwd

    x, lab = _ce_inputs(dev, 8, 100, torch.float32, seed=5)
    before = kernels.launch_counts()
    ones = torch.ones(8, device=dev)
    with pytest.raises((TypeError, ValueError)):
        if case == "float16 logits":
            CrossEntropy.apply(x.half(), lab)
        elif case == "float64 logits":
            cross_entropy_fwd(x.double(), lab)
        elif case == "float labels":
            cross_entropy_fwd(x, lab.float())
        elif case == "labels on the CPU":
            cross_entropy_fwd(x, lab.cpu())
        else:
            cross_entropy_bwd(x, lab, ones, ones, ones.double())
    assert kernels.launch_counts() == before


def test_cross_entropy_launches_on_the_last_card(last_card):
    from repro_torch import kernels
    from repro_torch.kernels.cross_entropy import (cross_entropy_bwd, cross_entropy_bwd_ref,
                                                   cross_entropy_fwd, cross_entropy_ref)

    x, lab = _ce_inputs(last_card, 9, 256_206, torch.bfloat16, seed=6)
    before = kernels.launch_counts()
    lse, nll = cross_entropy_fwd(x, lab)
    ones = torch.ones(9, device=last_card)
    d = cross_entropy_bwd(x, lab, lse, ones, ones)
    after = kernels.launch_counts()
    assert (after["cross_entropy_fwd"] - before["cross_entropy_fwd"],
            after["cross_entropy_bwd"] - before["cross_entropy_bwd"]) == (1, 1)
    assert lse.device == nll.device == d.device == last_card
    _hold_ce_forward((lse, nll), cross_entropy_ref(x, lab), "last card")
    _hold_ce_backward(d, cross_entropy_bwd_ref(x, lab, lse, ones, ones), "last card")
    with pytest.raises(ValueError, match="expected"):
        cross_entropy_fwd(x, lab.to("cuda:0"))
