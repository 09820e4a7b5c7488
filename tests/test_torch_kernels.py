"""Plain versions of the port's kernels against the JAX package's kernels.

Each kernel wrapper in ``repro_torch.kernels`` takes its plain PyTorch
version for CPU tensors.  The same numpy inputs go through that plain
version, JAX's Pallas kernel (interpret mode, ``use_pallas=True``) and
JAX's ``ref.py``.  Masks, codes and counts must be exact; float moments
within 1e-6 relative (the port's ground rule).  The glue that only the
CUDA path runs on the host (selector indices, digest-table packing) is
checked here too; the kernels themselves run in tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.hashing import key_digest as jax_key_digest
from repro.kernels.fused_clean.ops import fused_clean_groupby as jax_fused_clean
from repro.kernels.fused_clean.ref import fused_clean_ref as jax_fused_clean_ref
from repro.kernels.multi_agg import multi_agg_moments as jax_multi_agg
from repro.kernels.multi_agg.ref import multi_agg_ref as jax_multi_agg_ref
from repro.kernels.outlier_member import fused_hash_member as jax_fused_hash_member
from repro.kernels.outlier_member import outlier_member as jax_outlier_member
from repro.kernels.outlier_member.ref import fused_hash_member_ref as jax_fused_hash_member_ref
from repro_torch import kernels as port_kernels
from repro_torch.kernels.fused_clean.ops import fused_clean_groupby
from repro_torch.kernels.multi_agg.ops import multi_agg_moments, selector_indices
from repro_torch.kernels.multi_agg.ref import K_D, K_NEW, K_OLD, S_D, S_NEW, S_OLD
from repro_torch.kernels.outlier_member.ops import _as_i32_bits, fused_hash_member, outlier_member
from repro_torch.kernels.outlier_member.ref import pack_digest, sorted_digest_table
from repro_torch.relational.relation import SENTINEL_KEY

T = torch.from_numpy


# ---------------------------------------------------------------------------
# fused_clean
# ---------------------------------------------------------------------------

def _clean_inputs(rng, R, C, G, pin_density):
    gid = rng.integers(-1, G + 8, R).astype(np.int32)  # -1 and ≥ G both drop
    gid[:3] = [-1, G, G + 7]
    vals = rng.uniform(0.5, 50.0, (R, C)).astype(np.float32)
    valid = rng.uniform(size=R) < 0.9
    pin = rng.uniform(size=R) < pin_density
    return gid, vals, valid, pin


@pytest.mark.parametrize("shape", [(5, 1, 64), (777, 1, 64), (3000, 3, 200), (5000, 2, 1024)])
@pytest.mark.parametrize("pin_density", [0.0, 0.1])
@pytest.mark.parametrize("m", [0.1, 0.5])
def test_fused_clean_plain_matches_jax(shape, pin_density, m):
    R, C, G = shape
    rng = np.random.default_rng(R + C + int(m * 10))
    gid, vals, valid, pin = _clean_inputs(rng, R, C, G, pin_density)
    pin_t = T(pin) if pin_density else None
    pin_j = jnp.asarray(pin) if pin_density else None
    counts, sums = fused_clean_groupby(T(gid), T(vals), T(valid), m, 5, G, pin_mask=pin_t)
    jc, js = jax_fused_clean(jnp.asarray(gid), jnp.asarray(vals), jnp.asarray(valid), m, 5, G,
                             pin_mask=pin_j, use_pallas=True)
    rc, rs = jax_fused_clean_ref(jnp.asarray(gid), jnp.asarray(vals), jnp.asarray(valid), m, 5,
                                 G, pin_mask=pin_j)
    for want_c, want_s in ((jc, js), (rc, rs)):
        assert np.array_equal(counts.numpy(), np.asarray(want_c))
        np.testing.assert_allclose(sums.numpy(), np.asarray(want_s), rtol=1e-6, atol=0)
    if R > 100:
        assert counts.sum() > 0


def test_fused_clean_one_dim_values_and_checks():
    gid = torch.tensor([0, 1, 1, 3], dtype=torch.int32)
    valid = torch.ones(4, dtype=torch.bool)
    c, s = fused_clean_groupby(gid, torch.tensor([1.0, 2.0, 3.0, 4.0]), valid, 1.0, 0, 4)
    assert c.tolist() == [1.0, 2.0, 0.0, 1.0] and s.tolist() == [1.0, 5.0, 0.0, 4.0]
    with pytest.raises(TypeError):
        fused_clean_groupby(gid.long(), torch.ones(4), valid, 1.0, 0, 4)
    with pytest.raises(ValueError):
        fused_clean_groupby(gid, torch.ones(3), valid[:3], 1.0, 0, 4)


# ---------------------------------------------------------------------------
# outlier_member
# ---------------------------------------------------------------------------

def _member_inputs(rng, n, k, ncols):
    keys = [rng.integers(0, 400, k).astype(np.int32) for _ in range(ncols)]
    probe = [rng.integers(0, 400, n).astype(np.int32) for _ in range(ncols)]
    hits = rng.integers(0, k, max(1, n // 8))
    for c in range(ncols):
        probe[c][: len(hits)] = keys[c][hits]
    probe[0][-1] = SENTINEL_KEY  # a sentinel probe row is never a member
    keys[0][-1] = SENTINEL_KEY  # nor does a sentinel index slot match a live row
    return probe, keys


@pytest.mark.parametrize("n,k", [(1, 1), (5001, 257), (3000, 3000)])
@pytest.mark.parametrize("ncols", [1, 2, 3])
def test_outlier_member_plain_matches_jax(n, k, ncols):
    rng = np.random.default_rng(n * 7 + k + ncols)
    probe, keys = _member_inputs(rng, n, k, ncols)
    jp, jk = tuple(jnp.asarray(p) for p in probe), tuple(jnp.asarray(c) for c in keys)
    got = outlier_member([T(p) for p in probe], [T(c) for c in keys]).numpy()
    # JAX: Pallas kernel for K ≤ 2048, its binary-search path beyond
    assert np.array_equal(got, np.asarray(jax_outlier_member(jp, jk, use_pallas=True)))
    for m in (0.0, 0.3):
        keep, mem = fused_hash_member([T(p) for p in probe], m, 11, [T(c) for c in keys])
        khi, klo = jax_key_digest(jk)
        rkeep, rmem = jax_fused_hash_member_ref(jp, m, 11, khi, klo)
        pkeep, pmem = jax_fused_hash_member(jp, m, 11, jk, use_pallas=True)
        for want_keep, want_mem in ((rkeep, rmem), (pkeep, pmem)):
            assert np.array_equal(keep.numpy(), np.asarray(want_keep))
            assert np.array_equal(mem.numpy(), np.asarray(want_mem))
    assert not got[-1]


def test_digest_table_packing_is_lexicographic_unsigned():
    hi = torch.tensor([0, 0, 2**31 - 1, 2**31, 2**32 - 1, 2**32 - 1], dtype=torch.int64)
    lo = torch.tensor([0, 2**32 - 1, 5, 0, 0, 2**32 - 1], dtype=torch.int64)
    packed = pack_digest(hi, lo)
    assert torch.equal(torch.sort(packed).values, packed)  # already in (hi, lo) order
    # the kernel's int32 lanes carry the same bits back out of the table
    assert torch.equal(((packed >> 32) + 2**31), hi)
    assert torch.equal(packed & 0xFFFFFFFF, lo)
    bits = _as_i32_bits(hi)
    assert bits.dtype == torch.int32 and torch.equal(bits.to(torch.int64) & 0xFFFFFFFF, hi)
    table = sorted_digest_table((torch.tensor([3, 1, 2], dtype=torch.int32),))
    assert torch.equal(torch.sort(table).values, table)


# ---------------------------------------------------------------------------
# multi_agg
# ---------------------------------------------------------------------------

def _panel(rng, R, C):
    x = rng.normal(10.0, 4.0, (R, C)).astype(np.float32)
    valid = rng.uniform(size=R) < 0.8
    pin = rng.uniform(size=R) < 0.1
    m = 0.25
    w = np.where(pin, 1.0, 1.0 / m).astype(np.float32)
    ompi = np.where(pin, 0.0, 1.0 - m).astype(np.float32)
    return x, valid, w, ompi


def _batch(rng, C, Q, P):
    """Random encoded sel/meta (repro.query.batch layout): count/sum/avg with
    0..P predicate terms; unused blocks stay all-zero with ±inf bounds."""
    sel = np.zeros(((1 + P) * C, Q), np.float32)
    meta = np.zeros((2 + 4 * P, Q), np.float32)
    meta[2::4], meta[3::4], meta[4::4], meta[5::4] = -np.inf, -np.inf, np.inf, np.inf
    for q in range(Q):
        op = q % 3
        if op == 1:
            meta[0, q] = 1.0  # count: all-zero value selector
        else:
            sel[rng.integers(0, C), q] = 1.0
            meta[1, q] = 1.0 if op == 2 else 0.0
        for p in range(q % (P + 1)):
            sel[(1 + p) * C + rng.integers(0, C), q] = 1.0
            lo = rng.normal(8.0, 3.0)
            meta[2 + 4 * p, q] = lo
            meta[4 + 4 * p, q] = lo + abs(rng.normal(0, 6.0))
    return sel, meta


def _assert_moments(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    for k in (K_NEW, K_OLD, K_D):
        assert np.array_equal(got[k], want[k]), k
    scale = np.abs(want)
    scale[S_D] = np.abs(want[S_NEW]) + np.abs(want[S_OLD])  # Σ|d| ≤ Σ|t_new| + Σ|t_old|
    assert np.all(np.abs(got - want) <= 1e-6 * scale + 1e-6)


@pytest.mark.parametrize("shape", [(64, 2, 3, 1), (300, 5, 9, 2), (1024, 3, 17, 1)])
def test_multi_agg_plain_matches_jax(shape):
    R, C, Q, P = shape
    rng = np.random.default_rng(R + Q)
    new, old = _panel(rng, R, C), _panel(rng, R, C)
    sel, meta = _batch(rng, C, Q, P)
    jn, jo = [jnp.asarray(a) for a in new], [jnp.asarray(a) for a in old]
    tn, to = [T(a) for a in new], [T(a) for a in old]
    two = multi_agg_moments(*tn, T(sel), T(meta), *to)
    _assert_moments(two, jax_multi_agg_ref(*jn, jnp.asarray(sel), jnp.asarray(meta), *jo))
    _assert_moments(two, jax_multi_agg(*jn, jnp.asarray(sel), jnp.asarray(meta), *jo,
                                       use_pallas=True))
    one = multi_agg_moments(*tn, T(sel), T(meta))
    _assert_moments(one, jax_multi_agg_ref(*jn, jnp.asarray(sel), jnp.asarray(meta)))
    _assert_moments(one, jax_multi_agg(*jn, jnp.asarray(sel), jnp.asarray(meta),
                                       use_pallas=True))
    assert np.all(one.numpy()[4:] == 0)


def test_selector_indices_round_trip_and_reject_non_one_hot():
    rng = np.random.default_rng(0)
    C, Q, P = 4, 10, 2
    sel, _meta = _batch(rng, C, Q, P)
    idx = selector_indices(T(sel), C)
    assert idx.shape == (1 + P, Q) and idx.dtype == torch.int32
    back = np.zeros_like(sel)
    for p in range(1 + P):
        for q in range(Q):
            if idx[p, q] >= 0:
                back[p * C + idx[p, q], q] = 1.0
    assert np.array_equal(back, sel)
    assert (idx[0] == -1).any()  # count queries: all-zero value selector reads 0.0
    bad = sel.copy()
    bad[:C, 0] = 1.0
    with pytest.raises(ValueError):
        selector_indices(T(bad), C)
    half = sel.copy()
    half[half == 1.0] = 0.5
    with pytest.raises(ValueError):
        selector_indices(T(half), C)


def test_cpu_runs_never_count_as_launches():
    before = port_kernels.launch_counts()
    gid = torch.zeros(4, dtype=torch.int32)
    fused_clean_groupby(gid, torch.ones(4, 1), torch.ones(4, dtype=torch.bool), 1.0, 0, 2)
    wrappers = port_kernels.wrappers()
    wrappers["fused_clean_fleet"](gid[None], torch.ones(1, 4, 1),
                                  torch.ones(1, 4, dtype=torch.bool), (1.0,), (0,), 2)
    wrappers["fleet_merge"](gid[None], torch.ones(1, 4, dtype=torch.bool), torch.ones(1, 4, 1),
                            torch.ones(1, 2, dtype=torch.bool), torch.ones(1, 2, 1))
    wrappers["fleet_moments"](*[torch.ones(2, 4)] * 8)
    wrappers["fleet_score"](torch.ones(2, 13))
    wrappers["segment_aggsum"](gid, torch.ones(4, 2), 2)
    wrappers["corr_diff"](torch.ones(4), torch.zeros(4), torch.ones(4, dtype=torch.bool))
    assert port_kernels.launch_counts() == before
    assert set(before) == {"hash_threshold", "fused_clean", "outlier_member",
                           "multi_agg_two", "multi_agg_one", "fused_clean_fleet",
                           "fleet_merge", "fleet_moments", "fleet_score",
                           "segment_aggsum", "corr_diff"}
