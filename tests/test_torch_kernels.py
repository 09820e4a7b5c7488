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
from repro.core.outliers import apply_hash_with_outliers as jax_apply_hash_with_outliers
from repro.kernels.fused_clean.ops import fused_clean_groupby as jax_fused_clean
from repro.kernels.fused_clean.ref import fused_clean_ref as jax_fused_clean_ref
from repro.kernels.multi_agg import multi_agg_moments as jax_multi_agg
from repro.kernels.multi_agg.ref import multi_agg_ref as jax_multi_agg_ref
from repro.kernels.outlier_member import fused_hash_member as jax_fused_hash_member
from repro.kernels.outlier_member import outlier_member as jax_outlier_member
from repro.kernels.outlier_member.ops import _sorted_digests as jax_sorted_digests
from repro.kernels.outlier_member.ref import fused_hash_member_ref as jax_fused_hash_member_ref
from repro_torch import kernels as port_kernels
from repro_torch.kernels.fused_clean.ops import fused_clean_groupby
from repro_torch.kernels.multi_agg.ops import multi_agg_moments, selector_indices
from repro_torch.kernels.multi_agg.ref import K_D, K_NEW, K_OLD, S_D, S_NEW, S_OLD
from repro_torch.kernels.outlier_member.ops import (
    digest_table,
    fused_hash_member,
    outlier_member,
    pinned_hash,
)
from repro_torch.kernels.outlier_member.ref import pack_digest, sorted_digest_table
from repro.relational.relation import from_columns as jax_from_columns
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
    # the table carries both lanes, and the kernel packs a probe digest to
    # the same int64: the bits (hi ^ 2^31)·2^32 | lo in two's complement
    assert torch.equal(((packed >> 32) + 2**31), hi)
    assert torch.equal(packed & 0xFFFFFFFF, lo)
    for h, lw, p in zip(hi.tolist(), lo.tolist(), packed.tolist()):
        u = ((h ^ 2**31) << 32) | lw
        assert p == (u - 2**64 if u >= 2**63 else u)
    table = sorted_digest_table((torch.tensor([3, 1, 2], dtype=torch.int32),))
    assert torch.equal(torch.sort(table).values, table)


@pytest.mark.parametrize("k,ncols", [(1, 1), (257, 2), (3000, 3)])
def test_digest_table_holds_jax_sorted_digest_lanes(k, ncols):
    _probe, keys = _member_inputs(np.random.default_rng(k + ncols), 1, k, ncols)
    table = digest_table([T(c) for c in keys])
    hi, lo = jax_sorted_digests(tuple(jnp.asarray(c) for c in keys))
    assert np.array_equal(((table >> 32) + 2**31).numpy(), np.asarray(hi).astype(np.int64))
    assert np.array_equal((table & 0xFFFFFFFF).numpy(), np.asarray(lo).astype(np.int64))


@pytest.mark.parametrize("n,k", [(1, 1), (5001, 257), (3000, 3000)])
@pytest.mark.parametrize("ncols", [1, 2])
@pytest.mark.parametrize("m", [0.0, 0.3])
def test_pinned_hash_plain_matches_jax_apply_hash_with_outliers(n, k, ncols, m):
    """Validity ∧ (η ∨ member) and the int8 ``__outlier`` flag, from the
    raw key columns and validity, against JAX's composition over the
    SENTINEL-masked probe."""
    rng = np.random.default_rng(n + k + ncols)
    probe, keys = _member_inputs(rng, n, k, ncols)
    valid = rng.uniform(size=n) < 0.8
    valid[-1] = True  # a valid row keyed SENTINEL: never a member
    names = tuple(f"k{c}" for c in range(ncols))
    rel = jax_from_columns({nm: p for nm, p in zip(names, probe)}, pk=names, valid=valid)
    want = jax_apply_hash_with_outliers(rel, names, m, 9,
                                        tuple(jnp.asarray(c) for c in keys))
    got_valid, got_flag = pinned_hash([T(p) for p in probe], T(valid), m, 9,
                                      digest_table([T(c) for c in keys]))
    assert np.array_equal(got_valid.numpy(), np.asarray(want.valid))
    assert np.array_equal(got_flag.numpy(), np.asarray(want.col("__outlier")))
    assert got_flag.dtype == torch.int8 and not got_flag[-1]


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


def _dashboards():
    """The query batches the port's engine parity tests encode (slice,
    pin, streaming and serving dashboards), a wide batch (four columns, up
    to four predicate slots), a batch past 16 queries and an empty one."""
    from repro_torch.core import Query
    from repro_torch.relational.expr import Cmp, Col, Lit, and_

    vc, tb, vid = Col("visitCount"), Col("totalBytes"), Col("videoId")
    slice_ = [
        Query("count"), Query("sum", "visitCount"), Query("sum", "totalBytes"),
        Query("avg", "totalBytes"), Query("avg", "visitCount"),
        Query("count", pred=Cmp("gt", vc, Lit(30.0))),
        Query("sum", "totalBytes", pred=Cmp("ge", vid, Lit(450.0))),
        Query("count", pred=Cmp("ge", vid, Lit(450.0))),
        Query("avg", "totalBytes", pred=Cmp("gt", vc, Lit(10.0))),
        Query("sum", "visitCount", pred=and_(Cmp("ge", vid, Lit(0.0)), Cmp("lt", vid, Lit(250.0)))),
        Query("sum", "totalBytes", pred=and_(Cmp("gt", vc, Lit(5.0)), Cmp("lt", vid, Lit(450.0)))),
        Query("count", pred=and_(Cmp("ge", vc, Lit(2.0)), Cmp("le", vc, Lit(50.0)))),
        Query("avg", "visitCount", pred=Cmp("lt", vid, Lit(100.0))),
        Query("sum", "totalBytes", pred=Cmp("le", vc, Lit(3.0))),
        Query("count", pred=Cmp("eq", vc, Lit(1.0))),
        Query("avg", "totalBytes", pred=and_(Cmp("ge", vid, Lit(450.0)), Cmp("gt", vc, Lit(1.0)))),
    ]
    pin = [Query("count"), Query("sum", "totalBytes"),
           Query("avg", "visitCount", pred=Cmp("gt", vc, Lit(5.0))),
           Query("sum", "visitCount", pred=Cmp("lt", vid, Lit(150.0)))]
    stream = [Query("count"), Query("sum", "totalBytes"), Query("avg", "visitCount")]
    serving = [Query("sum", "totalBytes", pred=Cmp("lt", vid, Lit(10.0 * (i + 1))))
               for i in range(5)]
    ext = Col("extra")
    wide = [Query("sum", "extra", pred=and_(Cmp("gt", vc, Lit(1.0)), Cmp("lt", tb, Lit(9.0)),
                                            Cmp("ge", vid, Lit(2.0)))),
            Query("count", pred=and_(Cmp("le", ext, Lit(4.0)), Cmp("gt", ext, Lit(-1.0)))),
            Query("avg", "videoId", pred=Cmp("lt", Lit(3.0), tb))]
    many = [Query("sum", "totalBytes", pred=Cmp("gt", vc, Lit(float(i)))) for i in range(20)]
    cols = ("videoId", "visitCount", "totalBytes")
    return {"slice": (slice_, cols), "pin": (pin, cols), "stream": (stream, cols),
            "serving": (serving, cols), "wide": (wide, cols + ("extra",)),
            "many": (many, cols), "empty": ([], cols)}


@pytest.mark.parametrize("name", ["slice", "pin", "stream", "serving", "wide", "many", "empty"])
def test_query_batch_sel_idx_is_the_decoded_selector(name):
    from repro_torch.query import QueryBatch

    queries, cols = _dashboards()[name]
    batch = QueryBatch.encode(queries, cols, "cpu")
    Qp, P = batch.sel.shape[1], batch.n_pred
    assert batch.sel_idx.dtype == torch.int32 and batch.sel_idx.shape == (1 + P, Qp)
    assert torch.equal(batch.sel_idx, selector_indices(batch.sel, len(cols)))


def test_encode_still_accepts_and_rejects_what_it_did():
    from repro_torch.core import Query
    from repro_torch.query import QueryBatch, UnsupportedQueryError
    from repro_torch.relational.expr import Cmp, Col, Lit, or_

    vid = Col("videoId")
    # no columns at all: a count needs none, and its selectors all read 0.0
    batch = QueryBatch.encode([Query("count")], (), "cpu")
    assert batch.sel.shape == (0, 8) and torch.equal(batch.sel_idx, torch.full((2, 8), -1,
                                                                                dtype=torch.int32))
    for bad in (Query("sum", "videoId", pred=Cmp("ne", vid, Lit(1.0))),
                Query("sum", "videoId", pred=or_(Cmp("lt", vid, Lit(1.0)),
                                                 Cmp("gt", vid, Lit(2.0)))),
                Query("max", "videoId"), Query("sum", "nope")):
        with pytest.raises(UnsupportedQueryError):
            QueryBatch.encode([bad], ("videoId",), "cpu")


@pytest.mark.parametrize("shape", [(64, 2, 3, 1), (300, 5, 9, 2), (1024, 3, 17, 1),
                                   (500, 4, 24, 4)])
def test_multi_agg_with_sel_idx_matches_without_and_jax(shape):
    R, C, Q, P = shape
    rng = np.random.default_rng(R + Q)
    new, old = _panel(rng, R, C), _panel(rng, R, C)
    sel, meta = _batch(rng, C, Q, P)
    idx = selector_indices(T(sel), C)
    tn, to = [T(a) for a in new], [T(a) for a in old]
    jn, jo = [jnp.asarray(a) for a in new], [jnp.asarray(a) for a in old]
    two = multi_agg_moments(*tn, T(sel), T(meta), *to, sel_idx=idx)
    assert torch.equal(two, multi_agg_moments(*tn, T(sel), T(meta), *to))
    _assert_moments(two, jax_multi_agg(*jn, jnp.asarray(sel), jnp.asarray(meta), *jo,
                                       use_pallas=True))
    one = multi_agg_moments(*tn, T(sel), T(meta), sel_idx=idx)
    assert torch.equal(one, multi_agg_moments(*tn, T(sel), T(meta)))
    _assert_moments(one, jax_multi_agg(*jn, jnp.asarray(sel), jnp.asarray(meta),
                                       use_pallas=True))
    with pytest.raises(TypeError):
        multi_agg_moments(*tn, T(sel), T(meta), sel_idx=idx.to(torch.int64))
    with pytest.raises(ValueError):
        multi_agg_moments(*tn, T(sel), T(meta), sel_idx=idx[:, :-1].contiguous())


def test_engine_passes_the_batch_sel_idx(monkeypatch):
    from repro_torch.core import Query
    from repro_torch.query import QueryBatch, engine
    from repro_torch.relational.relation import from_columns

    rng = np.random.default_rng(3)
    rel = from_columns({"k": np.arange(50, dtype=np.int32),
                        "a": rng.normal(5.0, 2.0, 50).astype(np.float32),
                        "b": rng.integers(0, 9, 50).astype(np.int32)}, pk=("k",), device="cpu")
    batch = QueryBatch.encode([Query("count"), Query("sum", "a"), Query("avg", "b")],
                              ("a", "b"), "cpu")
    seen = []

    def spy(*args, sel_idx=None):
        seen.append(sel_idx)
        return multi_agg_moments(*args, sel_idx=sel_idx)

    monkeypatch.setattr(engine, "multi_agg_moments", spy)
    exact = engine.exact_batch(rel, batch)
    engine.run_batch_aqp(rel, batch, 0.5)
    assert len(seen) == 2 and all(s is batch.sel_idx for s in seen)
    assert np.allclose(exact, [50.0, float(rel.col("a").sum()), float(rel.col("b").float().mean())],
                       rtol=1e-6)


def test_multi_agg_launch_plan():
    from repro_torch.kernels.multi_agg.ops import grid_blocks, query_chunk

    assert [query_chunk(q) for q in (1, 8, 9, 16, 64)] == [8, 8, 16, 16, 16]
    assert grid_blocks(0, 132) == 1 and grid_blocks(1, 132) == 1
    assert grid_blocks(257, 132) == 2 and grid_blocks(2_097_152, 132) == 264


def test_cpu_runs_never_count_as_launches():
    before = port_kernels.launch_counts()
    gid = torch.zeros(4, dtype=torch.int32)
    fused_clean_groupby(gid, torch.ones(4, 1), torch.ones(4, dtype=torch.bool), 1.0, 0, 2)
    wrappers = port_kernels.wrappers()
    wrappers["fused_clean_fleet"](gid[None], torch.ones(1, 4, 1),
                                  torch.ones(1, 4, dtype=torch.bool), (1.0,), (0,), 2)
    wrappers["fleet_merge"](gid[None], torch.ones(1, 4, dtype=torch.bool), torch.ones(1, 4, 1),
                            torch.ones(1, 2, dtype=torch.bool), torch.ones(1, 2, 1))
    table = wrappers["outlier_digest"]((gid,))
    wrappers["outlier_member"]((gid,), torch.ones(4, dtype=torch.bool), 0.5, 0, table)
    wrappers["fleet_moments"](*[torch.ones(2, 4)] * 8)
    wrappers["outlier_pin_table"]((gid,), torch.ones(4, dtype=torch.bool))
    wrappers["fleet_score"](torch.ones(2, 13))
    wrappers["fleet_score_sharded"](torch.ones(2, 3, 13))
    wrappers["fleet_score_host"](np.ones((2, 13), np.float32), "cpu")
    wrappers["fleet_score_sharded_host"](np.ones((2, 3, 13), np.float32), ["cpu", "cpu"])
    wrappers["segment_aggsum"](gid, torch.ones(4, 2), 2)
    wrappers["segment_aggsum_unsorted"](gid, torch.ones(4, 2), 2)
    wrappers["corr_diff"](torch.ones(4), torch.zeros(4), torch.ones(4, dtype=torch.bool))
    wrappers["flash_attention"](torch.ones(1, 2, 2, 16), torch.ones(1, 2, 1, 16),
                                torch.ones(1, 2, 1, 16))
    wrappers["flash_attention_bwd"](torch.ones(1, 2, 2, 16), torch.ones(1, 2, 1, 16),
                                    torch.ones(1, 2, 1, 16), torch.ones(1, 2, 2, 16),
                                    torch.zeros(1, 2, 2), torch.ones(1, 2, 2, 16))
    from repro_torch.training import AdamWConfig

    opt, leaf = AdamWConfig(), [torch.ones(3)]
    sc = wrappers["adamw_norm"](opt, leaf, torch.zeros((), dtype=torch.int32))
    wrappers["adamw_update"](opt, [torch.ones(3)], leaf, [torch.zeros(3)], [torch.zeros(3)],
                             [False], sc)
    hs, _, saved = wrappers["slstm_fwd"](torch.ones(1, 2, 16), torch.ones(4, 1, 4), save=True)
    wrappers["slstm_bwd"](torch.ones(1, 2, 4), torch.ones(4, 1, 4), hs, saved)
    lse, _ = wrappers["cross_entropy_fwd"](torch.ones(2, 5), torch.zeros(2, dtype=torch.int32))
    wrappers["cross_entropy_bwd"](torch.ones(2, 5), torch.zeros(2, dtype=torch.int32), lse,
                                  torch.ones(2), torch.ones(2))
    assert port_kernels.launch_counts() == before
    assert set(before) == {"hash_threshold", "fused_clean", "outlier_member", "outlier_digest",
                           "outlier_pin_table", "multi_agg_two", "multi_agg_one",
                           "fused_clean_fleet", "fleet_merge", "fleet_moments", "fleet_score",
                           "fleet_score_host", "fleet_score_sharded", "fleet_score_sharded_host",
                           "segment_aggsum", "segment_aggsum_unsorted", "corr_diff",
                           "flash_attention", "flash_attention_bwd", "adamw_norm",
                           "adamw_update", "slstm_fwd", "slstm_bwd", "cross_entropy_fwd",
                           "cross_entropy_bwd"}
