"""The group-by through ``segment_groupby`` against its previous computation.

``repro_torch.relational.ops.groupby`` now sums its counts and every sum
and mean column in one ``segment_groupby`` call over a stacked panel, and
gathers only the columns its aggregates read.  On the CPU that call is the
plain version (``index_add_`` in int32 and float32), so the output must
equal, bit for bit, the computation it replaced: one int32 ``index_add_``
of the counts and one float32 ``index_add_`` per column over every
gathered column, kept below as ``groupby_per_column``.  The sorted entry
of ``segment_sum`` is held to JAX's ``segment_sum`` (Pallas in interpret
mode) and ``segment_sum_ref`` at the tolerance of
``tests/test_torch_svc_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.segment_aggsum.ops import segment_sum as jax_segment_sum
from repro.kernels.segment_aggsum.ref import segment_sum_ref as jax_segment_sum_ref
from repro_torch.kernels.segment_aggsum import segment_groupby, segment_groupby_ref, segment_sum
from repro_torch.relational import ops
from repro_torch.relational.expr import Bin, Boolean, Cmp, Col, IsNotNull, Lit, eval_expr
from repro_torch.relational.relation import (
    Relation,
    Schema,
    as_column,
    from_columns,
    keys_equal,
    lexsort_indices,
    sentinel_where,
    zeros_where,
)

T = torch.from_numpy


def groupby_per_column(rel, keys, aggs, num_groups):
    """The group-by as it was computed before the segment kernel: int64 group
    ids, every column gathered, one ``index_add_`` per count and sum column."""
    keys = tuple(keys)
    kcols = tuple(sentinel_where(rel.valid, rel.col(c)) for c in keys)
    order = lexsort_indices(kcols)
    sk = tuple(k[order] for k in kcols)
    sv = rel.valid[order]
    first = torch.arange(rel.capacity) == 0
    is_start = sv & (~keys_equal(sk, tuple(ops._shift_prev(k) for k in sk)) | first)
    gid = torch.cumsum(is_start, 0) - 1
    gid = torch.where(sv, gid.clamp(0, num_groups), torch.full_like(gid, num_groups))
    nseg = num_groups + 1
    out_cols = {}
    start_slot = torch.where(is_start, gid, torch.full_like(gid, nseg))
    for c, k in zip(keys, sk):
        out = torch.empty(nseg + 1, dtype=k.dtype)
        out.index_put_((start_slot,), k)
        out_cols[c] = out[:num_groups]
    counts = torch.zeros(nseg, dtype=torch.int32)
    counts.index_add_(0, gid, sv.to(torch.int32))
    counts = counts[:num_groups]
    group_valid = counts > 0
    sorted_cols = {c: rel.col(c)[order] for c in rel.schema.columns}
    for out, (fn, value) in aggs.items():
        if fn == "count":
            out_cols[out] = counts.to(torch.float32)
            continue
        v = sorted_cols[value] if isinstance(value, str) else eval_expr(value, sorted_cols)
        v = as_column(v, rel.device).to(torch.float32).expand(sv.shape)
        if fn in ("sum", "mean"):
            s = torch.zeros(nseg, dtype=torch.float32)
            s.index_add_(0, gid, zeros_where(sv, v))
            s = s[:num_groups]
            out_cols[out] = s if fn == "sum" else s / counts.clamp(min=1)
        else:
            init = float("inf") if fn == "min" else float("-inf")
            s = torch.full((nseg,), init, dtype=torch.float32)
            s.scatter_reduce_(0, gid, torch.where(sv, v, torch.full_like(v, init)),
                              "amin" if fn == "min" else "amax")
            out_cols[out] = zeros_where(group_valid, s[:num_groups])
    for c in keys:
        out_cols[c] = sentinel_where(group_valid, out_cols[c])
    return Relation(out_cols, group_valid, Schema(pk=keys, columns=tuple(sorted(out_cols))))


def assert_bit_equal(got, want):
    assert got.schema == want.schema
    assert torch.equal(got.valid, want.valid)
    for c, w in want.columns.items():
        g = got.columns[c]
        assert g.dtype == w.dtype, c
        assert torch.equal(g.view(torch.int32) if g.is_floating_point() else g,
                           w.view(torch.int32) if w.is_floating_point() else w), c


AGGS = {
    "n": ("count", None),
    "s": ("sum", "val"),
    "mu": ("mean", "val"),
    "mn": ("min", "val"),
    "mx": ("max", "val"),
    "s2": ("sum", Bin("mul", Col("val"), Lit(2.0))),
    "big": ("sum", Cmp("gt", Col("val"), Lit(0.5))),
    "present": ("sum", IsNotNull("w")),  # reads w__present
    "lit": ("sum", Lit(3.0)),
    "both": ("mean", Boolean("and", (IsNotNull("w"), Cmp("lt", Col("w"), Lit(0.0))))),
}


def relation(rng, n, capacity, n_keys, composite=False, valid_share=1.0):
    """Keys Zipf-skewed (a hot group) with a few uniform ones; columns the
    aggregates read and three they do not; invalid rows among the valid."""
    k = np.where(rng.uniform(size=n) < 0.5, rng.zipf(1.6, n) % n_keys,
                 rng.integers(0, n_keys, n)).astype(np.int32)
    cols = {
        "id": np.arange(n, dtype=np.int32),
        "k": k,
        "val": (rng.normal(size=n) * rng.uniform(0.0, 1e6, n)).astype(np.float32),
        "w": rng.normal(size=n).astype(np.float32),
        "w__present": (rng.uniform(size=n) < 0.7).astype(np.int8),
        "unused_a": rng.normal(size=n).astype(np.float32),
        "unused_b": rng.integers(0, 9, n).astype(np.int32),
        "unused_c": rng.normal(size=n).astype(np.float32),
    }
    if composite:
        cols["k2"] = rng.integers(0, 3, n).astype(np.int32)
    valid = rng.uniform(size=n) < valid_share
    return from_columns(cols, pk=["id"], valid=valid, capacity=capacity, device="cpu")


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("case", ["room", "overflow", "invalid_rows", "composite", "one_group"])
def test_groupby_is_bit_equal_to_the_per_column_computation(seed, case):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(200, 3000))
    n_keys = 1 if case == "one_group" else int(rng.integers(5, 400))
    rel = relation(rng, n, n + int(rng.integers(0, 500)), n_keys,
                   composite=case == "composite",
                   valid_share=0.6 if case == "invalid_rows" else 1.0)
    keys = ("k", "k2") if case == "composite" else ("k",)
    groups = max(1, n_keys // 3) if case == "overflow" else 3 * n_keys + 5
    got = ops.groupby(rel, keys, AGGS, groups)
    assert_bit_equal(got, groupby_per_column(rel, keys, AGGS, groups))
    if case == "overflow":
        assert int(got.valid.sum()) == groups  # more groups than slots: the rest dropped


@pytest.mark.parametrize("aggs", [AGGS, {"n": ("count", None)}, {"mx": ("max", "val")},
                                  {"s": ("sum", "val"), "n": ("count", None)}])
def test_groupby_of_an_empty_relation(aggs):
    rel = relation(np.random.default_rng(0), 0, 0, 5)
    got = ops.groupby(rel, ("k",), aggs, 8)
    assert_bit_equal(got, groupby_per_column(rel, ("k",), aggs, 8))
    assert not bool(got.valid.any())


@pytest.mark.parametrize("aggs", [{"n": ("count", None)}, {"mn": ("min", "w")},
                                  {"present": ("sum", IsNotNull("nothing"))}])
def test_groupby_with_one_aggregate(aggs):
    rel = relation(np.random.default_rng(1), 500, 600, 40)
    assert_bit_equal(ops.groupby(rel, ("k",), aggs, 64),
                     groupby_per_column(rel, ("k",), aggs, 64))


def test_group_ids_are_sorted_int32():
    rel = relation(np.random.default_rng(2), 2000, 2500, 90, valid_share=0.8)
    _order, _sk, _sv, _start, gid = ops.group_ids(rel, ("k",), 50)
    assert gid.dtype == torch.int32
    assert bool((gid[1:] >= gid[:-1]).all())
    assert int(gid.max()) == 50  # invalid rows and groups past 50 share the overflow slot


def test_groupby_gathers_only_the_columns_its_aggregates_read(monkeypatch):
    rel = relation(np.random.default_rng(3), 300, 300, 20)
    gathered = []
    real = Relation.col

    def col(self, name):
        gathered.append(name)
        return real(self, name)

    monkeypatch.setattr(Relation, "col", col)
    ops.groupby(rel, ("k",), AGGS, 64)
    assert set(gathered) == {"k", "val", "w", "w__present"}


# ---------------------------------------------------------------------------
# segment_sum(indices_are_sorted=True) and segment_groupby's plain version
# ---------------------------------------------------------------------------

def _close_to_scale(got, want, scale, rtol=1e-6):
    got, want, scale = (np.asarray(x, np.float64) for x in (got, want, scale))
    assert np.all(np.abs(got - want) <= rtol * scale + 1e-30), np.max(np.abs(got - want))


@pytest.mark.parametrize("shape", [(100, 1, 10), (1000, 4, 50), (4096, 8, 300),
                                   (257, 3, 129), (1, 1, 1), (3000, 2, 1000)])
@pytest.mark.parametrize("out_of_range", [False, True])
def test_sorted_segment_sum_plain_matches_jax(shape, out_of_range):
    R, C, G = shape
    rng = np.random.default_rng(R + C + out_of_range)
    lo, hi = (-3, G + 4) if out_of_range else (0, G)
    gid = np.sort(rng.integers(lo, hi, R)).astype(np.int32)
    vals = rng.normal(size=(R, C)).astype(np.float32)
    vals[:, 0] = 1.0  # a count column
    got = segment_sum(T(gid), T(vals), G, indices_are_sorted=True).numpy()
    pallas = np.asarray(jax_segment_sum(jnp.asarray(gid), jnp.asarray(vals), G))
    ref = np.asarray(jax_segment_sum_ref(jnp.asarray(gid), jnp.asarray(vals), G))
    assert got.shape == pallas.shape == (G, C)
    keep = (gid >= 0) & (gid < G)
    scale = np.zeros((G, C))
    np.add.at(scale, gid[keep], np.abs(vals[keep]).astype(np.float64))
    for want in (pallas, ref):
        assert np.array_equal(got[:, 0], want[:, 0])  # counts exact
        _close_to_scale(got, want, scale)
    assert np.array_equal(got, segment_sum(T(gid), T(vals), G).numpy())  # one plain version


@pytest.mark.parametrize("R,C,G", [(1, 0, 1), (1000, 0, 30), (5000, 1, 64), (777, 3, 1000),
                                   (0, 2, 5), (50, 2, 0)])
def test_segment_groupby_plain_counts_in_int32(R, C, G):
    rng = np.random.default_rng(R + C + G)
    gid = np.sort(rng.integers(-2, G + 2, R)).astype(np.int32)
    vals = rng.normal(size=(R, C)).astype(np.float32)
    before = segment_groupby.launches
    counts, sums = segment_groupby(T(gid), T(vals), G)
    assert counts.dtype == torch.int32 and tuple(counts.shape) == (G,)
    assert sums.dtype == torch.float32 and tuple(sums.shape) == (G, C)
    keep = (gid >= 0) & (gid < G)
    assert np.array_equal(counts.numpy(), np.bincount(gid[keep], minlength=G)[:G])
    assert torch.equal(sums, segment_sum(T(gid), T(vals), G))
    want_c, want_s = segment_groupby_ref(T(gid), T(vals), G)
    assert torch.equal(counts, want_c) and torch.equal(sums, want_s)
    assert segment_groupby.launches == before  # CPU tensors take the plain version
