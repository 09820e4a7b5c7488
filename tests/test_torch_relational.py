"""repro_torch's relational operators against the oracle and the JAX engine.

The same numpy relations go through ``repro.relational.ops`` and
``repro_torch.relational.ops`` (on the CPU).  Both must agree slot for
slot — validity masks and valid rows, since capacities and row order feed
``compact`` and the arenas downstream — and with the plain-Python oracle.
"""

import numpy as np
import pytest
import torch

from repro.relational import from_columns as jax_from_columns
from repro.relational import ops as jops
from repro.relational import expr as jexpr
from repro.relational.relation import compact as jax_compact
from repro_torch.relational import expr as texpr
from repro_torch.relational import ops as tops
from repro_torch.relational.relation import compact, from_arrays, from_columns, to_host
from tests import oracle


def both(cols, pk, capacity=None):
    return (jax_from_columns(cols, pk=pk, capacity=capacity),
            from_columns(cols, pk=pk, capacity=capacity, device="cpu"))


def assert_same(t_rel, j_rel, rtol=1e-6):
    assert set(t_rel.columns) == set(j_rel.columns)
    assert t_rel.schema.pk == j_rel.schema.pk
    valid = np.asarray(j_rel.valid)
    assert np.array_equal(t_rel.valid.numpy(), valid)
    for c, jv in j_rel.columns.items():
        jv = np.asarray(jv)[valid]
        tv = t_rel.columns[c].numpy()[valid]
        assert tv.dtype == jv.dtype, c
        if np.issubdtype(jv.dtype, np.floating):
            np.testing.assert_allclose(tv, jv, rtol=rtol, atol=1e-6, err_msg=c)
        else:
            assert np.array_equal(tv, jv), c


def double_val(x):
    """The expression val * 2.0 in expression module ``x`` (each engine has its own)."""
    return x.Bin("mul", x.Col("val"), x.Lit(2.0))


def val_gt(x, thr):
    return x.Cmp("gt", x.Col("val"), x.Lit(thr))


def fact_cols(rng, n, n_dim):
    return {
        "fid": np.arange(n, dtype=np.int32),
        "dkey": rng.integers(0, n_dim, n).astype(np.int32),
        "val": rng.normal(size=n).astype(np.float32),
    }


def dim_cols(rng, n):
    return {"dkey": np.arange(n, dtype=np.int32), "w": rng.normal(size=n).astype(np.float32)}


@pytest.mark.parametrize("seed", range(4))
def test_groupby_matches_jax_and_oracle(seed):
    rng = np.random.default_rng(seed)
    n, nd = int(rng.integers(1, 120)), int(rng.integers(1, 15))
    jf, tf = both(fact_cols(rng, n, nd), ["fid"], capacity=n + 7)

    def aggs(x):
        return {"c": ("count", None), "s": ("sum", "val"), "mu": ("mean", "val"),
                "mn": ("min", "val"), "mx": ("max", "val"), "s2": ("sum", double_val(x))}

    for groups in (nd + 4, max(1, nd // 2)):  # room to spare, and overflow
        got = tops.groupby(tf, ("dkey",), aggs(texpr), num_groups=groups)
        assert_same(got, jops.groupby(jf, ("dkey",), aggs(jexpr), num_groups=groups))
    got = tops.groupby(tf, ("dkey",), aggs(texpr), num_groups=nd + 4)
    want = oracle.groupby(oracle.from_relation(tf), ("dkey",),
                          {k: v for k, v in aggs(texpr).items() if k != "s2"})
    assert oracle.rows_equal(oracle.from_relation(got), want, keys=("dkey",))


@pytest.mark.parametrize("seed", range(4))
def test_fk_join_and_select_project_match(seed):
    rng = np.random.default_rng(100 + seed)
    n, nd = int(rng.integers(1, 80)), int(rng.integers(1, 12))
    jf, tf = both(fact_cols(rng, n, nd + 2), ["fid"], capacity=n + 5)  # some keys miss
    jd, td = both(dim_cols(rng, nd), ["dkey"])
    got = tops.fk_join(tf, td, "dkey")
    assert_same(got, jops.fk_join(jf, jd, "dkey"))
    want = oracle.fk_join(oracle.from_relation(tf), oracle.from_relation(td), "dkey", "dkey")
    assert oracle.rows_equal(oracle.from_relation(got), want, keys=("fid",))
    sel = tops.select(got, val_gt(texpr, 0.1))
    jsel = jops.select(jops.fk_join(jf, jd, "dkey"), val_gt(jexpr, 0.1))
    assert_same(sel, jsel)
    proj = tops.project(sel, {"fid": "fid", "v2": double_val(texpr), "one": texpr.Lit(1)},
                        pk=("fid",))
    jproj = jops.project(jsel, {"fid": "fid", "v2": double_val(jexpr), "one": jexpr.Lit(1)},
                         pk=("fid",))
    assert_same(proj, jproj)


@pytest.mark.parametrize("how", ["outer", "inner", "left"])
@pytest.mark.parametrize("seed", range(3))
def test_outer_join_unique_matches_jax(how, seed):
    rng = np.random.default_rng(200 + seed)
    lk = rng.choice(40, int(rng.integers(1, 25)), replace=False).astype(np.int32)
    rk = rng.choice(40, int(rng.integers(1, 25)), replace=False).astype(np.int32)
    jl, tl = both({"k": lk, "a": rng.normal(size=lk.size).astype(np.float32)}, ["k"],
                  capacity=lk.size + 3)
    jr, tr = both({"k": rk, "a": rng.normal(size=rk.size).astype(np.float32)}, ["k"])
    got = tops.outer_join_unique(tl, tr, on=("k",), how=how, suffixes=("", "_r"))
    assert_same(got, jops.outer_join_unique(jl, jr, on=("k",), how=how, suffixes=("", "_r")))
    rows = {r["k"]: r for r in oracle.from_relation(got)}
    expect = {"outer": set(lk) | set(rk), "inner": set(lk) & set(rk), "left": set(lk)}[how]
    assert set(rows) == {int(k) for k in expect}
    for k in set(rows) - set(rk.tolist()):
        assert rows[k]["a_r"] == 0.0  # Ø→0 (Def. 4)


@pytest.mark.parametrize("composite", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_union_intersect_difference_match(composite, seed):
    rng = np.random.default_rng(300 + seed)

    def cols(n):
        c = {"x": rng.integers(0, 12, n).astype(np.int32),
             "v": rng.normal(size=n).astype(np.float32)}
        if composite:
            c["y"] = rng.integers(0, 3, n).astype(np.int32)
        return c

    pk = ["x", "y"] if composite else ["x"]

    def dedup(c):
        keys = np.stack([c[k] for k in pk], 1)
        _, first = np.unique(keys, axis=0, return_index=True)
        return {k: v[np.sort(first)] for k, v in c.items()}

    ja, ta = both(dedup(cols(20)), pk, capacity=24)
    jb, tb = both(dedup(cols(15)), pk)
    assert_same(tops.union_keyed(ta, tb), jops.union_keyed(ja, jb))
    assert_same(tops.intersect_keyed(ta, tb), jops.intersect_keyed(ja, jb))
    assert_same(tops.difference_keyed(ta, tb), jops.difference_keyed(ja, jb))
    keys_a = {tuple(r[k] for k in pk) for r in oracle.from_relation(ta)}
    keys_b = {tuple(r[k] for k in pk) for r in oracle.from_relation(tb)}
    got_d = {tuple(r[k] for k in pk) for r in oracle.from_relation(tops.difference_keyed(ta, tb))}
    assert got_d == keys_a - keys_b


@pytest.mark.parametrize("capacity", [None, 15, 40])
def test_compact_matches_jax_slot_for_slot(capacity):
    rng = np.random.default_rng(7)
    jf, tf = both(fact_cols(rng, 20, 4), ["fid"], capacity=27)
    got = compact(tops.select(tf, val_gt(texpr, 0.0)), capacity)
    want = jax_compact(jops.select(jf, val_gt(jexpr, 0.0)), capacity)
    assert got.capacity == want.capacity
    assert_same(got, want)
    assert np.array_equal(got.col("fid").numpy(), np.asarray(want.col("fid")))  # padding too


def test_from_arrays_carries_full_capacity():
    rng = np.random.default_rng(9)
    jf, _ = both(fact_cols(rng, 10, 3), ["fid"], capacity=16)
    rel = from_arrays({c: np.asarray(v) for c, v in jf.columns.items()},
                      np.asarray(jf.valid), jf.schema.pk, "cpu")
    assert rel.capacity == 16
    assert (rel.schema.pk, rel.schema.columns) == (jf.schema.pk, jf.schema.columns)
    assert rel.col("fid").dtype == torch.int32 and rel.col("val").dtype == torch.float32
    assert_same(rel, jf)
    assert {k: v.tolist() for k, v in to_host(rel).items()} == {
        k: np.asarray(v)[np.asarray(jf.valid)].tolist() for k, v in jf.columns.items()}
