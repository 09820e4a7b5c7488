"""The functions the port had left out of its ported files, against JAX.

The TPCD-Skew star schema and its deltas (``make_lineitem_orders``,
``grow_lineitem``: equal columns from one numpy seed), ``staleness_report``
(§3.1's incorrect / missing / superfluous counts, exact),
``member_keys_loop`` (the O(N·K) oracle: equal to ``member_keys`` and to
JAX's), ``nested_join`` (the θ-join on a cross product: equal rows) and
``get_global_registry`` (one registry per process).  All on the CPU; tests
set torch to one thread.
"""

import numpy as np
import pytest
import torch

import repro.core.maintenance as jmaint
import repro.core.outliers as jout
import repro.data.synthetic as jsyn
import repro.relational.ops as jops
import repro.relational.expr as jexpr
import repro_torch.core as tcore
import repro_torch.core.outliers as tout
import repro_torch.data.synthetic as tsyn
import repro_torch.relational.ops as tops
import repro_torch.relational.expr as texpr
from repro.relational.relation import from_columns as jax_from_columns
from repro.relational.relation import to_host as jax_to_host
from repro_torch.obs.registry import MetricsRegistry, get_global_registry
from repro_torch.relational.relation import SENTINEL_KEY, from_columns, to_host

torch.set_num_threads(1)

TABLES = ("lineitem", "orders", "customer", "nation", "region")


def _same_host(a, b, what):
    assert sorted(a) == sorted(b), what
    for c in a:
        np.testing.assert_array_equal(np.asarray(a[c]), np.asarray(b[c]), err_msg=f"{what}:{c}")


@pytest.mark.parametrize("seed,z", [(0, 2.0), (7, 1.2)])
def test_make_lineitem_orders_gives_equal_columns(seed, z):
    args = (40, 200, 25, 30)
    j = jsyn.make_lineitem_orders(np.random.default_rng(seed), *args, z=z)
    t = tsyn.make_lineitem_orders(np.random.default_rng(seed), *args, z=z, device="cpu")
    for name, jr, tr in zip(TABLES, j, t):
        assert tr.capacity == jr.capacity, name
        assert tr.schema.pk == tuple(jr.schema.pk), name
        _same_host(jax_to_host(jr), to_host(tr), name)


def test_grow_lineitem_gives_equal_columns():
    j = jsyn.grow_lineitem(np.random.default_rng(3), 40, 30, 200, 64)
    t = tsyn.grow_lineitem(np.random.default_rng(3), 40, 30, 200, 64, device="cpu")
    _same_host(jax_to_host(j), to_host(t), "grow_lineitem")
    h = to_host(t)
    assert h["l_linekey"].tolist() == list(range(200, 264))
    assert h["l_shipdate"].min() >= 2400  # every new row ships after the base rows


def _stale_fresh(make, rng):
    """orders, then a fresh copy with 5 prices changed, 4 rows deleted and
    6 inserted (keys past the end)."""
    n = 50
    price = rng.exponential(100.0, n).astype(np.float32)
    cust = rng.integers(0, 10, n).astype(np.int32)
    stale = make({"o_orderkey": np.arange(n, dtype=np.int32), "o_custkey": cust,
                  "o_totalprice": price}, pk=["o_orderkey"], capacity=64)
    keep = np.ones(n, bool)
    keep[[3, 17, 18, 40]] = False
    new_price = price.copy()
    new_price[[0, 5, 9, 22, 31]] += 1.0
    keys = np.concatenate([np.arange(n, dtype=np.int32)[keep], np.arange(n, n + 6, dtype=np.int32)])
    fresh = make({"o_orderkey": keys,
                  "o_custkey": np.concatenate([cust[keep], np.zeros(6, np.int32)]),
                  "o_totalprice": np.concatenate([new_price[keep], np.ones(6, np.float32)])},
                 pk=["o_orderkey"], capacity=64)
    return stale, fresh


def test_staleness_report_counts_equal_jax():
    j = jmaint.staleness_report(*_stale_fresh(jax_from_columns, np.random.default_rng(1)))
    t = tcore.staleness_report(*_stale_fresh(
        lambda c, **kw: from_columns(c, device="cpu", **kw), np.random.default_rng(1)))
    got = {k: int(v) for k, v in t.items()}
    assert got == {k: int(v) for k, v in j.items()}
    assert got == {"incorrect": 5, "missing": 6, "superfluous": 4}
    fresh = _stale_fresh(lambda c, **kw: from_columns(c, device="cpu", **kw),
                         np.random.default_rng(1))[1]
    assert {k: int(v) for k, v in tcore.staleness_report(fresh, fresh).items()} == {
        "incorrect": 0, "missing": 0, "superfluous": 0}


@pytest.mark.parametrize("n_cols", [1, 2])
def test_member_keys_loop_equals_member_keys_and_jax(n_cols):
    rng = np.random.default_rng(11 + n_cols)
    probe = [rng.integers(0, 40, 300).astype(np.int32) for _ in range(n_cols)]
    keys = [rng.integers(0, 40, 24).astype(np.int32) for _ in range(n_cols)]
    probe[0][::17] = SENTINEL_KEY  # invalid probe rows never match
    keys[0][-3:] = SENTINEL_KEY  # nor do the index's padding slots
    tp = tuple(torch.from_numpy(p) for p in probe)
    tk = tuple(torch.from_numpy(k) for k in keys)
    loop = tout.member_keys_loop(tp, tk).numpy()
    np.testing.assert_array_equal(loop, tout.member_keys(tp, tk).numpy())
    np.testing.assert_array_equal(loop, np.asarray(jout.member_keys_loop(tuple(probe),
                                                                         tuple(keys))))
    want = np.zeros(300, bool)
    for i in range(24):
        row = np.ones(300, bool)
        for p, k in zip(probe, keys):
            row &= p == k[i]
        want |= row & (probe[0] != SENTINEL_KEY)
    np.testing.assert_array_equal(loop, want)
    assert want.any() and not want.all()


def _nested(pkg_ops, expr, make):
    rng = np.random.default_rng(5)
    left = make({"a": np.arange(6, dtype=np.int32), "x": rng.integers(0, 9, 6).astype(np.int32),
                 "v": rng.exponential(3.0, 6).astype(np.float32)}, pk=["a"], capacity=8)
    right = make({"b": np.arange(5, dtype=np.int32), "x": rng.integers(0, 9, 5).astype(np.int32),
                  "w": rng.exponential(3.0, 5).astype(np.float32)}, pk=["b"], capacity=7)
    pred = expr.Cmp("lt", expr.Col("x"), expr.Col("x_r"))
    return pkg_ops.nested_join(left, right, pred)


def test_nested_join_gives_equal_rows():
    j = _nested(jops, jexpr, jax_from_columns)
    t = _nested(tops, texpr, lambda c, **kw: from_columns(c, device="cpu", **kw))
    assert t.capacity == j.capacity == 8 * 7
    assert t.schema.pk == tuple(j.schema.pk) == ("a", "b")
    assert t.schema.columns == tuple(j.schema.columns)
    jh, th = jax_to_host(j), to_host(t)
    _same_host(jh, th, "nested_join")
    assert np.all(th["x"] < th["x_r"]) and 0 < th["a"].size < 30


def test_get_global_registry_is_one_per_process():
    reg = get_global_registry()
    assert isinstance(reg, MetricsRegistry)
    assert get_global_registry() is reg
    reg.counter("tpcd_probe").inc(2.0)
    assert get_global_registry().counter("tpcd_probe").value == 2.0
