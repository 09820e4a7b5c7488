"""The outlier pin set: its digest table is built once per pin.

The table's own build: ``pin_table`` (one launch over the pin's key
arena on a card) and its plain version ``pin_table_ref`` equal the JAX
package's ``_sorted_digests`` of the same compacted keys, packed as the
port packs a digest, and the table ``pin_set`` composed before, bit for
bit, for 1 to 4 key columns and arenas whose tables hold 1, 2, 300, 2,047,
2,048 and 2,049 entries (the last past the one-launch route).

A view with an outlier index (visitView over Log ⋈ Video, 300 videos,
6,000 sessions, k = 40) runs the same steps through
``repro.views.ViewManager`` and ``repro_torch.views.ViewManager(device=
"cpu")``: two pinned refreshes with the index unchanged, an ingest that
updates the index, two more refreshes, then a maintain (which changes the
base relations the pin is pushed up through) and a refresh.  The JAX
manager rebuilds its pin on every refresh; the port builds the pin and its
digest table only when the index or the bases moved.  After every refresh
the samples must be row-identical (keys, counts and ``__outlier`` exact,
sums within 1e-6 relative) and the answers must take the same estimator
with value and CI within 1e-5 relative.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core as jcore
import repro.relational.expr as jexpr
import repro.relational.plan as jplan
import repro_torch.core as tcore
import repro_torch.relational.expr as texpr
import repro_torch.relational.plan as tplan
from repro.data.synthetic import grow_log as jax_grow_log
from repro.data.synthetic import make_log_video as jax_make_log_video
from repro.kernels.outlier_member.ops import _sorted_digests as jax_sorted_digests
from repro.relational.relation import to_host as jax_to_host
from repro.views import ViewManager as JaxViewManager
from repro_torch.core import PinSet
from repro_torch.data.synthetic import grow_log, make_log_video
from repro_torch.kernels.outlier_member import (
    MAX_SMEM_KEYS,
    compact_pin_keys,
    pin_launches,
    pin_table,
    pin_table_ref,
    sorted_digest_table,
    table_route,
)
from repro_torch.kernels.outlier_member import ops as outlier_ops
from repro_torch.relational.relation import SENTINEL_KEY, from_columns, sentinel_where, to_host
from repro_torch.views import ViewManager

N_VIDEOS, N_LOGS, N_DELTA, GROUPS, M, K = 300, 6_000, 1_000, 512, 0.1, 40
STAGES = ("refresh_1", "refresh_2", "index_updated_1", "index_updated_2", "after_maintain")
# pin builds of the port after each stage: one at registration, one after
# the index update, one after the maintain moved the bases
PORT_BUILDS = (1, 1, 2, 2, 3)


def view_plan(P):
    return P.GroupByNode(
        child=P.FKJoin(fact=P.Scan("Log", pk=("sessionId",)),
                       dim=P.Scan("Video", pk=("videoId",)), fact_key="videoId"),
        keys=("videoId",),
        aggs=(("visitCount", "count", None), ("totalBytes", "sum", "bytes")),
        num_groups=GROUPS,
    )


def queries(core, X):
    vc, vid = X.Col("visitCount"), X.Col("videoId")
    return [core.Query("count"), core.Query("sum", "totalBytes"),
            core.Query("avg", "visitCount", pred=X.Cmp("gt", vc, X.Lit(5.0))),
            core.Query("sum", "visitCount", pred=X.Cmp("lt", vid, X.Lit(150.0)))]


def drive(vm, core, X, log_video, grow, device_kw, builds=None):
    """The five stages; per stage (stale, clean, answers[, port builds])."""
    rng = np.random.default_rng(4)
    log, video = log_video(rng, N_VIDEOS, N_LOGS, **device_kw)
    deltas = [grow(rng, N_VIDEOS, N_LOGS + i * N_DELTA, N_DELTA, **device_kw) for i in range(3)]
    vm.register_base("Log", log)
    vm.register_base("Video", video)
    vm.register_view(core.ViewDef("visitView", view_plan(tplan if core is tcore else jplan)),
                     delta_bases=("Log",), m=M, delta_group_capacity=GROUPS)
    vm.ingest("Log", inserts=deltas[0])
    vm.register_outlier_index("visitView", "Log", "bytes", k=K)
    mv = vm.views["visitView"]
    out = {}

    def stage(name):
        vm.svc_refresh("visitView")
        out[name] = (mv.stale_sample, mv.clean_sample,
                     vm.query_batch("visitView", queries(core, X)),
                     None if builds is None else builds[0])

    stage("refresh_1")
    stage("refresh_2")
    vm.ingest("Log", inserts=deltas[1])  # an offer the next refresh merges into the index
    stage("index_updated_1")
    stage("index_updated_2")
    vm.maintain("visitView")  # applies the pending segments to the bases
    vm.ingest("Log", inserts=deltas[2])
    stage("after_maintain")
    return out


@pytest.fixture(scope="module")
def runs():
    jax_out = drive(JaxViewManager(), jcore, jexpr, jax_make_log_video, jax_grow_log, {})
    builds = [0]
    real = outlier_ops.pin_table

    def counting(keys, valid):
        builds[0] += 1
        return real(keys, valid)

    outlier_ops.pin_table = counting
    try:
        vm = ViewManager(device="cpu")
        port_out = drive(vm, tcore, texpr, make_log_video, grow_log, {"device": "cpu"}, builds)
    finally:
        outlier_ops.pin_table = real
    return jax_out, port_out, vm


def _rows(h):
    order = np.argsort(h["videoId"], kind="stable")
    return {k: v[order] for k, v in h.items()}


@pytest.mark.parametrize("stage", STAGES)
def test_pinned_refresh_matches_jax(runs, stage):
    jax_out, port_out, _vm = runs
    for got, want in zip(port_out[stage][:2], jax_out[stage][:2]):
        a, b = _rows(to_host(got)), _rows(jax_to_host(want))
        assert set(a) == set(b) and "__outlier" in a
        for col in a:
            if col == "totalBytes":
                np.testing.assert_allclose(a[col], b[col], rtol=1e-6, atol=0)
            else:
                assert np.array_equal(a[col], b[col]), col
    assert to_host(port_out[stage][1])["__outlier"].sum() > 0
    for g, w in zip(port_out[stage][2], jax_out[stage][2]):
        assert g.method == w.method
        for x, y in ((g.value, w.value), (g.ci_low, w.ci_low), (g.ci_high, w.ci_high)):
            x, y = float(x), float(y)
            assert abs(x - y) <= 1e-5 * max(abs(x), abs(y), 1.0), (stage, x, y)


def test_the_digest_table_is_built_once_per_pin(runs):
    _jax_out, port_out, vm = runs
    assert tuple(port_out[s][3] for s in STAGES) == PORT_BUILDS
    pin = vm.views["visitView"].outlier_pin
    assert isinstance(pin, PinSet)
    assert torch.equal(pin.table, torch.sort(pin.table).values)
    # the valid pinned keys and one SENTINEL tuple for the invalid rows
    valid = pin.relation.valid
    assert pin.table.shape[0] == int(valid.sum()) + int(not bool(valid.all()))


# ---------------------------------------------------------------------------
# the pin's table: pin_table and pin_table_ref against JAX's _sorted_digests
# ---------------------------------------------------------------------------

# (arena slots, valid slots): tables of 1 (no slot valid), 300 (all
# valid), 2 (one valid), 2,047, 2,048 (the most the one launch holds),
# 2,048 without the SENTINEL tuple, and 2,049 entries
ARENAS = {"none_valid": (50, 0), "all_valid": (300, 300), "one_valid": (300, 1),
          "2047": (5_000, 2_046), "2048": (5_000, 2_047), "2048_all_valid": (2_048, 2_048),
          "2049": (5_000, 2_048)}


def _arena(ncols, slots, n_valid, seed):
    """Key columns of a pin arena (hot keys repeat) with ``n_valid`` valid
    slots scattered through it, and its validity."""
    rng = np.random.default_rng(seed)
    cols = [rng.integers(-50, 1_500, slots).astype(np.int32) for _ in range(ncols)]
    valid = np.zeros(slots, bool)
    valid[rng.choice(slots, n_valid, replace=False)] = True
    return cols, valid


def _jax_packed(cols, valid):
    """JAX's sorted digests of the compacted keys (the valid slots' tuples,
    then one all-SENTINEL tuple when a slot is invalid), packed as the
    port's int64 (hi ^ 2^31)·2^32 + lo."""
    keys = [np.concatenate([c[valid], [SENTINEL_KEY] * int(not valid.all())]).astype(np.int32)
            for c in cols]
    hi, lo = jax_sorted_digests([jnp.asarray(k) for k in keys])
    hi, lo = np.asarray(hi).astype(np.uint64), np.asarray(lo).astype(np.uint64)
    return (((hi ^ np.uint64(1 << 31)) << np.uint64(32)) | lo).view(np.int64)


@pytest.mark.parametrize("arena", list(ARENAS))
@pytest.mark.parametrize("ncols", [1, 2, 3, 4])
def test_pin_table_equals_jax_sorted_digests_and_the_composed_table(arena, ncols):
    slots, n_valid = ARENAS[arena]
    cols, valid = _arena(ncols, slots, n_valid, seed=slots + n_valid + ncols)
    raw, ok = tuple(torch.from_numpy(c) for c in cols), torch.from_numpy(valid)
    masked = tuple(sentinel_where(ok, c) for c in raw)  # as PinSet.keys holds them
    want = _jax_packed(cols, valid)
    entries = n_valid + int(n_valid < slots)
    assert want.shape == (entries,)
    got = pin_table_ref(raw, ok)
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(pin_table(raw, ok), got)
    # the masked keys give the same table: invalid slots are never digested
    assert torch.equal(pin_table(masked, ok), got)
    # the composition pin_set ran before: nonzero, cat, a gather a column,
    # the digest table of the compacted keys
    rows = torch.cat([ok.nonzero().flatten(), (~ok).nonzero()[:1].flatten()])
    old = sorted_digest_table(tuple(k[rows].contiguous() for k in masked))
    assert torch.equal(old, got)
    assert all(torch.equal(a, b) for a, b in zip(compact_pin_keys(raw, ok),
                                                 (k[rows] for k in masked)))
    pin = tcore.pin_set(from_columns({f"k{j}": c for j, c in enumerate(cols)},
                                     pk=[f"k{j}" for j in range(ncols)], valid=valid,
                                     device="cpu"))
    assert torch.equal(pin.table, got)
    assert all(torch.equal(a, b) for a, b in zip(pin.keys, masked))
    assert pin_launches(entries) == (1 if entries <= MAX_SMEM_KEYS else 2)


def test_the_table_routes():
    """digest_table digests and sorts in one block up to MAX_SMEM_KEYS
    tuples; pin_table's one launch holds a table of as many entries, and
    one entry more takes a second launch (the composed table's)."""
    assert MAX_SMEM_KEYS == 2048
    assert [table_route(k) for k in (0, 1, 1000, 2048, 2049, 50_000)] == \
        ["block"] * 4 + ["sort"] * 2
    assert [pin_launches(k) for k in (0, 1, 105, 2048, 2049)] == [1, 1, 1, 1, 2]


def test_pin_table_of_an_empty_arena_is_empty():
    empty, none = (torch.empty(0, dtype=torch.int32),), torch.empty(0, dtype=torch.bool)
    assert pin_table(empty, none).shape == (0,)
    assert pin_table_ref(empty, none).shape == (0,)
    with pytest.raises(ValueError):
        pin_table(empty, torch.ones(3, dtype=torch.bool))  # validity of another length
