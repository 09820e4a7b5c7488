"""segment_sum and corr_moments: the port's plain versions against JAX.

``repro_torch.kernels.segment_aggsum.segment_sum`` and
``repro_torch.kernels.corr_diff.corr_moments`` take their plain PyTorch
versions for CPU tensors.  The same numpy inputs go through them, through
JAX's ``ops`` (the Pallas kernels in interpret mode on the CPU) and
through JAX's ``ref``s.  Counts must be exact; float sums within 1e-6 of
the sum of the terms' magnitudes (Σ|x|), the scale at which a float32 sum
in another order is exact to the port's 1e-6.  The CUDA kernels run in
tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.corr_diff.ops import corr_moments as jax_corr_moments
from repro.kernels.corr_diff.ref import corr_diff_ref as jax_corr_diff_ref
from repro.kernels.segment_aggsum.ops import segment_sum as jax_segment_sum
from repro.kernels.segment_aggsum.ref import segment_sum_ref as jax_segment_sum_ref
from repro_torch.core import Query
from repro_torch.core.estimators import _masked_moments, correspondence_diff_stratified
from repro_torch.core.estimators import correspondence_join
from repro_torch.core.hashing import apply_hash
from repro_torch.kernels.corr_diff import corr_diff_ref, corr_moments
from repro_torch.kernels.segment_aggsum import segment_sum, segment_sum_ref
from repro_torch.relational import from_columns, ops

T = torch.from_numpy


def _close_to_scale(got, want, scale, rtol=1e-6):
    got, want, scale = (np.asarray(x, np.float64) for x in (got, want, scale))
    assert np.all(np.abs(got - want) <= rtol * scale + 1e-30), np.max(np.abs(got - want))


# ---------------------------------------------------------------------------
# segment_sum
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(100, 1, 10), (1000, 4, 50), (4096, 8, 300),
                                   (257, 3, 129), (1, 1, 1), (3000, 2, 1000)])
@pytest.mark.parametrize("out_of_range", [False, True])
def test_segment_sum_plain_matches_jax(shape, out_of_range):
    R, C, G = shape
    rng = np.random.default_rng(R + C + out_of_range)
    lo, hi = (-3, G + 4) if out_of_range else (0, G)
    gid = rng.integers(lo, hi, R).astype(np.int32)
    if out_of_range and R >= 3:
        gid[:3] = [-1, G, G + 3]  # the group-by's overflow slot G drops
    vals = rng.normal(size=(R, C)).astype(np.float32)
    vals[:, 0] = 1.0  # a count column
    got = segment_sum(T(gid), T(vals), G).numpy()
    pallas = np.asarray(jax_segment_sum(jnp.asarray(gid), jnp.asarray(vals), G))
    ref = np.asarray(jax_segment_sum_ref(jnp.asarray(gid), jnp.asarray(vals), G))
    assert got.shape == pallas.shape == (G, C)
    keep = (gid >= 0) & (gid < G)
    scale = np.zeros((G, C))
    np.add.at(scale, gid[keep], np.abs(vals[keep]).astype(np.float64))
    for want in (pallas, ref):
        assert np.array_equal(got[:, 0], want[:, 0])  # counts exact
        _close_to_scale(got, want, scale)


@pytest.mark.parametrize("R,G", [(1, 1), (999, 37), (5000, 64)])
def test_segment_sum_takes_one_dimensional_values(R, G):
    rng = np.random.default_rng(R)
    gid = rng.integers(-1, G + 1, R).astype(np.int32)
    vals = rng.uniform(0.0, 10.0, R).astype(np.float32)
    got = segment_sum(T(gid), T(vals), G)
    want = np.asarray(jax_segment_sum(jnp.asarray(gid), jnp.asarray(vals), G))
    assert tuple(got.shape) == want.shape == (G,)
    keep = (gid >= 0) & (gid < G)
    scale = np.zeros(G)
    np.add.at(scale, gid[keep], vals[keep].astype(np.float64))
    _close_to_scale(got.numpy(), want, scale)
    assert torch.equal(got, segment_sum_ref(T(gid), T(vals)[:, None], G)[:, 0])


def test_segment_sum_drops_out_of_range():
    out = segment_sum(T(np.array([0, 1, 99, -1], np.int32)), torch.ones(4, 1), 2)
    assert out[:, 0].tolist() == [1.0, 1.0]


def test_segment_sum_of_the_group_by_ids_equals_the_group_by():
    """The group-by's own (gid, [bytes, 1]) — overflow slot included —
    summed by segment_sum gives the group-by's sums and counts."""
    rng = np.random.default_rng(3)
    n, cap, G = 5000, 8192, 700
    rel = from_columns({"k": np.arange(n, dtype=np.int32),
                        "g": rng.integers(0, 600, n).astype(np.int32),
                        "b": rng.exponential(50.0, n).astype(np.float32)},
                       pk=["k"], capacity=cap, device="cpu")
    order, _sk, sv, _start, gid = ops.group_ids(rel, ("g",), G)
    assert int((gid == G).sum()) == cap - n  # the padding rows sit in the overflow slot
    vals = torch.stack([rel.col("b")[order], torch.ones(cap)], 1)
    got = segment_sum(gid.to(torch.int32), vals, G)
    want = ops.groupby(rel, ("g",), {"s": ("sum", "b"), "c": ("count", None)}, G)
    assert torch.equal(got[:, 1], want.col("c"))
    _close_to_scale(got[:, 0].numpy(), want.col("s").numpy(), want.col("s").numpy())


# ---------------------------------------------------------------------------
# corr_moments
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 300, 8192, 8193, 20000])
@pytest.mark.parametrize("density", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("mask_dtype", [np.bool_, np.int8])
def test_corr_moments_plain_matches_jax(n, density, mask_dtype):
    rng = np.random.default_rng(n)
    a = rng.normal(size=n).astype(np.float32)
    b = rng.normal(size=n).astype(np.float32)
    mask = (rng.random(n) < density).astype(mask_dtype)
    got = [float(x) for x in corr_moments(T(a), T(b), T(mask))]
    d = (a - b) * mask.astype(np.float32)
    scale = [np.abs(d).astype(np.float64).sum(), (d * d).astype(np.float64).sum()]
    for want in (jax_corr_moments(jnp.asarray(a), jnp.asarray(b), jnp.asarray(mask)),
                 jax_corr_diff_ref(jnp.asarray(a), jnp.asarray(b), jnp.asarray(mask))):
        want = [float(x) for x in want]
        assert got[2] == want[2] == float(mask.sum())  # the count
        _close_to_scale(got[:2], want[:2], scale)
    assert all(x.dtype == torch.float32 and x.dim() == 0
               for x in corr_moments(T(a), T(b), T(mask)))


def test_corr_moments_of_the_correspondence_join_equal_svc_corr_moments():
    """corr_moments over the joined ``__t_new``/``__t_old``/valid gives the
    (k, s) that ``_masked_moments`` gives svc_corr."""
    rng = np.random.default_rng(4)
    n = 3000
    base = rng.exponential(30.0, n).astype(np.float32)
    stale = from_columns({"k": np.arange(n, dtype=np.int32), "v": base}, pk=["k"],
                         capacity=4096, device="cpu")
    fresh_v = base + rng.normal(1.0, 5.0, n).astype(np.float32)
    fresh = from_columns({"k": np.arange(100, n + 100, dtype=np.int32), "v": fresh_v},
                         pk=["k"], capacity=4096, device="cpu")
    q = Query("sum", "v")
    s_hat, f_hat = apply_hash(stale, ("k",), 0.3, 1), apply_hash(fresh, ("k",), 0.3, 1)
    j = correspondence_join(f_hat, s_hat, q, 0.3)
    s1, _s2, cnt = corr_moments(j.col("__t_new"), j.col("__t_old"), j.valid)
    d, mask, _ = correspondence_diff_stratified(f_hat, s_hat, q, 0.3)
    k, s, _mean, _var = _masked_moments(d, mask)
    assert float(cnt) == float(k) > 0
    _close_to_scale([float(s1)], [float(s)], [float(d.abs().sum())])
    assert torch.equal(torch.stack(corr_diff_ref(j.col("__t_new"), j.col("__t_old"), j.valid)),
                       torch.stack([s1, _s2, cnt]))
