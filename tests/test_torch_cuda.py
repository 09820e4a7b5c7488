"""The port's CUDA kernels against their plain versions, on the card.

Needs an NVIDIA GPU (Hopper, sm_90a); every test here carries the ``cuda``
marker and skips where ``torch.cuda.is_available()`` is false.  Run on a
machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Imports only torch, numpy and repro_torch, so it runs without JAX.
Masks, codes and counts must be exact; float sums within 1e-5 relative
plus, for atomically accumulated group sums, the float32 bound
4·2^-24·sqrt(n) relative of a sum of n terms added in another order.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.fused_clean.ops import fused_clean_groupby
from repro_torch.kernels.fused_clean.ref import fused_clean_ref
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
