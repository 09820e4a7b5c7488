"""repro_torch hashing is bit-equal to repro.core.hashing (Prop. 2 needs it).

The same numpy keys go through the JAX package and the torch port: the
mixer, the composite-key fold, the 64-bit digest, the u01 conversion and
the η mask must agree bit for bit, against the JAX reference and against
JAX's hash_threshold op (the Pallas kernel in interpret mode).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashing as jh
from repro.kernels.hash_threshold.ops import hash_threshold as jax_hash_threshold
from repro_torch.core import hashing as th
from repro_torch.kernels.hash_threshold.ops import hash_threshold as torch_hash_threshold

I32 = np.iinfo(np.int32)
EDGES = np.array([0, 1, -1, I32.min, I32.max, I32.max - 1, I32.min + 1], np.int32)


def _keys(n, ncols, seed):
    rng = np.random.default_rng(seed)
    cols = []
    for c in range(ncols):
        k = rng.integers(I32.min, I32.max, n, dtype=np.int64, endpoint=True).astype(np.int32)
        k[: len(EDGES)] = np.roll(EDGES, c)
        cols.append(k)
    return cols


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.uint32)


def test_splitmix32_bit_equal_over_uint32_range():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 2**32, 200_000, dtype=np.uint64).astype(np.uint32)
    x[:6] = [0, 1, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1]
    want = np.asarray(jh.splitmix32(jnp.asarray(x)))
    got = _u32(th.splitmix32(torch.from_numpy(x.astype(np.int64))))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("ncols", [1, 2, 3])
@pytest.mark.parametrize("seed", [0, 7, 12345])
def test_hash_columns_digest_u01_bit_equal(ncols, seed):
    cols = _keys(100_000, ncols, seed + ncols)
    jcols = [jnp.asarray(c) for c in cols]
    tcols = [torch.from_numpy(c) for c in cols]
    assert np.array_equal(_u32(th.hash_columns(tcols, seed)),
                          np.asarray(jh.hash_columns(jcols, seed)))
    for t, j in zip(th.key_digest(tcols, seed), jh.key_digest(jcols, seed)):
        assert np.array_equal(_u32(t), np.asarray(j))
    tu = th.hash_u01(tcols, seed).numpy()
    ju = np.asarray(jh.hash_u01(jcols, seed))
    assert tu.dtype == np.float32
    assert np.array_equal(tu.view(np.uint32), ju.view(np.uint32))


@pytest.mark.parametrize("m", [0.1, 0.5, 1.0])
@pytest.mark.parametrize("ncols", [1, 2, 3])
@pytest.mark.parametrize("seed", [0, 3])
def test_hash_threshold_mask_bit_equal(m, ncols, seed):
    cols = _keys(100_000, ncols, 100 + seed + ncols)
    jcols = [jnp.asarray(c) for c in cols]
    got = th.hash_threshold_mask([torch.from_numpy(c) for c in cols], m, seed).numpy()
    assert np.array_equal(got, np.asarray(jh.hash_threshold_mask_ref(jcols, m, seed)))
    assert np.array_equal(got, np.asarray(jax_hash_threshold(tuple(jcols), m, seed)))


def test_hash_threshold_wrapper_uses_plain_version_on_cpu_only():
    keys = torch.arange(16, dtype=torch.int32)
    before = torch_hash_threshold.launches
    torch_hash_threshold((keys,), 0.5, 0)
    assert torch_hash_threshold.launches == before  # the CPU never launches
    with pytest.raises(TypeError):
        torch_hash_threshold((keys.to(torch.int64),), 0.5, 0)
    with pytest.raises(ValueError):  # no kernel and no fallback off the CPU
        torch_hash_threshold((torch.empty(16, dtype=torch.int32, device="meta"),), 0.5, 0)


def test_seed_mix_and_digest_seeds_match():
    for s in (0, 1, 99, 2**31):
        assert th.seed_mix(s) == jh.seed_mix(s)
    assert (th.DIGEST_SEED_HI, th.DIGEST_SEED_LO) == (jh.DIGEST_SEED_HI, jh.DIGEST_SEED_LO)
