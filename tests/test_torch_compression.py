"""The port's gradient compression (``repro_torch.distributed.compression``)
against the JAX package's.

``quantize_int8``/``dequantize_int8`` and ``ef_compress`` on the same
numpy gradients give JAX's codes and scales exactly and its dequantized
values and error states within float32 rounding (1e-6 of the largest
magnitude; both round half to even).  The ring all-reduce over a
``LocalMesh`` of 8 CPU devices sums to the reference within 1e-6
unquantized and 0.05 quantized, as ``tests/test_training_infra.py``
holds JAX's over 8 host devices, and equals JAX's ring, run in a child
process over 8 forced host devices, within 1e-6 unquantized and with the
same int8 hops quantized.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed.compression import dequantize_int8 as jax_dequantize
from repro.distributed.compression import ef_compress as jax_ef_compress
from repro.distributed.compression import quantize_int8 as jax_quantize
from repro_torch.distributed.compression import (
    dequantize_int8,
    ef_compress,
    make_compressed_allreduce,
    quantize_int8,
    ring_allreduce,
)
from repro_torch.launch.mesh import make_local_mesh


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("scale", [1.0, 1e-3, 0.0])
def test_quantize_matches_jax(scale):
    x = (np.random.default_rng(0).normal(size=513) * scale).astype(np.float32)
    jq, js = jax_quantize(jnp.asarray(x))
    tq, ts = quantize_int8(torch.from_numpy(x))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert float(ts) == float(js)
    np.testing.assert_allclose(dequantize_int8(tq, ts).numpy(), np.asarray(jax_dequantize(jq, js)),
                               rtol=1e-6)
    err = np.abs(dequantize_int8(tq, ts).numpy() - x).max()
    assert err <= float(ts) * 0.51


def test_error_feedback_matches_jax_and_is_unbiased():
    rng = np.random.default_rng(1)
    g = {"w": rng.normal(size=128).astype(np.float32), "b": rng.normal(size=(4, 8)).astype(
        np.float32)}
    jerr = terr = None
    acc = np.zeros(128)
    for _ in range(60):
        jdeq, jerr = jax_ef_compress({k: jnp.asarray(v) for k, v in g.items()}, jerr)
        tdeq, terr = ef_compress({k: torch.from_numpy(v) for k, v in g.items()}, terr)
        for k in g:
            scale = np.abs(np.asarray(jdeq[k])).max()
            assert np.abs(tdeq[k].numpy() - np.asarray(jdeq[k])).max() <= 1e-6 * scale, k
            assert np.abs(terr[k].numpy() - np.asarray(jerr[k])).max() <= 1e-6 * scale, k
        acc += tdeq["w"].numpy()
    assert np.abs(acc / 60 - g["w"]).max() < 5e-4


@pytest.mark.parametrize("quantize,tol", [(False, 1e-6), (True, 0.05)])
def test_ring_allreduce_over_8_cpu_devices(quantize, tol):
    mesh = make_local_mesh(8, 1, "cpu")
    x = torch.arange(8 * 32, dtype=torch.float32)
    want = x.reshape(8, 32).sum(0)
    out = make_compressed_allreduce(mesh, "data", quantize=quantize)(x).reshape(8, 32)
    rel = float((out - want).abs().max() / want.abs().max())
    assert rel < tol, (quantize, rel)


def test_ring_of_one_and_uneven_splits():
    x = torch.randn(6)
    assert ring_allreduce([x], ["cpu"])[0] is x
    with pytest.raises(ValueError, match="split"):
        ring_allreduce([torch.randn(5)] * 2, ["cpu"] * 2)
    with pytest.raises(ValueError, match="devices"):
        make_compressed_allreduce(make_local_mesh(4, 1, "cpu"), "data")(torch.randn(6, 2))


def test_ring_matches_jax_ring_over_8_host_devices():
    """JAX's ring in a child with 8 forced host devices, on random data:
    the port's sum within 1e-6 of JAX's unquantized, and within 1e-6 of
    max |sum| quantized (the same int8 hops in the same order)."""
    child = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import sys
import numpy as np, jax, jax.numpy as jnp
from repro.distributed.compression import make_compressed_allreduce
if hasattr(jax.sharding, "AxisType"):
    mesh = jax.make_mesh((8,), ("data",), axis_types=(jax.sharding.AxisType.Auto,))
else:
    mesh = jax.make_mesh((8,), ("data",))
x = jnp.asarray(np.random.default_rng(7).normal(size=8 * 64).astype(np.float32))
outs = [np.asarray(jax.jit(make_compressed_allreduce(mesh, "data", quantize=q))(x))
        for q in (False, True)]
np.save(sys.argv[1], np.stack(outs))
"""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ring.npy")
        env = dict(os.environ, PYTHONPATH=os.path.abspath("src"), JAX_PLATFORMS="cpu")
        env.pop("XLA_FLAGS", None)
        r = subprocess.run([sys.executable, "-c", child, path], capture_output=True, text=True,
                           env=env, timeout=600)
        assert r.returncode == 0, r.stderr[-2000:]
        want = np.load(path)
    x = torch.from_numpy(np.random.default_rng(7).normal(size=8 * 64).astype(np.float32))
    mesh = make_local_mesh(8, 1, "cpu")
    for i, q in enumerate((False, True)):
        got = make_compressed_allreduce(mesh, "data", quantize=q)(x).numpy()
        assert np.abs(got - want[i]).max() <= 1e-6 * np.abs(want[i]).max(), q
