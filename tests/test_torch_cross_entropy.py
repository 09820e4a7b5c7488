"""The float32 cross-entropy over the vocabulary (``kernels/cross_entropy``)
against JAX's ``repro.training.train_step.cross_entropy`` on the CPU.

Inputs are numpy from a seed, handed to both packages: logits of V = 50,
257 (odd) and 4,099 columns, in float32 and in bfloat16 (the same bf16
values in both), one row of large equal logits (ties at the max), labels
that wrap (−1 and −V) and labels out of range (V and −V − 1), which must
give NaN as JAX's ``take_along_axis`` does.  Held:

* ``cross_entropy_ref``'s lse, nll and the z-loss loss within 1e-6
  relative of JAX's (float32 sums in another order);
* ``cross_entropy_bwd_ref``'s gradient of the logits against ``jax.grad``
  of JAX's loss: within 1e-6 of each row's largest |gradient| in float32,
  within one bf16 ulp in bfloat16 (both round one float32 value once);
* the autograd Function ``CrossEntropy`` (the card's path; on CPU tensors
  its wrappers take the plain versions) against autograd of the plain
  composition that ``train_step.cross_entropy`` runs on the CPU: the same
  bits.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.training.train_step as JT
from repro_torch import kernels
from repro_torch.kernels.cross_entropy import (
    CrossEntropy,
    cross_entropy_bwd,
    cross_entropy_bwd_ref,
    cross_entropy_fwd,
    cross_entropy_ref,
)
from repro_torch.obs import kprof
from repro_torch.training.train_step import cross_entropy

torch.set_num_threads(1)

VOCABS = (50, 257, 4099)
DTYPES = ("float32", "bfloat16")
ROWS = (3, 7)
F32_TOL = 1e-6


def _inputs(V: int, dtype: str, seed: int = 0, out_of_range: bool = False):
    """(JAX logits, torch logits, int32 labels) from one numpy draw; row
    (0, 0) is V equal logits of 30, labels (0, 1) and (0, 2) wrap (−1, −V),
    and with ``out_of_range`` labels (1, 3) and (1, 4) read no logit."""
    rng = np.random.default_rng(seed + V)
    x = (rng.normal(size=ROWS + (V,)) * 4).astype(np.float32)
    x[0, 0] = 30.0
    labels = rng.integers(0, V, ROWS).astype(np.int32)
    labels[0, 1], labels[0, 2] = -1, -V
    if out_of_range:
        labels[1, 3], labels[1, 4] = V, -V - 1
    jx = jnp.asarray(x).astype(jnp.dtype(dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    return jx, tx, labels


def _jax_grad(jx, labels, z_loss):
    return np.asarray(jax.grad(lambda l: JT.cross_entropy(l, jnp.asarray(labels), z_loss)[0])(jx)
                      .astype(jnp.float32))


def _loss_grads(lse: torch.Tensor, z_loss: float):
    """(g_lse, g_nll) of nll.mean() + z_loss·(lse²).mean()."""
    n = lse.numel()
    return 2.0 * z_loss * lse / n, torch.full_like(lse, 1.0 / n)


def _hold_grad(got: torch.Tensor, want: np.ndarray, dtype: str) -> None:
    got = got.float().numpy().astype(np.float64)
    want = want.astype(np.float64)
    err = np.abs(got - want)
    if dtype == "float32":
        scale = np.abs(want).max(-1, keepdims=True)
        assert (err <= F32_TOL * scale).all(), float((err / scale).max())
    else:  # one bf16 ulp: 2^(exponent − 7)
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-38))) - 7)
        assert (err <= ulp).all(), float((err / ulp).max())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("V", VOCABS)
def test_plain_forward_matches_jax(V, dtype):
    jx, tx, labels = _inputs(V, dtype)
    jloss, jnll = JT.cross_entropy(jx, jnp.asarray(labels))
    jlse = jax.nn.logsumexp(jx.astype(jnp.float32), axis=-1)
    lse, nll = cross_entropy_ref(tx, torch.from_numpy(labels))
    assert lse.dtype == nll.dtype == torch.float32 and lse.shape == nll.shape == ROWS
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=F32_TOL, atol=0)
    nll_err = np.abs(nll.numpy().astype(np.float64) - np.asarray(jnll))
    assert nll_err.max() <= F32_TOL * np.abs(np.asarray(jnll)).max()
    # the tied row: lse = 30 + log V, every label's nll log V
    assert abs(float(lse[0, 0]) - (30.0 + np.log(V))) <= F32_TOL * (30.0 + np.log(V))
    loss, tnll = cross_entropy(tx, torch.from_numpy(labels))
    assert torch.equal(tnll, nll)
    assert abs(float(loss) - float(jloss)) <= F32_TOL * abs(float(jloss))


@pytest.mark.parametrize("z_loss", (1e-4, 0.1))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("V", VOCABS)
def test_plain_backward_matches_jax_grad(V, dtype, z_loss):
    jx, tx, labels = _inputs(V, dtype, seed=1)
    tl = torch.from_numpy(labels)
    lse, _ = cross_entropy_ref(tx, tl)
    d = cross_entropy_bwd_ref(tx, tl, lse, *_loss_grads(lse, z_loss))
    assert d.dtype == tx.dtype and d.shape == tx.shape
    _hold_grad(d, _jax_grad(jx, labels, z_loss), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("V", (50, 257))
def test_labels_out_of_range_give_nan_and_no_gold_gradient(V, dtype):
    """JAX's take_along_axis: V and −V − 1 read no logit (NaN nll, NaN
    loss); the gradient stays finite, the row's gold term dropped."""
    jx, tx, labels = _inputs(V, dtype, seed=2, out_of_range=True)
    tl = torch.from_numpy(labels)
    jloss, jnll = JT.cross_entropy(jx, jnp.asarray(labels))
    loss, nll = cross_entropy(tx, tl)
    bad = np.isnan(np.asarray(jnll))
    assert bad.sum() == 2 and bad[1, 3] and bad[1, 4]
    np.testing.assert_array_equal(torch.isnan(nll).numpy(), bad)
    assert np.isnan(float(jloss)) and torch.isnan(loss)
    lse, _ = cross_entropy_ref(tx, tl)
    d = cross_entropy_bwd_ref(tx, tl, lse, *_loss_grads(lse, 1e-4))
    want = _jax_grad(jx, labels, 1e-4)
    assert np.isfinite(want).all() and torch.isfinite(d).all()
    _hold_grad(d, want, dtype)
    # the dropped rows' gradients are the softmax term alone: every element ≥ 0
    assert (d.float()[1, 3:5] >= 0).all()


@pytest.mark.parametrize("out_of_range", (False, True))
@pytest.mark.parametrize("dtype", DTYPES)
def test_autograd_function_equals_plain_autograd(dtype, out_of_range):
    """``CrossEntropy`` (the card's path) on CPU tensors against autograd of
    the plain composition: the same lse, nll, loss and gradient bits."""
    _, tx, labels = _inputs(257, dtype, seed=3, out_of_range=out_of_range)
    tl = torch.from_numpy(labels)
    a = tx.clone().requires_grad_()
    loss_a, nll_a = cross_entropy(a, tl, 0.1)
    loss_a.backward()
    b = tx.clone().requires_grad_()
    lse_b, nll_b = CrossEntropy.apply(b, tl)
    loss_b = nll_b.mean() + 0.1 * (lse_b * lse_b).mean()
    loss_b.backward()
    assert torch.equal(nll_a, nll_b) or (out_of_range and torch.allclose(
        nll_a, nll_b, rtol=0, atol=0, equal_nan=True))
    assert torch.equal(loss_a, loss_b) or (out_of_range and loss_a.isnan() and loss_b.isnan())
    assert a.grad.dtype == b.grad.dtype == tx.dtype
    assert torch.equal(a.grad, b.grad)


def test_int64_labels_and_leading_shapes():
    _, tx, labels = _inputs(50, "float32", seed=4)
    l32, l64 = torch.from_numpy(labels), torch.from_numpy(labels).long()
    for a, b in zip(cross_entropy_fwd(tx, l32), cross_entropy_fwd(tx, l64)):
        assert torch.equal(a, b)
    flat = cross_entropy_fwd(tx.reshape(-1, 50), l32.reshape(-1))
    for a, b in zip(cross_entropy_fwd(tx, l32), flat):
        assert torch.equal(a.reshape(-1), b)


def test_wrappers_check_their_inputs():
    x = torch.zeros(4, 10)
    lab = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError, match="dtype"):
        cross_entropy_fwd(x.half(), lab)
    with pytest.raises(TypeError, match="labels"):
        cross_entropy_fwd(x, lab.float())
    with pytest.raises(ValueError, match="shape"):
        cross_entropy_fwd(x, lab[:3])
    with pytest.raises(ValueError, match="contiguous"):
        cross_entropy_fwd(torch.zeros(10, 4).T, lab)
    lse = torch.zeros(4)
    with pytest.raises(TypeError, match="g_nll"):
        cross_entropy_bwd(x, lab, lse, lse, lse.double())
    with pytest.raises(ValueError, match="no kernel"):
        from repro_torch.kernels import _build

        _build.check_cuda(torch.device("cpu"))


def test_cpu_calls_dispatch_as_fallbacks_and_never_count_as_launches():
    _, tx, labels = _inputs(50, "bfloat16", seed=5)
    tl = torch.from_numpy(labels)
    before = kernels.launch_counts()
    prof = kernels.set_profiler(kprof.KernelProfiler())
    try:
        lse, nll = cross_entropy_fwd(tx, tl)
        cross_entropy_bwd(tx, tl, lse, *_loss_grads(lse, 1e-4))
    finally:
        kernels.set_profiler(None)
    summary = prof.summary()
    assert set(summary) == {"cross_entropy_fwd", "cross_entropy_bwd"}
    for op in summary.values():
        assert (op["dispatches"], op["fallbacks"]) == (1, 1)
        assert op["rows_real"] == tl.numel()
    assert kernels.launch_counts() == before
    assert kernels.op_names()["cross_entropy_fwd"] == "cross_entropy_fwd"
    assert kernels.op_names()["cross_entropy_bwd"] == "cross_entropy_bwd"


def test_meta_takes_the_plain_composition():
    x = torch.empty(2, 5, 11, device="meta", dtype=torch.bfloat16, requires_grad=True)
    lab = torch.empty(2, 5, device="meta", dtype=torch.int32)
    before = kernels.launch_counts()
    loss, nll = cross_entropy(x, lab)
    loss.backward()
    assert nll.shape == (2, 5) and nll.dtype == torch.float32
    assert x.grad.shape == x.shape and x.grad.dtype == torch.bfloat16
    assert kernels.launch_counts() == before
