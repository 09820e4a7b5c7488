"""Hold a bf16 function of the port to JAX's with the same casts in the same places.

Two things differ between the packages in bfloat16 that are not where
either casts:

- XLA's CPU compiler, by default, drops a bf16 round trip inside a fusion
  (``xla_allow_excess_precision``), so a jitted JAX function keeps in
  float32 some tensors its source casts to bf16.  ``compiled`` turns that
  off, and JAX then rounds where its source says.
- XLA expands bf16 ``sigmoid``, ``silu`` and ``gelu`` with bf16
  intermediates, where torch evaluates them in float32 and rounds once:
  each lands within one bf16 step of the other, and ~40% of values differ
  (``test_bf16_activations_round_once_in_torch``).  ``jax_activations_in_f32``
  makes JAX's evaluate in float32 and round once, as torch's do.

What is left is the summation order of the matrix products and the
reductions, so a port that casts where JAX casts gives mostly the same
bf16 values: ``hold_bf16`` asks for ``BF16_SAME`` of them bit-equal and
the largest difference within ``BF16_NORM`` of the largest |JAX value|.  A
cast moved, added or dropped fails one of the two (checked on copies of
the port with each of the mLSTM's and the RG-LRU's casts changed).
"""

from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

BF16_NORM = 2.0 ** -9  # max |port − JAX| / max |JAX|
BF16_SAME = 0.99  # share of bit-equal values


def compiled_fn(fn, excess_precision: bool = False):
    """``fn`` jitted and compiled at its first call's shapes, with XLA's
    excess precision off (or, with ``excess_precision``, XLA's default)."""
    opts = {} if excess_precision else {"xla_allow_excess_precision": False}
    cache = {}

    def call(*args):
        if "f" not in cache:
            cache["f"] = jax.jit(fn).lower(*args).compile(compiler_options=opts)
        return cache["f"](*args)

    return call


def compiled(fn, *args):
    """``fn(*args)`` through ``compiled_fn``."""
    return compiled_fn(fn)(*args)


@contextlib.contextmanager
def jax_activations_in_f32():
    """JAX's ``jax.nn.sigmoid``, ``silu`` and ``gelu`` evaluated in float32
    and rounded once to the input's dtype, as torch's are.  JAX's caches
    are cleared on entry and exit, so no trace crosses the boundary."""
    saved = {name: getattr(jax.nn, name) for name in ("sigmoid", "silu", "gelu")}

    def once(f):
        return lambda x, *a, **k: f(jnp.asarray(x).astype(jnp.float32), *a, **k).astype(x.dtype)

    jax.clear_caches()
    try:
        for name, f in saved.items():
            setattr(jax.nn, name, once(f))
        yield
    finally:
        for name, f in saved.items():
            setattr(jax.nn, name, f)
        jax.clear_caches()


@contextlib.contextmanager
def jax_attention_as_port():
    """JAX's ``gqa_attention`` computed as the port's plain attention is
    (``flash_attention_ref``, and the JAX package's flash kernel): q scaled
    in float32, the scores, the softmax and P·V in float32, the output
    rounded once to q's dtype.  JAX's own rounds the scores and the
    probabilities to bf16, the one deliberate difference of the port's
    attention (ROADMAP C), which would otherwise dominate a bf16 step's
    comparison.  JAX's caches are cleared on entry and exit."""
    from repro.models import layers

    real = layers.gqa_attention

    def as_port(q, k, v, mask, scale=None):
        B, S, H, hd = q.shape
        K = k.shape[2]
        scale = scale if scale is not None else 1.0 / np.sqrt(hd)
        qg = (q.astype(jnp.float32) * scale).reshape(B, S, K, H // K, hd)
        scores = jnp.einsum("bskgh,btkh->bkgst", qg, k.astype(jnp.float32))
        if mask is not None:
            scores = jnp.where(mask, scores, layers.NEG_INF)
        probs = jax.nn.softmax(scores, axis=-1)
        out = jnp.einsum("bkgst,btkh->bskgh", probs, v.astype(jnp.float32))
        return out.reshape(B, S, H, hd).astype(q.dtype)

    jax.clear_caches()
    layers.gqa_attention = as_port
    try:
        yield
    finally:
        layers.gqa_attention = real
        jax.clear_caches()


def bf16_stats(got: torch.Tensor, want) -> tuple:
    """(max |got − want| / max |want|, share of bit-equal values)."""
    g, w = got.float().numpy(), np.asarray(want, np.float32)
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.abs(g - w).max() / np.abs(w).max()), float((g == w).mean())


def hold_bf16(got: torch.Tensor, want, what: str = "", norm: float = BF16_NORM,
              same: float = BF16_SAME) -> None:
    assert got.dtype == torch.bfloat16 and str(np.asarray(want).dtype) == "bfloat16", what
    err, share = bf16_stats(got, want)
    assert err <= norm and share >= same, \
        f"{what}: max |port - jax| {err} of max |jax| (limit {norm}), {share} bit-equal " \
        f"(limit {same})"
