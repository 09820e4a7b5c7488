"""Shared model layers: norms, rotary embeddings, attention, activations, GLU MLPs.

The port of ``repro.models.layers``: pure functions over tensors, with
JAX's layouts (q (B,S,H,hd), k/v (B,T,K,hd), matrices (in, out)).
Norms and the attention softmax accumulate in f32; activations keep the
config's ``compute_dtype``.  ``gqa_attention`` is the plain attention of
the JAX model (scores in the inputs' dtype, then f32); the port's
transformer computes its attention with ``kernels.flash_attention``
instead, which keeps scores and probabilities in f32 throughout.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

NEG_INF = -1e30
REMATS = ("none", "dots", "full")


# ---------------------------------------------------------------------------
# init helpers (an explicit torch.Generator: the numbers differ from
# jax.random's; parity tests carry JAX's weights over with models.convert)
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape, scale: Optional[float] = None,
               device=None) -> torch.Tensor:
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else 1.0 / np.sqrt(fan_in)
    return torch.randn(shape, generator=gen, dtype=torch.float32, device=device) * scale


def embed_init(gen: torch.Generator, vocab: int, d: int, device=None) -> torch.Tensor:
    return torch.randn((vocab, d), generator=gen, dtype=torch.float32, device=device) * 0.02


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))


@functools.lru_cache(maxsize=None)
def _device_freqs(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    """``rope_freqs`` on ``device``, copied there once (decode calls it per layer)."""
    return torch.from_numpy(rope_freqs(head_dim, theta)).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e4) -> torch.Tensor:
    """x: (..., S, n, head_dim); positions: broadcastable to (..., S)."""
    freqs = _device_freqs(x.shape[-1], float(theta), x.device)
    ang = positions[..., None].float() * freqs  # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]  # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, sections, theta: float = 1e4
                ) -> torch.Tensor:
    """Multimodal RoPE (Qwen2-VL): positions (3, ..., S) for the (t, h, w) axes.

    The half-dim frequency bands are split into ``sections`` (summing to
    head_dim/2); each band rotates by its own positional axis."""
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"apply_mrope: sections {tuple(sections)} sum to {sum(sections)}, "
                         f"expected head_dim/2 = {half}")
    freqs = _device_freqs(x.shape[-1], float(theta), x.device)
    bands = torch.split(freqs, list(sections))
    ang = torch.cat([positions[axis][..., None].float() * f for axis, f in enumerate(bands)],
                    dim=-1)  # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: Optional[torch.Tensor], scale: Optional[float] = None) -> torch.Tensor:
    """Grouped-query attention; returns (B, S, H, hd).  Softmax in f32."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qg = q.reshape(B, S, K, H // K, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k).float() * scale
    if mask is not None:
        scores = torch.where(mask, scores, torch.tensor(NEG_INF, device=scores.device))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bkgst,btkh->bskgh", probs, v).reshape(B, S, H, hd)


def causal_mask(S: int, T: int, offset: int = 0, device=None) -> torch.Tensor:
    """(1,1,1,S,T) boolean mask; query i attends keys j ≤ i + offset."""
    qi = torch.arange(S, device=device)[:, None] + offset
    kj = torch.arange(T, device=device)[None, :]
    return (kj <= qi)[None, None, None]


def local_mask(S: int, T: int, window: int, offset: int = 0, device=None) -> torch.Tensor:
    """Banded causal mask: attend to the last ``window`` positions."""
    qi = torch.arange(S, device=device)[:, None] + offset
    kj = torch.arange(T, device=device)[None, :]
    return ((kj <= qi) & (kj > qi - window))[None, None, None]


def decode_mask(T: int, pos: int, window: int = 0, device=None) -> torch.Tensor:
    """Mask for one-token decode against a cache of length T at ``pos``."""
    kj = torch.arange(T, device=device)[None, :]
    ok = kj <= pos
    if window:
        ok = ok & (kj > pos - window)
    return ok[None, None, None]


def put_rows(dst: torch.Tensor, src: torch.Tensor, rows: Optional[torch.Tensor]) -> None:
    """dst ← src in place, along the batch axis 0 at ``rows`` (row indices)
    only when given: a decode's cache write."""
    if rows is None:
        dst.copy_(src)
    else:
        dst[rows] = src[rows].to(dst.dtype)


@contextlib.contextmanager
def f32_accumulation():
    """bf16 matrix products accumulate in float32 and round once, as JAX's
    dots do: cuBLAS's reduced-precision (bf16) split-K reduction, which
    PyTorch allows by default, is turned off for the block and restored
    after.  It is what a skinny product such as the mLSTM's gate
    projection (K = 4,096, N = 4) takes on the card, where it rounds each
    partial sum to bf16."""
    matmul = torch.backends.cuda.matmul
    was = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        matmul.allow_bf16_reduced_precision_reduction = was


# ---------------------------------------------------------------------------
# rematerialisation (JAX's ``transformer._remat``)
# ---------------------------------------------------------------------------

def _dots_saveable():
    """``dots_with_no_batch_dims_saveable``: the outputs of ``aten.mm``
    (every ``x @ W`` of an activation and a matrix, a product with no batch
    dimension) are saved; everything else is recomputed, ``bmm`` (the
    einsums over a head axis) and the attention included, as JAX
    recomputes its dots with batch dimensions."""
    return create_selective_checkpoint_contexts([torch.ops.aten.mm.default])


def remat(fn, cfg):
    """``fn`` as ``cfg.remat`` trains it, for one call: itself under
    ``"none"`` or with grad off; under ``"full"`` (``nothing_saveable``)
    inside ``torch.utils.checkpoint``, every op recomputed in the
    backward; under ``"dots"`` inside a selective checkpoint that keeps
    the ``aten.mm`` outputs.  One body per call, as JAX wraps each scanned
    layer or super-block: ``remat(body, cfg)(*args)``."""
    if cfg.remat not in REMATS:
        raise ValueError(f"{cfg.name}: remat={cfg.remat!r}, expected one of {REMATS}")
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    extra = {"context_fn": _dots_saveable} if cfg.remat == "dots" else {}
    return functools.partial(checkpoint, fn, use_reentrant=False, **extra)


# ---------------------------------------------------------------------------
# activations (jax.nn's definitions, in the input's dtype)
# ---------------------------------------------------------------------------

def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x, approximate=True)``: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


@functools.lru_cache(maxsize=None)
def _constant(value: float, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    # a normal tensor even when first made under inference_mode: autograd
    # saves it in maximum's backward
    with torch.inference_mode(False):
        return torch.full((), value, dtype=dtype, device=device)


def maximum(x: torch.Tensor, value: float) -> torch.Tensor:
    """``jnp.maximum(x, value)``: ``torch.maximum`` against a 0-d constant
    of x's dtype and device (made once per dtype and device).  At a tie its
    gradient goes half to x, as ``jnp.maximum``'s does; ``clamp_min`` would
    pass all of it.  The forward is ``clamp_min``'s, bit for bit."""
    return torch.maximum(x, _constant(value, x.dtype, x.device))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, i.e. ``logaddexp(x, 0)`` = max(x, 0) +
    log1p(exp(−|x|)) (no large-x cutoff, unlike ``F.softplus``); its
    gradient at 0 is 0.5, as ``logaddexp``'s is."""
    return maximum(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid`` = −softplus(−x)."""
    return -softplus(-x)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def glu_mlp(x: torch.Tensor, w_gate, w_up, w_down, act: str) -> torch.Tensor:
    """SwiGLU / GeGLU: act(x·w_gate) ⊙ (x·w_up) · w_down."""
    g = x @ w_gate
    u = x @ w_up
    if act == "swiglu":
        h = F.silu(g) * u
    elif act == "geglu":
        h = gelu(g) * u
    elif act == "gelu":
        h = gelu(g)  # w_up unused pattern, kept uniform
    else:
        raise ValueError(act)
    return h @ w_down


def qkv_project(x, wq, wk, wv, H, K, hd):
    B, S, _ = x.shape
    q = (x @ wq).reshape(B, S, H, hd)
    k = (x @ wk).reshape(B, S, K, hd)
    v = (x @ wv).reshape(B, S, K, hd)
    return q, k, v
