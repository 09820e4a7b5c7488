"""Flash attention over (B, S, H, hd) queries and (B, T, K, hd) keys/values.

``flash_attention`` is the port of ``repro.kernels.flash_attention.ops.
flash_attention``, and the port's transformer computes all its attention
with it: causal over the prompt in ``forward``/``prefill``, non-causal
against the cache slice ``[:, :pos+1]`` in ``decode_step``.  CPU tensors
take the plain version (``ref.py``); CUDA tensors launch
``csrc/flash_attention.cu`` or raise.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build as B
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

HEAD_DIMS = (16, 32, 64, 96, 128, 256)  # the kernel's instantiations
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KEYS_PER_TILE = 32
_FILL_BLOCKS = 264  # two blocks on each of the H100's 132 SMs
_ARGS = (B.P, B.P, B.P, B.P) + (B.I64,) * 9 + (B.I32,) * 7 + (B.F32,) + (B.I32,) * 5 + (B.P,) * 3


def _check(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
        if t.dim() != 4:
            raise ValueError(f"{name}: expected 4 dims, got shape {tuple(t.shape)}")
        if t.device != q.device:
            raise ValueError(f"{name}: on {t.device}, expected {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: dtype {t.dtype}, expected {q.dtype} (q's)")
    Bq, _S, H, hd = q.shape
    Bk, T, K, hdk = k.shape
    if tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"v: shape {tuple(v.shape)}, expected {tuple(k.shape)} (k's)")
    if Bk != Bq or hdk != hd or K == 0 or H % K:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)}: need the same B and "
                         "head_dim and H % K == 0")


def _splits(base: int, key_span: int):
    """(keys per block, key splits): split the keys when the (row tile, b,
    kv head) blocks alone cannot fill the card."""
    tiles = max(1, -(-key_span // _KEYS_PER_TILE))
    want = 1 if base >= _FILL_BLOCKS // 2 else min(tiles, -(-_FILL_BLOCKS // base))
    per = -(-tiles // want)
    return per * _KEYS_PER_TILE, -(-tiles // per)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q (B,S,H,hd); k/v (B,T,K,hd) with H % K == 0 → (B,S,H,hd) in q's dtype.

    Query head h attends KV head h // (H/K).  ``causal``: key j is kept
    for query i when j ≤ i (i from 0); otherwise all T keys are kept.
    Inputs may be strided views (the last dim contiguous).
    """
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal)
    B.check_cuda(q.device)
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention: dtype {q.dtype}, the kernel takes float32 or bfloat16")
    Bn, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd}, the kernel takes {HEAD_DIMS}")
    if Bn * K > 65535:
        raise ValueError(f"flash_attention: B·K = {Bn * K}, the grid takes at most 65535")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name}: the last dim must be contiguous")
    out = torch.empty((Bn, S, H, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if T == 0:
        return out.zero_()
    G = H // K
    rows = S * G
    rows_per_tile = 8 if rows <= 8 else 32
    key_span = min(T, S) if causal else T
    chunk, nsplit = _splits(-(-rows // rows_per_tile) * Bn * K, key_span)
    part_ml = part_acc = None
    if nsplit > 1:
        part_ml = torch.empty((nsplit, Bn * K, rows, 2), dtype=torch.float32, device=q.device)
        part_acc = torch.empty((nsplit, Bn * K, rows, hd), dtype=torch.float32, device=q.device)
    width = 16 // q.element_size()
    vec = all(t.data_ptr() % 16 == 0 and all(st % width == 0 for st in t.stride()[:3])
              for t in (q, k, v))
    B.launch("svc_flash_attention", _ARGS, q.data_ptr(), k.data_ptr(), v.data_ptr(),
             out.data_ptr(), *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
             Bn, S, T, H, K, hd, int(causal), 1.0 / math.sqrt(hd), _DTYPES[q.dtype],
             rows_per_tile, chunk, nsplit, int(vec), B.ptr(part_ml), B.ptr(part_acc), B.stream())
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
