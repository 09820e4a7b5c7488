"""Plain PyTorch version of flash attention: scores materialized, f32 softmax."""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """q (B,S,H,hd); k/v (B,T,K,hd), H % K == 0 → (B,S,H,hd) in q's dtype.

    A grouped einsum: the G = H/K query heads of KV head k are one axis,
    so K/V are never repeated.  q is scaled by 1/sqrt(hd) in f32 before
    the product, as the JAX kernel does; masked scores are -1e30.
    """
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    qg = (q.float() * (1.0 / math.sqrt(hd))).reshape(B, S, K, H // K, hd)
    s = torch.einsum("bskgd,btkd->bkgst", qg, k.float())
    if causal:
        keep = torch.arange(T, device=q.device)[None, :] <= torch.arange(S, device=q.device)[:, None]
        s = torch.where(keep, s, torch.tensor(NEG_INF, dtype=s.dtype, device=s.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    return o.reshape(B, S, H, hd).to(q.dtype)
