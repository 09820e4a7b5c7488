"""Plain PyTorch version of flash attention and of its gradient: scores
materialized, f32 softmax."""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def keep_mask(S: int, T: int, window: int = 0, key_pos: Optional[torch.Tensor] = None,
              qpos: int = 0, device=None) -> torch.Tensor:
    """(S, T) bool: key j is kept for query i iff 0 ≤ p_j ≤ qpos + i and,
    when ``window`` > 0, p_j > qpos + i − window, where p_j is
    ``key_pos[j]`` (a slot's position, −1 for an empty slot) or j."""
    kp = (torch.arange(T, device=device) if key_pos is None
          else key_pos.to(device=device, dtype=torch.int64))[None, :]
    qp = (torch.arange(S, device=device) + qpos)[:, None]
    keep = (kp >= 0) & (kp <= qp)
    if window > 0:
        keep = keep & (kp > qp - window)
    return keep


def _scaled_scores(q, k, causal, window, key_pos, qpos):
    """(q·scale (B,S,K,G,hd) f32, masked scores (B,K,G,S,T) f32, the (S,T)
    keep mask or None)."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    qg = (q.float() * (1.0 / math.sqrt(hd))).reshape(B, S, K, H // K, hd)
    s = torch.einsum("bskgd,btkd->bkgst", qg, k.float())
    keep = None
    if causal:
        keep = keep_mask(S, T, window, key_pos, qpos, device=q.device)
        if ((window > 0 or key_pos is not None) and keep.device.type != "meta"
                and not bool(keep.any(-1).all())):
            # The banded mask keeps the diagonal key (p_j = qpos + i) and the
            # ring-buffer decode mask the slot just written at qpos, so a
            # caller of either never masks a whole row; -1e30 would then
            # average the masked values instead of raising.  A meta tensor
            # (the dry run's trace) has no values to check.
            raise ValueError("flash_attention: a query row keeps no key under window="
                             f"{window}, qpos={qpos}")
        s = s.masked_fill(~keep, NEG_INF)  # no host scalar copied to the device
    return qg, s, keep


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int = 0,
                        key_pos: Optional[torch.Tensor] = None, qpos: int = 0,
                        return_lse: bool = False):
    """q (B,S,H,hd); k/v (B,T,K,hd), H % K == 0 → (B,S,H,hd) in q's dtype.

    A grouped einsum: the G = H/K query heads of KV head k are one axis,
    so K/V are never repeated.  q is scaled by 1/sqrt(hd) in f32 before
    the product, as the JAX kernel does; masked scores are -1e30.
    ``causal`` keeps what ``keep_mask(S, T, window, key_pos, qpos)`` keeps
    (j ≤ i with the defaults); ``window``, ``key_pos`` and ``qpos`` refine
    the causal mask only.  ``return_lse``: also the (B, H, S) float32
    log-sum-exp of every row's scaled, masked scores, which the kernel's
    forward writes for its backward.
    """
    B, S, H, hd = q.shape
    _qg, s, _keep = _scaled_scores(q, k, causal, window, key_pos, qpos)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,btkd->bskgd", p, v.float()).reshape(B, S, H, hd).to(q.dtype)
    if return_lse:
        return o, torch.logsumexp(s, dim=-1).reshape(B, H, S)
    return o


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            o: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                            causal: bool = True, window: int = 0,
                            key_pos: Optional[torch.Tensor] = None, qpos: int = 0):
    """(dq, dk, dv) of ``flash_attention_ref(q, k, v, ...)`` against ``dout``
    in the backward kernel's form, each in its input's dtype: from the
    forward's output ``o`` and its (B, H, S) ``lse``, in float32,

        D = rowsum(dO ∘ o),  P = exp(s·scale − lse) on the kept pairs (0
        elsewhere),  dV = Pᵀ·dO,  dS = P ∘ (dO·Vᵀ − D),
        dQ = dS·K·scale,  dK = dSᵀ·(q·scale).

    This is the gradient autograd takes of ``flash_attention_ref`` (with P
    normalised by the given lse, and D from the given o)."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    qg, s, keep = _scaled_scores(q, k, causal, window, key_pos, qpos)
    p = torch.exp(s - lse.float().reshape(B, K, G, S, 1))
    if keep is not None:
        p = p.masked_fill(~keep, 0.0)
    do = dout.float().reshape(B, S, K, G, hd)
    delta = (do * o.float().reshape(B, S, K, G, hd)).sum(-1).permute(0, 2, 3, 1)
    dv = torch.einsum("bkgst,bskgd->btkd", p, do)
    ds = p * (torch.einsum("bskgd,btkd->bkgst", do, v.float()) - delta[..., None])
    dq = torch.einsum("bkgst,btkd->bskgd", ds, k.float()) * (1.0 / math.sqrt(hd))
    dk = torch.einsum("bkgst,bskgd->btkd", ds, qg)
    return dq.reshape(B, S, H, hd).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
