"""xLSTM LM: the port of ``repro.models.xlstm`` (arXiv:2405.04517).

Super-blocks of (slstm_every − 1) mLSTM layers and one sLSTM layer (48 =
6 × (7 + 1) for xlstm-1.3b).  mLSTM has no hidden-to-hidden recurrence:
``forward`` runs its stabilized parallel form, an S×S exponential-gating
decay chunked over queries of ``CHUNK``, and ``decode_step`` updates the
O(1) per-head matrix memory ``C_t = f' C_{t−1} + i' (k ⊗ v)``.  sLSTM
keeps a true recurrence (block-diagonal ``R`` over 4 heads) and runs as a
loop over time, as JAX's ``lax.scan`` does: on the card as the
``kernels.slstm`` kernels (one launch a sequence, one a decode step).

Dtypes follow JAX's: matrices in ``compute_dtype``; ``b_f``, sLSTM's ``b``
and ``R`` in f32 and used uncast; the parallel form materializes its decay
and scores in the compute dtype, accumulates both contractions in f32 and
keeps the row max in f32; the decode state (C, n, m and the sLSTM's h, c,
n, m) is f32.  The mLSTM decode's stabilizer starts at m = 0 while the
parallel form uses the row max, so the two agree only to JAX's own 5e-2.
With ``masters=True`` every leaf is a trainable float32 master, each cast
where JAX casts it.  ``forward`` runs under the caller's grad mode, each
super-block (its mLSTM layers and its sLSTM) under ``layers.remat``, as
JAX scans ``_remat(sb_body)``; the gradient flows through the parallel
form's chunks (the row max's through ``amax``, which splits it evenly
between tied maxima, as ``jnp.max``'s does) and the sLSTM's loop over
time (on the card the backward kernel).  ``prefill`` and ``decode_step``
build no graph.  Under a ``ParallelCtx`` the pins go through
``parallel.constrain`` (JAX's ``_pin`` after each block and the sLSTM's
batch-only pins, here on its outputs), which computes nothing.
On the meta device (the dry run's trace) the sLSTM's loop is one step
counted S times, forward and backward (``obs.opcount.repeated``), as
JAX's analyzer counts its scan's body.

Differences from the JAX module, all deliberate: one block module per
layer; ``decode_step(rows=...)`` writes the state at ``rows`` only (JAX
writes every row and the engine merges); the parallel form's chunk reads
only the keys up to its last query (the later ones carry weight exactly 0
in JAX's).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.slstm import ops as slstm_ops
from repro_torch.kernels.slstm import ref as slstm_ref
from repro_torch.models import layers as L
from repro_torch.models.parallel import P, constrain
from repro_torch.models.transformer import _add_params, _param, _pin, compute_dtype
from repro_torch.obs import opcount

MLSTM_PF = 2  # up-projection factor
CHUNK = 256
MLSTM_LEAVES = ("ln", "w_up", "w_gate", "wq", "wk", "wv", "w_i", "w_f", "b_f", "w_down")
SLSTM_LEAVES = ("ln", "W", "R", "b", "w_out")
_F32_LEAVES = ("ln", "b_f", "R", "b")



def inner_dim(cfg: ArchConfig) -> int:
    return MLSTM_PF * cfg.d_model


def head_dim(cfg: ArchConfig) -> int:
    return inner_dim(cfg) // cfg.mlstm_heads


def n_superblocks(cfg: ArchConfig) -> int:
    return cfg.n_layers // cfg.slstm_every


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_parallel(q, k, v, itil, logf) -> torch.Tensor:
    """q, k, v (B,S,H,hd); itil/logf (B,S,H) f32 → h (B,S,H,hd) in q's dtype.

    dlog[t,s] = cum[t] − cum[s] + itil[s] for s ≤ t, stabilized by the row
    max; chunked over queries of CHUNK (S ≤ CHUNK or a multiple of it)."""
    B, S, H, hd = q.shape
    if S > CHUNK and S % CHUNK:
        raise ValueError(f"mlstm_parallel: S = {S} is neither <= {CHUNK} nor a multiple of it")
    wdt = q.dtype  # compute dtype: bf16 in production, f32 in smoke
    cum = torch.cumsum(logf, dim=1)  # (B,S,H) f32
    kt = (k / math.sqrt(hd)).to(wdt)
    outs = []
    for t0 in range(0, S, min(S, CHUNK)):
        t1 = min(S, t0 + CHUNK)
        n = t1  # queries [t0, t1) against keys [0, t1)
        causal = (torch.arange(n, device=q.device)[None, :]
                  <= torch.arange(t0, t1, device=q.device)[:, None])[None, :, :, None]
        dlog = cum[:, t0:t1, None, :] - cum[:, None, :n, :] + itil[:, None, :n, :]
        dlog = torch.where(causal, dlog, torch.tensor(-math.inf, device=q.device))  # (B,C,n,H)
        mrow = dlog.amax(dim=2, keepdim=True)  # (B,C,1,H) f32
        w = torch.exp(dlog - mrow).to(wdt)
        qk = torch.einsum("bchd,bshd->bcsh", q[:, t0:t1], kt[:, :n])
        scores = qk * w  # (B,C,n,H) compute dtype
        num = torch.einsum("bcsh,bshd->bchd", scores.float(), v[:, :n].float())
        den = torch.maximum(scores.float().sum(dim=2).abs(), torch.exp(-mrow[:, :, 0, :]))
        outs.append(num / den[..., None])
    return torch.cat(outs, 1).to(q.dtype)


class MLSTMBlock(nn.Module):
    """One mLSTM layer (JAX ``_mlstm_block_full`` / ``_mlstm_block_decode``)."""

    def __init__(self, cfg: ArchConfig, device="cuda", masters: bool = False):
        super().__init__()
        self.cfg = cfg
        d, di, H = cfg.d_model, inner_dim(cfg), cfg.mlstm_heads
        hd = di // H
        shapes = {"ln": (d,), "w_up": (d, di), "w_gate": (d, di), "wq": (H, hd, hd),
                  "wk": (H, hd, hd), "wv": (H, hd, hd), "w_i": (di, H), "w_f": (di, H),
                  "b_f": (H,), "w_down": (di, d)}
        _add_params(self, MLSTM_LEAVES, shapes, _F32_LEAVES, device, masters)

    def _proj(self, x):
        dt = x.dtype
        h = L.rmsnorm(x, self.ln, self.cfg.norm_eps)
        xu = h @ self.w_up.to(dt)
        gate = F.silu(h @ self.w_gate.to(dt))
        itil = (xu @ self.w_i.to(dt)).float()
        logf = L.log_sigmoid((xu @ self.w_f.to(dt)).float() + self.b_f)
        return xu, gate, itil, logf

    def full(self, x):
        B, S, _ = x.shape
        H, dt = self.cfg.mlstm_heads, x.dtype
        xu, gate, itil, logf = self._proj(x)
        xh = xu.reshape(B, S, H, -1)
        q = torch.einsum("bshd,hde->bshe", xh, self.wq.to(dt))
        k = torch.einsum("bshd,hde->bshe", xh, self.wk.to(dt))
        v = torch.einsum("bshd,hde->bshe", xh, self.wv.to(dt))
        out = mlstm_parallel(q, k, v, itil, logf).reshape(B, S, -1)
        return x + (gate * out) @ self.w_down.to(dt)

    def decode(self, x, C_state, n_state, m_state, rows=None):
        """x (B,1,d); C (B,H,hd,hd), n (B,H,hd), m (B,H), all f32, updated
        in place (at ``rows`` only when given)."""
        B, dt = x.shape[0], x.dtype
        H = self.cfg.mlstm_heads
        xu, gate, itil, logf = self._proj(x)
        xu, gate, itil, logf = xu[:, 0], gate[:, 0], itil[:, 0], logf[:, 0]
        xh = xu.reshape(B, H, -1)
        hd = xh.shape[-1]
        q = torch.einsum("bhd,hde->bhe", xh, self.wq.to(dt)).float()
        k = torch.einsum("bhd,hde->bhe", xh, self.wk.to(dt)).float() / np.sqrt(hd)
        v = torch.einsum("bhd,hde->bhe", xh, self.wv.to(dt)).float()
        m_new = torch.maximum(logf + m_state, itil)
        fprime = torch.exp(logf + m_state - m_new)
        iprime = torch.exp(itil - m_new)
        C_new = fprime[..., None, None] * C_state + iprime[..., None, None] * (
            k[..., :, None] * v[..., None, :])
        n_new = fprime[..., None] * n_state + iprime[..., None] * k
        num = torch.einsum("bhd,bhde->bhe", q, C_new)
        # the stabilized normalizer's floor is exp(−m_t), as in the parallel form
        den = torch.maximum(torch.einsum("bhd,bhd->bh", q, n_new).abs(), torch.exp(-m_new))
        out = (num / den[..., None]).reshape(B, -1).to(dt)
        y = x + ((gate * out) @ self.w_down.to(dt))[:, None]
        L.put_rows(C_state, C_new, rows)
        L.put_rows(n_state, n_new, rows)
        L.put_rows(m_state, m_new, rows)
        return y


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

class SLSTMBlock(nn.Module):
    """One sLSTM layer (JAX ``_slstm_block_full`` / ``_slstm_block_decode``).

    The recurrence over time is ``kernels.slstm``'s wrapper: on the card
    the kernel, one launch a step (``SLSTMScan`` when a gradient is wanted,
    with the backward kernel); on the CPU its plain loop under autograd;
    on meta one step counted S times."""

    def __init__(self, cfg: ArchConfig, device="cuda", masters: bool = False):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        shapes = {"ln": (d,), "W": (d, 4 * d), "R": (4, d // 4, d), "b": (4 * d,),
                  "w_out": (d, d)}
        _add_params(self, SLSTM_LEAVES, shapes, _F32_LEAVES, device, masters)

    def _gates_in(self, x):
        return (L.rmsnorm(x, self.ln, self.cfg.norm_eps) @ self.W.to(x.dtype)).float() + self.b

    def full(self, x, ctx=None):
        B, S, d = x.shape
        wx = self._gates_in(x)  # (B,S,4d) f32
        if ctx is not None:
            wx = constrain(wx, ctx, P(ctx.dp_axes, None, None))
        if x.device.type == "meta":  # one step, counted S times
            state = slstm_ref.zero_state(B, d, x.device)
            h = opcount.repeated(lambda R, w, *st: slstm_ref.slstm_step_ref(st, w, R)[0], S,
                                 self.R, wx[:, 0], *state, name="slstm_time")[0]
            return x + h[:, None].expand(B, S, d).to(x.dtype) @ self.w_out.to(x.dtype)
        if x.device.type == "cuda" and torch.is_grad_enabled() and (
                wx.requires_grad or self.R.requires_grad):
            hs = slstm_ops.SLSTMScan.apply(wx, self.R)
        else:  # the CPU's plain loop runs under the caller's grad mode
            hs = slstm_ops.slstm_fwd(wx, self.R)[0]
        if ctx is not None:  # JAX's batch-only pins of every step's state and output
            hs = constrain(hs, ctx, P(ctx.dp_axes, None, None))
        return x + hs.to(x.dtype) @ self.w_out.to(x.dtype)

    def decode(self, x, states, rows=None):
        """x (B,1,d); ``states`` (h, c, n, m), each (B,d) f32, updated in
        place (at ``rows`` only when given)."""
        wx = self._gates_in(x)
        if x.device.type == "meta":
            # the dry run's decode cells count one step's ops, as JAX's does:
            # the wrapper's plain loop would add its stack of the steps (the
            # decode_32k cell of xlstm-1.3b: 14 dispatches, 12.6 MB more)
            new, h = slstm_ref.slstm_step_ref(tuple(states), wx[:, 0], self.R)
        else:  # on the card the kernel (one launch), on the CPU its plain version
            hs, new = slstm_ops.slstm_fwd(wx, self.R, states)
            h = hs[:, 0]
        y = x + (h.to(x.dtype) @ self.w_out.to(x.dtype))[:, None]
        for dst, src in zip(states, new):
            L.put_rows(dst, src, rows)
        return y


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, B: int, T: int, device=None) -> Dict[str, object]:
    """JAX's cache: mLSTM C (sb, m_per, B, H, hd, hd), n and m, and the four
    sLSTM states (sb, B, d), all f32 zeros (``T`` is unused: O(1) state)."""
    sb, m_per = n_superblocks(cfg), cfg.slstm_every - 1
    H, hd, d = cfg.mlstm_heads, head_dim(cfg), cfg.d_model

    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return {"mlstm_C": z(sb, m_per, B, H, hd, hd), "mlstm_n": z(sb, m_per, B, H, hd),
            "mlstm_m": z(sb, m_per, B, H), "slstm": tuple(z(sb, B, d) for _ in range(4))}


def _superblock(x, mls, sl: SLSTMBlock, ctx=None) -> torch.Tensor:
    """One super-block over a sequence: JAX's scanned ``sb_body``."""
    for blk in mls:
        x = _pin(blk.full(x), ctx)
    return _pin(sl.full(x, ctx), ctx)


class XLSTM(nn.Module):
    """Parameters as in JAX's ``init_params``: ``mlstm`` (sb × m_per blocks,
    super-block major) and ``slstm`` (one a super-block); served, or with
    ``masters`` float32 and trainable."""

    def __init__(self, cfg: ArchConfig, device="cuda", masters: bool = False):
        super().__init__()
        if cfg.family != "ssm":
            raise ValueError(f"{cfg.name}: XLSTM serves the ssm family, not {cfg.family}")
        self.cfg = cfg
        sb, m_per = n_superblocks(cfg), cfg.slstm_every - 1
        self.embed = _param((cfg.vocab, cfg.d_model), compute_dtype(cfg), device, masters)
        self.final_norm = _param((cfg.d_model,), torch.float32, device, masters)
        self.mlstm = nn.ModuleList(MLSTMBlock(cfg, device, masters) for _ in range(sb * m_per))
        self.slstm = nn.ModuleList(SLSTMBlock(cfg, device, masters) for _ in range(sb))

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> "XLSTM":
        """Draw every weight from ``gen`` as JAX's ``init_params`` does: f32
        normals scaled by 1/sqrt(fan_in) (``w_down`` by 1/sqrt(inner dim),
        ``R`` by 0.5/sqrt(d)), the embedding by 0.02; norms at 1, ``b_f``
        at 3 (open forget gates), ``b`` at 0 (masters keep the f32 draws)."""
        dev, d = self.embed.device, self.cfg.d_model
        self.embed.copy_(L.embed_init(gen, *self.embed.shape, device=dev))
        self.final_norm.fill_(1.0)
        fills = {"ln": 1.0, "b_f": 3.0, "b": 0.0}
        scales = {"w_down": 1.0 / np.sqrt(inner_dim(self.cfg)), "R": 0.5 / np.sqrt(d)}
        for blk in list(self.mlstm) + list(self.slstm):
            for name, w in blk.named_parameters():
                if name in fills:
                    w.fill_(fills[name])
                else:
                    w.copy_(L.dense_init(gen, tuple(w.shape), scales.get(name), device=dev))
        return self

    def _superblocks(self):
        m_per = self.cfg.slstm_every - 1
        for s, sl in enumerate(self.slstm):
            yield s, self.mlstm[s * m_per:(s + 1) * m_per], sl

    def _embed(self, tokens):
        return self.embed[tokens.long()].to(compute_dtype(self.cfg))

    def _unembed(self, x):
        x = L.rmsnorm(x, self.final_norm, self.cfg.norm_eps)
        return x @ self.embed.T.to(x.dtype)

    def forward(self, tokens, vision_embeds=None, ctx=None):
        """Full-sequence logits and ``{}``.  tokens (B, S) int.  Runs under
        the caller's grad mode, each super-block under ``layers.remat``."""
        x = self._embed(tokens)
        for _s, mls, sl in self._superblocks():
            x = L.remat(_superblock, self.cfg)(x, mls, sl, ctx)
        return self._unembed(x), {}

    def init_cache(self, B: int, T: int):
        return init_cache(self.cfg, B, T, self.embed.device)

    @torch.no_grad()
    def prefill(self, tokens, cache_len: Optional[int] = None, vision_embeds=None, ctx=None):
        """The forward's logits and a fresh ``init_cache`` (not the prompt's
        state), as JAX's ``prefill`` returns."""
        logits, _ = self.forward(tokens, ctx=ctx)
        return logits, self.init_cache(tokens.shape[0], cache_len or tokens.shape[1])

    @torch.no_grad()
    def decode_step(self, cache, tokens, pos: int, rows: Optional[Sequence[int]] = None,
                    ctx=None):
        """One new token per sequence (``pos`` and ``ctx`` are unused: the
        state is O(1), and JAX's decode places no pin).

        The cache is updated in place (and returned), at every row or only
        ``rows``."""
        x = self._embed(tokens)
        if rows is not None:
            rows = torch.as_tensor(rows, dtype=torch.long, device=x.device)
        C, n, m = cache["mlstm_C"], cache["mlstm_n"], cache["mlstm_m"]
        for s, mls, sl in self._superblocks():
            for j, blk in enumerate(mls):
                x = blk.decode(x, C[s, j], n[s, j], m[s, j], rows)
            x = sl.decode(x, [st[s] for st in cache["slstm"]], rows)
        return self._unembed(x), cache
