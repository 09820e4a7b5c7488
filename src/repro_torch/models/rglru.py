"""RecurrentGemma-style hybrid model: the port of ``repro.models.rglru``.

Griffin/RecurrentGemma (arXiv:2402.19427) interleaves RG-LRU recurrent
blocks with local (banded) attention in a (rec, rec, attn) pattern.  The
recurrence

    a_t = exp(−c · softplus(Λ) · r_t),   r_t = σ(x_t W_a + b_a)
    h_t = a_t ⊙ h_{t−1} + √(1 − a_t²) ⊙ (i_t ⊙ x_t)

is linear in h: ``forward`` runs it as a log-depth scan over time
(Hillis–Steele doubling in plain torch, where JAX uses XLA's
``associative_scan``: the same function, summed in another order), and
``decode_step`` carries O(1) state.  The layers are ``n_layers // 3``
super-blocks of (rec, rec, attn) and ``n_layers % 3`` trailing rec layers
(38 = 12 × 3 + 2 for recurrentgemma-9b).  Every attention is
``kernels.flash_attention``: banded causal over the prompt
(``window=attn_window``), and at decode against a ring-buffer KV cache of
width ``min(attn_window, T)`` whose slot s holds position ``attn_pos[s]``
(``key_pos=attn_pos, qpos=pos``).

Dtypes follow JAX's: matrices in ``compute_dtype``; ``lam`` used in f32,
``b_a``/``b_i`` cast to the compute dtype at use; ``conv_w`` kept in f32,
cast to the activations' dtype in the forward and contracted in f32 at
decode; the recurrent state h in f32 and the conv history in the compute
dtype.  With ``masters=True`` every leaf is a trainable float32 master and
each is cast where JAX casts it (a served leaf's cast returns the leaf).
``forward`` runs under the caller's grad mode, each (rec, rec, attn)
super-block under ``layers.remat`` (JAX's ``scan(_remat(body))``; the
trailing rec layers are not rematerialised, as in JAX); ``prefill`` and
``decode_step`` build no graph.

Differences from the JAX module, all deliberate: parameters are split
into one block module per layer; ``decode_step(rows=...)`` writes K/V and
the recurrent state at ``rows`` only (JAX writes every row and the engine
merges), but writes ``attn_pos`` on every call, since it has no batch axis
and JAX's engine takes such a leaf from the newest decode.  The rows
outside ``rows`` read their old K/V at the slot just stamped ``pos``;
their logits are the engine's to discard.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import layers as L
from repro_torch.models.transformer import _add_params, _param, build_positions, compute_dtype

RGLRU_C = 8.0
REC_LEAVES = ("ln", "w_in", "w_gate_branch", "conv_w", "w_a", "b_a", "w_i", "b_i", "lam",
              "w_out", "ln2", "w_gate", "w_up", "w_down")
ATTN_LEAVES = ("ln1", "wq", "wk", "wv", "wo", "ln2", "w_gate", "w_up", "w_down")
_F32_LEAVES = ("ln", "ln1", "ln2", "conv_w", "b_a", "b_i", "lam")


def n_superblocks(cfg: ArchConfig) -> Tuple[int, int]:
    sb = cfg.n_layers // 3
    return sb, cfg.n_layers - 3 * sb


# ---------------------------------------------------------------------------
# RG-LRU core
# ---------------------------------------------------------------------------

def causal_conv1d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal temporal conv.  x (B,S,D), w (W,D) cast to x's dtype."""
    W, S = w.shape[0], x.shape[1]
    pads = torch.nn.functional.pad(x, (0, 0, W - 1, 0))
    out = torch.zeros_like(x)
    for i in range(W):
        out = out + pads[:, i:i + S] * w[i].to(x.dtype)
    return out


def rglru_gates(xb: torch.Tensor, blk: "RecBlock") -> Tuple[torch.Tensor, torch.Tensor]:
    """(a, b), both f32, of h_t = a_t h_{t−1} + b_t for inputs xb (…, D)."""
    dt = xb.dtype
    r = torch.sigmoid(xb @ blk.w_a.to(dt) + blk.b_a.to(dt))
    i = torch.sigmoid(xb @ blk.w_i.to(dt) + blk.b_i.to(dt))
    log_a = (-RGLRU_C * L.softplus(blk.lam.float())) * r.float()
    a = torch.exp(log_a)
    b = torch.sqrt(L.maximum(1.0 - a * a, 1e-6)) * (i.float() * xb.float())
    return a, b


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t−1} + b_t over axis 1 (time) from h_{−1} = 0.

    Hillis–Steele doubling: after the pass at offset d, element t holds
    the composition of elements (t − 2d, t], combined as JAX's
    ``(a_l a_r, a_r b_l + b_r)``; ⌈log2 S⌉ passes of elementwise work."""
    S, d = a.shape[1], 1
    while d < S:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], 1)
        if 2 * d < S:
            a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], 1)
        d *= 2
    return b


def _ffn(blk, x: torch.Tensor) -> torch.Tensor:
    c, dt = blk.cfg, x.dtype
    return x + L.glu_mlp(L.rmsnorm(x, blk.ln2, c.norm_eps), blk.w_gate.to(dt), blk.w_up.to(dt),
                         blk.w_down.to(dt), c.act)



class RecBlock(nn.Module):
    """One RG-LRU block: ``full`` over a sequence (JAX ``_rec_block_full``),
    ``decode`` for one token (``_rec_block_decode``)."""

    def __init__(self, cfg: ArchConfig, device="cuda", masters: bool = False):
        super().__init__()
        self.cfg = cfg
        d, F = cfg.d_model, cfg.d_ff
        shapes = {"ln": (d,), "w_in": (d, d), "w_gate_branch": (d, d),
                  "conv_w": (cfg.rglru_conv_width, d), "w_a": (d, d), "b_a": (d,),
                  "w_i": (d, d), "b_i": (d,), "lam": (d,), "w_out": (d, d), "ln2": (d,),
                  "w_gate": (d, F), "w_up": (d, F), "w_down": (F, d)}
        _add_params(self, REC_LEAVES, shapes, _F32_LEAVES, device, masters)

    def full(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        h = L.rmsnorm(x, self.ln, self.cfg.norm_eps)
        xb = causal_conv1d(h @ self.w_in.to(dt), self.conv_w)
        a, b = rglru_gates(xb, self)
        rec = rglru_scan(a, b).to(dt)
        gate = L.gelu(h @ self.w_gate_branch.to(dt))
        return _ffn(self, x + (gate * rec) @ self.w_out.to(dt))

    def decode(self, x: torch.Tensor, h_state: torch.Tensor, conv_state: torch.Tensor,
               rows: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B,1,d); h_state (B,d) f32 and conv_state (B,W−1,d) are updated
        in place (at ``rows`` only when given)."""
        dt = x.dtype
        h = L.rmsnorm(x, self.ln, self.cfg.norm_eps)
        xb = (h @ self.w_in.to(dt))[:, 0]
        hist = torch.cat([conv_state, xb[:, None]], 1)  # (B, W, d)
        xc = (hist.float() * self.conv_w).sum(1).to(dt)
        a, b = rglru_gates(xc, self)
        h_new = a * h_state + b
        gate = L.gelu(h[:, 0] @ self.w_gate_branch.to(dt))
        y = _ffn(self, x + ((gate * h_new.to(dt)) @ self.w_out.to(dt))[:, None])
        L.put_rows(h_state, h_new, rows)
        L.put_rows(conv_state, hist[:, 1:], rows)
        return y


class AttnBlock(nn.Module):
    """One local-attention block (JAX ``_attn_block_full`` / ``_attn_block_decode``)."""

    def __init__(self, cfg: ArchConfig, device="cuda", masters: bool = False):
        super().__init__()
        self.cfg = cfg
        d, F = cfg.d_model, cfg.d_ff
        shapes = {"ln1": (d,), "wq": (d, cfg.q_dim), "wk": (d, cfg.kv_dim),
                  "wv": (d, cfg.kv_dim), "wo": (cfg.q_dim, d), "ln2": (d,),
                  "w_gate": (d, F), "w_up": (d, F), "w_down": (F, d)}
        _add_params(self, ATTN_LEAVES, shapes, _F32_LEAVES, device, masters)

    def _qkv(self, x, positions):
        c, dt = self.cfg, x.dtype
        h = L.rmsnorm(x, self.ln1, c.norm_eps)
        q, k, v = L.qkv_project(h, self.wq.to(dt), self.wk.to(dt), self.wv.to(dt), c.n_heads,
                                c.n_kv_heads, c.head_dim)
        return L.apply_rope(q, positions, c.rope_theta), L.apply_rope(k, positions, c.rope_theta), v

    def _out(self, x, attn):
        B, S = x.shape[:2]
        return _ffn(self, x + attn.reshape(B, S, self.cfg.q_dim) @ self.wo.to(x.dtype))

    def full(self, x, positions):
        """(x', k, v) over a whole sequence under the banded causal mask."""
        q, k, v = self._qkv(x, positions)
        attn = flash_attention(q, k, v, causal=True, window=self.cfg.attn_window)
        return self._out(x, attn), k, v

    def decode(self, x, k_cache, v_cache, pos_buf, pos: int, positions, rows=None):
        """One token at position ``pos`` into slot pos mod W of the ring:
        K/V (B, W, K, hd) written at ``rows`` only when given, ``pos_buf``
        (W,) on every call; attends the slots whose positions lie in
        (pos − window, pos]."""
        q, k, v = self._qkv(x, positions)
        slot = pos % k_cache.shape[1]
        L.put_rows(k_cache[:, slot], k[:, 0], rows)
        L.put_rows(v_cache[:, slot], v[:, 0], rows)
        pos_buf[slot] = pos
        attn = flash_attention(q, k_cache, v_cache, key_pos=pos_buf, qpos=pos,
                               window=self.cfg.attn_window)
        return self._out(x, attn)


def init_cache(cfg: ArchConfig, B: int, T: int, device=None) -> Dict[str, object]:
    """JAX's cache: per rec stack (h (n,B,d) f32, conv (n,B,W−1,d)); the ring
    (sb,B,W,K,hd) K and V with W = min(attn_window, T) and its (sb, W)
    int32 positions, −1 where empty."""
    dt = compute_dtype(cfg)
    sb, trailing = n_superblocks(cfg)
    Wn, Wc, d = min(cfg.attn_window, T), cfg.rglru_conv_width - 1, cfg.d_model

    def rec_state(n):
        return (torch.zeros((n, B, d), dtype=torch.float32, device=device),
                torch.zeros((n, B, Wc, d), dtype=dt, device=device))

    kv = (sb, B, Wn, cfg.n_kv_heads, cfg.head_dim)
    return {"rec1": rec_state(sb), "rec2": rec_state(sb),
            "attn_k": torch.zeros(kv, dtype=dt, device=device),
            "attn_v": torch.zeros(kv, dtype=dt, device=device),
            "attn_pos": torch.full((sb, Wn), -1, dtype=torch.int32, device=device),
            "rec_tail": rec_state(trailing) if trailing else None}


def _superblock(x, r1: RecBlock, r2: RecBlock, at: AttnBlock, positions) -> torch.Tensor:
    """One (rec, rec, attn) super-block over a sequence: JAX's scanned ``body``."""
    return at.full(r2.full(r1.full(x)), positions)[0]


class RecurrentGemma(nn.Module):
    """Parameters as in JAX's ``init_params``: ``rec1``, ``rec2`` and
    ``attn`` (one block per super-block) and ``rec_tail``; served, or with
    ``masters`` float32 and trainable."""

    def __init__(self, cfg: ArchConfig, device="cuda", masters: bool = False):
        super().__init__()
        if cfg.family != "hybrid":
            raise ValueError(f"{cfg.name}: RecurrentGemma serves the hybrid family, "
                             f"not {cfg.family}")
        self.cfg = cfg
        sb, trailing = n_superblocks(cfg)
        self.embed = _param((cfg.vocab, cfg.d_model), compute_dtype(cfg), device, masters)
        self.final_norm = _param((cfg.d_model,), torch.float32, device, masters)
        self.rec1 = nn.ModuleList(RecBlock(cfg, device, masters) for _ in range(sb))
        self.rec2 = nn.ModuleList(RecBlock(cfg, device, masters) for _ in range(sb))
        self.attn = nn.ModuleList(AttnBlock(cfg, device, masters) for _ in range(sb))
        self.rec_tail = nn.ModuleList(RecBlock(cfg, device, masters) for _ in range(trailing))

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> "RecurrentGemma":
        """Draw every weight from ``gen`` as JAX's ``init_params`` does: f32
        normals, matrices scaled by 1/sqrt(fan_in) (``conv_w`` by 0.5,
        ``w_down`` by 1/sqrt(d_ff)), the embedding by 0.02; norms at 1,
        ``b_a``/``b_i`` at 0, ``lam`` at 0.5 (masters keep the f32 draws)."""
        dev = self.embed.device
        self.embed.copy_(L.embed_init(gen, *self.embed.shape, device=dev))
        self.final_norm.fill_(1.0)
        fills = {"ln": 1.0, "ln1": 1.0, "ln2": 1.0, "b_a": 0.0, "b_i": 0.0, "lam": 0.5}
        scales = {"conv_w": 0.5, "w_down": 1.0 / np.sqrt(self.cfg.d_ff)}
        for blk in list(self.rec1) + list(self.rec2) + list(self.attn) + list(self.rec_tail):
            for name, w in blk.named_parameters():
                if name in fills:
                    w.fill_(fills[name])
                else:
                    w.copy_(L.dense_init(gen, tuple(w.shape), scales.get(name), device=dev))
        return self

    def _embed(self, tokens):
        dt = compute_dtype(self.cfg)
        x = self.embed[tokens.long()].to(dt)
        return x * torch.tensor(math.sqrt(self.cfg.d_model), dtype=dt, device=x.device)

    def _unembed(self, x):
        x = L.rmsnorm(x, self.final_norm, self.cfg.norm_eps)
        return x @ self.embed.T.to(x.dtype)

    def forward(self, tokens, vision_embeds=None, ctx=None):
        """Full-sequence logits and ``{}``.  tokens (B, S) int.  Runs under
        the caller's grad mode, each super-block under ``layers.remat``.
        ``ctx`` is unused, as in JAX's hybrid model (no pin, no shard region)."""
        B, S = tokens.shape
        x = self._embed(tokens)
        positions = build_positions(self.cfg, B, S, device=x.device)
        for r1, r2, at in zip(self.rec1, self.rec2, self.attn):
            x = L.remat(_superblock, self.cfg)(x, r1, r2, at, positions)
        for blk in self.rec_tail:
            x = blk.full(x)
        return self._unembed(x), {}

    def init_cache(self, B: int, T: int):
        return init_cache(self.cfg, B, T, self.embed.device)

    @torch.no_grad()
    def prefill(self, tokens, cache_len: Optional[int] = None, vision_embeds=None, ctx=None):
        """The forward's logits and a fresh ``init_cache`` (not the prompt's
        state), as JAX's ``prefill`` returns."""
        logits, _ = self.forward(tokens)
        return logits, self.init_cache(tokens.shape[0], cache_len or tokens.shape[1])

    @torch.no_grad()
    def decode_step(self, cache, tokens, pos: int, rows: Optional[Sequence[int]] = None,
                    ctx=None):
        """One new token per sequence at position ``pos``.  tokens (B, 1).

        The cache is updated in place (and returned): the recurrent states
        and K/V at every row, or only ``rows``; ``attn_pos`` always."""
        B, S = tokens.shape
        pos = int(pos)
        x = self._embed(tokens)
        positions = build_positions(self.cfg, B, S, offset=pos, device=x.device)
        if rows is not None:
            rows = torch.as_tensor(rows, dtype=torch.long, device=x.device)
        (h1, c1), (h2, c2) = cache["rec1"], cache["rec2"]
        for i, (r1, r2, at) in enumerate(zip(self.rec1, self.rec2, self.attn)):
            x = r1.decode(x, h1[i], c1[i], rows)
            x = r2.decode(x, h2[i], c2[i], rows)
            x = at.decode(x, cache["attn_k"][i], cache["attn_v"][i], cache["attn_pos"][i], pos,
                          positions, rows)
        if len(self.rec_tail) and cache.get("rec_tail") is not None:
            th, tc = cache["rec_tail"]
            for i, blk in enumerate(self.rec_tail):
                x = blk.decode(x, th[i], tc[i], rows)
        return self._unembed(x), cache
