"""Encoder-decoder backbone (seamless-m4t-large-v2): the port of ``repro.models.encdec``.

The modality frontend is a stub, as in JAX: precomputed frame embeddings
(B, S_src, d_model) feed the encoder directly.  The decoder is a causal
transformer with cross attention over the encoder memory; ``decode_step``
carries a self-attention KV cache plus the cross-attention K/V of the
memory (``mem_k``/``mem_v``), which it never writes.

Every attention is ``kernels.flash_attention``: the encoder's
bidirectional self-attention (non-causal, S = T), the decoder's causal
self-attention over the target, cross attention (non-causal, S_tgt
queries against S_src keys), and decode against the cache slice
``[:, :pos+1]``.  As in ``models.transformer``, matrices are held in
``compute_dtype``, norms in f32, and ``decode_step`` writes the cache in
place at ``rows`` only when given.  No gemma embed scale; the unembedding
is tied (``embed.T``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import layers as L
from repro_torch.models.transformer import _param, build_positions, check_family, compute_dtype

SELF_LEAVES = ("ln1", "wq", "wk", "wv", "wo", "ln2", "w_gate", "w_up", "w_down")
CROSS_LEAVES = ("ln_x", "xq", "xk", "xv", "xo")


def init_cache(cfg: ArchConfig, B: int, T: int, mem_len: Optional[int] = None,
               device=None) -> Dict[str, torch.Tensor]:
    """Zero caches: self-attention ``k``/``v`` (L_dec, B, T, K, hd) and the
    memory's ``mem_k``/``mem_v`` (L_dec, B, mem_len or T, K, hd)."""
    dt = compute_dtype(cfg)
    self_shape = (cfg.dec_layers, B, T, cfg.n_kv_heads, cfg.head_dim)
    mem_shape = (cfg.dec_layers, B, mem_len or T, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(self_shape, dtype=dt, device=device),
            "v": torch.zeros(self_shape, dtype=dt, device=device),
            "mem_k": torch.zeros(mem_shape, dtype=dt, device=device),
            "mem_v": torch.zeros(mem_shape, dtype=dt, device=device)}


class EncDecBlock(nn.Module):
    """One encoder block (self-attention, MLP), or one decoder block with
    cross attention between them (``cross``)."""

    def __init__(self, cfg: ArchConfig, cross: bool, device="cuda"):
        super().__init__()
        self.cfg = cfg
        d, F, dt = cfg.d_model, cfg.d_ff, compute_dtype(cfg)
        self.ln1 = _param((d,), torch.float32, device)
        self.wq = _param((d, cfg.q_dim), dt, device)
        self.wk = _param((d, cfg.kv_dim), dt, device)
        self.wv = _param((d, cfg.kv_dim), dt, device)
        self.wo = _param((cfg.q_dim, d), dt, device)
        self.ln2 = _param((d,), torch.float32, device)
        self.w_gate = _param((d, F), dt, device)
        self.w_up = _param((d, F), dt, device)
        self.w_down = _param((F, d), dt, device)
        self.cross = cross
        if cross:
            self.ln_x = _param((d,), torch.float32, device)
            self.xq = _param((d, cfg.q_dim), dt, device)
            self.xk = _param((d, cfg.kv_dim), dt, device)
            self.xv = _param((d, cfg.kv_dim), dt, device)
            self.xo = _param((cfg.q_dim, d), dt, device)

    def leaves(self):
        return SELF_LEAVES + (CROSS_LEAVES if self.cross else ())

    def qkv(self, x, positions):
        c = self.cfg
        h = L.rmsnorm(x, self.ln1, c.norm_eps)
        q, k, v = L.qkv_project(h, self.wq, self.wk, self.wv, c.n_heads, c.n_kv_heads, c.head_dim)
        return L.apply_rope(q, positions, c.rope_theta), L.apply_rope(k, positions, c.rope_theta), v

    def attn_out(self, x, attn):
        B, S = x.shape[:2]
        return x + attn.reshape(B, S, self.cfg.q_dim) @ self.wo

    def self_attn(self, x, positions, causal: bool):
        """(x + self-attention, (k, v)) over the whole sequence."""
        q, k, v = self.qkv(x, positions)
        return self.attn_out(x, flash_attention(q, k, v, causal=causal)), (k, v)

    def mem_kv(self, memory):
        """This decoder layer's cross-attention K/V of the memory (B, S_src, K, hd)."""
        c = self.cfg
        B, S = memory.shape[:2]
        return ((memory @ self.xk).reshape(B, S, c.n_kv_heads, c.head_dim),
                (memory @ self.xv).reshape(B, S, c.n_kv_heads, c.head_dim))

    def cross_attn(self, x, mem_k, mem_v):
        c = self.cfg
        B, S = x.shape[:2]
        h = L.rmsnorm(x, self.ln_x, c.norm_eps)
        q = (h @ self.xq).reshape(B, S, c.n_heads, c.head_dim)
        attn = flash_attention(q, mem_k, mem_v, causal=False)
        return x + attn.reshape(B, S, c.q_dim) @ self.xo

    def mlp(self, x):
        c = self.cfg
        h = L.rmsnorm(x, self.ln2, c.norm_eps)
        return x + L.glu_mlp(h, self.w_gate, self.w_up, self.w_down, c.act)


class EncDec(nn.Module):
    """Parameters as in ``repro.models.encdec.init_params``: ``embed``,
    ``final_norm``, ``enc_final_norm`` and the stacked ``enc``/``dec``
    leaves split into one ``EncDecBlock`` per layer."""

    def __init__(self, cfg: ArchConfig, device="cuda"):
        super().__init__()
        check_family(cfg)
        if cfg.family != "encdec":
            raise ValueError(f"{cfg.name}: EncDec serves the encdec family, not {cfg.family}")
        self.cfg = cfg
        d = cfg.d_model
        self.embed = _param((cfg.vocab, d), compute_dtype(cfg), device)
        self.final_norm = _param((d,), torch.float32, device)
        self.enc_final_norm = _param((d,), torch.float32, device)
        self.enc = nn.ModuleList(EncDecBlock(cfg, False, device) for _ in range(cfg.enc_layers))
        self.dec = nn.ModuleList(EncDecBlock(cfg, True, device) for _ in range(cfg.dec_layers))

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> "EncDec":
        """Draw every weight from ``gen`` as ``init_params`` does: the
        embedding by 0.02, matrices by 1/sqrt(fan_in) (``w_down`` by
        1/sqrt(d_ff)), norms at 1."""
        dev = self.embed.device
        self.embed.copy_(L.embed_init(gen, *self.embed.shape, device=dev))
        for norm in (self.final_norm, self.enc_final_norm):
            norm.fill_(1.0)
        for blk in list(self.enc) + list(self.dec):
            for name in blk.leaves():
                w = getattr(blk, name)
                if name.startswith("ln"):
                    w.fill_(1.0)
                    continue
                scale = 1.0 / np.sqrt(self.cfg.d_ff) if name == "w_down" else None
                w.copy_(L.dense_init(gen, tuple(w.shape), scale, device=dev))
        return self

    # -- the JAX module's functions ---------------------------------------------
    def _tokens(self, tokens):
        return self.embed[tokens.long()].to(compute_dtype(self.cfg))

    def _unembed(self, x):
        x = L.rmsnorm(x, self.final_norm, self.cfg.norm_eps)
        return x @ self.embed.T

    @torch.no_grad()
    def encode(self, frames):
        """frames (B, S_src, d_model) stub embeddings → encoder memory."""
        B, S, _ = frames.shape
        x = frames.to(compute_dtype(self.cfg))
        positions = build_positions(self.cfg, B, S, device=x.device)
        for blk in self.enc:
            x, _kv = blk.self_attn(x, positions, causal=False)
            x = blk.mlp(x)
        return L.rmsnorm(x, self.enc_final_norm, self.cfg.norm_eps)

    def _decoder(self, tokens, mem):
        """The teacher-forced decoder over ``tokens`` against the per-layer
        memory K/V ``mem``; returns (logits, per-layer self (k, v))."""
        B, S = tokens.shape
        x = self._tokens(tokens)
        positions = build_positions(self.cfg, B, S, device=x.device)
        kvs = []
        for blk, (mk, mv) in zip(self.dec, mem):
            x, kv = blk.self_attn(x, positions, causal=True)
            x = blk.mlp(blk.cross_attn(x, mk, mv))
            kvs.append(kv)
        return self._unembed(x), kvs

    @torch.no_grad()
    def decode_train(self, tokens, memory):
        """Teacher-forced decoder logits over target tokens (B, S_tgt)."""
        return self._decoder(tokens, [blk.mem_kv(memory) for blk in self.dec])[0]

    @torch.no_grad()
    def forward(self, frames, tokens):
        """(decoder logits, {}) for frames (B, S_src, d) and tokens (B, S_tgt)."""
        return self.decode_train(tokens, self.encode(frames)), {}

    def init_cache(self, B: int, T: int, mem_len: Optional[int] = None) -> Dict[str, torch.Tensor]:
        return init_cache(self.cfg, B, T, mem_len, self.embed.device)

    @torch.no_grad()
    def prefill(self, frames, tokens, cache_len: Optional[int] = None):
        """Encode the source and run the target prefix; returns (logits,
        cache): self K/V filled up to S_tgt (zeros beyond, to ``cache_len``)
        and the memory's K/V."""
        memory = self.encode(frames)
        B, S = tokens.shape
        mem = [blk.mem_kv(memory) for blk in self.dec]
        logits, kvs = self._decoder(tokens, mem)
        cache = init_cache(self.cfg, B, cache_len or S, memory.shape[1], memory.device)
        for i, ((k, v), (mk, mv)) in enumerate(zip(kvs, mem)):
            cache["k"][i, :, :S] = k
            cache["v"][i, :, :S] = v
            cache["mem_k"][i] = mk
            cache["mem_v"][i] = mv
        return logits, cache

    @torch.no_grad()
    def decode_step(self, cache, tokens, pos: int, rows: Optional[Sequence[int]] = None):
        """One new token per sequence against the cache.  tokens (B, 1).

        Writes the self-attention K/V in place at ``pos`` (only at ``rows``
        when given); ``mem_k``/``mem_v`` stay as they are."""
        B, S = tokens.shape
        pos = int(pos)
        x = self._tokens(tokens)
        positions = build_positions(self.cfg, B, S, offset=pos, device=x.device)
        if rows is not None:
            rows = torch.as_tensor(rows, dtype=torch.long, device=x.device)
        for i, blk in enumerate(self.dec):
            q, k, v = blk.qkv(x, positions)
            kc, vc = cache["k"][i], cache["v"][i]
            if rows is None:
                kc[:, pos] = k[:, 0].to(kc.dtype)
                vc[:, pos] = v[:, 0].to(vc.dtype)
            else:
                kc[rows, pos] = k[rows, 0].to(kc.dtype)
                vc[rows, pos] = v[rows, 0].to(vc.dtype)
            x = blk.attn_out(x, flash_attention(q, kc[:, :pos + 1], vc[:, :pos + 1], causal=False))
            x = blk.mlp(blk.cross_attn(x, cache["mem_k"][i], cache["mem_v"][i]))
        return self._unembed(x), cache
