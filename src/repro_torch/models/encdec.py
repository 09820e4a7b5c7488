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
``compute_dtype``, norms in f32 (or, with ``masters=True``, every leaf a
trainable float32 master, each cast where JAX casts it), and
``decode_step`` writes the cache in place at ``rows`` only when given.
No gemma embed scale; the unembedding is tied (``embed.T``).
``encode``, ``decode_train`` and ``forward`` run under the caller's grad
mode, each encoder and decoder layer under ``layers.remat`` (JAX's two
``scan(_remat(body))``); the memory's cross-attention K/V are projected
before the decoder's layers and outside their remat, as JAX's
``_mem_kv`` is, and get their gradient through the cross attention's
(non-causal, S_tgt queries against S_src keys).  ``prefill`` and
``decode_step`` build no graph.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import layers as L
from repro_torch.models.transformer import (
    _add_params,
    _param,
    build_positions,
    check_family,
    compute_dtype,
)

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

    def __init__(self, cfg: ArchConfig, cross: bool, device="cuda", masters: bool = False):
        super().__init__()
        self.cfg = cfg
        d, F = cfg.d_model, cfg.d_ff
        self.cross = cross
        shapes = {"ln1": (d,), "wq": (d, cfg.q_dim), "wk": (d, cfg.kv_dim),
                  "wv": (d, cfg.kv_dim), "wo": (cfg.q_dim, d), "ln2": (d,), "w_gate": (d, F),
                  "w_up": (d, F), "w_down": (F, d), "ln_x": (d,), "xq": (d, cfg.q_dim),
                  "xk": (d, cfg.kv_dim), "xv": (d, cfg.kv_dim), "xo": (cfg.q_dim, d)}
        _add_params(self, self.leaves(), shapes, ("ln1", "ln2", "ln_x"), device, masters)

    def leaves(self):
        return SELF_LEAVES + (CROSS_LEAVES if self.cross else ())

    def qkv(self, x, positions):
        c, dt = self.cfg, x.dtype
        h = L.rmsnorm(x, self.ln1, c.norm_eps)
        q, k, v = L.qkv_project(h, self.wq.to(dt), self.wk.to(dt), self.wv.to(dt), c.n_heads,
                                c.n_kv_heads, c.head_dim)
        return L.apply_rope(q, positions, c.rope_theta), L.apply_rope(k, positions, c.rope_theta), v

    def attn_out(self, x, attn):
        B, S = x.shape[:2]
        return x + attn.reshape(B, S, self.cfg.q_dim) @ self.wo.to(x.dtype)

    def self_attn(self, x, positions, causal: bool):
        """(x + self-attention, (k, v)) over the whole sequence."""
        q, k, v = self.qkv(x, positions)
        return self.attn_out(x, flash_attention(q, k, v, causal=causal)), (k, v)

    def mem_kv(self, memory):
        """This decoder layer's cross-attention K/V of the memory (B, S_src, K, hd)."""
        c, dt = self.cfg, memory.dtype
        B, S = memory.shape[:2]
        return ((memory @ self.xk.to(dt)).reshape(B, S, c.n_kv_heads, c.head_dim),
                (memory @ self.xv.to(dt)).reshape(B, S, c.n_kv_heads, c.head_dim))

    def cross_attn(self, x, mem_k, mem_v):
        c, dt = self.cfg, x.dtype
        B, S = x.shape[:2]
        h = L.rmsnorm(x, self.ln_x, c.norm_eps)
        q = (h @ self.xq.to(dt)).reshape(B, S, c.n_heads, c.head_dim)
        attn = flash_attention(q, mem_k, mem_v, causal=False)
        return x + attn.reshape(B, S, c.q_dim) @ self.xo.to(dt)

    def mlp(self, x):
        c, dt = self.cfg, x.dtype
        h = L.rmsnorm(x, self.ln2, c.norm_eps)
        return x + L.glu_mlp(h, self.w_gate.to(dt), self.w_up.to(dt), self.w_down.to(dt), c.act)

    def encoder_layer(self, x, positions):
        """One encoder layer: JAX ``encode``'s scanned ``body``."""
        return self.mlp(self.self_attn(x, positions, causal=False)[0])

    def decoder_layer(self, x, positions, mem_k, mem_v):
        """One teacher-forced decoder layer: JAX ``decode_train``'s ``body``;
        returns (x', (k, v)) with its self-attention K/V."""
        x, kv = self.self_attn(x, positions, causal=True)
        return self.mlp(self.cross_attn(x, mem_k, mem_v)), kv

    def train_decoder_layer(self, x, positions, mem_k, mem_v):
        """``decoder_layer`` without its K/V: what a remat layer keeps."""
        return self.decoder_layer(x, positions, mem_k, mem_v)[0]


class EncDec(nn.Module):
    """Parameters as in ``repro.models.encdec.init_params``: ``embed``,
    ``final_norm``, ``enc_final_norm`` and the stacked ``enc``/``dec``
    leaves split into one ``EncDecBlock`` per layer; served, or with
    ``masters`` float32 and trainable."""

    def __init__(self, cfg: ArchConfig, device="cuda", masters: bool = False):
        super().__init__()
        check_family(cfg)
        if cfg.family != "encdec":
            raise ValueError(f"{cfg.name}: EncDec serves the encdec family, not {cfg.family}")
        self.cfg = cfg
        d = cfg.d_model
        self.embed = _param((cfg.vocab, d), compute_dtype(cfg), device, masters)
        self.final_norm = _param((d,), torch.float32, device, masters)
        self.enc_final_norm = _param((d,), torch.float32, device, masters)
        self.enc = nn.ModuleList(EncDecBlock(cfg, False, device, masters)
                                 for _ in range(cfg.enc_layers))
        self.dec = nn.ModuleList(EncDecBlock(cfg, True, device, masters)
                                 for _ in range(cfg.dec_layers))

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> "EncDec":
        """Draw every weight from ``gen`` as ``init_params`` does: the
        embedding by 0.02, matrices by 1/sqrt(fan_in) (``w_down`` by
        1/sqrt(d_ff)), norms at 1 (masters keep the f32 draws)."""
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
        return x @ self.embed.T.to(x.dtype)

    def encode(self, frames):
        """frames (B, S_src, d_model) stub embeddings → encoder memory.
        Runs under the caller's grad mode, each layer under ``layers.remat``."""
        B, S, _ = frames.shape
        x = frames.to(compute_dtype(self.cfg))
        positions = build_positions(self.cfg, B, S, device=x.device)
        for blk in self.enc:
            x = L.remat(blk.encoder_layer, self.cfg)(x, positions)
        return L.rmsnorm(x, self.enc_final_norm, self.cfg.norm_eps)

    def decode_train(self, tokens, memory):
        """Teacher-forced decoder logits over target tokens (B, S_tgt).
        Runs under the caller's grad mode, each layer under ``layers.remat``."""
        B, S = tokens.shape
        mem = [blk.mem_kv(memory) for blk in self.dec]
        x = self._tokens(tokens)
        positions = build_positions(self.cfg, B, S, device=x.device)
        for blk, (mk, mv) in zip(self.dec, mem):
            x = L.remat(blk.train_decoder_layer, self.cfg)(x, positions, mk, mv)
        return self._unembed(x)

    def forward(self, frames, tokens, ctx=None):
        """(decoder logits, {}) for frames (B, S_src, d) and tokens (B, S_tgt),
        under the caller's grad mode.  ``ctx`` is unused, as in JAX's encdec
        model (no pin, no shard region)."""
        return self.decode_train(tokens, self.encode(frames)), {}

    def init_cache(self, B: int, T: int, mem_len: Optional[int] = None) -> Dict[str, torch.Tensor]:
        return init_cache(self.cfg, B, T, mem_len, self.embed.device)

    @torch.no_grad()
    def prefill(self, frames, tokens, cache_len: Optional[int] = None, ctx=None):
        """Encode the source and run the target prefix; returns (logits,
        cache): self K/V filled up to S_tgt (zeros beyond, to ``cache_len``)
        and the memory's K/V."""
        memory = self.encode(frames)
        B, S = tokens.shape
        cache = init_cache(self.cfg, B, cache_len or S, memory.shape[1], memory.device)
        x = self._tokens(tokens)
        positions = build_positions(self.cfg, B, S, device=x.device)
        for i, blk in enumerate(self.dec):
            mk, mv = blk.mem_kv(memory)
            x, (k, v) = blk.decoder_layer(x, positions, mk, mv)
            cache["k"][i, :, :S] = k
            cache["v"][i, :, :S] = v
            cache["mem_k"][i] = mk
            cache["mem_v"][i] = mv
        return self._unembed(x), cache

    @torch.no_grad()
    def decode_step(self, cache, tokens, pos: int, rows: Optional[Sequence[int]] = None,
                    ctx=None):
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
