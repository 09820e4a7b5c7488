"""Decoder-only transformer LM, dense family (phi3-mini, gemma-2b/7b, granite-3-2b).

The port of ``repro.models.transformer`` for the dense configs, as an
``nn.Module`` that serves (no backward: the JAX flash kernel has none).
Every attention goes through ``kernels.flash_attention``: causal over the
prompt in ``forward``/``prefill``, non-causal against the cache slice
``[:, :pos+1]`` in ``decode_step`` (the slice is a view; keys past ``pos``
are exactly the ones ``decode_mask(T, pos)`` masks).

Differences from the JAX module, all deliberate:
  * matrices are held in ``compute_dtype`` (the bf16 cast of an f32 master
    gives the same values JAX casts to at use); norm weights stay f32;
  * no ``ParallelCtx``, sharding pins or K/V repeat (sharding is ROADMAP
    A.13);
  * ``decode_step`` writes the new K/V into the cache in place, and only
    at the batch rows it is given (``rows``): the same cache JAX's
    functional update followed by the serving engine's masked merge gives.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import layers as L

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

_NOT_PORTED = {
    "moe": "models/moe.py (ROADMAP A.14, moe)",
    "vlm": "M-RoPE positions and vision_proj (ROADMAP A.14, vlm)",
    "hybrid": "models/rglru.py (ROADMAP A.14, rglru)",
    "ssm": "models/xlstm.py (ROADMAP A.14, xlstm)",
    "encdec": "models/encdec.py (ROADMAP A.14, encdec)",
}


def check_family(cfg: ArchConfig) -> None:
    """Raise unless ``cfg`` is of the dense family, the one ported so far."""
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(f"{cfg.name}: the {cfg.family} family is not ported yet: "
                                  f"{_NOT_PORTED[cfg.family]}")
    if cfg.family != "dense":
        raise ValueError(cfg.family)


def compute_dtype(cfg: ArchConfig) -> torch.dtype:
    return _DTYPES[cfg.compute_dtype]


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=False)


def build_positions(B: int, S: int, offset: int = 0, device=None) -> torch.Tensor:
    """(B, S) int32 rope positions; ``offset`` is the first token's absolute
    position (decode passes the cache position).  The dense family's only
    kind: M-RoPE's (3, B, S) positions come with the vlm family."""
    ai = torch.arange(S, dtype=torch.int32, device=device) + offset
    return ai[None, :].expand(B, S)


def init_cache(cfg: ArchConfig, B: int, T: int, device=None) -> Dict[str, torch.Tensor]:
    """Zero K/V caches, (L, B, T, K, hd) each in ``compute_dtype``."""
    shape = (cfg.n_layers, B, T, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=compute_dtype(cfg), device=device),
            "v": torch.zeros(shape, dtype=compute_dtype(cfg), device=device)}


class Block(nn.Module):
    """One transformer block: ``full`` over a sequence (JAX ``_layer_full``),
    ``decode`` for one token against the cache (``_layer_decode``)."""

    def __init__(self, cfg: ArchConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        d, F, dt = cfg.d_model, cfg.d_ff, compute_dtype(cfg)
        self.ln1 = _param((d,), torch.float32, device)
        self.ln2 = _param((d,), torch.float32, device)
        self.wq = _param((d, cfg.q_dim), dt, device)
        self.wk = _param((d, cfg.kv_dim), dt, device)
        self.wv = _param((d, cfg.kv_dim), dt, device)
        self.wo = _param((cfg.q_dim, d), dt, device)
        self.w_gate = _param((d, F), dt, device)
        self.w_up = _param((d, F), dt, device)
        self.w_down = _param((F, d), dt, device)

    def _qkv(self, x, positions):
        c = self.cfg
        h = L.rmsnorm(x, self.ln1, c.norm_eps)
        q, k, v = L.qkv_project(h, self.wq, self.wk, self.wv, c.n_heads, c.n_kv_heads, c.head_dim)
        return L.apply_rope(q, positions, c.rope_theta), L.apply_rope(k, positions, c.rope_theta), v

    def _out(self, x, attn):
        c = self.cfg
        B, S = x.shape[:2]
        x = x + attn.reshape(B, S, c.q_dim) @ self.wo
        h2 = L.rmsnorm(x, self.ln2, c.norm_eps)
        return x + L.glu_mlp(h2, self.w_gate, self.w_up, self.w_down, c.act)

    def full(self, x, positions):
        """(x', k, v) over a whole sequence, causal."""
        q, k, v = self._qkv(x, positions)
        return self._out(x, flash_attention(q, k, v, causal=True)), k, v

    def decode(self, x, k_cache, v_cache, pos: int, positions, rows=None):
        """One token per sequence at cache position ``pos``; writes its K/V
        into ``k_cache``/``v_cache`` (B, T, K, hd) in place, at ``rows`` only
        when given."""
        q, k, v = self._qkv(x, positions)
        if rows is None:
            k_cache[:, pos] = k[:, 0].to(k_cache.dtype)
            v_cache[:, pos] = v[:, 0].to(v_cache.dtype)
        else:
            k_cache[rows, pos] = k[rows, 0].to(k_cache.dtype)
            v_cache[rows, pos] = v[rows, 0].to(v_cache.dtype)
        attn = flash_attention(q, k_cache[:, :pos + 1], v_cache[:, :pos + 1], causal=False)
        return self._out(x, attn)


class Transformer(nn.Module):
    """Parameters as in ``init_params`` (names and (in, out) orientation),
    the stacked ``layers`` leaves split into one ``Block`` per layer."""

    def __init__(self, cfg: ArchConfig, device="cuda"):
        super().__init__()
        check_family(cfg)
        self.cfg = cfg
        d, V, dt = cfg.d_model, cfg.vocab, compute_dtype(cfg)
        self.embed = _param((V, d), dt, device)
        self.final_norm = _param((d,), torch.float32, device)
        self.lm_head = None if cfg.tie_embeddings else _param((d, V), dt, device)
        self.layers = nn.ModuleList(Block(cfg, device) for _ in range(cfg.n_layers))

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> "Transformer":
        """Draw every weight from ``gen`` (on the parameters' device) as
        ``init_params`` does: f32 normals, matrices scaled by 1/sqrt(fan_in),
        the embedding by 0.02, norms at 1; matrices then cast to
        ``compute_dtype``."""
        dev = self.embed.device
        self.embed.copy_(L.embed_init(gen, *self.embed.shape, device=dev))
        self.final_norm.fill_(1.0)
        for blk in self.layers:
            blk.ln1.fill_(1.0)
            blk.ln2.fill_(1.0)
            for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
                w = getattr(blk, name)
                w.copy_(L.dense_init(gen, tuple(w.shape), device=dev))
        if self.lm_head is not None:
            self.lm_head.copy_(L.dense_init(gen, tuple(self.lm_head.shape), device=dev))
        return self

    # -- public API (the JAX module's functions) -------------------------------
    def _embed(self, tokens):
        dt = compute_dtype(self.cfg)
        x = self.embed[tokens.long()].to(dt)
        if self.cfg.name.startswith("gemma"):
            x = x * torch.tensor(math.sqrt(self.cfg.d_model), dtype=dt, device=x.device)
        return x

    def _unembed(self, x):
        x = L.rmsnorm(x, self.final_norm, self.cfg.norm_eps)
        head = self.embed.T if self.lm_head is None else self.lm_head
        return x @ head.to(x.dtype)

    @torch.no_grad()
    def forward(self, tokens):
        """Full-sequence logits.  tokens (B, S) int."""
        B, S = tokens.shape
        x = self._embed(tokens)
        positions = build_positions(B, S, device=x.device)
        for blk in self.layers:
            x, _k, _v = blk.full(x, positions)
        loads = torch.zeros((self.cfg.n_layers, 1), dtype=torch.float32, device=x.device)
        return self._unembed(x), {"moe_load": loads}

    def init_cache(self, B: int, T: int) -> Dict[str, torch.Tensor]:
        return init_cache(self.cfg, B, T, self.embed.device)

    @torch.no_grad()
    def prefill(self, tokens, cache_len: Optional[int] = None):
        """Process the prompt; returns (logits, cache filled up to S, zeros
        beyond)."""
        B, S = tokens.shape
        cache = self.init_cache(B, cache_len or S)
        x = self._embed(tokens)
        positions = build_positions(B, S, device=x.device)
        for i, blk in enumerate(self.layers):
            x, k, v = blk.full(x, positions)
            cache["k"][i, :, :S] = k
            cache["v"][i, :, :S] = v
        return self._unembed(x), cache

    @torch.no_grad()
    def decode_step(self, cache, tokens, pos: int, rows: Optional[Sequence[int]] = None):
        """One new token per sequence against the cache.  tokens (B, 1).

        The cache is updated in place (and returned): every batch row at
        ``pos``, or only ``rows``.  Logits cover every row; a row outside
        ``rows`` read its own cache without this token's K/V.
        """
        B, S = tokens.shape
        x = self._embed(tokens)
        positions = build_positions(B, S, offset=int(pos), device=x.device)
        if rows is not None:
            rows = torch.as_tensor(rows, dtype=torch.long, device=x.device)
        for i, blk in enumerate(self.layers):
            x = blk.decode(x, cache["k"][i], cache["v"][i], int(pos), positions, rows)
        return self._unembed(x), cache
