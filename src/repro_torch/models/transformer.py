"""Decoder-only transformer LM: the dense, moe and vlm families.

Covers phi3-mini, gemma-2b/7b, granite-3-2b (dense GQA/MQA), grok-1-314b
and granite-moe-3b-a800m (MoE blocks, ``models.moe``) and qwen2-vl-72b
(M-RoPE positions and the patch-embedding stub).  The port of
``repro.models.transformer`` as an ``nn.Module`` in two forms: served
(matrices in ``compute_dtype``, nothing trainable) and float32 masters
(``masters=True``: every leaf float32 and trainable, as JAX trains).
Every matrix is cast to the activations' dtype at its use, as JAX casts
its masters; for a served leaf, already in that dtype, the cast returns
the leaf itself (no copy, no launch).  ``forward`` runs under the
caller's grad mode, each layer under ``layers.remat`` when grad is on
(JAX's ``_remat``: ``"full"`` recomputes the layer in the backward,
``"dots"`` keeps its ``aten.mm`` outputs); ``prefill`` and
``decode_step`` build no graph.  Every attention goes
through ``kernels.flash_attention`` (its gradient: the plain version's,
``kernels/flash_attention/autograd.py``): causal over the prompt in
``forward``/``prefill``, non-causal against the cache slice
``[:, :pos+1]`` in ``decode_step`` (the slice is a view; keys past
``pos`` are exactly the ones ``decode_mask(T, pos)`` masks).

Differences from the JAX module, all deliberate:
  * served matrices are held in ``compute_dtype`` (the bf16 cast of an f32
    master gives the same values JAX casts to at use); norm weights and
    the MoE router (which JAX never casts) stay f32;
  * per-layer leaves (``layers[i].wq``) where JAX stacks them over layers
    (``layers/wq`` (L, …)); ``models.convert`` maps the two;
  * under a ``ParallelCtx`` (the dry run's, ``launch.specs.make_ctx``)
    the pins (``_pin``, ``_pin_kv``) go through ``parallel.constrain``,
    which checks their rank and returns the tensor (one process has no
    partitioner); what the ctx changes in what is computed is the MoE's
    per-shard routing (``moe.moe_ffn_sharded``) and ``maybe_repeat_kv``.
    With ``ctx=None`` nothing changes;
  * ``decode_step`` writes the new K/V into the cache in place, and only
    at the batch rows it is given (``rows``): the same cache JAX's
    functional update followed by the serving engine's masked merge gives.
    A MoE block routes every row, as JAX does, since expert capacity
    couples the rows: each row then attends its own new K/V as in JAX,
    and the other rows' cache entries at ``pos`` are put back after.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import layers as L
from repro_torch.models.moe import moe_capacity, moe_ffn_local, moe_ffn_sharded
from repro_torch.models.parallel import P, ParallelCtx, constrain

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
VISION_STUB_DIM = 1024  # patch-embedding stub width (the frontend is external)
TRANSFORMER_FAMILIES = ("dense", "moe", "vlm")  # the families ``Transformer`` serves
LM_FAMILIES = TRANSFORMER_FAMILIES + ("hybrid", "ssm")  # the decoder-only LMs
FAMILIES = LM_FAMILIES + ("encdec",)  # the families the port serves and trains


def check_family(cfg: ArchConfig) -> None:
    """Raise unless the port serves and trains ``cfg``'s family: dense, moe
    and vlm (``Transformer``), hybrid (``models.rglru``), ssm
    (``models.xlstm``) and encdec (``models.encdec``)."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")


def compute_dtype(cfg: ArchConfig) -> torch.dtype:
    return _DTYPES[cfg.compute_dtype]


def _param(shape, dtype, device, masters: bool = False) -> nn.Parameter:
    """A served leaf in ``dtype``, or a trainable float32 master."""
    dtype = torch.float32 if masters else dtype
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=masters)


def _add_params(module: nn.Module, names, shapes, f32_names, device, masters: bool) -> None:
    """``module.<name>`` = ``_param`` of ``shapes[name]`` for each of
    ``names``, in order: served in float32 for ``f32_names`` and in
    ``compute_dtype`` for the rest, or float32 masters."""
    dt = compute_dtype(module.cfg)
    for name in names:
        setattr(module, name, _param(shapes[name], torch.float32 if name in f32_names else dt,
                                     device, masters))


def build_positions(cfg: ArchConfig, B: int, S: int, offset: int = 0, device=None) -> torch.Tensor:
    """Rope positions: (B, S) int32, or (3, B, S) for M-RoPE.

    ``offset`` is the absolute position of the first token (decode passes
    the cache position).  M-RoPE classifies by absolute index: below
    ``n_vision_tokens`` a token sits in the vision grid (t 0, h = i //
    side, w = i % side), later ones at i − nv + 1 on all three axes."""
    ai = torch.arange(S, dtype=torch.int32, device=device) + offset
    if not cfg.m_rope:
        return ai[None, :].expand(B, S)
    nv = cfg.n_vision_tokens
    side = max(1, int(np.sqrt(max(nv, 1))))
    is_vis = ai < nv
    text = ai - nv + 1
    grid = torch.stack([torch.where(is_vis, torch.zeros_like(ai), text),
                        torch.where(is_vis, ai // side, text),
                        torch.where(is_vis, ai % side, text)])[:, None, :]
    return grid.expand(3, B, S)


def _rope(cfg: ArchConfig, x, positions):
    if cfg.m_rope:
        return L.apply_mrope(x, positions, cfg.mrope_sections, cfg.rope_theta)
    return L.apply_rope(x, positions, cfg.rope_theta)


def _act_spec(ctx: ParallelCtx, ndim: int, head_axis: int = -1, n_heads: int = 0) -> P:
    """Batch over dp; heads over model when they divide it (Megatron TP)."""
    parts = [ctx.dp_axes] + [None] * (ndim - 1)
    if head_axis >= 0 and n_heads and n_heads % ctx.tp_size == 0:
        parts[head_axis] = ctx.tp_axis
    return P(*parts)


def _pin(x, ctx: Optional[ParallelCtx], head_axis: int = -1, n_heads: int = 0):
    if ctx is None:
        return x
    return constrain(x, ctx, _act_spec(ctx, x.ndim, head_axis, n_heads))


def _pin_kv(x, ctx: Optional[ParallelCtx], n_kv: int):
    """K/V (B, T, K, hd): heads over model when they divide it, else time."""
    if ctx is None:
        return x
    if n_kv % ctx.tp_size == 0:
        return constrain(x, ctx, P(ctx.dp_axes, None, ctx.tp_axis, None))
    return constrain(x, ctx, P(ctx.dp_axes, ctx.tp_axis, None, None))


def maybe_repeat_kv(k, v, cfg: ArchConfig, ctx: Optional[ParallelCtx]):
    """JAX's ``_maybe_repeat_kv``: (k, v, repeated).  Under a ctx whose
    model axis the KV heads do not divide but the query heads do, K/V are
    repeated to all heads (query head h keeps KV head h // G), so each
    head's scores stay on its shard."""
    if ctx is None:
        return k, v, False
    tp = ctx.tp_size
    if cfg.n_kv_heads % tp == 0 or cfg.n_heads % tp != 0:
        return k, v, False
    G = cfg.n_heads // cfg.n_kv_heads
    k, v = k.repeat_interleave(G, dim=2), v.repeat_interleave(G, dim=2)
    spec = P(ctx.dp_axes, None, ctx.tp_axis, None)
    return constrain(k, ctx, spec), constrain(v, ctx, spec), True


def init_cache(cfg: ArchConfig, B: int, T: int, device=None) -> Dict[str, torch.Tensor]:
    """Zero K/V caches, (L, B, T, K, hd) each in ``compute_dtype``."""
    shape = (cfg.n_layers, B, T, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=compute_dtype(cfg), device=device),
            "v": torch.zeros(shape, dtype=compute_dtype(cfg), device=device)}


class Block(nn.Module):
    """One transformer block: ``full`` over a sequence (JAX ``_layer_full``),
    ``decode`` for one token against the cache (``_layer_decode``)."""

    def __init__(self, cfg: ArchConfig, device="cuda", masters: bool = False):
        super().__init__()
        self.cfg = cfg
        d, F, dt = cfg.d_model, cfg.d_ff, compute_dtype(cfg)
        self.ln1 = _param((d,), torch.float32, device, masters)
        self.ln2 = _param((d,), torch.float32, device, masters)
        self.wq = _param((d, cfg.q_dim), dt, device, masters)
        self.wk = _param((d, cfg.kv_dim), dt, device, masters)
        self.wv = _param((d, cfg.kv_dim), dt, device, masters)
        self.wo = _param((cfg.q_dim, d), dt, device, masters)
        E = cfg.moe_experts
        if E:
            self.router = _param((d, E), torch.float32, device, masters)
        self.w_gate = _param((E, d, F) if E else (d, F), dt, device, masters)
        self.w_up = _param((E, d, F) if E else (d, F), dt, device, masters)
        self.w_down = _param((E, F, d) if E else (F, d), dt, device, masters)

    def _qkv(self, x, positions, ctx=None):
        c = self.cfg
        h = L.rmsnorm(x, self.ln1, c.norm_eps)
        q, k, v = L.qkv_project(h, self.wq.to(h.dtype), self.wk.to(h.dtype), self.wv.to(h.dtype),
                                c.n_heads, c.n_kv_heads, c.head_dim)
        q = _pin(q, ctx, head_axis=2, n_heads=c.n_heads)
        return _rope(c, q, positions), _rope(c, k, positions), v

    def ffn(self, h, ctx=None):
        """The dense GLU or the MoE FFN on (B, S, d); returns (y, load or None).
        The MoE capacity comes from all B·S tokens of the call, or under a
        ctx from each data shard's own (``moe_ffn_sharded``)."""
        c = self.cfg
        if not c.moe_experts:
            return L.glu_mlp(h, self.w_gate.to(h.dtype), self.w_up.to(h.dtype),
                             self.w_down.to(h.dtype), c.act), None
        if ctx is not None:
            return moe_ffn_sharded(h, self.router, self.w_gate, self.w_up, self.w_down, c,
                                   ctx.dp_size)
        B, S, d = h.shape
        y, load = moe_ffn_local(h.reshape(B * S, d), self.router, self.w_gate, self.w_up,
                                self.w_down, c, moe_capacity(c, B * S))
        return y.view(B, S, d), load

    def _out(self, x, attn, ctx=None):
        c = self.cfg
        B, S = x.shape[:2]
        attn = _pin(attn, ctx, head_axis=2, n_heads=c.n_heads)
        x = _pin(x + attn.reshape(B, S, c.q_dim) @ self.wo.to(x.dtype), ctx)
        f, load = self.ffn(L.rmsnorm(x, self.ln2, c.norm_eps), ctx)
        return _pin(x + f, ctx), load

    def full(self, x, positions, ctx=None):
        """(x', k, v, load) over a whole sequence, causal; ``load`` is the
        MoE per-expert count (None for a dense block).  K/V come back as
        projected (``maybe_repeat_kv`` repeats them for the attention only)."""
        x = _pin(x, ctx)
        q, k, v = self._qkv(x, positions, ctx)
        ka, va, repeated = maybe_repeat_kv(k, v, self.cfg, ctx)
        if not repeated:
            ka, va = _pin_kv(k, ctx, self.cfg.n_kv_heads), _pin_kv(v, ctx, self.cfg.n_kv_heads)
        x, load = self._out(x, flash_attention(q, ka, va, causal=True), ctx)
        return x, k, v, load

    def train_full(self, x, positions, ctx=None):
        """``full`` without its K/V: (x', load), what a remat layer keeps."""
        x, _k, _v, load = self.full(x, positions, ctx)
        return x, load

    def decode(self, x, k_cache, v_cache, pos: int, positions, rows=None, ctx=None):
        """One token per sequence at cache position ``pos``; writes its K/V
        into ``k_cache``/``v_cache`` (B, T, K, hd) in place, at ``rows`` only
        when given (a (B,) bool mask or row indices)."""
        q, k, v = self._qkv(x, positions, ctx)
        if rows is None:
            k_cache[:, pos] = k[:, 0].to(k_cache.dtype)
            v_cache[:, pos] = v[:, 0].to(v_cache.dtype)
        elif self.cfg.moe_experts:
            # every row attends its own new K/V, as in JAX's full-batch
            # update; the rows outside ``rows`` get their entries back after
            old_k, old_v = k_cache[:, pos].clone(), v_cache[:, pos].clone()
            k_cache[:, pos] = k[:, 0].to(k_cache.dtype)
            v_cache[:, pos] = v[:, 0].to(v_cache.dtype)
        else:
            k_cache[rows, pos] = k[rows, 0].to(k_cache.dtype)
            v_cache[rows, pos] = v[rows, 0].to(v_cache.dtype)
        attn = flash_attention(q, k_cache[:, :pos + 1], v_cache[:, :pos + 1], causal=False)
        if rows is not None and self.cfg.moe_experts:
            keep = rows[:, None, None]
            k_cache[:, pos] = torch.where(keep, k_cache[:, pos], old_k)
            v_cache[:, pos] = torch.where(keep, v_cache[:, pos], old_v)
        return self._out(x, attn, ctx)[0]


class Transformer(nn.Module):
    """Parameters as in ``init_params`` (names and (in, out) orientation),
    the stacked ``layers`` leaves split into one ``Block`` per layer;
    served (``compute_dtype`` matrices, frozen) or, with ``masters``,
    float32 and trainable."""

    def __init__(self, cfg: ArchConfig, device="cuda", masters: bool = False):
        super().__init__()
        check_family(cfg)
        if cfg.family not in TRANSFORMER_FAMILIES:
            raise ValueError(f"{cfg.name}: Transformer serves {TRANSFORMER_FAMILIES}, "
                             f"not {cfg.family}")
        self.cfg = cfg
        d, V, dt = cfg.d_model, cfg.vocab, compute_dtype(cfg)
        self.embed = _param((V, d), dt, device, masters)
        self.final_norm = _param((d,), torch.float32, device, masters)
        self.lm_head = None if cfg.tie_embeddings else _param((d, V), dt, device, masters)
        self.vision_proj = (_param((VISION_STUB_DIM, d), dt, device, masters)
                            if cfg.n_vision_tokens else None)
        self.layers = nn.ModuleList(Block(cfg, device, masters) for _ in range(cfg.n_layers))

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> "Transformer":
        """Draw every weight from ``gen`` (on the parameters' device) as
        ``init_params`` does: f32 normals, matrices scaled by 1/sqrt(fan_in)
        (the MoE ``w_down`` by 1/sqrt(d_ff)), the embedding by 0.02, norms at
        1; served matrices then cast to ``compute_dtype`` (masters keep the
        f32 draws, so a served model's weights are its masters rounded)."""
        dev = self.embed.device
        self.embed.copy_(L.embed_init(gen, *self.embed.shape, device=dev))
        self.final_norm.fill_(1.0)
        E = self.cfg.moe_experts
        for blk in self.layers:
            blk.ln1.fill_(1.0)
            blk.ln2.fill_(1.0)
            names = ("wq", "wk", "wv", "wo") + (("router",) if E else ()) + (
                "w_gate", "w_up", "w_down")
            for name in names:
                w = getattr(blk, name)
                scale = 1.0 / np.sqrt(self.cfg.d_ff) if E and name == "w_down" else None
                w.copy_(L.dense_init(gen, tuple(w.shape), scale, device=dev))
        if self.lm_head is not None:
            self.lm_head.copy_(L.dense_init(gen, tuple(self.lm_head.shape), device=dev))
        if self.vision_proj is not None:
            self.vision_proj.copy_(L.dense_init(gen, tuple(self.vision_proj.shape), device=dev))
        return self

    # -- public API (the JAX module's functions) -------------------------------
    def _embed(self, tokens, vision_embeds=None):
        dt = compute_dtype(self.cfg)
        x = self.embed[tokens.long()].to(dt)
        if self.cfg.name.startswith("gemma"):
            x = x * torch.full((), math.sqrt(self.cfg.d_model), dtype=dt, device=x.device)
        if self.vision_proj is not None and vision_embeds is not None:
            n_vis = vision_embeds.shape[1]
            if n_vis > x.shape[1]:
                raise ValueError(f"vision_embeds: {n_vis} positions, the sequence has "
                                 f"{x.shape[1]}")
            x[:, :n_vis] = vision_embeds.to(dt) @ self.vision_proj.to(dt)
        return x

    def _unembed(self, x):
        x = L.rmsnorm(x, self.final_norm, self.cfg.norm_eps)
        head = self.embed.T if self.lm_head is None else self.lm_head
        return x @ head.to(x.dtype)

    def forward(self, tokens, vision_embeds=None, ctx=None):
        """Full-sequence logits and ``{"moe_load": (L, E)}`` ((L, 1) zeros
        for a dense model).  tokens (B, S) int; ``vision_embeds`` (B, n_vis,
        1024) overwrite the first n_vis positions (vlm).  Runs under the
        caller's grad mode; with grad on, each layer under ``layers.remat``
        (``cfg.remat``)."""
        B, S = tokens.shape
        x = _pin(self._embed(tokens, vision_embeds), ctx)
        positions = build_positions(self.cfg, B, S, device=x.device)
        loads = []
        for blk in self.layers:
            x, load = L.remat(blk.train_full, self.cfg)(x, positions, ctx)
            loads.append(load if load is not None
                         else torch.zeros((1,), dtype=torch.float32, device=x.device))
        return self._unembed(x), {"moe_load": torch.stack(loads)}

    def init_cache(self, B: int, T: int) -> Dict[str, torch.Tensor]:
        return init_cache(self.cfg, B, T, self.embed.device)

    @torch.no_grad()
    def prefill(self, tokens, cache_len: Optional[int] = None, vision_embeds=None, ctx=None):
        """Process the prompt; returns (logits, cache filled up to S, zeros
        beyond)."""
        B, S = tokens.shape
        cache = self.init_cache(B, cache_len or S)
        x = _pin(self._embed(tokens, vision_embeds), ctx)
        positions = build_positions(self.cfg, B, S, device=x.device)
        for i, blk in enumerate(self.layers):
            x, k, v, _load = blk.full(x, positions, ctx)
            cache["k"][i, :, :S] = k
            cache["v"][i, :, :S] = v
        return self._unembed(x), cache

    @torch.no_grad()
    def decode_step(self, cache, tokens, pos: int, rows: Optional[Sequence[int]] = None,
                    ctx=None):
        """One new token per sequence against the cache.  tokens (B, 1).

        The cache is updated in place (and returned): every batch row at
        ``pos``, or only ``rows``.  Logits cover every row; outside
        ``rows`` a dense row read its own cache without this token's K/V,
        a MoE row with it (as JAX's, before the engine's merge).
        """
        B, S = tokens.shape
        x = _pin(self._embed(tokens), ctx)
        positions = build_positions(self.cfg, B, S, offset=int(pos), device=x.device)
        if rows is not None:
            rows = torch.as_tensor(rows, dtype=torch.long, device=x.device)
            if self.cfg.moe_experts:
                rows = torch.zeros(B, dtype=torch.bool, device=x.device).index_fill_(0, rows, True)
        for i, blk in enumerate(self.layers):
            x = blk.decode(x, cache["k"][i], cache["v"][i], int(pos), positions, rows, ctx)
        return self._unembed(x), cache
