"""Uniform model interface: the port of ``repro.models.api``.

``get_model(cfg, device=...)`` returns a ``Model`` with the JAX package's
five entry names for the dense, moe and vlm families (``Transformer``),
the hybrid family (``rglru.RecurrentGemma``), the ssm family
(``xlstm.XLSTM``) and the encdec family (``EncDec``).  ``params`` is the module that ``init``
builds (or ``models.convert`` carries over from JAX); with ``train=True`` (every
family) ``init`` builds the float32-master form that ``training``
updates, and ``forward`` runs under the caller's grad mode:

  init(seed or torch.Generator)                 -> params
  forward(params, batch, ctx=None)              -> (logits, aux)
  init_cache(B, T)                              -> cache
  prefill(params, batch, cache_len=None, ctx=None) -> (logits, cache)
  decode_step(params, cache, tokens, pos, rows=None, ctx=None) -> (logits, cache)

``ctx`` is a ``models.parallel.ParallelCtx`` (the dry run's) or None.  On
``device="meta"`` (the dry run's trace) ``init`` builds the module and
draws nothing: a meta tensor holds no values, and a generator cannot live
there.

Every entry point that computes runs under ``layers.f32_accumulation``:
bf16 products accumulate in float32, as JAX's do.

  batch (LM):     {"tokens": (B, S) int}
  batch (vlm):    + {"vision_embeds": (B, n_vis, 1024) f32 stub}
  batch (encdec): {"frames": (B, S_src, d) f32 stub, "tokens": (B, S_tgt)}
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import encdec, rglru, xlstm
from repro_torch.models.layers import f32_accumulation
from repro_torch.models.transformer import Transformer, check_family, init_cache


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    device: torch.device
    train: bool  # whether ``init`` builds float32 masters
    init: Callable[..., Any]
    forward: Callable[..., Any]
    init_cache: Callable[..., Any]
    prefill: Callable[..., Any]
    decode_step: Callable[..., Any]


_MODULES = {"encdec": encdec.EncDec, "hybrid": rglru.RecurrentGemma, "ssm": xlstm.XLSTM}
_CACHES = {"hybrid": rglru.init_cache, "ssm": xlstm.init_cache}


def module_of(cfg: ArchConfig):
    """The ``nn.Module`` class that holds ``cfg``'s parameters."""
    return _MODULES.get(cfg.family, Transformer)


def get_model(cfg: ArchConfig, device="cuda", train: bool = False) -> Model:
    """``cfg``'s entry points on ``device`` (the card unless the caller asks
    for the CPU); ``train``: ``init`` builds float32 masters."""
    check_family(cfg)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"get_model(device={str(device)!r}): no CUDA device is available; "
                           "pass device='cpu' to run on the CPU")
    module = module_of(cfg)

    def init(seed=0):
        if device.type == "meta":
            return module(cfg, device, masters=train)
        gen = seed
        if not isinstance(seed, torch.Generator):
            gen = torch.Generator(device=device).manual_seed(int(seed))
        return module(cfg, device, masters=train).init_weights(gen)

    def decode_step(params, cache, tokens, pos, rows=None, ctx=None):
        with f32_accumulation():
            return params.decode_step(cache, tokens, pos, rows, ctx)

    if cfg.family == "encdec":
        def forward(params, batch, ctx=None):
            with f32_accumulation():
                return params(batch["frames"], batch["tokens"], ctx)

        def prefill(params, batch, cache_len=None, ctx=None):
            with f32_accumulation():
                return params.prefill(batch["frames"], batch["tokens"], cache_len, ctx)

        return Model(cfg=cfg, device=device, train=train, init=init, forward=forward,
                     init_cache=lambda B, T: encdec.init_cache(cfg, B, T, device=device),
                     prefill=prefill, decode_step=decode_step)

    def forward(params, batch, ctx=None):
        with f32_accumulation():
            return params(batch["tokens"], batch.get("vision_embeds"), ctx)

    def prefill(params, batch, cache_len=None, ctx=None):
        with f32_accumulation():
            return params.prefill(batch["tokens"], cache_len, batch.get("vision_embeds"), ctx)

    return Model(cfg=cfg, device=device, train=train, init=init, forward=forward,
                 init_cache=lambda B, T: _CACHES.get(cfg.family, init_cache)(cfg, B, T, device),
                 prefill=prefill, decode_step=decode_step)


# ---------------------------------------------------------------------------
# parameter counts from shapes (exact; no allocation)
# ---------------------------------------------------------------------------

def param_counts(cfg: ArchConfig) -> Dict[str, int]:
    """(total, embed, non_embed, active, active_non_embed) parameter counts
    of the module built on the meta device; ``active`` counts top_k of the
    E experts' matrices for a MoE model, as JAX's does."""
    check_family(cfg)
    total = embed = expert = 0
    for name, p in module_of(cfg)(cfg, "meta").named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        total += p.numel()
        if leaf in ("embed", "lm_head"):
            embed += p.numel()
        if cfg.moe_experts and leaf in ("w_gate", "w_up", "w_down"):
            expert += p.numel()
    active = total
    if cfg.moe_experts:
        active = total - expert + int(expert * cfg.moe_top_k / cfg.moe_experts)
    return {"total": total, "embed": embed, "non_embed": total - embed,
            "active": active, "active_non_embed": active - embed}
