"""Uniform model interface: the port of ``repro.models.api``.

``get_model(cfg, device=...)`` returns a ``Model`` with the JAX package's
five entry names for the dense, moe and vlm families (``Transformer``) and
the encdec family (``EncDec``).  ``params`` is the module that ``init``
builds (or ``models.convert`` carries over from JAX):

  init(seed or torch.Generator)                 -> params
  forward(params, batch)                        -> (logits, aux)
  init_cache(B, T)                              -> cache
  prefill(params, batch, cache_len=None)        -> (logits, cache)
  decode_step(params, cache, tokens, pos, rows=None) -> (logits, cache)

  batch (LM):     {"tokens": (B, S) int}
  batch (vlm):    + {"vision_embeds": (B, n_vis, 1024) f32 stub}
  batch (encdec): {"frames": (B, S_src, d) f32 stub, "tokens": (B, S_tgt)}

The hybrid and ssm families raise ``NotImplementedError`` naming the
ROADMAP item that ports them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import encdec
from repro_torch.models.transformer import Transformer, check_family, init_cache


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    device: torch.device
    init: Callable[..., Any]
    forward: Callable[..., Any]
    init_cache: Callable[..., Any]
    prefill: Callable[..., Any]
    decode_step: Callable[..., Any]


def _module(cfg: ArchConfig):
    return encdec.EncDec if cfg.family == "encdec" else Transformer


def get_model(cfg: ArchConfig, device="cuda") -> Model:
    """``cfg``'s entry points on ``device`` (the card unless the caller asks
    for the CPU)."""
    check_family(cfg)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"get_model(device={str(device)!r}): no CUDA device is available; "
                           "pass device='cpu' to run on the CPU")
    module = _module(cfg)

    def init(seed=0):
        gen = seed
        if not isinstance(seed, torch.Generator):
            gen = torch.Generator(device=device).manual_seed(int(seed))
        return module(cfg, device).init_weights(gen)

    def decode_step(params, cache, tokens, pos, rows=None):
        return params.decode_step(cache, tokens, pos, rows)

    if cfg.family == "encdec":
        return Model(
            cfg=cfg, device=device, init=init,
            forward=lambda params, batch: params(batch["frames"], batch["tokens"]),
            init_cache=lambda B, T: encdec.init_cache(cfg, B, T, device=device),
            prefill=lambda params, batch, cache_len=None: params.prefill(
                batch["frames"], batch["tokens"], cache_len),
            decode_step=decode_step,
        )
    return Model(
        cfg=cfg, device=device, init=init,
        forward=lambda params, batch: params(batch["tokens"], batch.get("vision_embeds")),
        init_cache=lambda B, T: init_cache(cfg, B, T, device),
        prefill=lambda params, batch, cache_len=None: params.prefill(
            batch["tokens"], cache_len, batch.get("vision_embeds")),
        decode_step=decode_step,
    )


# ---------------------------------------------------------------------------
# parameter counts from shapes (exact; no allocation)
# ---------------------------------------------------------------------------

def param_counts(cfg: ArchConfig) -> Dict[str, int]:
    """(total, embed, non_embed, active, active_non_embed) parameter counts
    of the module built on the meta device; ``active`` counts top_k of the
    E experts' matrices for a MoE model, as JAX's does."""
    check_family(cfg)
    total = embed = expert = 0
    for name, p in _module(cfg)(cfg, "meta").named_parameters():
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
