"""Uniform model interface: the port of ``repro.models.api`` for the dense family.

``get_model(cfg, device=...)`` returns a ``Model`` with the JAX package's
five entry names.  ``params`` is the ``Transformer`` module that ``init``
builds (or ``models.convert`` carries over from JAX):

  init(seed or torch.Generator)                 -> params
  forward(params, batch)                        -> (logits, aux)
  init_cache(B, T)                              -> cache
  prefill(params, batch, cache_len=None)        -> (logits, cache)
  decode_step(params, cache, tokens, pos, rows=None) -> (logits, cache)

The moe, vlm, hybrid, ssm and encdec families raise ``NotImplementedError``
naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch

from repro_torch.configs.base import ArchConfig
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


def get_model(cfg: ArchConfig, device="cuda") -> Model:
    """The dense transformer's entry points on ``device`` (the card unless
    the caller asks for the CPU)."""
    check_family(cfg)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"get_model(device={str(device)!r}): no CUDA device is available; "
                           "pass device='cpu' to run on the CPU")

    def init(seed=0) -> Transformer:
        gen = seed
        if not isinstance(seed, torch.Generator):
            gen = torch.Generator(device=device).manual_seed(int(seed))
        return Transformer(cfg, device).init_weights(gen)

    return Model(
        cfg=cfg,
        device=device,
        init=init,
        forward=lambda params, batch: params(batch["tokens"]),
        init_cache=lambda B, T: init_cache(cfg, B, T, device),
        prefill=lambda params, batch, cache_len=None: params.prefill(batch["tokens"], cache_len),
        decode_step=lambda params, cache, tokens, pos, rows=None: params.decode_step(
            cache, tokens, pos, rows),
    )


# ---------------------------------------------------------------------------
# parameter counts from shapes (exact; no allocation)
# ---------------------------------------------------------------------------

def param_counts(cfg: ArchConfig) -> Dict[str, int]:
    """(total, embed, non_embed, active, active_non_embed) parameter counts
    of the module built on the meta device."""
    check_family(cfg)
    total = embed = 0
    for name, p in Transformer(cfg, "meta").named_parameters():
        total += p.numel()
        if name in ("embed", "lm_head"):
            embed += p.numel()
    return {"total": total, "embed": embed, "non_embed": total - embed,
            "active": total, "active_non_embed": total - embed}
