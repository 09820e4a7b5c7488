"""Plain PyTorch version of the AdamW update: the port of
``repro.training.optim``'s schedule, norm and update, in two halves that
match the kernel's two entries.

``adamw_norm_ref`` takes the step's scalars (the step counter + 1, the
cosine schedule's lr, the global norm, the clip scale and the bias
corrections), ``adamw_update_ref`` updates every leaf in place, one leaf at
a time so that no temporary outgrows a leaf.  The norm is a norm of the
per-leaf norms (JAX's sums the squares: the same sum in another order).
``cfg`` is any object with ``AdamWConfig``'s fields.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Sequence

import torch


class Scalars(NamedTuple):
    """A step's scalars, each a 0-d tensor on the leaves' device."""

    step: torch.Tensor        # int32: the step this update makes (the counter + 1)
    lr: torch.Tensor          # float32, the cosine schedule at ``step``
    grad_norm: torch.Tensor   # float32, sqrt(Σ over leaves of Σ g²)
    clip_scale: torch.Tensor  # float32, min(1, clip_norm / max(grad_norm, 1e-9))
    bc1: torch.Tensor         # float32, 1 − b1^step
    bc2: torch.Tensor         # float32, 1 − b2^step


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 0-d tensor filled on ``like``'s device (no host copy)."""
    return torch.full((), x, dtype=torch.float32, device=like.device)


def cosine_schedule(cfg, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (an integer tensor), float32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tensors) -> torch.Tensor:
    """sqrt(Σ over leaves of Σ x²), float32."""
    norms = torch._foreach_norm([t.float() if t.dtype != torch.float32 else t for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


@torch.no_grad()
def adamw_norm_ref(cfg, grads: Sequence[torch.Tensor], step: torch.Tensor) -> Scalars:
    """The step's scalars from the gradients and the int32 step counter."""
    step = step + 1
    lr = cosine_schedule(cfg, step)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    b1, b2 = _f32(cfg.b1, step), _f32(cfg.b2, step)
    bc1 = 1 - b1 ** step.to(torch.float32)
    bc2 = 1 - b2 ** step.to(torch.float32)
    return Scalars(step, lr, gnorm, scale, bc1, bc2)


@torch.no_grad()
def adamw_update_ref(cfg, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                     ms: Sequence[torch.Tensor], vs: Sequence[torch.Tensor],
                     decay: Sequence[bool], sc: Scalars) -> List[torch.Tensor]:
    """Every leaf's p, m and v in place (decoupled decay where ``decay``);
    returns ``params``."""
    lr, scale, bc1, bc2 = sc.lr, sc.clip_scale, sc.bc1, sc.bc2
    for p, g, m, v, d in zip(params, grads, ms, vs, decay, strict=True):
        g = g.to(torch.float32) * scale
        m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
        v.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
        del g
        delta = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
        if d:  # decoupled decay, matrices only
            delta.add_(p, alpha=cfg.weight_decay)
        p.sub_(delta.mul_(lr))
    return list(params)
