"""Hand-rolled AdamW with a cosine schedule and global-norm clipping: the
port of ``repro.training.optim``.

The optimizer is a pair of plain functions over named trainable leaves
(``{name: tensor}``), as JAX's is over a parameter pytree; not
``torch.optim.AdamW``.  States ``m`` and ``v`` are float32.  The schedule
and the bias corrections are float32 functions of the step, computed on
the step's device as JAX computes them (no host read).  Differences from
JAX, deliberate: parameters, ``m`` and ``v`` are updated in place (JAX
returns new trees), one leaf at a time so that no temporary outgrows a
leaf; the gradients are left as they came (JAX's are local values), and
the norm is a norm of the per-leaf norms (the same sum in another order).

Weight decay follows JAX's rule, "matrices only" by rank, ``p.ndim >=
2`` of *JAX's* leaf, so ``adamw_update`` takes each leaf's JAX rank
(``ranks``): the transformer's per-layer ``ln1``/``ln2`` are (d,) where
JAX stacks them to (L, d), so JAX decays them
(``models.convert.jax_leaves`` gives each port leaf its JAX rank).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 0-d tensor filled on ``like``'s device (no host copy)."""
    return torch.full((), x, dtype=torch.float32, device=like.device)


def cosine_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (an integer tensor), float32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def adamw_init(params: Mapping[str, torch.Tensor]) -> Dict:
    """``{"m": {name: zeros}, "v": {name: zeros}, "step": int32 0}``, float32
    states on each leaf's device."""
    device = next(iter(params.values())).device
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {"m": {n: zeros(p) for n, p in params.items()},
            "v": {n: zeros(p) for n, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tensors) -> torch.Tensor:
    """sqrt(Σ over leaves of Σ x²), float32."""
    norms = torch._foreach_norm([t.float() if t.dtype != torch.float32 else t for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: Mapping[str, torch.Tensor],
                 grads: Mapping[str, torch.Tensor], opt_state: Dict,
                 ranks: Mapping[str, int]) -> Tuple[Mapping, Dict, Dict]:
    """One AdamW step over ``params`` in place; returns (params, opt_state,
    {"lr", "grad_norm", "clip_scale"}), the metrics float32 0-d tensors.
    ``ranks``: each leaf's JAX rank, which the decay rule reads."""
    step = opt_state["step"] + 1
    lr = cosine_schedule(cfg, step)
    names = list(params)
    gnorm = global_norm([grads[n] for n in names])
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    b1, b2 = _f32(cfg.b1, step), _f32(cfg.b2, step)
    bc1 = 1 - b1 ** step.to(torch.float32)
    bc2 = 1 - b2 ** step.to(torch.float32)
    for name in names:
        p, m, v = params[name], opt_state["m"][name], opt_state["v"][name]
        g = grads[name].to(torch.float32) * scale
        m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
        v.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
        del g
        delta = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
        if ranks[name] >= 2:  # decoupled decay, matrices only
            delta.add_(p, alpha=cfg.weight_decay)
        p.sub_(delta.mul_(lr))
    opt_state["step"] = step
    return params, opt_state, {"lr": lr, "grad_norm": gnorm, "clip_scale": scale}
