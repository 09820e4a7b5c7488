"""Hand-rolled AdamW with a cosine schedule and global-norm clipping: the
port of ``repro.training.optim``.

The optimizer is a pair of plain functions over named trainable leaves
(``{name: tensor}``), as JAX's is over a parameter pytree; not
``torch.optim.AdamW``.  States ``m`` and ``v`` are float32.  The schedule
and the bias corrections are float32 functions of the step, computed on
the step's device as JAX computes them (no host read).  ``adamw_update``
runs through the two wrappers of ``kernels.adamw``: on the card one
launch takes the global norm and the step's scalars and one updates every
leaf (``csrc/adamw.cu``), where JAX's XLA fuses the same update into one
pass a leaf; on the CPU and the meta device their plain version
(``kernels/adamw/ref.py``).  Differences from JAX, deliberate: parameters,
``m`` and ``v`` are updated in place (JAX returns new trees); the
gradients are left as they came (JAX's are local values), and the norm
is summed in another order (float64 on the card, a norm of the per-leaf
norms in the plain version).

Weight decay follows JAX's rule, "matrices only" by rank, ``p.ndim >=
2`` of *JAX's* leaf, so ``adamw_update`` takes each leaf's JAX rank
(``ranks``): the transformer's per-layer ``ln1``/``ln2`` are (d,) where
JAX stacks them to (L, d), so JAX decays them
(``models.convert.jax_leaves`` gives each port leaf its JAX rank).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Tuple

import torch

from repro_torch.kernels.adamw import adamw_apply, adamw_norm, cosine_schedule, global_norm

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_schedule", "global_norm"]


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


def adamw_init(params: Mapping[str, torch.Tensor]) -> Dict:
    """``{"m": {name: zeros}, "v": {name: zeros}, "step": int32 0}``, float32
    states on each leaf's device."""
    device = next(iter(params.values())).device
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {"m": {n: zeros(p) for n, p in params.items()},
            "v": {n: zeros(p) for n, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=device)}


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: Mapping[str, torch.Tensor],
                 grads: Mapping[str, torch.Tensor], opt_state: Dict,
                 ranks: Mapping[str, int]) -> Tuple[Mapping, Dict, Dict]:
    """One AdamW step over ``params`` in place; returns (params, opt_state,
    {"lr", "grad_norm", "clip_scale"}), the metrics float32 0-d tensors.
    ``ranks``: each leaf's JAX rank, which the decay rule reads."""
    names = list(params)
    sc = adamw_norm(cfg, [grads[n] for n in names], opt_state["step"])
    adamw_apply(cfg, [params[n] for n in names], [grads[n] for n in names],
                [opt_state["m"][n] for n in names], [opt_state["v"][n] for n in names],
                [ranks[n] >= 2 for n in names], sc)
    opt_state["step"] = sc.step
    return params, opt_state, {"lr": sc.lr, "grad_norm": sc.grad_norm,
                               "clip_scale": sc.clip_scale}
