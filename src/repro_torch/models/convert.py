"""Carry the JAX package's parameters into the port's ``Transformer``.

``from_jax_params`` takes the pytree of ``repro.models.transformer.
init_params`` as numpy arrays (``embed``, ``final_norm``, ``lm_head`` when
untied, and the stacked ``(L, …)`` ``layers`` leaves ``ln1, ln2, wq, wk,
wv, wo, w_gate, w_up, w_down``) and returns a module that computes what
the JAX model computes.  JAX's ``(in, out)`` orientation is kept; matrices
are cast to ``compute_dtype`` (what JAX casts to at use), norms stay f32.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import Transformer

LAYER_LEAVES = ("ln1", "ln2", "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def _copy(dst: torch.nn.Parameter, src, what: str) -> None:
    arr = np.array(src, dtype=np.float32)  # a writable copy for torch.from_numpy
    if tuple(arr.shape) != tuple(dst.shape):
        raise ValueError(f"{what}: shape {tuple(arr.shape)}, expected {tuple(dst.shape)}")
    dst.copy_(torch.from_numpy(arr).to(device=dst.device, dtype=dst.dtype))


@torch.no_grad()
def from_jax_params(params: Mapping, cfg: ArchConfig, device="cuda") -> Transformer:
    model = Transformer(cfg, device)
    expected = {"embed", "final_norm", "layers"} | ({"lm_head"} if not cfg.tie_embeddings else set())
    if set(params) != expected:
        raise ValueError(f"params: keys {sorted(params)}, expected {sorted(expected)}")
    if set(params["layers"]) != set(LAYER_LEAVES):
        raise ValueError(f"params['layers']: keys {sorted(params['layers'])}, "
                         f"expected {sorted(LAYER_LEAVES)}")
    _copy(model.embed, params["embed"], "embed")
    _copy(model.final_norm, params["final_norm"], "final_norm")
    if model.lm_head is not None:
        _copy(model.lm_head, params["lm_head"], "lm_head")
    for name in LAYER_LEAVES:
        stacked = np.asarray(params["layers"][name])
        if stacked.shape[0] != cfg.n_layers:
            raise ValueError(f"layers.{name}: {stacked.shape[0]} layers, expected {cfg.n_layers}")
        for i, blk in enumerate(model.layers):
            _copy(getattr(blk, name), stacked[i], f"layers.{name}[{i}]")
    return model
