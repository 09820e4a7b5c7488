"""Carry the JAX package's parameters into the port's modules.

``from_jax_params`` takes the pytree of ``repro.models.transformer.
init_params`` or ``repro.models.encdec.init_params`` as numpy arrays and
returns a module that computes what the JAX model computes:
  * dense, moe, vlm: ``embed``, ``final_norm``, ``lm_head`` when untied,
    ``vision_proj`` for vlm, and the stacked ``(L, …)`` ``layers`` leaves
    ``ln1, ln2, wq, wk, wv, wo, w_gate, w_up, w_down`` (plus ``router`` and
    the (L, E, …) expert stacks for moe) → ``Transformer``;
  * encdec: ``embed``, ``final_norm``, ``enc_final_norm`` and the stacked
    ``enc``/``dec`` leaves (``dec`` adds the cross-attention ``ln_x, xq,
    xk, xv, xo``) → ``EncDec``;
  * hybrid: ``embed``, ``final_norm`` and the ``rec1``, ``rec2``, ``attn``
    leaves stacked over super-blocks (sb, …), plus ``rec_tail`` (trailing,
    …) when n_layers % 3 → ``rglru.RecurrentGemma``;
  * ssm: ``embed``, ``final_norm``, ``mlstm`` stacked (sb, m_per, …) and
    ``slstm`` stacked (sb, …) → ``xlstm.XLSTM``.
JAX's ``(in, out)`` orientation is kept; each leaf is cast to its
parameter's dtype (``compute_dtype`` for matrices, what JAX casts to at
use; f32 for norms, the MoE router, rglru's ``lam``, ``b_a``, ``b_i`` and
``conv_w``, and xlstm's ``b_f``, ``b`` and ``R``).
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import rglru, xlstm
from repro_torch.models.encdec import CROSS_LEAVES, SELF_LEAVES, EncDec
from repro_torch.models.transformer import Transformer, check_family

LAYER_LEAVES = ("ln1", "ln2", "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def _copy(dst: torch.nn.Parameter, src, what: str) -> None:
    arr = np.array(src, dtype=np.float32)  # a writable copy for torch.from_numpy
    if tuple(arr.shape) != tuple(dst.shape):
        raise ValueError(f"{what}: shape {tuple(arr.shape)}, expected {tuple(dst.shape)}")
    dst.copy_(torch.from_numpy(arr).to(device=dst.device, dtype=dst.dtype))


def _keys(tree: Mapping, expected, what: str) -> None:
    if set(tree) != set(expected):
        raise ValueError(f"{what}: keys {sorted(tree)}, expected {sorted(expected)}")


def _stacked(tree: Mapping, leaves: Sequence[str], blocks, what: str) -> None:
    """Split each stacked (L, …) leaf of ``tree`` over ``blocks``."""
    _keys(tree, leaves, what)
    for name in leaves:
        stacked = np.asarray(tree[name])
        if stacked.shape[0] != len(blocks):
            raise ValueError(f"{what}.{name}: {stacked.shape[0]} layers, expected {len(blocks)}")
        for i, blk in enumerate(blocks):
            _copy(getattr(blk, name), stacked[i], f"{what}.{name}[{i}]")


@torch.no_grad()
def from_jax_params(params: Mapping, cfg: ArchConfig, device="cuda"):
    check_family(cfg)
    if cfg.family == "encdec":
        model = EncDec(cfg, device)
        _keys(params, {"embed", "final_norm", "enc_final_norm", "enc", "dec"}, "params")
        for name in ("embed", "final_norm", "enc_final_norm"):
            _copy(getattr(model, name), params[name], name)
        _stacked(params["enc"], SELF_LEAVES, model.enc, "enc")
        _stacked(params["dec"], SELF_LEAVES + CROSS_LEAVES, model.dec, "dec")
        return model
    if cfg.family == "hybrid":
        model = rglru.RecurrentGemma(cfg, device)
        stacks = {"rec1": rglru.REC_LEAVES, "rec2": rglru.REC_LEAVES, "attn": rglru.ATTN_LEAVES}
        if len(model.rec_tail):
            stacks["rec_tail"] = rglru.REC_LEAVES
        _keys(params, {"embed", "final_norm"} | set(stacks), "params")
        for name in ("embed", "final_norm"):
            _copy(getattr(model, name), params[name], name)
        for name, leaves in stacks.items():
            _stacked(params[name], leaves, getattr(model, name), name)
        return model
    if cfg.family == "ssm":
        model = xlstm.XLSTM(cfg, device)
        _keys(params, {"embed", "final_norm", "mlstm", "slstm"}, "params")
        for name in ("embed", "final_norm"):
            _copy(getattr(model, name), params[name], name)
        # (sb, m_per, …) → (sb·m_per, …), super-block major as ``model.mlstm``
        mlstm = {name: np.asarray(a).reshape((-1,) + np.shape(a)[2:])
                 for name, a in params["mlstm"].items()}
        _stacked(mlstm, xlstm.MLSTM_LEAVES, model.mlstm, "mlstm")
        _stacked(params["slstm"], xlstm.SLSTM_LEAVES, model.slstm, "slstm")
        return model
    model = Transformer(cfg, device)
    expected = ({"embed", "final_norm", "layers"} | ({"lm_head"} if not cfg.tie_embeddings else set())
                | ({"vision_proj"} if cfg.n_vision_tokens else set()))
    _keys(params, expected, "params")
    for name in expected - {"layers"}:
        _copy(getattr(model, name), params[name], name)
    leaves = LAYER_LEAVES + (("router",) if cfg.moe_experts else ())
    _stacked(params["layers"], leaves, model.layers, "layers")
    return model
