"""Carry parameters between the JAX package's pytrees and the port's modules.

``from_jax_params`` takes the pytree of ``repro.models.transformer.
init_params`` or ``repro.models.encdec.init_params`` as numpy arrays and
returns a module that computes what the JAX model computes;
``to_jax_params`` is its inverse (float32 numpy arrays, JAX's keys and
stacked shapes).  The two meet in ``layout``: one entry per JAX leaf,
its key path and the port's tensors it splits into.
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
parameter's dtype: served, ``compute_dtype`` for matrices (what JAX casts
to at use) and f32 for norms, the MoE router, rglru's ``lam``, ``b_a``,
``b_i`` and ``conv_w``, and xlstm's ``b_f``, ``b`` and ``R``; as float32
masters (``masters=True``, every family), f32 throughout, JAX's training
leaves unrounded.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import rglru, xlstm
from repro_torch.models.api import module_of
from repro_torch.models.encdec import CROSS_LEAVES, SELF_LEAVES
from repro_torch.models.transformer import check_family

LAYER_LEAVES = ("ln1", "ln2", "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


class Leaf(NamedTuple):
    """One JAX leaf: its key path, the port's tensors it splits into (in
    order along the stacked axes) and those axes' sizes (() unstacked)."""
    path: Tuple[str, ...]
    tensors: List[torch.Tensor]
    lead: Tuple[int, ...]

    @property
    def key(self) -> str:
        return "/".join(self.path)

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.lead + tuple(self.tensors[0].shape)

    @property
    def ndim(self) -> int:
        return len(self.shape)


def _stacks(model, cfg: ArchConfig) -> Tuple[Tuple[str, ...], Dict[str, Tuple]]:
    """(the unstacked leaves, {stack name: (leaf names, blocks, lead)})."""
    if cfg.family == "encdec":
        return (("embed", "final_norm", "enc_final_norm"),
                {"enc": (SELF_LEAVES, list(model.enc), (cfg.enc_layers,)),
                 "dec": (SELF_LEAVES + CROSS_LEAVES, list(model.dec), (cfg.dec_layers,))})
    if cfg.family == "hybrid":
        stacks = {name: (rglru.ATTN_LEAVES if name == "attn" else rglru.REC_LEAVES,
                         list(getattr(model, name)), (len(getattr(model, name)),))
                  for name in ("rec1", "rec2", "attn", "rec_tail")}
        if not len(model.rec_tail):
            del stacks["rec_tail"]
        return ("embed", "final_norm"), stacks
    if cfg.family == "ssm":
        sb = xlstm.n_superblocks(cfg)
        return (("embed", "final_norm"),
                {"mlstm": (xlstm.MLSTM_LEAVES, list(model.mlstm), (sb, cfg.slstm_every - 1)),
                 "slstm": (xlstm.SLSTM_LEAVES, list(model.slstm), (sb,))})
    top = (("embed", "final_norm") + (() if cfg.tie_embeddings else ("lm_head",))
           + (("vision_proj",) if cfg.n_vision_tokens else ()))
    leaves = LAYER_LEAVES + (("router",) if cfg.moe_experts else ())
    return top, {"layers": (leaves, list(model.layers), (cfg.n_layers,))}


def layout(model) -> List[Leaf]:
    """Every JAX leaf of ``model``'s parameters, in JAX's key order (sorted
    dict keys at every level, as ``jax.tree_util`` flattens a dict)."""
    top, stacks = _stacks(model, model.cfg)
    out = [Leaf((name,), [getattr(model, name)], ()) for name in top]
    for stack, (names, blocks, lead) in stacks.items():
        out += [Leaf((stack, name), [getattr(b, name) for b in blocks], lead) for name in names]
    return sorted(out, key=lambda leaf: leaf.path)


def jax_leaves(model) -> Dict[str, Tuple[str, int, int]]:
    """Port parameter name → (JAX key, index along the stacked axes, the
    JAX leaf's rank)."""
    names = {id(p): n for n, p in model.named_parameters()}
    return {names[id(t)]: (leaf.key, i, leaf.ndim)
            for leaf in layout(model) for i, t in enumerate(leaf.tensors)}


def _get(tree: Mapping, path: Tuple[str, ...]):
    for name in path:
        tree = tree[name]
    return tree


def _check_keys(tree: Mapping, leaves: List[Leaf]) -> None:
    want: Dict[Tuple[str, ...], set] = {(): set()}
    for leaf in leaves:
        want[()].add(leaf.path[0])
        if len(leaf.path) == 2:
            want.setdefault(leaf.path[:1], set()).add(leaf.path[1])
    for path, keys in want.items():
        sub = _get(tree, path)
        what = "/".join(path) or "params"
        if not isinstance(sub, Mapping) or set(sub) != keys:
            got = sorted(sub) if isinstance(sub, Mapping) else type(sub).__name__
            raise ValueError(f"{what}: keys {got}, expected {sorted(keys)}")


def read_leaf(leaf: Leaf) -> np.ndarray:
    """The leaf's host array in JAX's shape: its tensors stacked, bf16
    widened to float32 (exactly; numpy has no bf16)."""
    arr = np.stack([(t.detach().cpu().float() if t.dtype == torch.bfloat16
                     else t.detach().cpu()).numpy() for t in leaf.tensors])
    return arr.reshape(leaf.shape) if leaf.lead else arr[0]


@torch.no_grad()
def write_leaf(leaf: Leaf, arr) -> None:
    """Split an array of the leaf's JAX shape into its tensors, in place,
    each cast to its tensor's dtype (floats through float32)."""
    arr = np.asarray(arr)
    if tuple(arr.shape) != leaf.shape:
        raise ValueError(f"{leaf.key}: shape {tuple(arr.shape)}, expected {leaf.shape}")
    if arr.dtype.kind not in "biu":
        arr = arr.astype(np.float32)  # JAX's bf16 arrays included
    flat = arr.reshape((-1,) + tuple(leaf.tensors[0].shape))
    for i, t in enumerate(leaf.tensors):
        t.copy_(torch.from_numpy(np.array(flat[i])).to(device=t.device, dtype=t.dtype))


@torch.no_grad()
def from_jax_params(params: Mapping, cfg: ArchConfig, device="cuda", masters: bool = False):
    """The port's module of ``cfg`` holding JAX's ``params``: served, or
    with ``masters`` the float32-master form that the port trains."""
    check_family(cfg)
    model = module_of(cfg)(cfg, device, masters=masters)
    leaves = layout(model)
    _check_keys(params, leaves)
    for leaf in leaves:
        write_leaf(leaf, _get(params, leaf.path))
    return model


@torch.no_grad()
def to_jax_params(model) -> Dict:
    """``model``'s parameters as JAX's pytree: float32 numpy arrays under
    JAX's keys, per-layer leaves stacked to JAX's (L, …) shapes (bf16 values
    widen exactly)."""
    tree: Dict = {}
    for leaf in layout(model):
        arr = read_leaf(leaf).astype(np.float32)
        node = tree
        for name in leaf.path[:-1]:
            node = node.setdefault(name, {})
        node[leaf.path[-1]] = arr
    return tree
