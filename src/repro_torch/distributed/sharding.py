"""Sharding rules: parameter / batch / cache partition specs per architecture,
the port of ``repro.distributed.sharding``.

Scheme (JAX's, unchanged; its roofline terms read these specs):
  * 2-D weight matrices: FSDP over ``data`` on the input dim × TP over
    ``model`` on the output dim (transposed for down/out projections so the
    contracting dim stays TP-sharded — one psum per block);
  * MoE expert stacks: experts replicated along mesh axes (8/40 don't
    divide 16), d_ff TP + FSDP storage over data;
  * embeddings: vocab over ``model``, d_model over ``data``;
  * batch: ``("pod","data")`` (pure DP across pods; params replicate
    across pods and gradients all-reduce over the pod axis);
  * KV caches: batch over dp; heads over ``model`` when divisible, else
    the *time* axis is TP-sharded (sequence-sharded KV for MQA/GQA-8);
  * optimizer states mirror parameter specs; scalars replicated.

Every rule degrades to ``None`` (replicated) when the dim doesn't divide
the axis.  The rules read only ``mesh.shape``.

The port names its parameters per layer where JAX stacks them: a JAX leaf
``layers/wq`` of shape (L, d, q) is the port's ``layers.{i}.wq`` (d, q)
for each i (``models.convert.layout``).  Each port tensor takes the spec
JAX gives its leaf, without the entries of the stacked axes (all ``None``:
no rule shards a layer axis).  ``Sharded`` pairs a meta tensor with its
spec, the counterpart of ``named`` and ``with_sharding``: its per-device
shape and bytes on a mesh.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.models.convert import layout
from repro_torch.models.parallel import P

# leaf names whose LAST dim is the "output" (TP) dim
_UP_NAMES = {
    "wq", "wk", "wv", "w_gate", "w_up", "w_in", "w_gate_branch", "w_a", "w_i",
    "W", "xq", "xk", "xv", "w_f",
}
# leaf names whose last dim is d_model (contracting dim first → TP on dim 0)
_DOWN_NAMES = {"wo", "w_down", "w_out", "xo"}
_REPL_NAMES = {
    "ln", "ln1", "ln2", "ln_x", "b", "b_a", "b_i", "b_f", "lam", "final_norm",
    "enc_final_norm", "conv_w", "router", "vision_proj",
    # the sLSTM's recurrence weights are read at every step of its time
    # loop: sharded, each step would all-gather them
    "R",
}


def axis_extent(mesh, axis) -> int:
    """Devices an entry of a spec splits over: 1 for None, else the product
    of its axes' sizes."""
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        return math.prod(mesh.shape[a] for a in axis)
    return mesh.shape[axis]


def _axis_ok(mesh, axis, dim: int) -> bool:
    return dim % axis_extent(mesh, axis) == 0


def _maybe(mesh, axis, dim: int):
    return axis if _axis_ok(mesh, axis, dim) else None


def dp_axes(multi_pod: bool) -> Tuple[str, ...]:
    return ("pod", "data") if multi_pod else ("data",)


def param_spec_for(path_keys, shape, cfg: ArchConfig, mesh) -> P:
    """JAX's spec for the leaf at ``path_keys`` of (JAX's) ``shape``."""
    name = path_keys[-1] if path_keys else ""
    nd = len(shape)
    if name in _REPL_NAMES or nd <= 1:
        return P()
    if name in ("embed", "lm_head"):
        if name == "embed":  # (V, D)
            return P(_maybe(mesh, "model", shape[0]), _maybe(mesh, "data", shape[1]))
        return P(_maybe(mesh, "data", shape[0]), _maybe(mesh, "model", shape[1]))
    lead = (None,) * (nd - 2)
    if name in _DOWN_NAMES:
        return P(*lead, _maybe(mesh, "model", shape[-2]), _maybe(mesh, "data", shape[-1]))
    # the up projections, and by default: FSDP on in (data), TP on out (model)
    return P(*lead, _maybe(mesh, "data", shape[-2]), _maybe(mesh, "model", shape[-1]))


def _serving(spec: P) -> P:
    return P(*[None if a == "data" else a for a in spec])


def tree_param_specs(cfg: ArchConfig, params, mesh, serving: bool = False) -> Dict[str, P]:
    """The spec of each parameter of the module ``params`` by its name.

    ``serving=True`` drops the FSDP (data) axis so weights stay
    TP-resident: under FSDP every decode step re-gathers each layer's
    weights over the data axis.  Only applied when the bf16 weights fit
    per-chip HBM (``serving_weights_fit``)."""
    names = {id(p): n for n, p in params.named_parameters()}
    out = {}
    for leaf in layout(params):
        spec = param_spec_for(list(leaf.path), leaf.shape, cfg, mesh)
        if serving:
            spec = _serving(spec)
        k = len(leaf.lead)
        if any(a is not None for a in spec[:k]):
            raise ValueError(f"{leaf.key}: spec {spec} shards a stacked axis")
        for t in leaf.tensors:
            out[names[id(t)]] = P(*spec[k:])
    return out


def serving_weights_fit(cfg: ArchConfig, mesh, hbm_budget: float = 8e9) -> bool:
    """Do bf16 weights fit per chip with model-axis-only sharding?  (JAX's
    budget, 8e9 bytes, so that the spec decisions stay JAX's.)"""
    from repro_torch.models.api import param_counts

    per_chip = param_counts(cfg)["total"] * 2 / mesh.shape["model"]
    return per_chip <= hbm_budget


def batch_specs(cfg: ArchConfig, cell: ShapeCell, mesh, multi_pod: bool) -> Dict[str, P]:
    dp = _maybe(mesh, dp_axes(multi_pod), cell.global_batch)
    specs = {"tokens": P(dp, None), "labels": P(dp, None), "domain": P(dp)}
    if cfg.family == "vlm":
        specs["vision_embeds"] = P(dp, None, None)
    if cfg.family == "encdec":
        specs["frames"] = P(dp, None, None)
    return specs


def _cache_spec(cfg: ArchConfig, name: str, shape, mesh, dp_full) -> P:
    nd = len(shape)

    def dpax(dim):
        return _maybe(mesh, dp_full, dim)

    if cfg.family in ("dense", "moe", "vlm", "encdec") and nd == 5:  # (L, B, T, K, hd)
        k_ax = _maybe(mesh, "model", shape[3])
        t_ax = None if k_ax else _maybe(mesh, "model", shape[2])
        return P(None, dpax(shape[1]), t_ax, k_ax, None)
    if cfg.family == "hybrid":
        if name in ("attn_k", "attn_v") and nd == 5:  # (sb, B, W, 1, hd)
            return P(None, dpax(shape[1]), _maybe(mesh, "model", shape[2]), None, None)
        if name == "attn_pos":
            return P()
        if nd == 3:  # rec h (sb, B, d)
            return P(None, dpax(shape[1]), _maybe(mesh, "model", shape[2]))
        if nd == 4:  # conv buf (sb, B, W-1, d)
            return P(None, dpax(shape[1]), None, _maybe(mesh, "model", shape[3]))
    if cfg.family == "ssm":
        if name == "mlstm_C" and nd == 6:  # (sb, m, B, H, hd, hd)
            return P(None, None, dpax(shape[2]), None, _maybe(mesh, "model", shape[4]), None)
        if name == "mlstm_n" and nd == 5:
            return P(None, None, dpax(shape[2]), None, _maybe(mesh, "model", shape[4]))
        if name == "mlstm_m" and nd == 4:
            return P(None, None, dpax(shape[2]), None)
        if nd == 3:  # slstm (sb, B, d)
            return P(None, dpax(shape[1]), _maybe(mesh, "model", shape[2]))
    return P()


def cache_specs(cfg: ArchConfig, cache: Any, mesh, multi_pod: bool) -> Any:
    """The spec of every tensor of ``cache`` (nested dicts and tuples, as
    ``init_cache`` builds it; a None leaf stays None), named by its top key
    as JAX's rules name it."""
    dp_full = dp_axes(multi_pod)

    def walk(node, name):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return type(node)(walk(v, name) for v in node)
        return _cache_spec(cfg, name, tuple(node.shape), mesh, dp_full)

    return {k: walk(v, k) for k, v in cache.items()}


def opt_state_specs(param_specs: Any) -> Dict[str, Any]:
    return {"m": param_specs, "v": param_specs, "step": P()}


def local_shape(shape, spec: P, mesh) -> Tuple[int, ...]:
    """Per-device shape of a ``shape`` tensor under ``spec`` (a dim that its
    axes do not divide is padded up, as a sharded array's shard is)."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(-(-n // axis_extent(mesh, a)) for n, a in zip(shape, spec))


class Sharded(NamedTuple):
    """A meta tensor with its spec on a mesh (JAX's sharded
    ``ShapeDtypeStruct``)."""
    tensor: torch.Tensor
    spec: P
    mesh: Any

    @property
    def local_shape(self) -> Tuple[int, ...]:
        return local_shape(tuple(self.tensor.shape), self.spec, self.mesh)

    @property
    def local_bytes(self) -> int:
        return math.prod(self.local_shape) * self.tensor.element_size()


def with_sharding(tensors: Any, specs: Any, mesh) -> Any:
    """Pair every tensor of ``tensors`` with its spec in ``specs`` (the same
    nesting of dicts, tuples and lists; None stays None)."""
    if tensors is None:
        return None
    if isinstance(tensors, torch.Tensor):
        return Sharded(tensors, specs, mesh)
    if isinstance(tensors, dict):
        return {k: with_sharding(v, specs[k], mesh) for k, v in tensors.items()}
    return type(tensors)(with_sharding(t, s, mesh) for t, s in zip(tensors, specs))


def leaves(tree: Any):
    """The ``Sharded`` leaves of a ``with_sharding`` tree, in order."""
    if isinstance(tree, Sharded):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from leaves(v)
