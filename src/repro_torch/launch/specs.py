"""Meta-device stand-ins for every input of a dry-run cell: the port of ``repro.launch.specs``.

``input_specs(arch, cell, mesh, multi_pod)`` returns what the dry run
traces a cell's step on: the train state, the parameters, the caches and
the batch as tensors on ``torch.device("meta")`` (shapes and dtypes, no
storage), each paired with its spec (``distributed.sharding.Sharded``).

The parameters are the port's own modules, as its steps consume them:
the float32 masters for the train state and for prefill (JAX lowers its
f32 ``init`` tree there), and for decode the served module (matrices in
``compute_dtype``, norms and the router in float32, TP-resident) when
``serving_weights_fit``, else the masters with FSDP, as JAX decides.
JAX's served tree casts every float32 leaf of rank ≥ 2 to bf16, its
stacked norms and router included; the port's keeps those leaves in
float32 (a few kB a layer).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.distributed import sharding as shd
from repro_torch.models.api import Model, get_model
from repro_torch.models.parallel import P, ParallelCtx
from repro_torch.training.train_step import TrainState, init_train_state, trainable

VISION_STUB_DIM = 1024
META = torch.device("meta")


def config(arch) -> ArchConfig:
    """``arch``'s config: an id (``configs.get_config``) or a config itself."""
    return get_config(arch) if isinstance(arch, str) else arch


def make_ctx(mesh, multi_pod: bool) -> ParallelCtx:
    return ParallelCtx(mesh=mesh, dp_axes=shd.dp_axes(multi_pod), tp_axis="model")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def batch_sds(cfg: ArchConfig, cell: ShapeCell, mesh, multi_pod: bool,
              decode: bool = False) -> Dict[str, shd.Sharded]:
    dp = shd.dp_axes(multi_pod)
    B = cell.global_batch
    S = 1 if decode else cell.seq_len
    out = {"tokens": ((B, S), torch.int32, P(dp, None)),
           "labels": ((B, S), torch.int32, P(dp, None)),
           "domain": ((B,), torch.int32, P(dp))}
    if cfg.family == "vlm" and not decode:
        out["vision_embeds"] = ((B, cfg.n_vision_tokens, VISION_STUB_DIM), torch.float32,
                                P(dp, None, None))
    if cfg.family == "encdec" and not decode:
        out["frames"] = ((B, cell.seq_len, cfg.d_model), torch.float32, P(dp, None, None))
    return {k: shd.Sharded(_meta(shape, dt), spec, mesh) for k, (shape, dt, spec) in out.items()}


def state_sds(model: Model, mesh, multi_pod: bool) -> Tuple[TrainState, TrainState]:
    """(the train state on meta, its specs): master, m and v mirror the
    parameter specs, the step counters replicated."""
    if not model.train:
        raise ValueError("state_sds: needs get_model(cfg, 'meta', train=True)")
    state = init_train_state(model)
    pspecs = shd.tree_param_specs(model.cfg, state.params, mesh)
    specs = TrainState(params=pspecs, opt_state=shd.opt_state_specs(pspecs), step=P())
    return state, specs


def state_leaves(state: TrainState, specs: TrainState, mesh):
    """Every tensor of the train state with its spec (``Sharded``)."""
    params = trainable(state.params)
    return list(shd.leaves(shd.with_sharding(
        {"params": params, "opt_state": state.opt_state, "step": state.step},
        {"params": specs.params, "opt_state": specs.opt_state, "step": specs.step}, mesh)))


def params_sds(cfg: ArchConfig, mesh, multi_pod: bool, serving: bool = False):
    """(the parameters' module on meta, {name: spec}).  ``serving=True``:
    the served module, TP-resident, when ``serving_weights_fit``."""
    serve = serving and shd.serving_weights_fit(cfg, mesh)
    params = get_model(cfg, META, train=not serve).init()
    return params, shd.tree_param_specs(cfg, params, mesh, serving=serve)


def param_leaves(params, specs, mesh):
    named = dict(params.named_parameters())
    return list(shd.leaves(shd.with_sharding(named, specs, mesh)))


def cache_sds(model: Model, cell: ShapeCell, mesh, multi_pod: bool) -> Tuple[Any, Any]:
    """(the cell's cache on meta, its specs)."""
    cache = model.init_cache(cell.global_batch, cell.seq_len)
    return cache, shd.cache_specs(model.cfg, cache, mesh, multi_pod)


def input_specs(arch, cell: ShapeCell, mesh, multi_pod: bool) -> Dict[str, Any]:
    """Every input of the cell's step, as (meta tensors, specs):
    train {"state", "batch"}, prefill {"params", "batch"}, decode
    {"params", "cache", "tokens", "pos"}.  Decode's ``pos`` is the cache's
    last position, a host int: the step attends the whole cache, as JAX's
    masked decode computes over a traced position.  ``arch``: an id or an
    ``ArchConfig``."""
    cfg = config(arch)
    if cell.kind == "train":
        model = get_model(cfg, META, train=True)
        return {"state": state_sds(model, mesh, multi_pod),
                "batch": batch_sds(cfg, cell, mesh, multi_pod)}
    if cell.kind == "prefill":
        return {"params": params_sds(cfg, mesh, multi_pod),
                "batch": batch_sds(cfg, cell, mesh, multi_pod)}
    if cell.kind == "decode":
        dp = shd._maybe(mesh, shd.dp_axes(multi_pod), cell.global_batch)
        return {"params": params_sds(cfg, mesh, multi_pod, serving=True),
                "cache": cache_sds(get_model(cfg, META), cell, mesh, multi_pod),
                "tokens": shd.Sharded(_meta((cell.global_batch, 1), torch.int32),
                                      P(dp, None), mesh),
                "pos": (cell.seq_len - 1, P())}
    raise ValueError(cell.kind)
