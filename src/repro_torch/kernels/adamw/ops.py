"""AdamW over every trainable leaf in two multi-tensor launches.

``adamw_norm(cfg, grads, step)`` takes the step's scalars
(``ref.Scalars``: the step counter + 1, lr, grad_norm, clip_scale, bc1,
bc2) and ``adamw_apply(cfg, params, grads, ms, vs, decay, scalars)``
updates every p, m and v in place.  JAX has no op of its own for either
(XLA fuses ``repro.training.optim.adamw_update``); they dispatch through
``obs.kprof.profiled`` as ``"adamw_norm"`` and ``"adamw_update"``.

CPU and meta tensors take the plain version (``ref.py``; the dry run's
trace counts its operations).  CUDA tensors launch ``csrc/adamw.cu`` or
raise: ``svc_adamw_sumsq`` (Σg² and the scalars, computed on the card from
the int32 step counter, no host read) and ``svc_adamw_update``.  The
leaves' addresses and sizes go in the kernels' parameter block, built
afresh every call (the gradients are new tensors every step), so a call
copies nothing to the card and never synchronizes.  One launch of each
takes up to ``max_leaves()`` leaves; more split into groups, one launch of
each kernel a group, and each wrapper's ``launches`` counts them.  The
norm's per-block float64 partials and its ticket live in a persistent
workspace per card and stream (the ticket zeroed once; every call leaves
it at 0).
"""

from __future__ import annotations

import functools
from typing import List, Sequence

import numpy as np
import torch

from repro_torch.kernels import _build as B
from repro_torch.kernels.adamw.ref import Scalars, adamw_norm_ref, adamw_update_ref
from repro_torch.obs.kprof import profiled

_NORM_ARGS = (B.P, B.I32, B.P, B.P, B.I32, B.P, B.P, B.P) + (B.F32,) * 9 + (B.P,)
_UPDATE_ARGS = (B.P, B.I32, B.P, B.P, B.P, B.P) + (B.F32,) * 6 + (B.P,)
BLOCKS_PER_SM = 8  # the most 256-thread blocks an SM holds: one launch's partials

_workspace: dict = {}


@functools.lru_cache(maxsize=None)
def max_leaves() -> int:
    """Leaves one launch takes (the library's parameter-block table)."""
    fn = B.library().svc_adamw_max_leaves
    fn.restype = B.I32
    return fn()


def launches_per_call(leaves: int) -> int:
    """Launches of each kernel a call over ``leaves`` leaves makes."""
    return -(-leaves // max_leaves())


def _partials(device: torch.device, stream: int, groups: int):
    """(ticket int32 (1,), partials float64, blocks a launch) of the card
    and stream, with room for ``groups`` launches' partials."""
    key = (device.index, stream)
    ws = _workspace.get(key)
    blocks = BLOCKS_PER_SM * B.sm_count(device.index)
    if ws is None:
        ws = _workspace[key] = (torch.zeros(1, dtype=torch.int32, device=device),
                                torch.empty(groups * blocks, dtype=torch.float64,
                                            device=device))
    elif ws[1].numel() < groups * blocks:  # every slot a call reads, it writes first
        ws = _workspace[key] = (ws[0], torch.empty(groups * blocks, dtype=torch.float64,
                                                   device=device))
    return ws[0], ws[1], blocks


def _check_leaves(what: str, leaves: Sequence[torch.Tensor], dev: torch.device,
                  shapes=None) -> None:
    for i, t in enumerate(leaves):
        B.check(t, f"{what}[{i}]", torch.float32, dev, None if shapes is None else shapes[i])


def adamw_norm(cfg, grads: Sequence[torch.Tensor], step: torch.Tensor) -> Scalars:
    """grads: float32 contiguous leaves on one device; step: its int32 0-d
    step counter → the step's ``Scalars`` (new tensors; ``step`` is left
    as it was)."""
    grads = list(grads)
    if not grads:
        raise ValueError("adamw_norm: no leaves")
    dev = grads[0].device
    _check_leaves("grads", grads, dev)
    B.check(step, "step", torch.int32, dev, ())
    n = sum(g.numel() for g in grads)
    if dev.type in ("cpu", "meta"):
        return profiled("adamw_norm", adamw_norm_ref, cfg, grads, step, fallback=True, rows=n,
                        padded=n)
    B.check_cuda(dev)
    return profiled("adamw_norm", _launch_norm, cfg, grads, step, rows=n, padded=n)


def _launch_norm(cfg, grads: List[torch.Tensor], step: torch.Tensor) -> Scalars:
    dev = grads[0].device
    card = dev.index
    groups = launches_per_call(len(grads))
    ticket, partials, blocks = _partials(dev, B.stream(card), groups)
    table = np.array([(g.data_ptr(), g.numel()) for g in grads], dtype=np.int64)
    out_step = torch.empty((), dtype=torch.int32, device=dev)
    sc = torch.empty(5, dtype=torch.float32, device=dev)  # the last block writes all five
    B.launch_on(card, "svc_adamw_sumsq", _NORM_ARGS, table.ctypes.data, len(grads),
                partials.data_ptr(), ticket.data_ptr(), blocks, step.data_ptr(),
                out_step.data_ptr(), sc.data_ptr(), cfg.lr, float(cfg.warmup_steps),
                float(max(cfg.warmup_steps, 1)),
                float(max(cfg.total_steps - cfg.warmup_steps, 1)), cfg.min_lr_ratio,
                (1 - cfg.min_lr_ratio) * 0.5, cfg.b1, cfg.b2, cfg.clip_norm)
    adamw_norm.launches += groups
    return Scalars(out_step, *sc.unbind())


def adamw_apply(cfg, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                ms: Sequence[torch.Tensor], vs: Sequence[torch.Tensor], decay: Sequence[bool],
                sc: Scalars) -> List[torch.Tensor]:
    """One AdamW step of every leaf in place: p, g, m, v float32, contiguous,
    of one shape a leaf, all on one device; ``decay[i]``: leaf i takes the
    decoupled decay; ``sc``: the step's scalars (``adamw_norm``'s or the
    plain version's).  Returns ``params``."""
    params, grads, ms, vs, decay = list(params), list(grads), list(ms), list(vs), list(decay)
    if not params:
        raise ValueError("adamw_apply: no leaves")
    if not len(grads) == len(ms) == len(vs) == len(decay) == len(params):
        raise ValueError(f"adamw_apply: {len(params)} params, {len(grads)} grads, {len(ms)} m, "
                         f"{len(vs)} v, {len(decay)} decay flags")
    dev = params[0].device
    _check_leaves("params", params, dev)
    shapes = [p.shape for p in params]
    for what, leaves in (("grads", grads), ("m", ms), ("v", vs)):
        _check_leaves(what, leaves, dev, shapes)
    for name in ("lr", "clip_scale", "bc1", "bc2"):
        B.check(getattr(sc, name), name, torch.float32, dev, ())
    n = sum(p.numel() for p in params)
    if dev.type in ("cpu", "meta"):
        return profiled("adamw_update", adamw_update_ref, cfg, params, grads, ms, vs, decay, sc,
                        fallback=True, rows=n, padded=n)
    B.check_cuda(dev)
    return profiled("adamw_update", _launch_update, cfg, params, grads, ms, vs, decay, sc,
                    rows=n, padded=n)


def _launch_update(cfg, params, grads, ms, vs, decay, sc: Scalars) -> List[torch.Tensor]:
    dev = params[0].device
    card = dev.index
    table = np.array([(p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(), p.numel(),
                       1 if d else 0) for p, g, m, v, d in zip(params, grads, ms, vs, decay)],
                     dtype=np.int64)
    B.launch_on(card, "svc_adamw_update", _UPDATE_ARGS, table.ctypes.data, len(params),
                sc.lr.data_ptr(), sc.clip_scale.data_ptr(), sc.bc1.data_ptr(),
                sc.bc2.data_ptr(), cfg.b1, 1 - cfg.b1, cfg.b2, 1 - cfg.b2, cfg.eps,
                cfg.weight_decay)
    adamw_apply.launches += launches_per_call(len(params))
    return params


adamw_norm.launches = 0
adamw_apply.launches = 0
