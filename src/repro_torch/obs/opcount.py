"""Counting regions for ``launch.op_analysis``: loops counted once and multiplied.

JAX's dry run reads its figures from the optimized HLO, where a
``lax.scan`` is one loop body and the analyzer multiplies the body by its
trip count (``repro.launch.hlo_analysis``).  The port traces its step on
the meta device, where nothing runs, and marks the same loops here:

  * ``loop(trips, name)``: every operation dispatched inside is counted
    ``trips`` times (regions nest and multiply; ``path()`` names them);
  * ``repeated(fn, trips, *args, name=...)``: ``fn(*args)`` traced once, its
    operations counted ``trips`` times in the forward and again in the
    backward (and again in a checkpoint's recompute), for a loop whose body
    is differentiated (the sLSTM's steps over time).  A meta path only: it
    computes one trip, and the caller shapes the rest;
  * ``aside()``: operations counted apart from the function's own, for an
    implementation's recompute that the function does not need (the flash
    plain backward's forward).

Outside an analysis a region is a list push and pop; nothing reads it.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, List, Tuple

import torch

_regions: List[Tuple[str, int, bool]] = []  # (name, trips, aside) from the outermost in


def current() -> Tuple[int, bool]:
    """(the product of the open loops' trips, whether an ``aside`` is open)."""
    return math.prod(t for _, t, _ in _regions), any(a for _, _, a in _regions)


def path() -> str:
    """The names of the open loops of more than one trip, outermost first,
    joined by "/" (JAX's analyzer records a body whose multiplier exceeds 1)."""
    return "/".join(n for n, t, a in _regions if n and t > 1 and not a)


@contextlib.contextmanager
def _region(name: str, trips: int, aside: bool):
    _regions.append((name, int(trips), aside))
    try:
        yield
    finally:
        _regions.pop()


def loop(trips: int, name: str = ""):
    """Count the operations dispatched inside ``trips`` times."""
    if trips < 1:
        raise ValueError(f"loop: trips={trips}")
    return _region(name, trips, False)


def aside():
    """Count the operations dispatched inside apart from the function's."""
    return _region("", 1, True)


class _Repeated(torch.autograd.Function):
    """``apply(fn, trips, name, *args)``: the forward runs ``fn`` once under
    ``loop(trips, name)`` and keeps its graph; the backward runs that graph's
    vector-Jacobian product under ``loop(trips)``.  Every floating input
    takes part in the product, as a loop's carry does in a scan's
    transpose (every iteration's, the first one's included)."""

    @staticmethod
    def forward(ctx, fn, trips, name, *args):
        ins = [a.detach().requires_grad_() if isinstance(a, torch.Tensor)
               and a.is_floating_point() else a for a in args]
        # the inner graph saves its tensors itself: a checkpoint around the
        # caller must not drop them
        with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(
                lambda t: t, lambda t: t), loop(trips, name):
            outs = fn(*ins)
        single = isinstance(outs, torch.Tensor)
        outs = (outs,) if single else tuple(outs)
        ctx.trips, ctx.name, ctx.ins, ctx.outs = trips, name, ins, outs
        # saved through autograd, the inputs make a checkpoint's recompute
        # reach this node (it stops after the last tensor the forward saved;
        # without them a loop with nothing saved after it went uncounted)
        ctx.save_for_backward(*[a for a in args if isinstance(a, torch.Tensor)])
        return tuple(o.detach() for o in outs)

    @staticmethod
    def backward(ctx, *grads):
        ctx.saved_tensors  # a checkpoint around the caller recomputes here
        live = [(o, g) for o, g in zip(ctx.outs, grads) if o.requires_grad and g is not None]
        wants = [a for a in ctx.ins if isinstance(a, torch.Tensor) and a.requires_grad]
        got = iter(())
        if live and wants:
            with loop(ctx.trips, ctx.name):
                got = iter(torch.autograd.grad([o for o, _ in live], wants,
                                               [g for _, g in live], allow_unused=True))
        out = [next(got, None) if isinstance(a, torch.Tensor) and a.requires_grad else None
               for a in ctx.ins]
        return (None, None, None, *out)


def repeated(fn: Callable, trips: int, *args, name: str = ""):
    """``fn(*args)`` computed once and counted ``trips`` times, forward and
    backward; returns ``fn``'s outputs as a tuple.  On meta tensors only:
    the values of one trip stand for all of them, which holds only where
    there are no values."""
    if any(isinstance(a, torch.Tensor) and a.device.type != "meta" for a in args):
        raise ValueError("repeated: meta tensors only (a real loop runs every trip)")
    if trips < 1:
        raise ValueError(f"repeated: trips={trips}")
    if torch.is_grad_enabled():
        return _Repeated.apply(fn, trips, name, *args)
    with loop(trips, name):
        outs = fn(*args)
    return (outs,) if isinstance(outs, torch.Tensor) else tuple(outs)
