"""The sLSTM's recurrence over time: one launch a time step, forward and
backward, each a sequence's steps enqueued from one C loop.

``slstm_fwd(wx, R, state=None, save=False)`` runs the recurrence over
wx (B, S, 4d) from ``state`` (h, c, n, m; zeros when None) and returns
(hs (B, S, d), the last state) and, with ``save``, ``ref.Saved`` (every
step's gate pre-activations and c, n, m) for the backward.
``slstm_bwd(dhs, R, hs, saved)`` returns (dwx, dR) of a forward from the
zero state (the only one that takes a gradient): dwx is the kernel's
per-step dg, dR = Σ_t h_{t−1}ᵀ·dg_t one batched product over
all steps after the loop (``ref.slstm_dR``), as JAX's scan transposes its
einsum into a plain dot.  ``SLSTMScan`` is the autograd Function around
the two.  JAX has no op name for either (XLA compiles its ``lax.scan``);
they dispatch through ``obs.kprof.profiled`` as ``"slstm_fwd"`` and
``"slstm_bwd"``.

CPU and meta tensors take the plain version (``ref.py``).  CUDA tensors
launch ``csrc/slstm.cu`` or raise: ``svc_slstm_fwd`` and
``svc_slstm_bwd`` each enqueue S launches (one a step) from a C loop, so a
call crosses ctypes once and never synchronizes; each wrapper's
``launches`` counts S a call.  The kernel's block owns 16 units of every
gate, so d must be a multiple of 64 (16 units of one head).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.kernels import _build as B
from repro_torch.kernels.slstm.ref import Saved, slstm_bwd_ref, slstm_dR, slstm_scan_ref
from repro_torch.obs.kprof import profiled

_FWD_ARGS = (B.P,) * 14 + (B.I32,) * 3 + (B.P,)
_BWD_ARGS = (B.P,) * 10 + (B.I32,) * 3 + (B.P,)
UNIT_TILE = 16  # units of each gate a block owns (csrc/slstm.cu's kUnits)


def _check_common(wx_like: torch.Tensor, what: str, R: torch.Tensor, width: int):
    """(B, S, d) after checking ``wx_like`` (B, S, width·d) and R (4, d/4, d)."""
    if not isinstance(R, torch.Tensor) or R.dim() != 3:
        raise ValueError(f"R: expected a (4, d/4, d) tensor, got {getattr(R, 'shape', R)}")
    d = R.shape[-1]
    dev = wx_like.device
    B.check(R, "R", torch.float32, dev, (4, d // 4, d))
    if d % 4 or wx_like.dim() != 3:
        raise ValueError(f"{what}: shape {tuple(wx_like.shape)}, R {tuple(R.shape)}")
    Bn, S = wx_like.shape[:2]
    B.check(wx_like, what, torch.float32, dev, (Bn, S, width * d))
    if Bn < 1 or S < 1:
        raise ValueError(f"{what}: shape {tuple(wx_like.shape)} has no rows or no steps")
    if dev.type == "cuda" and d % (4 * UNIT_TILE):
        raise ValueError(f"slstm: d = {d} is not a multiple of {4 * UNIT_TILE}: the kernel's "
                         f"blocks take {UNIT_TILE} units of one head")
    return Bn, S, d


def _check_state(state, Bn: int, d: int, dev) -> Optional[tuple]:
    if state is None:
        return None
    state = tuple(state)
    if len(state) != 4:
        raise ValueError(f"state: expected (h, c, n, m), got {len(state)} tensors")
    for name, t in zip("hcnm", state):
        B.check(t, f"state {name}", torch.float32, dev, (Bn, d))
    return state


def slstm_fwd(wx: torch.Tensor, R: torch.Tensor, state: Optional[Sequence] = None,
              save: bool = False):
    """wx (B, S, 4d) f32, R (4, d/4, d) f32, state (h, c, n, m) each (B, d)
    f32 or None (zeros), all contiguous on one device → (hs (B, S, d), the
    last state), and with ``save`` also ``Saved``."""
    Bn, S, d = _check_common(wx, "wx", R, 4)
    state = _check_state(state, Bn, d, wx.device)
    if wx.device.type in ("cpu", "meta"):
        return profiled("slstm_fwd", slstm_scan_ref, wx, R, state, save, fallback=True,
                        rows=Bn * S, padded=Bn * S)
    B.check_cuda(wx.device)
    return profiled("slstm_fwd", _launch_fwd, wx, R, state, save, rows=Bn * S, padded=Bn * S)


def _launch_fwd(wx, R, state, save: bool):
    Bn, S, _ = wx.shape
    d = R.shape[-1]
    dev = wx.device

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    hs = empty(Bn, S, d)
    c, n, m = empty(Bn, d), empty(Bn, d), empty(Bn, d)
    saved = Saved(empty(Bn, S, 4 * d), empty(Bn, S, d), empty(Bn, S, d),
                  empty(Bn, S, d)) if save else None
    init = [0] * 4 if state is None else [t.data_ptr() for t in state]
    keep = [0] * 4 if saved is None else [t.data_ptr() for t in saved]
    card = dev.index
    B.launch_on(card, "svc_slstm_fwd", _FWD_ARGS, wx.data_ptr(), R.data_ptr(), *init,
                hs.data_ptr(), c.data_ptr(), n.data_ptr(), m.data_ptr(), *keep, Bn, S, d)
    slstm_fwd.launches += S
    last = (hs[:, -1], c, n, m)
    return (hs, last, saved) if save else (hs, last)


def slstm_bwd(dhs: torch.Tensor, R: torch.Tensor, hs: torch.Tensor, saved: Saved):
    """The gradient of ``slstm_fwd(wx, R)``'s hs (from the zero state)
    against ``dhs`` (B, S, d) f32: (dwx (B, S, 4d), dR (4, d/4, d)).
    ``hs`` and ``saved`` are the forward's (``save=True``)."""
    Bn, S, d = _check_common(dhs, "dhs", R, 1)
    dev = dhs.device
    B.check(hs, "hs", torch.float32, dev, (Bn, S, d))
    saved = Saved(*saved)
    for name, t, w in zip(Saved._fields, saved, (4, 1, 1, 1)):
        B.check(t, f"saved {name}", torch.float32, dev, (Bn, S, w * d))
    if dev.type in ("cpu", "meta"):
        return profiled("slstm_bwd", slstm_bwd_ref, dhs, R, hs, saved, fallback=True,
                        rows=Bn * S, padded=Bn * S)
    B.check_cuda(dev)
    return profiled("slstm_bwd", _launch_bwd, dhs, R, hs, saved, rows=Bn * S, padded=Bn * S)


def _launch_bwd(dhs, R, hs, saved: Saved):
    Bn, S, d = dhs.shape
    dev = dhs.device
    dG = torch.empty((Bn, S, 4 * d), dtype=torch.float32, device=dev)
    carries = torch.empty((3, Bn, d), dtype=torch.float32, device=dev)  # dc, dn, dm
    card = dev.index
    B.launch_on(card, "svc_slstm_bwd", _BWD_ARGS, dhs.data_ptr(), R.data_ptr(),
                *[t.data_ptr() for t in saved], dG.data_ptr(), carries[0].data_ptr(),
                carries[1].data_ptr(), carries[2].data_ptr(), Bn, S, d)
    slstm_bwd.launches += S
    return dG, slstm_dR(hs, dG)


class SLSTMScan(torch.autograd.Function):
    """``apply(wx, R)`` → hs: the recurrence from the zero state, its
    forward ``slstm_fwd(save=True)``, its backward ``slstm_bwd``."""

    @staticmethod
    def forward(ctx, wx, R):
        hs, _last, saved = slstm_fwd(wx, R, save=True)
        ctx.save_for_backward(R, hs, *saved)
        return hs

    @staticmethod
    def backward(ctx, dhs):
        R, hs, *saved = ctx.saved_tensors  # unpacked once (a remat recompute allows no more)
        return slstm_bwd(dhs.contiguous(), R, hs, Saved(*saved))


slstm_fwd.launches = 0
slstm_bwd.launches = 0
