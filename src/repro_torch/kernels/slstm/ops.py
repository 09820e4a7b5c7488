"""The sLSTM's recurrence over time, forward and backward, on two routes.

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
launch ``csrc/slstm.cu`` or raise, on the route ``route(B, S, d, SMs,
opt-in shared memory)`` names from the card's figures before any launch:

* ``"resident"`` (S > 1, d ≤ 2,048 with d/16 blocks no more than the
  card's SMs, B ≤ 32): one cooperative launch a call
  (``svc_slstm_fwd_resident`` / ``svc_slstm_bwd_resident``) whose blocks
  hold their slice of R in registers and loop over the steps, one
  grid-wide barrier a step through an arrival counter in a per-(card,
  stream) workspace (``_barrier``);
* ``"step"`` (every decode, S = 1, and the shapes above the resident
  route's limits): one launch a time step, a sequence's steps enqueued
  from one C loop (``svc_slstm_fwd`` / ``svc_slstm_bwd``).

The two routes take every sum in the same order and give the same bits;
the card tests and the smoke hold one against the other through the
launchers (``_launch_fwd``/``_launch_bwd`` with a route), whose C entry
refuses a shape its route does not take and raises.  Each wrapper's
``launches`` counts 1 a call on the resident route and S on the per-step
route, and ``routes`` the launches of each; neither route crosses ctypes
more than once a call or synchronizes.  The kernel's block
owns 16 units of every gate, so d must be a multiple of 64 (16 units of
one head).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import torch

from repro_torch.kernels import _build as B
from repro_torch.kernels.slstm.ref import Saved, slstm_bwd_ref, slstm_dR, slstm_scan_ref
from repro_torch.obs.kprof import profiled

_FWD_ARGS = (B.P,) * 14 + (B.I32,) * 3 + (B.P,)
_BWD_ARGS = (B.P,) * 10 + (B.I32,) * 3 + (B.P,)
_FWD_RES_ARGS = (B.P,) * 14 + (B.I32,) * 3 + (B.P, B.I64, B.P)
_BWD_RES_ARGS = (B.P,) * 7 + (B.I32,) * 3 + (B.P, B.I64, B.P)
_PROBE_ARGS = (B.I32, B.I32, B.P, B.I64, B.P)
UNIT_TILE = 16  # units of each gate a block owns (csrc/slstm.cu's kUnits)
ROW_TILE = 8  # batch rows of a tile (kRows)
MAX_TILES = 4  # row tiles whose state a resident block keeps in registers (kMaxTiles)
RESIDENT_MAX_D = 2048  # R's slice in registers, d/16 floats a thread (kResMaxD)
ROUTES = ("resident", "step")


def resident_smem(d: int) -> int:
    """Bytes of shared memory a resident block asks for: the forward's h
    tile (8·d floats) and partials (16·4·8·16 floats), more than the
    backward's."""
    return (ROW_TILE * d + 16 * 4 * ROW_TILE * UNIT_TILE) * 4


def route(Bn: int, S: int, d: int, sms: int, smem_optin: int) -> str:
    """The route a call of B rows, S steps at width d takes on a card of
    ``sms`` SMs whose blocks may have ``smem_optin`` bytes of shared
    memory: ``"resident"`` where S > 1 and its d/16 blocks, one an SM, fit
    the card with their slice of R (d ≤ 2,048), B ≤ 32 and the shared
    memory fits; else ``"step"``.  Raises for a d that is not a multiple
    of 64."""
    if d < 4 * UNIT_TILE or d % (4 * UNIT_TILE):
        raise ValueError(f"slstm: d = {d} is not a multiple of {4 * UNIT_TILE}: the kernel's "
                         f"blocks take {UNIT_TILE} units of one head")
    if (S > 1 and d <= RESIDENT_MAX_D and d // UNIT_TILE <= sms
            and -(-Bn // ROW_TILE) <= MAX_TILES and resident_smem(d) <= smem_optin):
        return "resident"
    return "step"


@functools.lru_cache(maxsize=None)
def card_figures(index: int) -> tuple:
    """(SMs, opt-in shared memory a block) of card ``index``, read once."""
    p = torch.cuda.get_device_properties(index)
    return p.multi_processor_count, p.shared_memory_per_block_optin


def route_on(Bn: int, S: int, d: int, card: int) -> str:
    """``route`` on card ``card``'s figures."""
    return route(Bn, S, d, *card_figures(card))


def launches_per_call(Bn: int, S: int, d: int, card: int = 0) -> int:
    """Launches of each kernel a call at (B, S, d) on card ``card``: 1 on
    the resident route, S on the per-step route."""
    return 1 if route_on(Bn, S, d, card) == "resident" else S


_workspace: dict = {}


def _barrier(card: int, stream: int) -> list:
    """[the arrival counter (uint64 as int64, (1,)), the arrivals counted so
    far] of the card and stream: the resident kernels' grid barrier, zeroed
    once, never reset; each launch adds its barriers × blocks."""
    ws = _workspace.get((card, stream))
    if ws is None:
        ws = _workspace[(card, stream)] = [
            torch.zeros(1, dtype=torch.int64, device=torch.device("cuda", card)), 0]
    return ws


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
    card = B.check_cuda(wx.device)
    return profiled("slstm_fwd", _launch_fwd, wx, R, state, save,
                    route_on(Bn, S, d, card), rows=Bn * S, padded=Bn * S)


def _launch_fwd(wx, R, state, save: bool, route_: str):
    """``slstm_fwd``'s launch on route ``route_`` (``"resident"`` or
    ``"step"``) of checked CUDA inputs."""
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
    args = (wx.data_ptr(), R.data_ptr(), *init, hs.data_ptr(), c.data_ptr(), n.data_ptr(),
            m.data_ptr(), *keep, Bn, S, d)
    if route_ == "resident":
        ws = _barrier(card, B.stream(card))
        B.launch_on(card, "svc_slstm_fwd_resident", _FWD_RES_ARGS, *args, ws[0].data_ptr(),
                    ws[1])
        ws[1] += (S - 1) * (d // UNIT_TILE)
        n_launch = 1
    else:
        B.launch_on(card, "svc_slstm_fwd", _FWD_ARGS, *args)
        n_launch = S
    slstm_fwd.launches += n_launch
    slstm_fwd.routes[route_] += n_launch
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
    card = B.check_cuda(dev)
    return profiled("slstm_bwd", _launch_bwd, dhs, R, hs, saved, route_on(Bn, S, d, card),
                    rows=Bn * S, padded=Bn * S)


def _launch_bwd(dhs, R, hs, saved: Saved, route_: str):
    """``slstm_bwd``'s launch on route ``route_`` of checked CUDA inputs."""
    Bn, S, d = dhs.shape
    dev = dhs.device
    dG = torch.empty((Bn, S, 4 * d), dtype=torch.float32, device=dev)
    card = dev.index
    ins = (dhs.data_ptr(), R.data_ptr(), *[t.data_ptr() for t in saved], dG.data_ptr())
    if route_ == "resident":
        ws = _barrier(card, B.stream(card))
        B.launch_on(card, "svc_slstm_bwd_resident", _BWD_RES_ARGS, *ins, Bn, S, d,
                    ws[0].data_ptr(), ws[1])
        ws[1] += (S - 1) * (d // UNIT_TILE)
        n_launch = 1
    else:
        carries = torch.empty((3, Bn, d), dtype=torch.float32, device=dev)  # dc, dn, dm
        B.launch_on(card, "svc_slstm_bwd", _BWD_ARGS, *ins, carries[0].data_ptr(),
                    carries[1].data_ptr(), carries[2].data_ptr(), Bn, S, d)
        n_launch = S
    slstm_bwd.launches += n_launch
    slstm_bwd.routes[route_] += n_launch
    return dG, slstm_dR(hs, dG)


def barrier_probe(device, blocks: int, barriers: int) -> None:
    """One cooperative launch of ``blocks`` blocks that passes ``barriers``
    of the resident route's grid barriers and does nothing else, on the
    device's current stream: what the smoke times as a barrier's cost.
    Counts no wrapper launch."""
    dev = B.cuda_device(device)
    B.check_cuda(dev)
    card = dev.index
    ws = _barrier(card, B.stream(card))
    B.launch_on(card, "svc_slstm_barrier_probe", _PROBE_ARGS, blocks, barriers,
                ws[0].data_ptr(), ws[1])
    ws[1] += barriers * blocks


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
slstm_fwd.routes = dict.fromkeys(ROUTES, 0)
slstm_bwd.routes = dict.fromkeys(ROUTES, 0)
