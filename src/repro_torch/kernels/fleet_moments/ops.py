"""Every view's planner moments from one pass over the fleet panel.

``fleet_moments`` is the op ``FleetPanel.moments`` calls once per epoch.
The eight channel panels may be strided views of one stacked (V, 8, R)
slab: rows must be contiguous and every panel must share one view stride,
so the panel is never copied.  CPU tensors take the plain version
(``ref.py``); CUDA tensors launch ``csrc/fleet_moments.cu`` or raise.
Every call dispatches through ``obs.kprof.profiled`` as ``"fleet_moments"``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build as B
from repro_torch.kernels.fleet_moments.ref import N_MOMENTS, fleet_moments_ref
from repro_torch.obs.kprof import profiled

_ARGS = (B.P,) * 8 + (B.I64, B.I64, B.I64, B.I32, B.P, B.P, B.P)
_ROWS_PER_BLOCK = 16384
NAMES = ("x_new", "valid_new", "w_new", "ompi_new", "x_old", "valid_old", "w_old", "ompi_old")


def _check_panels(panels) -> int:
    """Shared (V, R) f32 shape, one device, unit row stride, one view stride."""
    V, R = panels[0].shape
    dev = panels[0].device
    stride = panels[0].stride(0)
    for name, p in zip(NAMES, panels):
        if not isinstance(p, torch.Tensor):
            raise TypeError(f"{name}: expected a tensor, got {type(p).__name__}")
        if p.dim() != 2 or tuple(p.shape) != (V, R):
            raise ValueError(f"ragged channel panel {name}: {tuple(p.shape)} != {(V, R)}")
        if p.device != dev:
            raise ValueError(f"{name}: on {p.device}, expected {dev}")
        if p.dtype != torch.float32:
            raise TypeError(f"{name}: dtype {p.dtype}, expected torch.float32")
        if p.numel() == 0:
            continue
        if R > 1 and p.stride(1) != 1:
            raise ValueError(f"{name}: rows must be contiguous")
        if V > 1 and p.stride(0) != stride:
            raise ValueError(f"{name}: view stride {p.stride(0)} != {stride}")
    return stride


def fleet_moments(x_new, valid_new, w_new, ompi_new,
                  x_old, valid_old, w_old, ompi_old) -> torch.Tensor:
    """Eight (V, R) f32 channel panels → (V, N_MOMENTS) per-view moments.

    Padding rows/views must carry all-zero channels (the fleet panel's
    contract) so they reduce to zero on every moment."""
    panels = (x_new, valid_new, w_new, ompi_new, x_old, valid_old, w_old, ompi_old)
    stride = _check_panels(panels)
    dev = x_new.device
    V = x_new.shape[0]
    if dev.type == "cpu":
        return profiled("fleet_moments", fleet_moments_ref, *panels, fallback=True, rows=V,
                        padded=V)
    B.check_cuda(dev)
    if V > 65535:
        raise ValueError(f"fleet_moments takes at most 65535 views (grid y), got {V}")
    return profiled("fleet_moments", _launch, panels, stride, rows=V, padded=V)


def _launch(panels, stride: int) -> torch.Tensor:
    V, R = panels[0].shape
    dev = panels[0].device
    out = torch.empty((V, N_MOMENTS), dtype=torch.float32, device=dev)
    if V == 0:
        return out
    chunks = max(1, -(-R // _ROWS_PER_BLOCK))
    partials = torch.empty((V, chunks, N_MOMENTS), dtype=torch.float64, device=dev)
    card = dev.index
    B.launch_on(card, "svc_fleet_moments", _ARGS, *[p.data_ptr() for p in panels], V, R,
                stride, _ROWS_PER_BLOCK, partials.data_ptr(), out.data_ptr())
    fleet_moments.launches += 1
    return out


fleet_moments.launches = 0
