"""Fused (Σd, Σd², count) for d = (t_new − t_old)·mask over 1-D inputs.

``corr_moments`` is the port of ``repro.kernels.corr_diff.ops.
corr_moments``, a library call the JAX package exports (its ``svc_corr``
takes the same moments with ``_masked_moments``, as the port's does).
CPU tensors take the plain version (``ref.py``); CUDA tensors launch
``csrc/corr_diff.cu`` or raise.

The kernel's per-block partials and its ticket live in a persistent
workspace per device and stream (the ticket zeroed once; every launch
leaves it at 0), sized for the most blocks the card holds, so a call
allocates only its output.  The wrapper takes the kernel's vector route
when t_new and t_old are 16-byte aligned and the mask 4-byte aligned,
else its scalar route; ``corr_moments.routes`` counts the launches of
each.  Every call dispatches through ``obs.kprof.profiled`` as
``"corr_diff"``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build as B
from repro_torch.kernels.corr_diff.ref import corr_diff_ref
from repro_torch.obs.kprof import profiled

_ARGS = (B.P, B.P, B.P, B.I64, B.P, B.P, B.I32, B.I32, B.P, B.P)
BLOCKS_PER_SM = 8  # the most 256-thread blocks an SM holds: the partials' bound

_workspace: dict = {}


def _partials(device: torch.device, stream: int):
    """(ticket int32 (1,), partials float64 (3·blocks,), blocks) of the
    device and stream, zeroed when first made."""
    device = B.cuda_device(device)
    key = (device.index, stream)
    ws = _workspace.get(key)
    if ws is None:
        blocks = BLOCKS_PER_SM * B.sm_count(key[0])
        ws = _workspace[key] = (torch.zeros(1, dtype=torch.int32, device=device),
                                torch.zeros(3 * blocks, dtype=torch.float64, device=device),
                                blocks)
    return ws


def corr_moments(t_new: torch.Tensor, t_old: torch.Tensor, mask: torch.Tensor):
    """t_new, t_old (n,) f32; mask (n,) bool or int8 → (Σd, Σd², Σmask) as
    three 0-d float32 tensors."""
    dev = t_new.device
    n = t_new.shape[0] if t_new.dim() == 1 else -1
    B.check(t_new, "t_new", torch.float32, dev, (n,))
    B.check(t_old, "t_old", torch.float32, dev, (n,))
    if mask.dtype not in (torch.bool, torch.int8):
        raise TypeError(f"mask: dtype {mask.dtype}, expected torch.bool or torch.int8")
    B.check(mask, "mask", mask.dtype, dev, (n,))
    if dev.type == "cpu":
        return profiled("corr_diff", corr_diff_ref, t_new, t_old, mask, fallback=True, rows=n,
                        padded=n)
    B.check_cuda(dev)
    return profiled("corr_diff", _launch, t_new, t_old, mask, rows=n, padded=n)


def _launch(t_new: torch.Tensor, t_old: torch.Tensor, mask: torch.Tensor):
    dev = t_new.device
    n = t_new.shape[0]
    if n == 0:
        return torch.zeros(3, dtype=torch.float32, device=dev).unbind()
    out = torch.empty(3, dtype=torch.float32, device=dev)  # the last block writes all three
    card = dev.index
    stream = B.stream(card)
    ticket, partials, blocks = _partials(dev, stream)
    pn, po, pm = t_new.data_ptr(), t_old.data_ptr(), mask.data_ptr()
    vec = pn % 16 == 0 and po % 16 == 0 and pm % 4 == 0
    B.launch_on(card, "svc_corr_diff", _ARGS, pn, po, pm, n, partials.data_ptr(),
                ticket.data_ptr(), blocks, vec, out.data_ptr())
    corr_moments.launches += 1
    corr_moments.routes["vector" if vec else "scalar"] += 1
    return out.unbind()


corr_moments.launches = 0
corr_moments.routes = {"vector": 0, "scalar": 0}
