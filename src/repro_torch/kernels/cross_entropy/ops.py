"""The float32 cross-entropy over the vocabulary as a kernel pair, one
launch forward and one backward.

``cross_entropy_fwd(logits, labels)`` → (lse, nll), each float32 of the
labels' shape; ``cross_entropy_bwd(logits, labels, lse, g_lse, g_nll)`` →
the gradient of the logits, in their dtype; ``CrossEntropy`` is the
autograd Function around the two (``training.train_step.cross_entropy``
applies it to CUDA tensors).  The labels' rule is JAX's ``take_along_axis``
(``ref.py``).  JAX has no op name for either (XLA fuses its composition);
they dispatch through ``obs.kprof.profiled`` as ``"cross_entropy_fwd"``
and ``"cross_entropy_bwd"``.

CPU and meta tensors take the plain version (``ref.py``).  CUDA tensors
launch ``csrc/cross_entropy.cu`` or raise: ``svc_cross_entropy_fwd`` and
``svc_cross_entropy_bwd``, one block a row, for bfloat16 or float32
logits and int32 or int64 labels; each wrapper's ``launches`` counts one a
call.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build as B
from repro_torch.kernels.cross_entropy.ref import cross_entropy_bwd_ref, cross_entropy_ref
from repro_torch.obs.kprof import profiled

_FWD_ARGS = (B.P, B.I32, B.P, B.I32, B.P, B.P, B.I64, B.I32, B.P)
_BWD_ARGS = (B.P, B.I32, B.P, B.I32, B.P, B.P, B.P, B.P, B.I64, B.I32, B.P)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # the logits' dtypes the kernels take
LABEL_DTYPES = (torch.int32, torch.int64)


def _check(logits: torch.Tensor, labels: torch.Tensor) -> int:
    """The vocabulary V after checking logits (..., V) and labels (...)."""
    if not isinstance(logits, torch.Tensor) or logits.dim() < 1:
        raise ValueError(f"logits: expected a (..., V) tensor, got {getattr(logits, 'shape', logits)}")
    if logits.dtype not in DTYPES:
        raise TypeError(f"logits: dtype {logits.dtype}, expected one of {sorted(map(str, DTYPES))}")
    B.check(logits, "logits", logits.dtype, logits.device)
    if not isinstance(labels, torch.Tensor) or labels.dtype not in LABEL_DTYPES:
        raise TypeError(f"labels: expected an int32 or int64 tensor, got "
                        f"{getattr(labels, 'dtype', type(labels).__name__)}")
    B.check(labels, "labels", labels.dtype, logits.device, logits.shape[:-1])
    V = logits.shape[-1]
    if not 1 <= V < 2 ** 31:
        raise ValueError(f"logits: a vocabulary of {V}")
    return V


def _check_rows(what: str, t: torch.Tensor, labels: torch.Tensor) -> None:
    B.check(t, what, torch.float32, labels.device, labels.shape)


def cross_entropy_fwd(logits: torch.Tensor, labels: torch.Tensor):
    """logits (..., V) bfloat16 or float32, labels (...) int32 or int64,
    contiguous on one device → (lse, nll), each float32 (...)."""
    _check(logits, labels)
    n = labels.numel()
    if logits.device.type in ("cpu", "meta"):
        return profiled("cross_entropy_fwd", cross_entropy_ref, logits, labels, fallback=True,
                        rows=n, padded=n)
    B.check_cuda(logits.device)
    return profiled("cross_entropy_fwd", _launch_fwd, logits, labels, rows=n, padded=n)


def _launch_fwd(logits: torch.Tensor, labels: torch.Tensor):
    dev = logits.device
    lse = torch.empty(labels.shape, dtype=torch.float32, device=dev)
    nll = torch.empty_like(lse)
    n, V = labels.numel(), logits.shape[-1]
    if n:
        card = dev.index
        B.launch_on(card, "svc_cross_entropy_fwd", _FWD_ARGS, logits.data_ptr(),
                    DTYPES[logits.dtype], labels.data_ptr(), labels.element_size(),
                    lse.data_ptr(), nll.data_ptr(), n, V)
        cross_entropy_fwd.launches += 1
    return lse, nll


def cross_entropy_bwd(logits: torch.Tensor, labels: torch.Tensor, lse: torch.Tensor,
                      g_lse: torch.Tensor, g_nll: torch.Tensor) -> torch.Tensor:
    """The gradient of ``cross_entropy_fwd(logits, labels)``'s logits
    against g_lse and g_nll (float32, the labels' shape, contiguous), from
    the forward's ``lse``: a new tensor of the logits' shape and dtype."""
    _check(logits, labels)
    for what, t in (("lse", lse), ("g_lse", g_lse), ("g_nll", g_nll)):
        _check_rows(what, t, labels)
    n = labels.numel()
    if logits.device.type in ("cpu", "meta"):
        return profiled("cross_entropy_bwd", cross_entropy_bwd_ref, logits, labels, lse, g_lse,
                        g_nll, fallback=True, rows=n, padded=n)
    B.check_cuda(logits.device)
    return profiled("cross_entropy_bwd", _launch_bwd, logits, labels, lse, g_lse, g_nll,
                    rows=n, padded=n)


def _launch_bwd(logits, labels, lse, g_lse, g_nll) -> torch.Tensor:
    dev = logits.device
    dx = torch.empty_like(logits)
    n, V = labels.numel(), logits.shape[-1]
    if n:
        card = dev.index
        B.launch_on(card, "svc_cross_entropy_bwd", _BWD_ARGS, logits.data_ptr(),
                    DTYPES[logits.dtype], labels.data_ptr(), labels.element_size(),
                    lse.data_ptr(), g_lse.data_ptr(), g_nll.data_ptr(), dx.data_ptr(), n, V)
        cross_entropy_bwd.launches += 1
    return dx


class CrossEntropy(torch.autograd.Function):
    """``apply(logits, labels)`` → (lse, nll): its forward
    ``cross_entropy_fwd``, its backward ``cross_entropy_bwd`` (the labels
    take no gradient).  It keeps the logits for the backward, and no
    float32 copy of them."""

    @staticmethod
    def forward(ctx, logits, labels):
        lse, nll = cross_entropy_fwd(logits, labels)
        ctx.save_for_backward(logits, labels, lse)
        return lse, nll

    @staticmethod
    def backward(ctx, g_lse, g_nll):
        logits, labels, lse = ctx.saved_tensors
        # a mean's gradient comes expanded from a scalar (stride 0)
        return cross_entropy_bwd(logits, labels, lse, g_lse.contiguous(),
                                 g_nll.contiguous()), None


cross_entropy_fwd.launches = 0
cross_entropy_bwd.launches = 0
