"""Plain PyTorch version of the float32 cross-entropy over the vocabulary:
the port of the composition in ``repro.training.train_step.cross_entropy``
(``astype(f32)``, ``logsumexp``, ``take_along_axis``) and of its VJP.

``cross_entropy_ref(logits, labels) -> (lse, nll)``, both float32 of the
labels' shape; ``cross_entropy_bwd_ref(logits, labels, lse, g_lse, g_nll)``
the gradient of the logits against the two outputs' gradients, computed in
float32 and rounded once to the logits' dtype, as autograd of the forward
does.  Labels follow JAX's ``take_along_axis`` in its default fill mode: a
label in [−V, 0) wraps to label + V; one at or past V, or below −V, reads
no logit (its nll is NaN, and its row takes no gold term in the
gradient).  Nothing reads the labels on the host.
"""

from __future__ import annotations

import torch


def wrapped_labels(labels: torch.Tensor, V: int):
    """(labels as int64 with [−V, 0) wrapped to label + V, 0 where out of
    range; the in-range mask)."""
    lab = labels.long()
    lab = torch.where(lab < 0, lab + V, lab)
    ok = (lab >= 0) & (lab < V)
    return torch.where(ok, lab, 0), ok


def cross_entropy_ref(logits: torch.Tensor, labels: torch.Tensor):
    """logits (..., V), labels (...) integer → (lse, nll), each float32 (...)."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    lab, ok = wrapped_labels(labels, lf.shape[-1])
    gold = torch.gather(lf, -1, lab[..., None])[..., 0]
    nll = lse - torch.where(ok, gold, torch.nan)
    return lse, nll


def cross_entropy_bwd_ref(logits: torch.Tensor, labels: torch.Tensor, lse: torch.Tensor,
                          g_lse: torch.Tensor, g_nll: torch.Tensor) -> torch.Tensor:
    """The gradient of the logits: (g_lse + g_nll)·exp(x − lse) −
    g_nll·[j = label] in float32, in the logits' dtype."""
    lf = logits.float()
    d = (g_lse + g_nll)[..., None] * torch.exp(lf - lse[..., None])
    lab, ok = wrapped_labels(labels, lf.shape[-1])
    d.scatter_add_(-1, lab[..., None], torch.where(ok, -g_nll, 0.0)[..., None])
    return d.to(logits.dtype)
