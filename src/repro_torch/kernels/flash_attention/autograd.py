"""The gradient of ``flash_attention``: autograd through its plain version.

The JAX package has no attention backward to port: its flash kernel has
none and is on no training path, and JAX's trainer differentiates the
model's XLA attention (``gqa_attention``) with autodiff.  So the port's
``FlashAttention`` launches the CUDA kernel in its forward (one launch,
counted and profiled as ``"flash_attention"``, as without grad) and saves
q, k, v and the mask; its backward recomputes ``flash_attention_ref`` on
the saved inputs with grad on and returns ``torch.autograd.grad`` of it:
the gradient XLA's autodiff of the model's attention computes, with P
kept in float32 (JAX rounds it to the value dtype; ROADMAP C).  The
backward is plain PyTorch on the card too, so it dispatches through
``profiled`` under its own op, ``"flash_attention_bwd"`` (which JAX does
not have), as a kernel dispatch (``fallback=False``), and adds nothing
to ``flash_attention.launches``.  Its products run on float32 copies of
the inputs, so no bf16 product rounds inside it.  The recompute of the
forward runs under ``obs.opcount.aside()``: the dry run's analysis counts
the function's gradient (four products, as XLA's autodiff of the
attention), and this implementation's recompute apart.  A hand-written
backward kernel is a later redesign.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.obs import opcount
from repro_torch.obs.kprof import profiled


def flash_attention_bwd(q, k, v, grad_out, causal: bool = True, window: int = 0,
                        key_pos: Optional[torch.Tensor] = None, qpos: int = 0,
                        need: Tuple[bool, bool, bool] = (True, True, True)):
    """(dq, dk, dv) of ``flash_attention(q, k, v, ...)`` against
    ``grad_out`` (None where ``need`` says no), each in its input's dtype."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(n) for t, n in zip((q, k, v), need)]
        with opcount.aside():
            out = flash_attention_ref(*ins, causal, window, key_pos, qpos)
        got = iter(torch.autograd.grad(out, [t for t in ins if t.requires_grad], grad_out))
    return tuple(next(got) if n else None for n in need)


class FlashAttention(torch.autograd.Function):
    """``apply(dispatch, q, k, v, causal, window, key_pos, qpos)``:
    ``dispatch`` is the wrapper's own forward (the kernel's launch on the
    card, the plain version on the CPU)."""

    @staticmethod
    def forward(ctx, dispatch, q, k, v, causal, window, key_pos, qpos):
        ctx.save_for_backward(q, k, v, key_pos)
        ctx.mask = (causal, window, qpos)
        return dispatch(q, k, v, causal, window, key_pos, qpos)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, key_pos = ctx.saved_tensors
        causal, window, qpos = ctx.mask
        rows = q.shape[0] * q.shape[1]
        dq, dk, dv = profiled("flash_attention_bwd", flash_attention_bwd, q, k, v, grad_out,
                              causal, window, key_pos, qpos, tuple(ctx.needs_input_grad[1:4]),
                              fallback=False, rows=rows, padded=rows)
        return None, dq, dk, dv, None, None, None, None
