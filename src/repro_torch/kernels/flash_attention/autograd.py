"""The gradient of ``flash_attention``: a hand-written kernel on the card,
autograd through the plain version elsewhere.

The JAX package has no attention backward to port: its flash kernel has
none and is on no training path, and JAX's trainer differentiates the
model's XLA attention (``gqa_attention``) with autodiff.  The port's
``FlashAttention`` computes that gradient.

On the card its forward is the wrapper's one launch (counted and profiled
as ``"flash_attention"``, as without grad) with the ``lse`` output on: the
same kernel also writes each row's log-sum-exp.  It saves q, k, v, the
output, lse and ``key_pos``; its backward calls ``ops.flash_attention_bwd``,
which launches ``csrc/flash_attention_bwd.cu`` (counted in its own
``launches``, profiled as ``"flash_attention_bwd"``, an op JAX does not
have) and raises if the build or the launch fails: nothing falls back to
the plain version.  In bf16 the kernel rounds P and dS to bf16 as the
operands of its products (f32 accumulation); in float32 it runs on the
CUDA cores without TF32.

On CPU and meta tensors (the tests and the dry run's trace) the forward
is the plain version, which saves q, k, v and the mask, and the backward
(``plain_grad``) recomputes ``flash_attention_ref`` with grad on and
returns ``torch.autograd.grad`` of it: the gradient XLA's autodiff of the
model's attention computes, with P kept in float32 (JAX rounds it to the
value dtype; ROADMAP C), dispatched through ``profiled`` as
``"flash_attention_bwd"`` with ``fallback=False``.  Its products run on
float32 copies of the inputs.  The recompute of the forward runs under
``obs.opcount.aside()``: the dry run's analysis counts the function's
gradient (four products, as XLA's autodiff of the attention), and this
implementation's recompute apart.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.obs import opcount
from repro_torch.obs.kprof import profiled


def plain_grad(q, k, v, grad_out, causal: bool = True, window: int = 0,
               key_pos: Optional[torch.Tensor] = None, qpos: int = 0,
               need: Tuple[bool, bool, bool] = (True, True, True)):
    """(dq, dk, dv) of ``flash_attention_ref(q, k, v, ...)`` against
    ``grad_out`` by autograd (None where ``need`` says no), each in its
    input's dtype."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(n) for t, n in zip((q, k, v), need)]
        with opcount.aside():
            out = flash_attention_ref(*ins, causal, window, key_pos, qpos)
        got = iter(torch.autograd.grad(out, [t for t in ins if t.requires_grad], grad_out))
    return tuple(next(got) if n else None for n in need)


class FlashAttention(torch.autograd.Function):
    """``apply(dispatch, backward, q, k, v, causal, window, key_pos, qpos)``:
    ``dispatch`` is the wrapper's own forward (the kernel's launch on the
    card, with an ``lse`` output; the plain version on the CPU and the meta
    device), ``backward`` the backward's wrapper (``ops.flash_attention_bwd``)."""

    @staticmethod
    def forward(ctx, dispatch, backward, q, k, v, causal, window, key_pos, qpos):
        ctx.mask = (causal, window, qpos)
        ctx.backward_fn = backward
        if q.device.type != "cuda":
            ctx.save_for_backward(q, k, v, key_pos)
            return dispatch(q, k, v, causal, window, key_pos, qpos)
        lse = torch.empty((q.shape[0], q.shape[2], q.shape[1]), dtype=torch.float32,
                          device=q.device)
        out = dispatch(q, k, v, causal, window, key_pos, qpos, lse)
        ctx.save_for_backward(q, k, v, key_pos, out, lse)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        causal, window, qpos = ctx.mask
        need = tuple(ctx.needs_input_grad[2:5])
        saved = ctx.saved_tensors  # unpacked once (a remat recompute allows no more)
        if len(saved) == 6:  # the card: the kernel
            q, k, v, key_pos, out, lse = saved
            grads = ctx.backward_fn(q, k, v, out, lse, grad_out.contiguous(), causal, window,
                                    key_pos, qpos)
            dq, dk, dv = (g if n else None for g, n in zip(grads, need))
        else:
            q, k, v, key_pos = saved
            rows = q.shape[0] * q.shape[1]
            dq, dk, dv = profiled("flash_attention_bwd", plain_grad, q, k, v, grad_out, causal,
                                  window, key_pos, qpos, need, fallback=False, rows=rows,
                                  padded=rows)
        return None, None, dq, dk, dv, None, None, None, None
