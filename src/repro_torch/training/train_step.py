"""Train step: CE loss, microbatch gradient accumulation, mixed precision:
the port of ``repro.training.train_step``.

``make_train_step(model, opt_cfg)`` returns ``step(state, batch) ->
(state, metrics)``.  The model is ``get_model(cfg, train=True)``: float32
master leaves, each matrix cast to ``compute_dtype`` at its use, every
layer (or super-block) under ``layers.remat`` (``cfg.remat``).  Gradient
accumulation over microbatches sums the float32 ``.grad`` of each
microbatch's backward (JAX scans and sums) and divides.  The loss reads
``model.forward(params, batch)`` on the whole (micro)batch, as JAX's
``loss_fn`` does: ``frames`` reach the encdec forward, ``vision_embeds``
the vlm one.  The whole step,
the backward's products included, runs under ``layers.f32_accumulation``:
bf16 products accumulate in float32, as JAX's dots do.  Per-domain loss
sums are emitted as **SVC delta feeds**: the training loop ingests them
into ``data.pipeline.PipelineStats``' loss view.

``ctx`` (a ``models.parallel.ParallelCtx``, the dry run's) reaches the
model's forward and pins the logits through ``parallel.constrain``, as
JAX's step does.  On the meta device (the dry run's trace) the step runs
one microbatch's forward and backward counted ``microbatches`` times
(``obs.opcount.loop``), as JAX's analyzer counts its scan over
microbatches: nothing runs there, and every microbatch has one shape.

Differences from JAX, deliberate: the state is updated in place (the
parameters' module, ``m`` and ``v``; JAX's step is pure) and the returned
``TrainState`` holds the same tensors; the gradients stay in the leaves'
``.grad`` after the step.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.kernels.cross_entropy import CrossEntropy, cross_entropy_ref
from repro_torch.models.api import Model
from repro_torch.models.convert import jax_leaves
from repro_torch.models.layers import f32_accumulation
from repro_torch.models.parallel import P, constrain
from repro_torch.obs import opcount
from repro_torch.models.transformer import check_family
from repro_torch.training.optim import AdamWConfig, adamw_init, adamw_update

N_DOMAINS = 16  # the per-domain feed's width (JAX's n_dom)


@dataclasses.dataclass
class TrainState:
    params: Any  # the float32-master module
    opt_state: Dict
    step: torch.Tensor  # int32, 0-d


def trainable(params) -> Dict[str, torch.Tensor]:
    """The module's trainable leaves by name (the optimizer's tree)."""
    return {n: p for n, p in params.named_parameters() if p.requires_grad}


def init_train_state(model: Model, seed=0) -> TrainState:
    """Float32 masters drawn from ``seed`` (``model`` from ``get_model(cfg,
    train=True)``), zero AdamW states, step 0."""
    if not model.train:
        raise ValueError(f"{model.cfg.name}: init_train_state needs get_model(cfg, train=True)")
    params = model.init(seed)
    return TrainState(params=params, opt_state=adamw_init(trainable(params)),
                      step=torch.zeros((), dtype=torch.int32, device=model.device))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, z_loss: float = 1e-4):
    """Token-mean CE with z-loss, in float32; returns (loss, nll (B, S)).
    A label in [−V, 0) wraps to label + V and one out of range gives a NaN
    nll, as JAX's ``take_along_axis`` does.  CPU and meta tensors take the
    plain composition (``kernels.cross_entropy.ref``); CUDA tensors the
    kernel pair (``CrossEntropy``: one launch forward, one backward)."""
    if logits.device.type in ("cpu", "meta"):
        lse, nll = cross_entropy_ref(logits, labels)  # (B, S) each
    else:
        lse, nll = CrossEntropy.apply(logits.contiguous(), labels.contiguous())
    loss = nll.mean() + z_loss * (lse * lse).mean()
    return loss, nll


def _split_micro(batch: Dict[str, torch.Tensor], n: int):
    if any(v.shape[0] % n for v in batch.values()):
        raise ValueError(f"the batch's {next(iter(batch.values())).shape[0]} rows do not split "
                         f"into {n} microbatches")
    return [{k: v.chunk(n)[i] for k, v in batch.items()} for i in range(n)]


def make_train_step(model: Model, opt_cfg: AdamWConfig, ctx=None, microbatches: int = 1,
                    moe_balance_coeff: float = 1e-2) -> Callable:
    """``step(state, batch) -> (state, metrics)`` for ``model`` (from
    ``get_model(cfg, train=True)``) under ``ctx`` (None: one device); the
    step carries ``opt_cfg``."""
    cfg = model.cfg
    check_family(cfg)
    if microbatches < 1:
        raise ValueError(f"microbatches={microbatches}")

    def loss_fn(params, mb) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        logits, aux = model.forward(params, mb, ctx)
        if ctx is not None:
            logits = constrain(logits, ctx, P(ctx.dp_axes, None, ctx.tp_axis))
        loss, nll = cross_entropy(logits, mb["labels"])
        extras: Dict[str, torch.Tensor] = {}
        if cfg.moe_experts and aux.get("moe_load") is not None:
            load = aux["moe_load"]  # (L, E), no gradient (counts)
            frac = load / torch.clamp(load.sum(-1, keepdim=True), min=1.0)
            balance = (frac * frac).sum(-1).mean() * cfg.moe_experts
            loss = loss + moe_balance_coeff * balance
            extras["moe_load"] = load.sum(0)  # (E,) delta feed for SVC
            extras["moe_balance"] = balance
        if "domain" in mb:  # per-domain loss sums (SVC delta feed)
            with torch.no_grad():
                per_seq = nll.mean(-1)  # (B,)
                # one_hot's range check would read the device; an id outside
                # [0, 16) gets a zero row, as in JAX
                dom = mb["domain"].long()
                onehot = (dom[:, None] == torch.arange(N_DOMAINS, device=dom.device)).float()
                extras["domain_loss_sum"] = onehot.T @ per_seq
                extras["domain_count"] = onehot.sum(0)
        return loss, extras

    ranks: Dict[str, int] = {}  # JAX's leaf ranks, the decay rule's, read at the first step

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        params = state.params
        leaves = trainable(params)
        if not ranks:
            ranks.update((n, r) for n, (_k, _i, r) in jax_leaves(params).items())
        for p in leaves.values():
            p.grad = None
        with f32_accumulation(), torch.enable_grad():
            micro = _split_micro(batch, microbatches) if microbatches > 1 else [batch]
            trips = 1
            if next(iter(leaves.values())).device.type == "meta":
                micro, trips = micro[:1], len(micro)
            lsum, extras = None, {}
            with opcount.loop(trips, "microbatches"):
                for mb in micro:
                    loss, ex = loss_fn(params, mb)
                    loss.backward()  # .grad sums the microbatches' float32 gradients
                    loss = loss.detach()
                    lsum = loss if lsum is None else lsum + loss
                    extras = {k: extras[k] + v if k in extras else v for k, v in ex.items()}
            for p in leaves.values():
                if p.grad is None:  # a leaf the batch does not reach (JAX: zeros)
                    p.grad = torch.zeros_like(p)
                elif microbatches > 1:
                    p.grad.div_(microbatches)
            grads = {n: p.grad for n, p in leaves.items()}
            _, opt_state, opt_metrics = adamw_update(opt_cfg, leaves, grads, state.opt_state,
                                                     ranks)
        metrics = {"loss": lsum / microbatches, **opt_metrics, **extras}
        return TrainState(params, opt_state, state.step + 1), metrics

    train_step.opt_cfg = opt_cfg
    return train_step
