"""Where an xlstm-1.3b mLSTM layer in bf16 on the card parts from the same layer on the CPU.

One mLSTM layer at xlstm-1.3b's widths (random weights from a seed) over
64 embedded tokens, once with cuBLAS allowed to reduce bf16 split-K partial
sums in bf16 (PyTorch's default) and once under ``f32_accumulation`` (as
every model entry point runs): for each stage, the largest |card − CPU|
over the largest |CPU| and the share of bit-equal values.  The stages after
the projections take the CPU's projections on both sides.  Needs a card:

    PYTHONPATH=src:tests python tests/torch_mlstm_card_precision.py
"""

from __future__ import annotations

import copy
import dataclasses
import json

import torch

from repro_torch.configs import get_config
from repro_torch.models import get_model, xlstm


def _stats(got, want) -> dict:
    got, want = got.float().cpu(), want.float().cpu()
    return {"rel": float((got - want).abs().max() / want.abs().max()),
            "same": float((got == want).float().mean())}


def stages(blk, cpu, x) -> dict:
    """Card against CPU for each stage of ``blk.full(x)``."""
    H = blk.cfg.mlstm_heads
    card_proj, cpu_proj = blk._proj(x), cpu._proj(x.cpu())
    out = {name: _stats(a, b) for name, a, b in zip(("xu", "gate", "itil", "logf"),
                                                      card_proj, cpu_proj)}
    xu, _, itil, logf = cpu_proj
    xh = xu.reshape(1, x.shape[1], H, -1)
    q, k, v = (torch.einsum("bshd,hde->bshe", xh, w) for w in (cpu.wq, cpu.wk, cpu.wv))
    dev = x.device
    out["q"] = _stats(torch.einsum("bshd,hde->bshe", xh.to(dev), blk.wq), q)
    out["parallel_form"] = _stats(
        xlstm.mlstm_parallel(*(t.to(dev) for t in (q, k, v, itil, logf))),
        xlstm.mlstm_parallel(q, k, v, itil, logf))
    out["layer"] = _stats(blk.full(x), cpu.full(x.cpu()))
    return out


def main(cfg=None, device="cuda") -> dict:
    """``cfg``: xlstm-1.3b cut to one super-block unless given."""
    from repro_torch.models.layers import f32_accumulation

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = cfg or dataclasses.replace(get_config("xlstm-1.3b"), n_layers=8)
    params = get_model(cfg, device=device).init(torch.Generator(device=device).manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (1, 64), device=device, dtype=torch.int32,
                         generator=torch.Generator(device=device).manual_seed(1))
    x = params.embed[toks.long()]
    blk = params.mlstm[0]
    cpu = copy.deepcopy(blk).cpu()
    matmul = torch.backends.cuda.matmul
    matmul.allow_bf16_reduced_precision_reduction = True
    out = {"bf16_reduced_precision_reduction": stages(blk, cpu, x)}
    with f32_accumulation():
        out["f32_accumulation"] = stages(blk, cpu, x)
    return out


if __name__ == "__main__":
    print(json.dumps(main()))
