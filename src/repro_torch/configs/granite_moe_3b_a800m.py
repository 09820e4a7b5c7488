"""granite-moe-3b-a800m [moe] — hf:ibm-granite (hf tier).

32L d_model=1536 24H (GQA kv=8) d_ff=512 vocab=49155; MoE 40 experts top-8.
NOTE: the assignment lists both "MoE 40e top-8" and "32 experts top-8"; we
take 40 experts / top-8 from the shape field (see DESIGN.md).
"""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, head_dim=64,
    d_ff=512, vocab=49155, act="swiglu", rope_theta=10_000.0,
    moe_experts=40, moe_top_k=8,
    remat="full",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf",
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="granite-moe-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=32, vocab=512,
        moe_experts=8, moe_top_k=2, compute_dtype="float32", remat="none",
    )
