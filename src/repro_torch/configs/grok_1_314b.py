"""grok-1-314b [moe] — hf:xai-org/grok-1 (unverified tier).

64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072; 8 experts top-2.
"""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=32768, vocab=131072, act="swiglu", rope_theta=10_000.0,
    moe_experts=8, moe_top_k=2,
    remat="full",
    source="hf:xai-org/grok-1; unverified",
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="grok-1-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, vocab=512,
        moe_experts=4, moe_top_k=2, compute_dtype="float32", remat="none",
    )
