"""phi3-mini-3.8b [dense] — arXiv:2404.14219 (unverified tier).

32L d_model=3072 32H (GQA kv=32 = MHA) d_ff=8192 vocab=32064; RoPE SwiGLU.
"""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi3-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32, head_dim=96,
    d_ff=8192, vocab=32064, act="swiglu", rope_theta=10_000.0,
    remat="full",
    source="arXiv:2404.14219; unverified",
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="phi3-mini-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=128, vocab=512, compute_dtype="float32", remat="none",
    )
