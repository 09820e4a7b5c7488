"""gemma-2b [dense] — arXiv:2403.08295 (hf tier).

18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=256000; GeGLU head_dim=256.
"""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma-2b", family="dense",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
    d_ff=16384, vocab=256_000, act="geglu", rope_theta=10_000.0,
    remat="full",
    source="arXiv:2403.08295; hf",
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="gemma-2b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=1, head_dim=32, d_ff=128, vocab=512, compute_dtype="float32", remat="none",
    )
