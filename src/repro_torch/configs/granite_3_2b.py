"""granite-3-2b [dense] — hf:ibm-granite/granite-3.0-2b-base (hf tier).

40L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=49155.
"""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-3-2b", family="dense",
    n_layers=40, d_model=2048, n_heads=32, n_kv_heads=8, head_dim=64,
    d_ff=8192, vocab=49155, act="swiglu", rope_theta=10_000.0,
    remat="full",
    source="hf:ibm-granite/granite-3.0-2b-base; hf",
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="granite-3-2b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, vocab=512, compute_dtype="float32", remat="none",
    )
