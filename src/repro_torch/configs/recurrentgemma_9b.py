"""recurrentgemma-9b [hybrid] — arXiv:2402.19427 (unverified tier).

38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000; RG-LRU + local
attention in a (rec, rec, attn) pattern (1:2), window 2048.  Sub-quadratic:
eligible for long_500k (ring-buffer KV of width=window, O(1) rec state).
38 = 12 super-blocks × 3 + 2 trailing rec layers.
"""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, head_dim=256,
    d_ff=12288, vocab=256_000, act="geglu", rope_theta=10_000.0,
    attn_window=2048, block_pattern=("rec", "rec", "attn"),
    sub_quadratic=True,
    remat="full",
    source="arXiv:2402.19427; unverified",
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="recurrentgemma-smoke", n_layers=5, d_model=64, n_heads=4,
        n_kv_heads=1, head_dim=16, d_ff=128, vocab=512, attn_window=16,
        compute_dtype="float32", remat="none",
    )
