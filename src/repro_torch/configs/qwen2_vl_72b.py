"""qwen2-vl-72b [vlm] — arXiv:2409.12191 (hf tier).

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064; M-RoPE, dynamic
resolution.  The vision frontend is a STUB per spec: input_specs provides
precomputed patch embeddings occupying the first n_vision_tokens positions.
"""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=29568, vocab=152064, act="swiglu", rope_theta=1_000_000.0,
    m_rope=True, mrope_sections=(16, 24, 24), n_vision_tokens=256,
    remat="full",
    source="arXiv:2409.12191; hf",
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="qwen2-vl-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, vocab=512,
        mrope_sections=(2, 3, 3), n_vision_tokens=4, compute_dtype="float32", remat="none",
    )
