"""seamless-m4t-large-v2 [audio] — arXiv:2308.11596 (hf tier).

24L (12 enc + 12 dec) d_model=1024 16H (kv=16) d_ff=8192 vocab=256206;
encoder-decoder.  The audio frontend is a STUB per spec: input_specs
provides precomputed frame embeddings (B, S_src, d_model) into the encoder.
"""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2", family="encdec",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=8192, vocab=256206, act="swiglu", rope_theta=10_000.0,
    enc_layers=12, dec_layers=12, audio_frontend=True,
    remat="full",
    source="arXiv:2308.11596; hf",
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="seamless-smoke", n_layers=4, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=128, vocab=512,
        enc_layers=2, dec_layers=2, compute_dtype="float32", remat="none",
    )
