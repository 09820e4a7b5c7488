"""xlstm-1.3b [ssm] — arXiv:2405.04517 (unverified tier).

48L d_model=2048 4H d_ff=0 vocab=50304; alternating sLSTM + mLSTM blocks
(1 sLSTM per 8 layers).  d_ff=0: feed-forward capacity lives inside the
blocks (up-projection factor 2).  Sub-quadratic: O(1) matrix-memory decode.
"""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4, head_dim=512,
    d_ff=0, vocab=50304, act="swiglu",
    slstm_every=8, mlstm_heads=4, sub_quadratic=True,
    remat="full",
    source="arXiv:2405.04517; unverified",
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="xlstm-smoke", n_layers=4, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, slstm_every=2, mlstm_heads=4, vocab=512,
        compute_dtype="float32", remat="none",
    )
