"""Architecture registry: the 10 assigned archs (a copy of ``repro.configs``).

``get_config(arch_id)`` / ``get_smoke_config(arch_id)`` accept the public
ids (e.g. "phi3-mini-3.8b") used by ``--arch`` on every launcher.
"""

from repro_torch.configs.base import (
    ALL_SHAPES,
    DECODE_32K,
    LONG_500K,
    PREFILL_32K,
    TRAIN_4K,
    ArchConfig,
    ShapeCell,
    shape_applicable,
)
from repro_torch.configs import (
    gemma_2b,
    gemma_7b,
    granite_3_2b,
    granite_moe_3b_a800m,
    grok_1_314b,
    phi3_mini_3_8b,
    qwen2_vl_72b,
    recurrentgemma_9b,
    seamless_m4t_large_v2,
    xlstm_1_3b,
)

_MODULES = {
    "phi3-mini-3.8b": phi3_mini_3_8b,
    "gemma-2b": gemma_2b,
    "gemma-7b": gemma_7b,
    "granite-3-2b": granite_3_2b,
    "qwen2-vl-72b": qwen2_vl_72b,
    "grok-1-314b": grok_1_314b,
    "granite-moe-3b-a800m": granite_moe_3b_a800m,
    "recurrentgemma-9b": recurrentgemma_9b,
    "xlstm-1.3b": xlstm_1_3b,
    "seamless-m4t-large-v2": seamless_m4t_large_v2,
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str) -> ArchConfig:
    return _MODULES[arch_id].CONFIG


def get_smoke_config(arch_id: str) -> ArchConfig:
    return _MODULES[arch_id].smoke()
