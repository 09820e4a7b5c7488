from repro_torch.kernels.fused_clean.ops import fused_clean_groupby
from repro_torch.kernels.fused_clean.ref import fused_clean_ref

__all__ = ["fused_clean_groupby", "fused_clean_ref"]
