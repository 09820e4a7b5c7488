"""AdamW over every trainable leaf in two multi-tensor launches: the global
norm with the step's scalars, then the update."""

from repro_torch.kernels.adamw.ops import adamw_apply, adamw_norm, launches_per_call, max_leaves
from repro_torch.kernels.adamw.ref import (
    Scalars,
    adamw_norm_ref,
    adamw_update_ref,
    cosine_schedule,
    global_norm,
)

__all__ = ["Scalars", "adamw_apply", "adamw_norm", "adamw_norm_ref", "adamw_update_ref",
           "cosine_schedule", "global_norm", "launches_per_call", "max_leaves"]
