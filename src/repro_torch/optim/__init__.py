"""Optimizer of the port (counterpart of ``repro.optim``): AdamW, its
masks and the learning-rate schedules.  The reference's int8 gradient
compression for data-parallel all-reduce waits with its collectives
(ROADMAP §1 item 15); per-tensor int8 is ``core.quant``."""
from repro_torch.optim.adamw import (
    AdamW, global_norm, path_str, reference_leaves, default_decay_mask,
    default_trainable_mask, linear_warmup_linear_decay,
    linear_warmup_cosine_decay,
)

__all__ = ["AdamW", "global_norm", "path_str", "reference_leaves",
           "default_decay_mask", "default_trainable_mask",
           "linear_warmup_linear_decay", "linear_warmup_cosine_decay"]
