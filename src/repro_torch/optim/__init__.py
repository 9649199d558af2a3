"""Optimizer of the port (counterpart of ``repro.optim``): AdamW, its
masks, the learning-rate schedules, and the int8 error-feedback
compression of the data-parallel gradient mean (``compression``; the
per-tensor int8 quantizer is ``core.quant``'s)."""
from repro_torch.optim.adamw import (
    AdamW, global_norm, path_str, reference_leaves, default_decay_mask,
    default_trainable_mask, linear_warmup_linear_decay,
    linear_warmup_cosine_decay,
)
from repro_torch.optim.compression import (
    quantize_int8, dequantize_int8, compressed_psum, compress_tree_psum,
    init_error_state,
)

__all__ = ["AdamW", "global_norm", "path_str", "reference_leaves",
           "default_decay_mask", "default_trainable_mask",
           "linear_warmup_linear_decay", "linear_warmup_cosine_decay",
           "quantize_int8", "dequantize_int8", "compressed_psum",
           "compress_tree_psum", "init_error_state"]
