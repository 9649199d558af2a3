"""Functional layers on tensors (counterpart of ``repro.nn``).

Params are nested dicts of fp32 tensors with the reference's layouts
(``(in, out)`` weights); every layer is an ``init``/``apply`` pair of
plain functions.
"""
from repro_torch.nn.layers import Linear, Embedding, LayerNorm, RMSNorm
from repro_torch.nn.rope import rope_frequencies, apply_rope
from repro_torch.nn.attention import (NEG_INF, attention_core,
                                      chunked_attention_core,
                                      make_attention_mask,
                                      multi_head_attention)
from repro_torch.nn.activations import ACTIVATIONS, gelu_tanh

__all__ = ["Linear", "Embedding", "LayerNorm", "RMSNorm",
           "rope_frequencies", "apply_rope", "NEG_INF", "attention_core",
           "chunked_attention_core", "make_attention_mask",
           "multi_head_attention", "ACTIVATIONS", "gelu_tanh"]
