"""Activation registry (``repro.nn.activations``).

The reference's ``jax.nn.gelu`` defaults to the tanh approximation, so
both ``"gelu"`` and ``"gelu_tanh"`` are the tanh form here too; torch's
default GELU is the erf form.  In fp32 the GELU and SiLU are torch's
fused ops; below fp32 they are the reference's own compositions, each
op rounded to the dtype as JAX rounds it, where the fused ops round once
and sit a bf16 ulp away at ~44% (GELU) and ~40% (SiLU) of elements.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.nn.layers import rounded


def gelu_tanh(x):
    """``jax.nn.gelu(x, approximate=True)``: below fp32 its composition
    x * 0.5 * (1 + tanh(sqrt(2 / pi) * (x + 0.044715 x^3))), its constants
    at their values in x's dtype."""
    if x.dtype == torch.float32:
        return F.gelu(x, approximate="tanh")
    inner = x + x ** 3 * rounded(0.044715, x.dtype)
    c = rounded(math.sqrt(2 / math.pi), x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(c * inner)))


def silu(x):
    """``jax.nn.silu``, x * sigmoid(x): below fp32 the sigmoid is 1 / (1 +
    exp(-x)) with each op rounded, as the reference's CPU runs compute
    ``lax.logistic`` in bf16, and the product rounds again."""
    if x.dtype == torch.float32:
        return F.silu(x)
    return x * (1.0 / (1.0 + torch.exp(-x)))


def squared_relu(x):
    return torch.relu(x).square()


ACTIVATIONS = {
    "gelu": gelu_tanh,
    "gelu_tanh": gelu_tanh,
    "silu": silu,
    "relu": torch.relu,
    "squared_relu": squared_relu,
    "tanh": torch.tanh,
}
