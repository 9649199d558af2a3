"""Activation registry (``repro.nn.activations``).

The reference's ``jax.nn.gelu`` defaults to the tanh approximation, so
both ``"gelu"`` and ``"gelu_tanh"`` are the tanh form here too; torch's
default GELU is the erf form.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


def squared_relu(x):
    return torch.relu(x).square()


ACTIVATIONS = {
    "gelu": gelu_tanh,
    "gelu_tanh": gelu_tanh,
    "silu": F.silu,
    "relu": torch.relu,
    "squared_relu": squared_relu,
    "tanh": torch.tanh,
}
