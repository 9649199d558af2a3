"""Parameter initializers, fp32 (counterpart of ``repro.nn.initializers``),
drawn from an explicit ``torch.Generator`` on its device."""
from __future__ import annotations

import torch


def normal_init(generator, shape, stddev: float = 0.02,
                dtype=torch.float32):
    return torch.randn(shape, generator=generator, device=generator.device,
                       dtype=dtype) * stddev


def truncated_normal_init(generator, shape, stddev: float = 0.02,
                          dtype=torch.float32):
    """N(0, 1) truncated to [-2, 2], times ``stddev``."""
    x = torch.empty(shape, device=generator.device, dtype=dtype)
    return torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0,
                                       generator=generator) * stddev


def zeros_init(_generator, shape, dtype=torch.float32, *, device="cpu"):
    return torch.zeros(shape, dtype=dtype, device=device)


def ones_init(_generator, shape, dtype=torch.float32, *, device="cpu"):
    return torch.ones(shape, dtype=dtype, device=device)


def fanin_init(generator, shape, dtype=torch.float32):
    """LeCun normal on the penultimate dim (a matmul's fan-in)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    return torch.randn(shape, generator=generator, device=generator.device,
                       dtype=dtype) * fan_in ** -0.5
