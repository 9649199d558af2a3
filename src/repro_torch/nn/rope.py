"""Rotary position embeddings, half-rotation convention (``repro.nn.rope``)."""
from __future__ import annotations

import torch


def rope_frequencies(head_dim: int, positions, *, theta: float = 10000.0):
    """(sin, cos) of shape (*positions.shape, head_dim // 2), fp32."""
    half = head_dim // 2
    exponent = -torch.arange(0, half, dtype=torch.float32,
                             device=positions.device) / half
    freq = torch.pow(float(theta), exponent)    # no host-to-device copy
    ang = positions.float()[..., None] * freq
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x, sin, cos):
    """x: (..., L, H, D); sin/cos: (..., L, D // 2), broadcast over heads."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    sin = sin[..., None, :].to(x.dtype)
    cos = cos[..., None, :].to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
