"""Gaussian multiplexer (Eq. 1-2; ``repro.core.mux.GaussianMux``).

Input (N, B, L, D), N instances already grouped; output (B, L, D).
"""
from __future__ import annotations

import torch

from repro_torch.nn.layers import normal


class GaussianMux:
    """x_mux = (1/N) sum_i x^i ⊙ v^i,  v^i ~ N(0, I) fixed."""

    @staticmethod
    def init(generator, n: int, d: int):
        return {"v": normal(generator, (n, d), 1.0)}

    @staticmethod
    def apply(p, x):
        v = p["v"].to(x.dtype)
        return torch.einsum("nbld,nd->bld", x, v) / x.shape[0]
