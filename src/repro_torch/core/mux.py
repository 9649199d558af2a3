"""Gaussian multiplexer (Eq. 1-2; ``repro.core.mux.GaussianMux``).

Input (N, B, L, D), N instances already grouped; output (B, L, D).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops
from repro_torch.nn.layers import normal


class GaussianMux:
    """x_mux = (1/N) sum_i x^i ⊙ v^i,  v^i ~ N(0, I) fixed."""

    @staticmethod
    def init(generator, n: int, d: int):
        return {"v": normal(generator, (n, d), 1.0)}

    @staticmethod
    def apply(p, x, *, use_kernel: bool = False):
        """use_kernel: through ``kernels.ops.mux_combine`` (the CUDA
        kernel on CUDA tensors, its plain version on the CPU) over the
        (N, B*L, D) view; else the einsum."""
        v = p["v"].to(x.dtype)
        if use_kernel:
            n, b, l, d = x.shape
            return kops.mux_combine(x.reshape(n, b * l, d), v).reshape(b, l,
                                                                       d)
        return torch.einsum("nbld,nd->bld", x, v) / x.shape[0]
