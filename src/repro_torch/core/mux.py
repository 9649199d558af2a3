"""Multiplexers (Eq. 1-2 and Eq. 4-5; ``repro.core.mux``).

Input (N, B, L, D), N instances already grouped; output one superimposed
stream (B, L, D).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops
from repro_torch.nn.activations import gelu_tanh
from repro_torch.nn.attention import attention_core
from repro_torch.nn.layers import LayerNorm, Linear, normal


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


def _mini_encoder_layer_init(generator, d: int, n_heads: int):
    """One pre-LN transformer encoder layer used inside ContextualMux."""
    dev, dh = generator.device, d // n_heads
    return {
        "ln1": LayerNorm.init(dev, d),
        "wqkv": Linear.init(generator, d, (3, n_heads, dh), use_bias=False),
        "wo": Linear.init(generator, n_heads * dh, d, use_bias=False),
        "ln2": LayerNorm.init(dev, d),
        "w1": Linear.init(generator, d, 4 * d),
        "w2": Linear.init(generator, 4 * d, d),
    }


def _mini_encoder_layer_apply(p, x):
    """x (B, L, D): bidirectional self-attention + a tanh-GELU MLP, pre-LN
    residuals; the heads are ``wqkv``'s."""
    qkv = Linear.apply(p["wqkv"], LayerNorm.apply(p["ln1"], x))
    o = attention_core(qkv[..., 0, :, :], qkv[..., 1, :, :],
                       qkv[..., 2, :, :])
    x = x + Linear.apply(p["wo"], o.reshape(*o.shape[:2], -1))
    h = LayerNorm.apply(p["ln2"], x)
    return x + Linear.apply(p["w2"], gelu_tanh(Linear.apply(p["w1"], h)))


class ContextualMux:
    """Attention-based multiplexer (Eq. 4-5): TRANS_ctx contextualizes
    each instance along L; after the Hadamard with v^i, TRANS_inst attends
    across the N instances at every position; the result is the mean over
    N.  Plain PyTorch: no kernel."""

    @staticmethod
    def init(generator, n: int, d: int, *, n_heads: int = 8):
        return {"v": normal(generator, (n, d), 1.0),
                "trans_ctx": _mini_encoder_layer_init(generator, d, n_heads),
                "trans_inst": _mini_encoder_layer_init(generator, d,
                                                       n_heads)}

    @staticmethod
    def apply(p, x):
        n, b, l, d = x.shape
        h = _mini_encoder_layer_apply(p["trans_ctx"], x.reshape(n * b, l, d))
        g = h.reshape(n, b, l, d) * p["v"].to(x.dtype)[:, None, None, :]
        # attend across instances at each position: sequences of length N
        g = g.permute(1, 2, 0, 3).reshape(b * l, n, d)
        g = _mini_encoder_layer_apply(p["trans_inst"], g)
        return g.mean(dim=1).reshape(b, l, d)


def init_mux(generator, spec, d: int):
    if spec.mux_kind == "gaussian":
        return GaussianMux.init(generator, spec.n, d)
    return ContextualMux.init(generator, spec.n, d, n_heads=spec.ctx_heads)


def apply_mux(p, spec, x, *, use_kernel: bool = False):
    """use_kernel: the Gaussian mux through the mux-combine kernel; the
    contextual mux always runs plain."""
    if spec.mux_kind == "gaussian":
        return GaussianMux.apply(p, x, use_kernel=use_kernel)
    return ContextualMux.apply(p, x)
