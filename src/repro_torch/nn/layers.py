"""Core layers: Linear, Embedding, LayerNorm, RMSNorm (``repro.nn.layers``).

``init(generator, ...)`` draws from an explicit ``torch.Generator`` on the
generator's device; ``apply`` casts params to the input's dtype.
"""
from __future__ import annotations

import torch


def rounded(x: float, dtype) -> float:
    """The Python scalar ``x`` rounded to ``dtype``: a tensor times it
    then multiplies by the value the reference's scalar takes in that
    dtype (a weakly typed scalar, or ``jnp.asarray(x, dtype)``), where
    PyTorch would apply ``x`` at fp32 precision to a bf16 tensor."""
    return float(torch.tensor(x, dtype=dtype))


def normal(generator, shape, stddev: float):
    return torch.randn(shape, generator=generator,
                       device=generator.device) * stddev


class Linear:
    """y = x @ w (+ b).  w: (in, out) or (in, *outs) for fused projections."""

    @staticmethod
    def init(generator, d_in: int, d_out, *, use_bias: bool = True,
             stddev: float = 0.02):
        out_shape = (d_out,) if isinstance(d_out, int) else tuple(d_out)
        p = {"w": normal(generator, (d_in, *out_shape), stddev)}
        if use_bias:
            p["b"] = torch.zeros(out_shape, device=generator.device)
        return p

    @staticmethod
    def apply(p, x):
        w = p["w"].to(x.dtype)
        y = torch.tensordot(x, w, dims=1) if w.ndim > 2 else x @ w
        if "b" in p:
            y = y + p["b"].to(x.dtype)
        return y


class Embedding:
    """Token embedding with tied-softmax logits (``attend``)."""

    @staticmethod
    def init(generator, vocab: int, d: int, *, stddev: float = 0.02):
        return {"table": normal(generator, (vocab, d), stddev)}

    @staticmethod
    def apply(p, ids, dtype=torch.float32):
        return p["table"][ids].to(dtype)

    @staticmethod
    def attend(p, x):
        """(..., d) @ (d, vocab)."""
        return x @ p["table"].to(x.dtype).T


class LayerNorm:
    @staticmethod
    def init(device, d: int):
        return {"scale": torch.ones(d, device=device),
                "bias": torch.zeros(d, device=device)}

    @staticmethod
    def apply(p, x, *, eps: float = 1e-6):
        x32 = x.float()
        mu = x32.mean(-1, keepdim=True)
        var = (x32 - mu).square().mean(-1, keepdim=True)
        y = (x32 - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].float()
        if "bias" in p:
            y = y + p["bias"].float()
        return y.to(x.dtype)


class RMSNorm:
    """Gemma-style ``x * rsqrt(mean(x^2) + eps) * (1 + scale)`` — not
    ``torch.nn.RMSNorm``, whose weight multiplies without the 1 + offset."""

    @staticmethod
    def init(device, d: int):
        return {"scale": torch.zeros(d, device=device)}

    @staticmethod
    def apply(p, x, *, eps: float = 1e-6):
        x32 = x.float()
        var = x32.square().mean(-1, keepdim=True)
        y = x32 * torch.rsqrt(var + eps)
        y = y * (1.0 + p["scale"].float())
        return y.to(x.dtype)


def dropout(generator, x, rate: float, *, deterministic: bool):
    """Inverted dropout drawn from ``generator`` (on x's device).  As in the
    reference, no model's forward calls it (``ModelConfig.dropout`` is
    read by no block)."""
    if deterministic or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))
