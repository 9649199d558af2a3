"""RSA demultiplexer (Eq. 6; ``repro.core.demux.RSADemux``).

Output (N, B, L, D), one recovered stream per instance.  The MLP on
[h ; k_i] runs in split form, W1 @ [h ; k_i] = W1h @ h + W1k @ k_i, so the
h projection is shared by the N instances.
"""
from __future__ import annotations

import torch

from repro_torch.nn.activations import gelu_tanh
from repro_torch.nn.layers import LayerNorm, Linear, normal


class RSADemux:
    """h^i = LN(MLP([h_mux ; k^i])) with learned private keys k^i."""

    @staticmethod
    def init(generator, n: int, d: int, d_hidden: int):
        dev = generator.device
        return {
            "k": normal(generator, (n, d), 1.0),
            "w1h": Linear.init(generator, d, d_hidden, use_bias=True),
            "w1k": Linear.init(generator, d, d_hidden, use_bias=False),
            "w2": Linear.init(generator, d_hidden, d, use_bias=True),
            "ln": LayerNorm.init(dev, d),
        }

    @staticmethod
    def apply(p, h):
        """Plain path. h: (B, L, D) -> (N, B, L, D)."""
        shared = Linear.apply(p["w1h"], h)
        kb = p["k"].to(h.dtype) @ p["w1k"]["w"].to(h.dtype)
        z = gelu_tanh(shared[None] + kb[:, None, None, :])
        return LayerNorm.apply(p["ln"], Linear.apply(p["w2"], z))

    @staticmethod
    def apply_fused(p, h, *, final_norm, norm_kind: str):
        """Fused exit: backbone final norm + demux MLP + demux LayerNorm
        through the ``demux_rsa`` kernel.  h: the un-normed backbone
        hidden state (B, L, D) -> (N, B, L, D)."""
        from repro_torch.kernels import ops as kops
        entry = {"entry_kind": norm_kind, "entry_scale": final_norm["scale"]}
        if norm_kind == "ln":
            entry["entry_bias"] = final_norm.get(
                "bias", torch.zeros_like(final_norm["scale"]))
        dt = h.dtype
        return kops.demux_rsa(
            h, p["k"].to(dt), p["w1h"]["w"].to(dt), p["w1k"]["w"].to(dt),
            p["w1h"]["b"].to(dt), p["w2"]["w"].to(dt), p["w2"]["b"].to(dt),
            exit_scale=p["ln"]["scale"], exit_bias=p["ln"]["bias"], **entry)
