"""Demultiplexers (Eq. 3 prefix baseline, Eq. 6 RSA keys;
``repro.core.demux``).

Output (N, B, L, D), one recovered stream per instance.  Both MLPs on
[h ; key_i] run in split form, W1 @ [h ; key_i] = W1h @ h + W1k @ key_i,
so the h projection is shared by the N instances.
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


class PrefixDemux:
    """T-MUX baseline (Eq. 3): N prefix positions carry instance
    signatures.  The engine prepends the N prefix embeddings to the
    mux'd stream before the backbone; ``apply`` computes
    h^i_j = LN(MLP([h_j ; p^i])) with p^i the backbone's output at prefix
    position i.  Plain PyTorch: no kernel."""

    @staticmethod
    def init(generator, n: int, d: int, d_hidden: int):
        return {
            "prefix_emb": normal(generator, (n, d), 0.02),
            "w1h": Linear.init(generator, d, d_hidden, use_bias=True),
            "w1p": Linear.init(generator, d, d_hidden, use_bias=False),
            "w2": Linear.init(generator, d_hidden, d, use_bias=True),
            "ln": LayerNorm.init(generator.device, d),
        }

    @staticmethod
    def prefix(p, b: int, dtype):
        """(B, N, D) prefix embeddings to prepend to the mux'd stream."""
        return p["prefix_emb"].to(dtype)[None].expand(b, -1, -1)

    @staticmethod
    def apply(p, h_with_prefix, n: int):
        """(B, N+L, D) -> (N, B, L, D)."""
        pfx, h = h_with_prefix[:, :n], h_with_prefix[:, n:]
        shared = Linear.apply(p["w1h"], h)                  # (B, L, F)
        pb = Linear.apply(p["w1p"], pfx)                    # (B, N, F)
        z = gelu_tanh(shared[None] + pb.transpose(0, 1)[:, :, None, :])
        return LayerNorm.apply(p["ln"], Linear.apply(p["w2"], z))


def init_demux(generator, spec, d: int):
    dh = spec.demux_hidden or 2 * d
    if spec.demux_kind == "rsa":
        return RSADemux.init(generator, spec.n, d, dh)
    return PrefixDemux.init(generator, spec.n, d, dh)


def apply_demux(p, spec, h):
    """The plain demux of either kind: (B, L', D) -> (N, B, L, D)."""
    if spec.demux_kind == "rsa":
        return RSADemux.apply(p, h)
    return PrefixDemux.apply(p, h, spec.n)
