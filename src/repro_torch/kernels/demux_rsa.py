"""Fused RSA demux exit: the CUDA kernels (``csrc/demux_rsa.cu``) and the
plain PyTorch versions.

Counterpart of ``repro/kernels/demux_rsa.py`` (``demux_rsa``):

    out[n] = LN_exit( gelu_tanh( norm(h) @ W1h + k[n] @ W1k + b1 ) @ W2 + b2 )

``kb = k @ W1k + b1`` is a small (N, F) product left to ``torch.matmul``
outside the kernel, as the reference leaves it to XLA.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.nn.activations import gelu_tanh
from repro_torch.nn.layers import LayerNorm, RMSNorm


def demux_rsa_ref(h, k, w1h, w1k, b1, w2, b2):
    """h (T, D); k (N, D); w1h, w1k (D, F); b1 (F,); w2 (F, D); b2 (D,)
    -> (N, T, D) = gelu(h W1h + k W1k + b1) W2 + b2."""
    shared = h @ w1h
    kb = k @ w1k + b1[None]
    return gelu_tanh(shared[None] + kb[:, None]) @ w2 + b2


def demux_rsa_fused_ref(h, k, w1h, w1k, b1, w2, b2, *, entry_kind=None,
                        entry_scale=None, entry_bias=None, exit_scale=None,
                        exit_bias=None):
    """Backbone final norm (``entry_kind`` 'rms' / 'ln') -> RSA demux MLP
    -> demux LayerNorm, composed from the plain pieces."""
    if entry_kind == "rms":
        h = RMSNorm.apply({"scale": entry_scale}, h)
    elif entry_kind == "ln":
        h = LayerNorm.apply({"scale": entry_scale, "bias": entry_bias}, h)
    out = demux_rsa_ref(h, k, w1h, w1k, b1, w2, b2)
    if exit_scale is not None:
        out = LayerNorm.apply({"scale": exit_scale, "bias": exit_bias}, out)
    return out


ENTRY_KINDS = {None: 0, "rms": 1, "ln": 2}      # the source's kEntry*


def demux_rsa_cuda(h, k, w1h, w1k, b1, w2, b2, *, entry_kind=None,
                   entry_scale=None, entry_bias=None, exit_scale=None,
                   exit_bias=None):
    """Launch the demux kernels on (T, D) ``h``; arguments as
    ``demux_rsa_fused_ref`` (the LN entry needs ``entry_bias``)."""
    if h.device.type != "cuda":
        raise ValueError(f"the demux kernel runs on CUDA tensors, got "
                         f"{h.device}")
    if entry_kind not in ENTRY_KINDS:
        raise ValueError(f"entry_kind {entry_kind!r}: the kernel fuses "
                         "None, 'rms' or 'ln'")
    if entry_kind is not None and entry_scale is None:
        raise ValueError(f"entry_kind {entry_kind!r} needs entry_scale")
    if entry_kind == "ln" and entry_bias is None:
        raise ValueError("the LN entry needs entry_bias")
    if entry_kind != "ln":
        entry_bias = None
    t, d = h.shape
    n, f = k.shape[0], w1h.shape[1]
    ts = [h, k, w1h, w1k, b1, w2, b2]
    ts += [x for x in (entry_scale, entry_bias, exit_scale, exit_bias)
           if x is not None]
    for x in ts:
        if x.dtype != torch.float32 or x.device != h.device:
            raise ValueError(f"need fp32 on {h.device}, got {x.dtype} on "
                             f"{x.device}")
    if (tuple(w1h.shape) != (d, f) or tuple(w2.shape) != (f, d)
            or tuple(k.shape) != (n, d)):
        raise ValueError(f"shapes h {tuple(h.shape)} k {tuple(k.shape)} "
                         f"w1h {tuple(w1h.shape)} w2 {tuple(w2.shape)}")
    if (exit_scale is None) != (exit_bias is None):
        raise ValueError("exit_scale and exit_bias come together")
    h, w1h, w2, b2 = (x.contiguous() for x in (h, w1h, w2, b2))
    kb = (k @ w1k + b1[None]).contiguous()
    es = None if entry_kind is None else entry_scale.contiguous()
    eb = None if entry_bias is None else entry_bias.contiguous()
    xs = None if exit_scale is None else exit_scale.contiguous()
    xb = None if exit_bias is None else exit_bias.contiguous()
    lib = build.load("demux_rsa")
    split = lib.demux_rsa_split()

    def scratch(*shape):
        return torch.empty(shape, device=h.device, dtype=torch.float32)

    stats = scratch(t, 2) if entry_kind == "ln" else None
    zp, g = scratch(split, t, f), scratch(n, t, f)
    yp, out = scratch(split, n * t, d), scratch(n, t, d)

    def ptr(x):
        return None if x is None else x.data_ptr()

    err = lib.demux_rsa_forward(
        h.data_ptr(), ptr(es), ptr(eb), w1h.data_ptr(), kb.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), ptr(xs), ptr(xb), ptr(stats),
        zp.data_ptr(), g.data_ptr(), yp.data_ptr(), out.data_ptr(),
        ENTRY_KINDS[entry_kind], t, n, d, f,
        torch.cuda.current_stream(h.device).cuda_stream)
    build.check(err, "demux_rsa kernels")
    return out
