"""Fused embed + Gaussian mux-combine entry: the Triton kernel and its
plain PyTorch version.

    out[t] = (scale / N) * sum_i emb[tokens[i, t]] ⊙ v[i]

Replaces the Pallas TPU kernel ``repro/kernels/mux_embed.py``
(``mux_embed_combine``).  Bound: bytes — N gathered embedding rows, the N
keys and one output row per token, with no matrix product; the work is a
gather, an elementwise product and a sum over N <= 8.  Design: one Triton
program per (token, 512-wide slice of D); it loads the N token ids itself,
gathers the rows straight from the embedding table and accumulates in
fp32 registers, so no (N, T, D) intermediate is ever written.  Triton is
imported, and the kernel compiled, at first launch.
"""
from __future__ import annotations

import functools
import os

import torch

from repro_torch.kernels import build

BLOCK_D = 512


def mux_embed_ref(tokens, emb, v, *, scale=1.0):
    """tokens (N, T) int; emb (V, D); v (N, D) -> (T, D)."""
    x = emb[tokens.long()]
    return torch.einsum("ntd,nd->td", x, v) * (scale / tokens.shape[0])


@functools.cache
def _triton_kernel():
    os.environ.setdefault("TRITON_CACHE_DIR",
                          str(build.BUILD / "triton-cache"))
    import triton
    import triton.language as tl

    @triton.jit
    def mux_embed_kernel(tok_ptr, emb_ptr, v_ptr, out_ptr, T, D, coef,
                         N: tl.constexpr, BLOCK: tl.constexpr):
        t = tl.program_id(0)
        offs = tl.program_id(1) * BLOCK + tl.arange(0, BLOCK)
        m = offs < D
        acc = tl.zeros([BLOCK], dtype=tl.float32)
        for i in tl.static_range(N):
            tok = tl.load(tok_ptr + i * T + t).to(tl.int64)
            e = tl.load(emb_ptr + tok * D + offs, mask=m, other=0.0)
            w = tl.load(v_ptr + i * D + offs, mask=m, other=0.0)
            acc += e * w
        tl.store(out_ptr + t * D + offs, acc * coef, mask=m)

    return triton, mux_embed_kernel


def mux_embed_combine_cuda(tokens, emb, v, *, scale=1.0):
    """Launch the Triton kernel; arguments as ``mux_embed_ref``.  Token ids
    must be in range (the model clamps inactive rows' ids to 0)."""
    if emb.device.type != "cuda":
        raise ValueError(f"the mux-embed kernel runs on CUDA tensors, got "
                         f"{emb.device}")
    n, t = tokens.shape
    vocab, d = emb.shape
    if emb.dtype != torch.float32 or v.dtype != torch.float32:
        raise ValueError(f"need fp32 emb / v, got {emb.dtype} / {v.dtype}")
    if tuple(v.shape) != (n, d) or v.device != emb.device:
        raise ValueError(f"v {tuple(v.shape)} on {v.device}, want ({n}, {d})"
                         f" on {emb.device}")
    tokens = tokens.to(device=emb.device, dtype=torch.int32).contiguous()
    emb, v = emb.contiguous(), v.contiguous()
    out = torch.empty((t, d), device=emb.device, dtype=torch.float32)
    triton, kernel = _triton_kernel()
    kernel[(t, triton.cdiv(d, BLOCK_D))](
        tokens, emb, v, out, t, d, float(scale / n), N=n, BLOCK=BLOCK_D,
        num_warps=4)
    return out
