"""Fused embed + Gaussian mux-combine entry: the CUDA kernel
(``csrc/mux_entry.cu``, ``mux_embed_kernel``) and its plain PyTorch
version.

    out[t] = (scale / N) * sum_i emb[tokens[i, t]] ⊙ v[i]

Counterpart of ``repro/kernels/mux_embed.py`` (``mux_embed_combine``):
emb and v fp32 or bf16, the sum in fp32, the (T, D) output in
``out_dtype`` (fp32 or bf16).  ``plan`` cuts each token's row into
D-slices, one block each, from shapes only.  The counted dispatching
wrapper is ``kernels.ops.mux_embed_combine``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import build

DTYPES = (torch.float32, torch.bfloat16)
MIN_COLS = 256          # columns a block at least (1 KB of an fp32 row)
MAX_COLS = 1024         # ... at most (256 threads of 16 bytes in fp32)
TARGET_BLOCKS = 2 * 132  # ~2 blocks on each of an H100's 132 SMs


class Plan(NamedTuple):
    cols: int       # columns a block: its D-slice
    threads: int    # threads a block
    vector: bool    # 16 bytes of the table's row a thread; else
                    # per-thread scalar loads


def plan(n: int, t: int, d: int, elt: int, aligned: bool = True) -> Plan:
    """The kernel's blocks for tokens (n, t) over a (V, d) table of
    ``elt``-byte elements: ceil(d / cols) blocks a token, enough of them
    for ~TARGET_BLOCKS blocks but no slice under MIN_COLS columns.  The
    vector branch needs d % 8 == 0 and 16-byte aligned tensors
    (``aligned``); then every row's slice is whole 16-byte words."""
    vector = aligned and d % 8 == 0
    slices = max(1, min(-(-d // MIN_COLS), -(-TARGET_BLOCKS // t)))
    if not vector:
        cols = min(d, -(-d // slices))
        return Plan(cols, min(256, 32 * -(-cols // 32)), False)
    cols = max(8, min(8 * -(-d // (8 * slices)), MAX_COLS))
    return Plan(cols, min(256, 32 * -(-cols * elt // 512)), True)


def mux_embed_ref(tokens, emb, v, *, scale=1.0, out_dtype=torch.float32):
    """tokens (N, T) int; emb (V, D); v (N, D) -> (T, D) in ``out_dtype``:
    rows and keys cast to fp32, summed, scaled, then cast (the Pallas
    kernel's order)."""
    x = emb[tokens.long()].float()
    out = torch.einsum("ntd,nd->td", x, v.float()) * (scale / tokens.shape[0])
    return out.to(out_dtype)


def mux_embed_combine_cuda(tokens, emb, v, *, scale=1.0,
                           out_dtype=torch.float32):
    """Launch ``mux_embed_kernel``; arguments as ``mux_embed_ref``.  Token
    ids must be in range (the model clamps inactive rows' ids to 0)."""
    if emb.device.type != "cuda":
        raise ValueError(f"the mux-embed kernel runs on CUDA tensors, got "
                         f"{emb.device}")
    n, t = tokens.shape
    vocab, d = emb.shape
    if (emb.dtype not in DTYPES or v.dtype not in DTYPES
            or out_dtype not in DTYPES):
        raise ValueError(f"need fp32 or bf16 emb / v / out_dtype, got "
                         f"{emb.dtype} / {v.dtype} / {out_dtype}")
    if tuple(v.shape) != (n, d) or v.device != emb.device:
        raise ValueError(f"v {tuple(v.shape)} on {v.device}, want ({n}, {d})"
                         f" on {emb.device}")
    tokens = tokens.to(device=emb.device, dtype=torch.int32).contiguous()
    emb, v = emb.contiguous(), v.contiguous()
    out = torch.empty((t, d), device=emb.device, dtype=out_dtype)
    aligned = all(a.data_ptr() % 16 == 0 for a in (emb, v, out))
    p = plan(n, t, d, emb.element_size(), aligned)
    bf = torch.bfloat16
    err = build.load("mux_entry").mux_embed_forward(
        tokens.data_ptr(), emb.data_ptr(), v.data_ptr(), out.data_ptr(), n, t,
        d, p.cols, p.threads, int(p.vector), int(emb.dtype == bf),
        int(v.dtype == bf), int(out_dtype == bf), float(scale / n),
        torch.cuda.current_stream(emb.device).cuda_stream)
    build.check(err, "mux_embed_kernel")
    return out
