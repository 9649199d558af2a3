"""Gaussian mux-combine over precomputed embeddings: the CUDA kernel
(``csrc/mux_entry.cu``, ``mux_combine_kernel``) and its plain PyTorch
version.

    out[t] = (1 / N) * sum_i x[i, t] ⊙ v[i]

Counterpart of ``repro/kernels/mux_combine.py`` (``mux_combine``): x
(N, T, D) and v (N, D) in fp32 or bf16, the sum over N kept in fp32, a
(T, D) output in x's dtype.  ``plan`` sets the kernel's tiles and grid
from shapes only.  The counted dispatching wrapper is
``kernels.ops.mux_combine``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import build

DTYPES = (torch.float32, torch.bfloat16)
THREADS = 256           # threads a block, at most
UNROLL = {4: 2, 2: 2}   # rows a thread at once by element size: the
                        # source's kUnroll (fp32) and kUnrollBf16


class Plan(NamedTuple):
    cols: int       # columns a tile: D, or a D-slice (a multiple of 8)
    rows: int       # rows of T a tile
    slices: int     # ceil(D / cols)
    grid: int       # blocks: slices x tiles
    threads: int    # threads a block
    vector: bool    # 16-byte chunks of x a thread; else per-thread scalar
                    # loads


def plan(n: int, t: int, d: int, elt: int, aligned: bool = True) -> Plan:
    """The kernel's tiles for x (n, t, d) of ``elt``-byte elements: one
    block a tile.  D-slices whose row is at most THREADS 16-byte chunks,
    a thread a chunk of UNROLL[elt] rows of the tile at once.  The vector
    branch needs d % 8 == 0 and 16-byte aligned tensors (``aligned``);
    else a block takes a tile of whole rows by per-thread scalar loads."""
    if not (aligned and d % 8 == 0):
        rows = max(1, min(t, 4 * THREADS // d))
        return Plan(d, rows, 1, -(-t // rows), THREADS, False)
    slices = -(-d * elt // (16 * THREADS))
    cols = 8 * -(-d // (8 * slices))
    slices = -(-d // cols)
    chunks = -(-cols * elt // 16)
    groups = THREADS // chunks
    rows = groups * UNROLL[elt]
    return Plan(cols, rows, slices, slices * -(-t // rows), groups * chunks,
                True)


def mux_combine_ref(x, v):
    """x (N, T, D); v (N, D) -> (T, D) = mean_i x_i ⊙ v_i, summed in fp32
    and cast to x's dtype (``repro/kernels/ref.py`` ``mux_combine_ref``)."""
    out = torch.einsum("ntd,nd->td", x.float(), v.float()) / x.shape[0]
    return out.to(x.dtype)


def mux_combine_cuda(x, v):
    """Launch ``mux_combine_kernel``; arguments as ``mux_combine_ref`` (x
    and v fp32 or bf16, on one CUDA device)."""
    if x.device.type != "cuda":
        raise ValueError(f"the mux-combine kernel runs on CUDA tensors, got "
                         f"{x.device}")
    if x.ndim != 3 or x.shape[0] < 1:
        raise ValueError(f"x must be (N, T, D) with N >= 1, got "
                         f"{tuple(x.shape)}")
    n, t, d = x.shape
    if x.dtype not in DTYPES or v.dtype not in DTYPES:
        raise ValueError(f"need fp32 or bf16 x / v, got {x.dtype} / "
                         f"{v.dtype}")
    if tuple(v.shape) != (n, d) or v.device != x.device:
        raise ValueError(f"v {tuple(v.shape)} on {v.device}, want ({n}, {d})"
                         f" on {x.device}")
    x, v = x.contiguous(), v.contiguous()
    out = torch.empty((t, d), device=x.device, dtype=x.dtype)
    aligned = all(a.data_ptr() % 16 == 0 for a in (x, v, out))
    p = plan(n, t, d, x.element_size(), aligned)
    bf = torch.bfloat16
    err = build.load("mux_entry").mux_combine_forward(
        x.data_ptr(), v.data_ptr(), out.data_ptr(), n, t, d, p.cols, p.rows,
        p.slices, p.grid, p.threads, int(p.vector), int(x.dtype == bf),
        int(v.dtype == bf), 1.0 / n,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "mux_combine_kernel")
    return out
