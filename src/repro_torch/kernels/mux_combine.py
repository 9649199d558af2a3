"""Gaussian mux-combine over precomputed embeddings: the Triton kernel and
its plain PyTorch version.

    out[t] = (1 / N) * sum_i x[i, t] ⊙ v[i]

Replaces the Pallas TPU kernel ``repro/kernels/mux_combine.py``
(``mux_combine``): x (N, T, D) and v (N, D) in fp32 or bf16, the sum over
N kept in fp32, a (T, D) output in x's dtype.  Bound: bytes — x read
once, v once, the output written once; two flops per element of x and no
reuse across tiles, so nothing for shared memory or the tensor cores to
do.  Design: one Triton program per (BLOCK_T x BLOCK_D) output tile; it
loads the tile's N slices of x and N rows of v with masked vector loads,
accumulates in fp32 registers and stores the tile once, so x is read in
one pass and no (N, T, D) product is written.  Any N >= 1 (a constexpr:
one compile per N), and T, D need not be multiples of a tile.  Triton is
imported, and the kernel compiled, at first launch.
"""
from __future__ import annotations

import functools
import os

import torch

from repro_torch.kernels import build

BLOCK_T = 16
BLOCK_D = 256
DTYPES = (torch.float32, torch.bfloat16)


def mux_combine_ref(x, v):
    """x (N, T, D); v (N, D) -> (T, D) = mean_i x_i ⊙ v_i, summed in fp32
    and cast to x's dtype (``repro/kernels/ref.py`` ``mux_combine_ref``)."""
    out = torch.einsum("ntd,nd->td", x.float(), v.float()) / x.shape[0]
    return out.to(x.dtype)


@functools.cache
def _triton_kernel():
    os.environ.setdefault("TRITON_CACHE_DIR",
                          str(build.BUILD / "triton-cache"))
    import triton
    import triton.language as tl

    @triton.jit
    def mux_combine_kernel(x_ptr, v_ptr, out_ptr, T, D,
                           N: tl.constexpr, BT: tl.constexpr,
                           BD: tl.constexpr):
        rows = tl.program_id(0) * BT + tl.arange(0, BT)
        cols = tl.program_id(1) * BD + tl.arange(0, BD)
        rm, cm = rows < T, cols < D
        m = rm[:, None] & cm[None, :]
        r64 = rows.to(tl.int64)          # element offsets pass 2**31
        acc = tl.zeros([BT, BD], dtype=tl.float32)
        for i in tl.static_range(N):
            w = tl.load(v_ptr + i * D + cols, mask=cm, other=0.0)
            xi = tl.load(x_ptr + (r64 + i * T)[:, None] * D + cols[None, :],
                         mask=m, other=0.0)
            acc += xi.to(tl.float32) * w.to(tl.float32)[None, :]
        tl.store(out_ptr + r64[:, None] * D + cols[None, :],
                 (acc / N).to(out_ptr.dtype.element_ty), mask=m)

    return triton, mux_combine_kernel


def mux_combine_cuda(x, v):
    """Launch the Triton kernel; arguments as ``mux_combine_ref`` (x and v
    fp32 or bf16, on one CUDA device)."""
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
    triton, kernel = _triton_kernel()
    kernel[(triton.cdiv(t, BLOCK_T), triton.cdiv(d, BLOCK_D))](
        x, v, out, t, d, N=n, BT=BLOCK_T, BD=BLOCK_D, num_warps=4)
    return out
