"""The RWKV6 (Finch) recurrence: the CUDA kernel (``csrc/rwkv6.cu``) and
its plain PyTorch versions.

    out_t = r_t S_{t-1} + ((r_t * u) . k_t) v_t
    S_t   = diag(exp(logw_t)) S_{t-1} + k_t v_t^T

over r, k, v, logw (B, L, H, hd), u (H, hd) and the carried state s0
(B, H, hd, hd); returns out (B, L, H, hd) and the final state sT.  r, k
and v are fp32 or bf16 (one dtype); logw, u, s0 and sT are fp32; out is
in r's dtype.  As the Pallas kernel (and the reference's model path at
its default ``rwkv_intra_dtype='f32'``), bf16 r, k and v are widened to
fp32, the recurrence runs in fp32 and out is rounded once.

Counterpart of ``repro/kernels/rwkv6.py`` (``rwkv6_chunked``, the Pallas
kernel) and of the function the reference's model path runs in its place,
``repro/models/blocks.py`` ``rwkv_chunked``:

  * ``rwkv_chunked`` — the plain version: the reference's chunkwise form
    (inter-chunk term from the carried state, intra-chunk scores weighted
    by exp(la_prev_t - la_j), the state carried chunk to chunk) with its
    ``intra_dtype`` option.  One change: the pairwise log decay is masked
    to the strict lower triangle *before* the exp.  The reference takes
    the exp of the whole (c, c, hd) tensor and multiplies by the mask
    afterwards; past ~88 nats of decay inside one chunk (a 100-token
    chunk at the default decay exp(-1) per token) the upper triangle
    overflows to inf and inf * 0 makes the output NaN.  Masking first
    gives the reference's values bit for bit wherever those are finite.
  * ``rwkv6_ref`` — the sequential per-token oracle
    (``repro/kernels/ref.py`` ``rwkv6_ref``).
  * ``rwkv6_cuda`` — launches the kernel on CUDA tensors and nothing
    else: a per-token scan with the state in registers, any L (no chunk
    rule), a head's value columns split over blocks where ``PLAN`` says
    so; see the source.

The counted dispatching wrapper is ``kernels.ops.rwkv6_chunked``.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import build

DTYPES = (torch.float32, torch.bfloat16)    # r, k, v and out

HEAD_DIMS = (16, 32, 64, 128)      # the kernel's instantiations
# head dim -> (value columns a block, row groups, columns a thread, tokens
# a staged tile): a head's hd columns split over hd / columns blocks, each
# thread holding hd / row groups state rows of its columns (Cfg in the
# source)
PLAN = {16: (16, 4, 4, 8), 32: (32, 4, 4, 8), 64: (64, 8, 4, 16),
        128: (64, 16, 4, 8)}


def rwkv_chunked(r, k, v, logw, u, s0, chunk: int,
                 intra_dtype=torch.float32, remat_inner: bool = False):
    """Chunkwise-parallel recurrence in chunks of ``chunk`` tokens (L a
    multiple of it).  The (c, c, hd) pairwise decay and the intra-chunk
    products run in ``intra_dtype`` (fp32 or bf16), as the reference's;
    bf16 r, k and v are widened first (the reference promotes them where
    they meet fp32) and out comes back in r's dtype.  remat_inner: under
    autograd (an input that requires grad), each chunk step is
    checkpointed (the reference's nested remat of the training scan):
    its (c, c, hd) decay is recomputed for the backward instead of
    kept."""
    dt = r.dtype
    r, k, v = r.float(), k.float(), v.float()
    b, l, h, hd = r.shape
    if l % chunk:
        raise ValueError(f"L={l} is not a multiple of chunk={chunk}")
    nc, c = l // chunk, chunk

    def chunks(x):                    # (B, L, H, hd) -> (nc, B, H, c, hd)
        return x.reshape(b, nc, c, h, hd).permute(1, 0, 3, 2, 4)

    below = torch.ones(c, c, dtype=torch.bool, device=r.device).tril(-1)

    def step(s, rj, kj, vj, lw):                     # (B, H, c, hd) each
        la = torch.cumsum(lw, dim=2)                 # log decay incl. t
        la_prev = la - lw                            # ... up to t-1
        out = torch.einsum("bhck,bhkv->bhcv", rj * torch.exp(la_prev), s)
        decay = la_prev[:, :, :, None, :] - la[:, :, None, :, :]
        decay.masked_fill_(~below[:, :, None], float("-inf"))
        decay = decay.exp_().to(intra_dtype)         # (B, H, c, c, hd)
        att = torch.einsum("bhtk,bhjk,bhtjk->bhtj", rj.to(intra_dtype),
                           kj.to(intra_dtype), decay)
        bonus = torch.einsum("bhtk,bhtk->bht", rj * u[None, :, None, :], kj)
        out = (out + torch.einsum("bhtj,bhjv->bhtv", att,
                                  vj.to(intra_dtype)).float()
               + bonus[..., None] * vj)
        la_end = la[:, :, -1:, :]
        k_scaled = kj * torch.exp(la_end - la)
        s = (torch.exp(la_end[:, :, 0, :])[..., None] * s
             + torch.einsum("bhck,bhcv->bhkv", k_scaled, vj))
        return s, out

    remat = remat_inner and torch.is_grad_enabled() and any(
        t.requires_grad for t in (r, k, v, logw, u, s0))
    s, outs = s0, []
    for xs in zip(*map(chunks, (r, k, v, logw))):
        s, out = (checkpoint(step, s, *xs, use_reentrant=False) if remat
                  else step(s, *xs))
        outs.append(out)
    out = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(b, l, h, hd)
    return out.to(dt), s


def rwkv6_ref(r, k, v, logw, u, s0):
    """The sequential per-token recurrence (the definition), widened and
    rounded as ``rwkv_chunked``.  Returns (out (B, L, H, hd) in r's dtype,
    sT (B, H, hd, hd) fp32)."""
    dt = r.dtype
    r, k, v = r.float(), k.float(), v.float()
    w = torch.exp(logw)
    s, outs = s0, []
    for t in range(r.shape[1]):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], w[:, t]
        outs.append(torch.einsum("bhk,bhkv->bhv", rt, s)
                    + torch.einsum("bhk,bhk->bh", rt * u[None], kt)[..., None]
                    * vt)
        s = wt[..., None] * s + kt[..., None] * vt[:, :, None, :]
    return torch.stack(outs, 1).to(dt), s


def _aligned(x):
    """Contiguous, with the 16-byte alignment the kernel's vector loads
    need."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def rwkv6_cuda(r, k, v, logw, u, s0):
    """Launch ``rwkv6_scan``; arguments as ``rwkv6_ref``, CUDA tensors
    (r, k and v fp32 or bf16, one dtype; logw, u and s0 fp32), hd one of
    ``HEAD_DIMS``, any L >= 1."""
    for name, x in (("r", r), ("k", k), ("v", v)):
        if x.dtype not in DTYPES or x.dtype != r.dtype:
            raise ValueError(f"{name}: need r's dtype, fp32 or bf16, got "
                             f"{x.dtype} (r {r.dtype})")
    for name, x in (("logw", logw), ("u", u), ("s0", s0)):
        if x.dtype != torch.float32:
            raise ValueError(f"{name}: need fp32, got {x.dtype}")
    dev = r.device
    if dev.type != "cuda":
        raise ValueError(f"the rwkv6 kernel runs on CUDA tensors, got {dev}")
    for name, x in (("k", k), ("v", v), ("logw", logw), ("u", u),
                    ("s0", s0)):
        if x.device != dev:
            raise ValueError(f"{name}: need {dev}, got {x.device}")
    b, l, h, hd = r.shape
    if (k.shape != r.shape or v.shape != r.shape or logw.shape != r.shape
            or u.shape != (h, hd) or s0.shape != (b, h, hd, hd) or l < 1):
        raise ValueError(f"shapes r/k/v/logw {tuple(r.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)} "
                         f"{tuple(logw.shape)}, u {tuple(u.shape)}, s0 "
                         f"{tuple(s0.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd}: the kernel takes {HEAD_DIMS}")
    r, k, v, logw, u, s0 = map(_aligned, (r, k, v, logw, u, s0))
    out, s_t = torch.empty_like(r), torch.empty_like(s0)
    err = build.load("rwkv6").rwkv6_forward(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
        u.data_ptr(), s0.data_ptr(), out.data_ptr(), s_t.data_ptr(), b, l, h,
        hd, int(r.dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "rwkv6_scan")
    return out, s_t
