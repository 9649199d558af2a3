"""Paged attention over a block-table-addressed KV pool: the CUDA kernels
(``csrc/paged_attention.cu``) and their plain PyTorch versions.

Counterpart of ``repro/kernels/paged_attention.py`` (``paged_attention``
and ``paged_prefill_attention``).  ``*_cuda`` launch the kernels on CUDA
tensors and nothing else; ``*_ref`` are the plain versions (gather each
row's pages, then naive attention), mirroring ``repro/kernels/ref.py``.
The dispatching wrappers with launch counts are in ``kernels/ops.py``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.nn.attention import attention_core, make_attention_mask


# --------------------------------------------------------- plain versions

def _gather(k_pages, v_pages, block_tables, page_pos):
    bt = block_tables.long()
    b = bt.shape[0]
    btc = bt.clamp(min=0)
    k = k_pages[btc].reshape(b, -1, *k_pages.shape[2:])
    v = v_pages[btc].reshape(b, -1, *v_pages.shape[2:])
    pos = torch.where(bt[..., None] >= 0, page_pos[btc], -1).reshape(b, -1)
    return k, v, pos


def paged_attention_ref(q, k_pages, v_pages, block_tables, page_pos, q_pos,
                        *, window=None, causal=True):
    """q (B, 1, H, Dh); pages (P, BS, Hkv, Dh); block_tables (B, MB)
    (-1 = unallocated); page_pos (P, BS) (-1 = empty); q_pos (B,)
    (-1 = inactive row).  Returns (B, 1, H, Dh)."""
    k, v, pos = _gather(k_pages, v_pages, block_tables, page_pos)
    q_pos = q_pos.long()
    mask = make_attention_mask(q_pos[:, None], pos, causal=causal,
                               window=window, kv_valid=pos >= 0)
    mask = mask & (q_pos >= 0)[:, None, None]
    return attention_core(q, k, v, mask=mask)


def paged_prefill_attention_ref(q, k_pages, v_pages, block_tables,
                                page_pos, q_start, q_len, *, window=None,
                                causal=True):
    """q (B, Lq, H, Dh); q_start (B,) chunk start (-1 = inactive row);
    q_len (B,) valid queries (the rest is bucket padding, fully masked).
    Returns (B, Lq, H, Dh)."""
    k, v, pos = _gather(k_pages, v_pages, block_tables, page_pos)
    lq = q.shape[1]
    li = torch.arange(lq, device=q.device)[None]
    q_start, q_len = q_start.long(), q_len.long()
    q_pos = q_start[:, None] + li
    q_pos = torch.where((li >= q_len[:, None]) | (q_start[:, None] < 0),
                        -1, q_pos)
    mask = make_attention_mask(q_pos, pos, causal=causal, window=window,
                               kv_valid=pos >= 0)
    mask = mask & (q_pos >= 0)[..., None]
    return attention_core(q, k, v, mask=mask)


# ----------------------------------------------------------- CUDA launch

def _checked(q, k_pages, v_pages, block_tables, page_pos, *vecs):
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the paged attention kernel runs on CUDA tensors, "
                         f"got {dev}")
    for name, x in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if x.dtype != torch.float32 or x.device != dev:
            raise ValueError(f"{name}: need fp32 on {dev}, got {x.dtype} "
                             f"on {x.device}")
    b, _, h, dh = q.shape
    p, bs, hkv, dh2 = k_pages.shape
    if v_pages.shape != k_pages.shape or dh2 != dh or h % hkv:
        raise ValueError(f"shapes q {tuple(q.shape)}, pages "
                         f"{tuple(k_pages.shape)} / {tuple(v_pages.shape)}")
    if dh % 4 or dh > 256:
        raise ValueError(f"head_dim {dh}: the kernel takes multiples of 4 "
                         "up to 256")
    if block_tables.shape[0] != b or tuple(page_pos.shape) != (p, bs):
        raise ValueError(f"block_tables {tuple(block_tables.shape)} / "
                         f"page_pos {tuple(page_pos.shape)} do not match")
    ints = [x.to(device=dev, dtype=torch.int32).contiguous()
            for x in (block_tables, page_pos, *vecs)]
    for v in ints[2:]:
        if v.shape != (b,):
            raise ValueError(f"per-row vector of shape {tuple(v.shape)}, "
                             f"want ({b},)")
    return ([x.contiguous() for x in (q, k_pages, v_pages)], ints)


def _window(window) -> int:
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    return 0 if window is None else int(window)


def paged_attention_cuda(q, k_pages, v_pages, block_tables, page_pos,
                         q_pos, *, window=None, causal=True):
    """Launch ``paged_decode_kernel``; arguments as ``paged_attention_ref``."""
    (q, kp, vp), (bt, pp, qp) = _checked(q, k_pages, v_pages, block_tables,
                                         page_pos, q_pos)
    b, _, h, dh = q.shape
    out = torch.empty_like(q)
    err = build.load("paged_attention").paged_attention_decode(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(), bt.data_ptr(),
        pp.data_ptr(), qp.data_ptr(), out.data_ptr(), b, h, kp.shape[2], dh,
        kp.shape[1], bt.shape[1], int(causal), _window(window),
        float(dh ** -0.5), torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "paged_decode_kernel")
    return out


def paged_prefill_attention_cuda(q, k_pages, v_pages, block_tables,
                                 page_pos, q_start, q_len, *, window=None,
                                 causal=True):
    """Launch ``paged_prefill_kernel``; arguments as
    ``paged_prefill_attention_ref``."""
    (q, kp, vp), (bt, pp, qs, ql) = _checked(
        q, k_pages, v_pages, block_tables, page_pos, q_start, q_len)
    b, lq, h, dh = q.shape
    out = torch.empty_like(q)
    err = build.load("paged_attention").paged_attention_prefill(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(), bt.data_ptr(),
        pp.data_ptr(), qs.data_ptr(), ql.data_ptr(), out.data_ptr(), b, lq,
        h, kp.shape[2], dh, kp.shape[1], bt.shape[1], int(causal),
        _window(window), float(dh ** -0.5),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "paged_prefill_kernel")
    return out
