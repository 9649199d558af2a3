"""Flash-decode over a contiguous ring KV cache: the CUDA kernel
(``csrc/decode_attention.cu``) and its plain PyTorch version.

Counterpart of ``repro/kernels/decode_attention.py`` (``decode_attention``).
One query per row attends over the cache's C slots; ``slot_pos`` (C,)
holds the absolute position each slot stores (-1 = empty) and masks
validity, causality and the window against ``q_pos``, a plain int.
``decode_attention_cuda`` launches the kernel on CUDA tensors and nothing
else; ``decode_attention_ref`` is the plain version (naive attention with
slot-position masks, mirroring ``repro/kernels/ref.py``).  The counted
dispatching wrapper is ``kernels.ops.decode_attention``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.nn.attention import attention_core, make_attention_mask

TILE = 16             # slots per shared-memory tile (kTile in the source)
TARGET_BLOCKS = 264   # ~2 blocks per SM of an H100 (132 SMs)


def decode_attention_ref(q, k_cache, v_cache, slot_pos, *, q_pos: int,
                         window=None, causal=True):
    """q (B, 1, H, Dh); k_cache / v_cache (B, C, Hkv, Dh); slot_pos (C,)
    int (-1 = empty); q_pos int.  Returns (B, 1, H, Dh)."""
    qp = torch.full((1,), q_pos, dtype=torch.long, device=q.device)
    pos = slot_pos.long()
    mask = make_attention_mask(qp, pos, causal=causal, window=window,
                               kv_valid=pos >= 0)[None]
    return attention_core(q, k_cache, v_cache, mask=mask)


def splits(batch: int, n_kv: int, capacity: int) -> tuple[int, int]:
    """(number of splits, slots per split) of the cache axis: enough
    blocks for ~2 per SM, each split a whole number of tiles and none
    empty."""
    tiles = -(-capacity // TILE)
    want = max(1, -(-TARGET_BLOCKS // (batch * n_kv)))
    per = -(-tiles // min(tiles, want)) * TILE
    return -(-capacity // per), per


def decode_attention_cuda(q, k_cache, v_cache, slot_pos, *, q_pos: int,
                          window=None, causal=True):
    """Launch the split kernel (and, with more than one split, the
    combine kernel); arguments as ``decode_attention_ref``."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the decode attention kernel runs on CUDA "
                         f"tensors, got {dev}")
    for name, x in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if x.dtype != torch.float32 or x.device != dev:
            raise ValueError(f"{name}: need fp32 on {dev}, got {x.dtype} "
                             f"on {x.device}")
    b, lq, h, dh = q.shape
    c, hkv = k_cache.shape[1], k_cache.shape[2]
    if (lq != 1 or k_cache.shape != (b, c, hkv, dh)
            or v_cache.shape != k_cache.shape or h % hkv
            or slot_pos.shape != (c,)):
        raise ValueError(f"shapes q {tuple(q.shape)}, cache "
                         f"{tuple(k_cache.shape)} / {tuple(v_cache.shape)}, "
                         f"slot_pos {tuple(slot_pos.shape)}")
    if dh % 4 or dh > 256 or h // hkv > 16:
        raise ValueError(f"head_dim {dh}, {h // hkv} query heads per KV "
                         "head: the kernel takes head_dim a multiple of 4 "
                         "up to 256 and at most 16 query heads per KV head")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    q, kc, vc = q.contiguous(), k_cache.contiguous(), v_cache.contiguous()
    sp = slot_pos.to(device=dev, dtype=torch.int32).contiguous()
    nsplit, per = splits(b, hkv, c)
    out = torch.empty_like(q)
    part_acc = part_ml = None
    if nsplit > 1:
        part_acc = torch.empty((b, h, nsplit, dh), device=dev)
        part_ml = torch.empty((b, h, nsplit, 2), device=dev)
    err = build.load("decode_attention").decode_attention_forward(
        q.data_ptr(), kc.data_ptr(), vc.data_ptr(), sp.data_ptr(),
        None if part_acc is None else part_acc.data_ptr(),
        None if part_ml is None else part_ml.data_ptr(), out.data_ptr(),
        b, c, h, hkv, dh, int(q_pos), int(causal),
        0 if window is None else int(window), nsplit, per,
        float(dh ** -0.5), torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "decode_split_kernel")
    return out
