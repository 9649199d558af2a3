"""Flash-decode over a contiguous ring KV cache: the CUDA kernel
(``csrc/decode_attention.cu``) and its plain PyTorch version.

Counterpart of ``repro/kernels/decode_attention.py`` (``decode_attention``).
One query per row attends over the cache's C slots; ``slot_pos`` (C,)
holds the absolute position each slot stores (-1 = empty) and masks
validity, causality and the window against ``q_pos``: an int, or a 0-d
integer tensor on q's device, which the kernel reads where it lies (no
wrapper reads a device tensor on the host, so a captured launch replays
at whatever position the tensor holds).  ``decode_attention_cuda``
launches the kernel on CUDA tensors and nothing else;
``decode_attention_ref`` is the plain version (naive attention with
slot-position masks, mirroring ``repro/kernels/ref.py``).  q, the cache
and the output are all fp32 or all bf16; as the Pallas kernel, bf16 is
widened to fp32 on load and the output rounded once.  The counted
dispatching wrapper is ``kernels.ops.decode_attention``.

The cache axis is split across blocks by ``plan``, from shapes only; the
splits of each (row, KV head, head group) run as one thread block
cluster, whose first block merges them in split order through
distributed shared memory, in the same launch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.nn.attention import make_attention_mask, widened_attention

TILE = 16           # slots a shared-memory stage (kTile in the source)
MAX_HEADS = 8       # query heads (warps) a block (kMaxHeads)
SMS = 132           # an H100's SMs
WARPS_PER_SM = 16   # warps the split aims to put on each SM
MAX_SPLITS = 16     # blocks a cluster (kMaxSplits); 8 above head_dim 128
DTYPES = (torch.float32, torch.bfloat16)    # q, K, V and the output


def _q_pos_rows(q_pos, device):
    """q_pos as a (1,) long tensor on ``device`` (no host read)."""
    if isinstance(q_pos, torch.Tensor):
        return q_pos.reshape(1).to(device=device, dtype=torch.long)
    return torch.full((1,), q_pos, dtype=torch.long, device=device)


def decode_attention_ref(q, k_cache, v_cache, slot_pos, *, q_pos,
                         window=None, causal=True):
    """q (B, 1, H, Dh); k_cache / v_cache (B, C, Hkv, Dh); all fp32 or
    all bf16; slot_pos (C,) int (-1 = empty); q_pos an int or a 0-d
    integer tensor.  As the Pallas kernel: q, K and V widened to fp32,
    attention in fp32, the output rounded once to q's dtype.  Returns
    (B, 1, H, Dh)."""
    pos = slot_pos.long()
    mask = make_attention_mask(_q_pos_rows(q_pos, q.device), pos,
                               causal=causal, window=window,
                               kv_valid=pos >= 0)[None]
    return widened_attention(q, k_cache, v_cache, mask=mask)


def plan(batch: int, heads: int, kv_heads: int, capacity: int,
         head_dim: int) -> tuple[int, int]:
    """(number of splits, slots per split) of the cache axis: blocks of
    (row, KV head, group of at most ``MAX_HEADS`` query heads) and split,
    one warp per query head, enough splits for ~``WARPS_PER_SM`` warps on
    each SM, at most one cluster of them (``MAX_SPLITS``, 8 past head_dim
    128, whose blocks hold more shared memory), each split a whole number
    of tiles and none empty.  Shapes only.  Measured on the card, one-tile
    splits beat longer walks at the ring decode shape (the ring then has
    nothing to overlap, but twice the blocks are in flight), and 16
    splits of 6 tiles beat fewer, longer ones at whisper's C = 1500."""
    g = heads // kv_heads
    groups = -(-g // MAX_HEADS)
    warps = batch * kv_heads * groups * -(-g // groups)
    tiles = -(-capacity // TILE)
    want = max(1, -(-SMS * WARPS_PER_SM // warps))
    top = MAX_SPLITS if head_dim <= 128 else MAX_SPLITS // 2
    n = max(1, min(want, top, tiles))
    per = -(-tiles // n) * TILE
    return -(-capacity // per), per


def _aligned(x):
    """Contiguous, with the 16-byte alignment the kernel's copies need."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def decode_attention_cuda(q, k_cache, v_cache, slot_pos, *, q_pos,
                          window=None, causal=True):
    """Launch ``decode_kernel``; arguments as ``decode_attention_ref``, a
    tensor ``q_pos`` on q's device."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the decode attention kernel runs on CUDA "
                         f"tensors, got {dev}")
    for name, x in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if x.dtype not in DTYPES or x.dtype != q.dtype or x.device != dev:
            raise ValueError(f"{name}: need q's dtype, fp32 or bf16, on "
                             f"{dev}, got {x.dtype} on {x.device}")
    b, lq, h, dh = q.shape
    c, hkv = k_cache.shape[1], k_cache.shape[2]
    if (lq != 1 or k_cache.shape != (b, c, hkv, dh)
            or v_cache.shape != k_cache.shape or h % hkv
            or slot_pos.shape != (c,)):
        raise ValueError(f"shapes q {tuple(q.shape)}, cache "
                         f"{tuple(k_cache.shape)} / {tuple(v_cache.shape)}, "
                         f"slot_pos {tuple(slot_pos.shape)}")
    vec = 16 // q.element_size()          # elements a 16-byte copy moves
    if dh % vec or dh > 256 or h // hkv > 2 * MAX_HEADS:
        raise ValueError(f"head_dim {dh}, {h // hkv} query heads per KV "
                         f"head: the kernel takes head_dim a multiple of "
                         f"{vec} ({q.dtype}) up to 256 and at most 16 query "
                         "heads per KV head")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    qp_t, qp = None, 0
    if isinstance(q_pos, torch.Tensor):
        if (q_pos.ndim or q_pos.device != dev or q_pos.dtype == torch.bool
                or q_pos.dtype.is_floating_point or q_pos.dtype.is_complex):
            raise ValueError(f"q_pos: need an int or a 0-d integer tensor "
                             f"on {dev}, got {q_pos.dtype} "
                             f"{tuple(q_pos.shape)} on {q_pos.device}")
        qp_t = q_pos.to(torch.int32)
    else:
        qp = int(q_pos)
    q, kc, vc = map(_aligned, (q, k_cache, v_cache))
    sp = _aligned(slot_pos.to(device=dev, dtype=torch.int32))
    nsplit, per = plan(b, h, hkv, c, dh)
    out = torch.empty_like(q)
    err = build.load("decode_attention").decode_attention_forward(
        q.data_ptr(), kc.data_ptr(), vc.data_ptr(), sp.data_ptr(),
        None if qp_t is None else qp_t.data_ptr(), out.data_ptr(), b, c, h,
        hkv, dh, qp, int(causal), 0 if window is None else int(window),
        nsplit, per, int(q.dtype == torch.bfloat16), float(dh ** -0.5),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "decode_kernel")
    return out
