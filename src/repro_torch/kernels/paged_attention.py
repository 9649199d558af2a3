"""Paged attention over a block-table-addressed KV pool: the CUDA kernels
(``csrc/paged_attention.cu``) and their plain PyTorch versions.

Counterpart of ``repro/kernels/paged_attention.py`` (``paged_attention``
and ``paged_prefill_attention``).  Pages are stored as fp32, bf16, int8 or
fp8 e4m3; int8 and fp8 pages come with per-(slot, head) fp32 scales
``k_scales``/``v_scales`` of shape (P, BS, Hkv), and the kernels fuse the
dequant (``payload.float() * scale``) into each page load.  q, and the
output, are fp32 or bf16 (the compute dtype): as the Pallas kernels, the
kernels widen a bf16 q to fp32, compute in fp32 and round the output
once.  ``*_cuda`` launch the kernels on CUDA tensors and nothing else;
``*_ref`` and ``*_quant_ref`` are the plain versions (dequantize, gather
each row's pages, then naive attention), mirroring
``repro/kernels/ref.py``.  The dispatching wrappers with launch counts
are in ``kernels/ops.py``.

Each row's table is split across blocks (``decode_plan``,
``prefill_plan``): a split walks a contiguous run of table entries and the
splits merge by their log-sum-exp.  ``_local_tables`` and ``_head_axis``
serve the shard-local wrappers of ``ops`` (``sharded_paged_*``).  The plan depends on shapes only, so a
wrapper never reads a device tensor on the host.
"""
from __future__ import annotations

import torch

from repro_torch.core.quant import (KV_DTYPES, dequantize_kv, kv_quant_kind,
                                    kv_store_dtype)
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import TILES, padded_head_dim
from repro_torch.nn.attention import make_attention_mask, widened_attention

# page storage dtype -> the kernels' storage-kind argument, the index of its
# name in KV_DTYPES: 0 fp32, 1 bf16, 2 int8, 3 fp8 e4m3
STORAGE_KINDS = {kv_store_dtype(k): i for i, k in enumerate(KV_DTYPES)}
# query (and output) dtype -> the kernels' q_bf16 argument
Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def storage_kind(k_pages, v_pages, k_scales=None, v_scales=None) -> int:
    """Check the page storage and its scales; return the kernels' storage
    kind.  fp32 and bf16 pages take no scales; int8 and fp8 pages need
    both, fp32, shaped (P, BS, Hkv) like the pages, on their device."""
    dt = k_pages.dtype
    if v_pages.dtype != dt or dt not in STORAGE_KINDS:
        raise ValueError(f"pages {dt} / {v_pages.dtype}: need one of "
                         f"{sorted(map(str, STORAGE_KINDS))} for both")
    given = [s is not None for s in (k_scales, v_scales)]
    if kv_quant_kind(dt) is None:
        if any(given):
            raise ValueError(f"{dt} pages are not quantized: pass no "
                             "k_scales / v_scales")
        return STORAGE_KINDS[dt]
    if not all(given):
        raise ValueError(f"{dt} pages need both k_scales and v_scales")
    for name, s in (("k_scales", k_scales), ("v_scales", v_scales)):
        if (s.dtype != torch.float32 or s.shape != k_pages.shape[:3]
                or s.device != k_pages.device):
            raise ValueError(f"{name}: need fp32 {tuple(k_pages.shape[:3])} "
                             f"on {k_pages.device}, got {s.dtype} "
                             f"{tuple(s.shape)} on {s.device}")
    return STORAGE_KINDS[dt]


# ----------------------------------------------------------- split plan

SMS = 132             # an H100's SMs
DECODE_TILE = 16      # slots a decode stage (kDecodeTile in the source)
MAX_HEADS = 8         # query heads a decode block (kMaxHeads)


def splits(blocks: int, per_sm: int, max_blocks: int, block_size: int,
           tile: int) -> tuple[int, int]:
    """(number of splits, table entries per split) of a row's
    ``max_blocks`` entries, where ``blocks`` blocks serve a split each:
    enough splits for ~``per_sm`` blocks an SM, each split at least one
    tile of ``tile`` slots (or the whole row) and none empty."""
    want = max(1, -(-SMS * per_sm // blocks))
    per = max(-(-max_blocks // min(max_blocks, want)), -(-tile // block_size))
    per = min(per, max_blocks)
    return -(-max_blocks // per), per


def decode_plan(batch: int, heads: int, kv_heads: int, max_blocks: int,
                block_size: int) -> tuple[int, int]:
    """The decode kernel's split: blocks of (row, KV head, group of at most
    ``MAX_HEADS`` query heads), two an SM."""
    groups = -(-(heads // kv_heads) // MAX_HEADS)
    return splits(batch * kv_heads * groups, 2, max_blocks, block_size,
                  DECODE_TILE)


def prefill_plan(batch: int, lq: int, heads: int, kv_heads: int,
                 head_dim: int, max_blocks: int,
                 block_size: int) -> tuple[int, int]:
    """The chunk kernel's split: blocks of (row, KV head, tile of the G * Lq
    query rows), as many an SM as the flash tile shape allows (``TILES``)."""
    bk, per_sm, bq = TILES[padded_head_dim(head_dim)]
    tiles = -(-(heads // kv_heads * lq) // bq)
    return splits(batch * kv_heads * tiles, per_sm, max_blocks, block_size,
                  bk)


# --------------------------------------------------------- plain versions

def _gather(k_pages, v_pages, block_tables, page_pos):
    """Rows' pages gathered contiguous and widened to fp32 (exactly), as
    the Pallas kernels widen each page they load."""
    bt = block_tables.long()
    b = bt.shape[0]
    btc = bt.clamp(min=0)
    k = k_pages[btc].float().reshape(b, -1, *k_pages.shape[2:])
    v = v_pages[btc].float().reshape(b, -1, *v_pages.shape[2:])
    pos = torch.where(bt[..., None] >= 0, page_pos[btc], -1).reshape(b, -1)
    return k, v, pos


def paged_attention_ref(q, k_pages, v_pages, block_tables, page_pos, q_pos,
                        *, window=None, causal=True):
    """q (B, 1, H, Dh) fp32 or bf16; pages (P, BS, Hkv, Dh); block_tables
    (B, MB) (-1 = unallocated); page_pos (P, BS) (-1 = empty); q_pos (B,)
    (-1 = inactive row).  Returns (B, 1, H, Dh) in q's dtype."""
    k, v, pos = _gather(k_pages, v_pages, block_tables, page_pos)
    q_pos = q_pos.long()
    mask = make_attention_mask(q_pos[:, None], pos, causal=causal,
                               window=window, kv_valid=pos >= 0)
    mask = mask & (q_pos >= 0)[:, None, None]
    return widened_attention(q, k, v, mask=mask)


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
    return widened_attention(q, k, v, mask=mask)


def paged_attention_quant_ref(q, k_pages, v_pages, k_scales, v_scales,
                              block_tables, page_pos, q_pos, *, window=None,
                              causal=True):
    """Plain version of the fused-dequant decode kernel: dequantize the
    whole pool in fp32 (the per-slot ``payload * scale`` the kernel fuses
    into its page loads), then ``paged_attention_ref``."""
    return paged_attention_ref(q, dequantize_kv(k_pages, k_scales),
                               dequantize_kv(v_pages, v_scales),
                               block_tables, page_pos, q_pos, window=window,
                               causal=causal)


def paged_prefill_attention_quant_ref(q, k_pages, v_pages, k_scales,
                                      v_scales, block_tables, page_pos,
                                      q_start, q_len, *, window=None,
                                      causal=True):
    """Chunked-prefill analogue of ``paged_attention_quant_ref``."""
    return paged_prefill_attention_ref(q, dequantize_kv(k_pages, k_scales),
                                       dequantize_kv(v_pages, v_scales),
                                       block_tables, page_pos, q_start,
                                       q_len, window=window, causal=causal)


# ------------------------------------------------- shard-local tables

def _local_tables(bt, shard: int, blocks_per_shard: int):
    """A data shard's block tables rebased to its page segment: shard s
    owns global ids [s * bps, (s + 1) * bps) (``ShardedKVPool``'s
    segments), so a local id is global - s * bps; -1 stays -1."""
    return torch.where(bt >= 0, bt - shard * blocks_per_shard,
                       torch.full_like(bt, -1))


def _head_axis(mesh_shape, h: int, hkv: int):
    """'model' when a rank's head group splits over the model axis: only
    when BOTH head counts divide it (splitting query heads without their
    KV heads would break the GQA grouping); else None (every model rank
    holds every head)."""
    m = mesh_shape.get("model", 1)
    return "model" if m > 1 and h % m == 0 and hkv % m == 0 else None


# ----------------------------------------------------------- CUDA launch

def _checked(q, k_pages, v_pages, k_scales, v_scales, block_tables,
             page_pos, *vecs):
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the paged attention kernel runs on CUDA tensors, "
                         f"got {dev}")
    if q.dtype not in Q_DTYPES:
        raise ValueError(f"q: need fp32 or bf16, got {q.dtype}")
    if k_pages.device != dev or v_pages.device != dev:
        raise ValueError(f"pages on {k_pages.device} / {v_pages.device}, "
                         f"q on {dev}")
    kind = storage_kind(k_pages, v_pages, k_scales, v_scales)
    b, _, h, dh = q.shape
    p, bs, hkv, dh2 = k_pages.shape
    if v_pages.shape != k_pages.shape or dh2 != dh or h % hkv:
        raise ValueError(f"shapes q {tuple(q.shape)}, pages "
                         f"{tuple(k_pages.shape)} / {tuple(v_pages.shape)}")
    vec = 8 if q.dtype == torch.bfloat16 else 4   # elements a q load
    if dh % vec or dh > 256:
        raise ValueError(f"head_dim {dh}: the kernel takes multiples of "
                         f"{vec} up to 256 ({q.dtype} q)")
    if block_tables.shape[0] != b or tuple(page_pos.shape) != (p, bs):
        raise ValueError(f"block_tables {tuple(block_tables.shape)} / "
                         f"page_pos {tuple(page_pos.shape)} do not match")
    ints = [x.to(device=dev, dtype=torch.int32).contiguous()
            for x in (block_tables, page_pos, *vecs)]
    for v in ints[2:]:
        if v.shape != (b,):
            raise ValueError(f"per-row vector of shape {tuple(v.shape)}, "
                             f"want ({b},)")
    kp, vp = k_pages.contiguous(), v_pages.contiguous()
    if kp.data_ptr() % 16 or vp.data_ptr() % 16:
        raise ValueError("pages must start on a 16-byte boundary (the "
                         "kernels load four elements at a time)")
    q = q.contiguous()
    q = q if q.data_ptr() % 16 == 0 else q.clone()   # 16-byte q loads
    scales = [None if s is None else s.contiguous()
              for s in (k_scales, v_scales)]
    return kind, [q, kp, vp], scales, ints


def _ptr(x):
    """A tensor's device address; None (a null pointer) for no tensor."""
    return None if x is None else x.data_ptr()


def _window(window) -> int:
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    return 0 if window is None else int(window)


def _partials(nsplit, rows, dh, dev):
    """The split kernels' unnormalised outputs (nsplit, rows, dh) and their
    (max, sum) pairs (nsplit, rows, 2), in one allocation; none for one
    split."""
    if nsplit == 1:
        return None, None
    scratch = torch.empty(nsplit * rows * (dh + 2), device=dev)
    return scratch[:nsplit * rows * dh], scratch[nsplit * rows * dh:]


def paged_attention_cuda(q, k_pages, v_pages, block_tables, page_pos,
                         q_pos, *, k_scales=None, v_scales=None, window=None,
                         causal=True):
    """Launch ``paged_decode_kernel`` for the pages' storage kind (and,
    with more than one split, ``paged_combine_kernel``); arguments as
    ``paged_attention_ref`` (int8/fp8 pages: with their scales, as
    ``paged_attention_quant_ref``)."""
    kind, (q, kp, vp), (ks, vs), (bt, pp, qp) = _checked(
        q, k_pages, v_pages, k_scales, v_scales, block_tables, page_pos,
        q_pos)
    b, lq, h, dh = q.shape
    if lq != 1:
        raise ValueError(f"q {tuple(q.shape)}: decode takes one query a row")
    _, bs, hkv, _ = kp.shape
    mb = bt.shape[1]
    nsplit, per = decode_plan(b, h, hkv, mb, bs)
    out = torch.empty_like(q)
    part_o, part_ml = _partials(nsplit, b * h, dh, q.device)
    err = build.load("paged_attention").paged_attention_decode(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(), _ptr(ks), _ptr(vs),
        bt.data_ptr(), pp.data_ptr(), qp.data_ptr(), out.data_ptr(),
        _ptr(part_o), _ptr(part_ml), kind, Q_DTYPES[q.dtype], b, h, hkv, dh,
        bs, mb, int(causal), _window(window), nsplit, per, float(dh ** -0.5),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "paged_decode_kernel")
    return out


def paged_prefill_attention_cuda(q, k_pages, v_pages, block_tables,
                                 page_pos, q_start, q_len, *, k_scales=None,
                                 v_scales=None, window=None, causal=True):
    """Launch ``paged_chunk_kernel`` for the pages' storage kind (and, with
    more than one split, ``paged_combine_kernel``); arguments as
    ``paged_prefill_attention_ref`` (int8/fp8 pages: with their scales)."""
    kind, (q, kp, vp), (ks, vs), (bt, pp, qs, ql) = _checked(
        q, k_pages, v_pages, k_scales, v_scales, block_tables, page_pos,
        q_start, q_len)
    b, lq, h, dh = q.shape
    _, bs, hkv, _ = kp.shape
    mb = bt.shape[1]
    nsplit, per = prefill_plan(b, lq, h, hkv, dh, mb, bs)
    out = torch.empty_like(q)
    part_o, part_ml = _partials(nsplit, b * lq * h, dh, q.device)
    err = build.load("paged_attention").paged_attention_prefill(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(), _ptr(ks), _ptr(vs),
        bt.data_ptr(), pp.data_ptr(), qs.data_ptr(), ql.data_ptr(),
        out.data_ptr(), _ptr(part_o), _ptr(part_ml), kind, Q_DTYPES[q.dtype],
        b, lq, h, hkv, dh, bs, mb, int(causal), _window(window), nsplit, per,
        float(dh ** -0.5),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "paged_chunk_kernel")
    return out
