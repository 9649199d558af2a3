"""Serving engine (counterpart of ``repro.serve.engine``): config, pool
and cache construction, block-table installs, and the step functions —
``prefill`` (blocking, whole prompt), ``prefill_chunk`` (paged, one
chunk), ``decode_step`` — plus ``greedy_generate``.

Two cache layouts, as in the reference:

  * ``ring``  — one contiguous (B, capacity, Hkv, Dh) buffer per layer
                with a shared slot-position vector; every row decodes at
                one shared position (fill-drain and the continuous ring
                arm, which re-prefills the grid when it changes);
  * ``paged`` — a shared page pool per layer addressed through per-row
                block tables (``serve.kvpool``); rows decode at their own
                positions and ``prefill(..., rows=[j])`` writes one
                joining row's K/V without touching its siblings.

An RG-LRU or RWKV layer's cache is its recurrent state, O(1) per row,
on both layouts; the paged runtime refuses recurrent blocks
(``serve.runtime``), so they serve on the ring and in fill-drain.  An
encoder-decoder model (``ServeConfig.kind='encdec'``, whisper) serves on
the ring only, as in the reference: its prefill takes the frame
embeddings (``extra``), runs the encoder and fills each decoder layer's
cross-K/V, which its decode steps read.  A vision-language model
(``kind='vlm'``, llava) also serves on the ring only, as in the
reference: its prefill takes the patch embeddings (``extra``) and runs
the backbone over the projected patches and then the prompt; its decode
steps take text tokens, at the positions the caller gives.

Unlike the reference's functional updates, ``set_block_tables``,
``reset_blocks`` and the step functions update the cache IN PLACE; they
return the cache for symmetry with the reference.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import MuxSpec
from repro_torch.core import quant as quantlib
from repro_torch.models import VLM, EncDecLM, TransformerLM
from repro_torch.models.blocks import heads_split
from repro_torch.models.transformer import check_dtype
from repro_torch.models.config import ModelConfig
from repro_torch.serve.kvpool import (KVPool, ShardedKVPool, blocks_for,
                                      check_page_storage, copy_pages,
                                      pages_as_bytes, pages_from_bytes,
                                      pages_nbytes, put_pages, take_pages)


def backbone_batch(global_batch: int, mux: MuxSpec) -> int:
    if global_batch % max(mux.n, 1):
        raise ValueError(f"batch {global_batch} not divisible by N={mux.n}")
    return global_batch // max(mux.n, 1)


# the model class of each serve kind
MODELS = {"lm": TransformerLM, "encdec": EncDecLM, "vlm": VLM}
KINDS = tuple(MODELS)


@dataclass(frozen=True)
class ServeConfig:
    """A model served from a ring cache or from paged KV of ``block_size``
    tokens (``cache_layout``, 'ring' by default as in the reference).

    kind: 'lm' (decoder-only, the default), 'encdec' (whisper) or 'vlm'
    (llava); the last two on the ring only, as the reference.  dtype: the
    compute dtype the model runs in (``MODELS[kind].apply(dtype=)``), bf16 by
    default as in the reference, or fp32, for every model kind, block kind
    and attention implementation; the ring, the cross-K/V and an RWKV
    layer's token shifts are stored in it (its matrix state is fp32).
    kv_dtype (paged only): page storage — 'fp32' |
    'bf16' | 'int8' | 'fp8' (any ``core.quant.resolve_kv_dtype``
    spelling); None stores pages in ``dtype``.  int8 and fp8 pages carry
    per-(slot, head) fp32 scales.  num_blocks (paged only): the pool's
    size in blocks, the trash block included; None sizes it for the
    worst case, every row at capacity.  A smaller pool makes the runtime
    roll admissions back and preempt decoding rows (``serve.runtime``).
    n_shards (paged only): logical data shards on the one device — rows
    and pool blocks split into per-shard segments (``ShardedKVPool``),
    each with its own trash block, the substrate of kill-shard replay."""
    cfg: ModelConfig
    mux: MuxSpec
    capacity: int              # KV capacity (max context)
    dtype: torch.dtype = torch.bfloat16
    cache_layout: str = "ring"      # ring | paged
    block_size: int = 16            # paged: tokens per block
    num_blocks: int | None = None   # paged: pool size (default: worst case)
    n_shards: int = 1               # paged: logical data shards
    kv_dtype: str | None = None     # paged: page storage
    kind: str = "lm"                # lm | encdec | vlm

    def __post_init__(self):
        if self.kind not in KINDS:
            raise NotImplementedError(f"serve kind {self.kind!r}: the port "
                                      f"serves {KINDS} so far")
        if self.cache_layout not in ("ring", "paged"):
            raise ValueError(f"unknown cache layout {self.cache_layout!r}")
        if self.block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {self.block_size}")
        if self.num_blocks is not None and self.num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is reserved)")
        if self.n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {self.n_shards}")
        quantlib.resolve_kv_dtype(self.kv_dtype)
        check_dtype(self.dtype)

    @property
    def max_blocks_per_seq(self) -> int:
        return blocks_for(self.capacity, self.block_size)

    @property
    def kv_quant(self) -> str | None:
        """Quantization kind of the page store ('int8'/'fp8'), or None for
        plain floating-point pages."""
        kind = quantlib.resolve_kv_dtype(self.kv_dtype)
        return kind if kind in quantlib.KV_QUANT_KINDS else None

    @property
    def page_dtype(self) -> torch.dtype:
        """Storage dtype of the KV pages under this config: ``dtype``
        unless ``kv_dtype`` says otherwise."""
        kind = quantlib.resolve_kv_dtype(self.kv_dtype)
        if kind is None:
            return self.dtype
        return quantlib.kv_store_dtype(kind)

    def kv_bytes_per_token(self) -> int:
        """Pool bytes one token occupies across all attention layers
        (payload + scales + the shared slot-position entry); 0 for a model
        without attention layers."""
        cfg = self.cfg
        n_attn = sum(b in ("attn", "local") for b in cfg.pattern_layers)
        per_layer = (2 * cfg.n_kv_heads * cfg.head_dim
                     * self.page_dtype.itemsize)
        if self.kv_quant is not None:
            per_layer += 2 * cfg.n_kv_heads * 4          # fp32 ksc/vsc
        per_layer += 4                                   # int32 ppos entry
        return n_attn * per_layer

    def pool_bytes(self, global_batch: int) -> int:
        """Total device bytes of the page pool for ``global_batch``."""
        return (self.pool_blocks(global_batch) * self.block_size
                * self.kv_bytes_per_token())

    def pool_blocks(self, global_batch: int) -> int:
        """Pool size: ``num_blocks`` when set, else the worst case (every
        row at capacity) plus one trash block per shard."""
        if self.num_blocks is not None:
            if self.num_blocks % self.n_shards:
                raise ValueError(
                    f"num_blocks={self.num_blocks} not divisible by "
                    f"n_shards={self.n_shards}")
            return self.num_blocks
        b = backbone_batch(global_batch, self.mux)
        if b % self.n_shards:
            raise ValueError(f"backbone batch {b} not divisible by "
                             f"n_shards={self.n_shards}")
        return b * self.max_blocks_per_seq + self.n_shards


def lane_config(sc: ServeConfig, n_mux: int) -> ServeConfig:
    """One serving lane's ``ServeConfig`` from a base config (width-lane
    serving): the same model, capacity, dtype, pages and shard count,
    only the mux width changes.  ``num_blocks`` is reset to None so each lane sizes
    its own pool from its own row count (a router's global budget then
    caps live usage through per-lane quotas)."""
    if n_mux < 1:
        raise ValueError(f"lane mux width must be >= 1, got {n_mux}")
    return dataclasses.replace(
        sc, mux=dataclasses.replace(sc.mux, n=n_mux), num_blocks=None)


def make_pool(sc: ServeConfig, global_batch: int):
    """Host allocator matching ``init_cache(sc, global_batch)``: a
    ``ShardedKVPool`` when ``sc.n_shards > 1``, else a ``KVPool``."""
    if sc.n_shards > 1:
        return ShardedKVPool(num_blocks=sc.pool_blocks(global_batch),
                             block_size=sc.block_size,
                             max_blocks_per_seq=sc.max_blocks_per_seq,
                             n_shards=sc.n_shards,
                             n_rows=backbone_batch(global_batch, sc.mux))
    return KVPool(num_blocks=sc.pool_blocks(global_batch),
                  block_size=sc.block_size,
                  max_blocks_per_seq=sc.max_blocks_per_seq)


def init_cache(sc: ServeConfig, global_batch: int, *, device, mesh=None):
    """The cache for ``global_batch`` streams on ``device``: a ring in
    ``sc.dtype``, or pages stored as ``sc.page_dtype`` says; RG-LRU and RWKV
    layers hold their recurrent state on either layout (conv inputs and
    token shifts in ``sc.dtype``), cross-attention layers their cross-K/V beside a
    ring.  mesh (paged only): this rank's part of the cache on a serve
    mesh — its data shard's rows and page segment (``num_blocks / data``
    blocks, its local block 0 the shard's trash block) and, where the
    model axis splits the heads (``models.blocks.heads_split``), its KV
    heads."""
    b = backbone_batch(global_batch, sc.mux)
    if mesh is not None and (sc.kind != "lm" or sc.cache_layout != "paged"):
        raise ValueError("a mesh cache needs the paged layout of an LM")
    if sc.kind != "lm":
        if sc.cache_layout == "paged":
            raise NotImplementedError(
                "paged cache layout: decoder-only LM families")
        return MODELS[sc.kind].init_cache(sc.cfg, b, sc.capacity, sc.dtype,
                                          device=device)
    if sc.cache_layout == "ring":
        return TransformerLM.init_cache(sc.cfg, b, sc.capacity, sc.dtype,
                                        device=device)
    # a quantized pool takes its storage from kv_quant; the dtype then
    # types only non-attention state, which stays floating-point
    dt = sc.dtype if sc.kv_quant is not None else sc.page_dtype
    cfg, blocks = sc.cfg, sc.pool_blocks(global_batch)
    if mesh is not None:
        b //= mesh.shape["data"]
        blocks //= mesh.shape["data"]
        if heads_split(cfg, mesh):
            cfg = cfg.replace(
                n_kv_heads=cfg.n_kv_heads // mesh.shape["model"])
    return TransformerLM.init_cache(
        cfg, b, sc.capacity, dt, layout="paged", block_size=sc.block_size,
        num_blocks=blocks, kv_quant=sc.kv_quant, device=device)


def set_block_tables(cache, block_tables):
    """Install a host (B, max_blocks_per_seq) table into the cache's shared
    block table, in place."""
    cache["bt"].copy_(torch.as_tensor(np.asarray(block_tables, np.int32)))
    return cache


def reset_blocks(cache, block_ids):
    """Mark pool blocks empty (position entries -1) in every layer, in
    place.  Required for blocks from ``KVPool.allocate``/``append`` before
    their first write: freed blocks are reused without clearing, and stale
    position entries would leak a retired request's KV into the new
    owner."""
    ids = list(block_ids)
    if not ids:
        return cache
    idx = torch.as_tensor(ids, dtype=torch.long, device=cache["bt"].device)
    for c in cache["layers"]:
        c["ppos"][idx] = -1
    return cache


def copy_cache_pages(src_cache, dst_cache, src_ids, dst_ids, *, mesh=None,
                     src_shard: int = 0, dst_shard: int = 0):
    """Migrate whole pool pages between two paged caches (disaggregated
    serving), in place: pages ``src_ids`` of every layer of ``src_cache``
    land in slots ``dst_ids`` of the same layer of ``dst_cache`` —
    payload, quant scales and position entries (``kvpool.take_pages`` /
    ``put_pages`` per layer, bit for bit); the ids are int lists or device
    tensors.  The caches must share layers, page shape and storage; the
    block tables are the caller's to install.  Returns ``dst_cache``.

    mesh: a serve mesh whose data shard ``src_shard`` holds the source
    pages and ``dst_shard`` the destination's, each rank its segment
    (the ids are local to it) and, where the KV heads split, its heads.
    Every rank calls it.  On one shard its ranks copy locally; between
    two, rank (src_shard, m) sends every layer's pages as bytes to rank
    (dst_shard, m) for each model coordinate m: one ``page_move``
    broadcast over ``data``, which moves bytes and sums nothing."""
    if len(src_ids) != len(dst_ids):
        raise ValueError("page migration needs equal-length id lists")
    if len(src_ids) == 0:
        return dst_cache
    # the ids go to the device once for every layer
    dev = dst_cache["bt"].device
    src_ids = torch.as_tensor(src_ids, dtype=torch.long).to(dev)
    dst_ids = torch.as_tensor(dst_ids, dtype=torch.long).to(dev)
    pairs = [(s, d) for s, d in zip(src_cache["layers"], dst_cache["layers"],
                                    strict=True) if "ppos" in d]
    # before any collective, on every rank alike
    check_page_storage([s for s, _ in pairs], [d for _, d in pairs])
    me = None if mesh is None else mesh.coords["data"]
    if mesh is None or src_shard == dst_shard:
        if me is None or me == src_shard:
            for s, d in pairs:
                copy_pages(s, d, src_ids, dst_ids)
        return dst_cache
    like = [d for _, d in pairs]
    n = len(dst_ids)
    nbytes = pages_nbytes(like, n)
    if me == src_shard:
        buf = pages_as_bytes([x for s, _ in pairs
                              for x in take_pages(s, src_ids)])
    else:
        buf = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    mesh.broadcast(buf, "data", src=src_shard, kind="page_move")
    if me == dst_shard:
        for d, pages in zip(like, pages_from_bytes(buf, like, n)):
            put_pages(d, dst_ids, pages)
    return dst_cache


def prefill(params, sc: ServeConfig, cache, tokens, *, extra=None,
            rows=None, use_kernels: bool = False, extra_ctx=None):
    """Blocking prefill of whole prompts: tokens (NB, L).  The K/V go into
    the ring at positions 0 .. L-1, or (paged) into the pages of the
    backbone rows ``rows`` (default: every row), and every query attends
    over the prompt's own fresh K/V with ``cfg.attn_impl``; an RG-LRU or
    RWKV layer runs its recurrence from the cache's state and leaves its
    final state there.  extra: kind 'encdec', the (NB, frames, D_enc)
    frame embeddings the encoder runs over; kind 'vlm', the (NB, P,
    D_VISION) patch embeddings, projected and put in front of the prompt
    (the ring then holds positions 0 .. P + L - 1).  use_kernels: the
    layers' kernels (the RWKV6 recurrence; the attention follows
    ``cfg.attn_impl`` either way) and the mux-combine kernel of the
    entries.  As in the reference, the entry and exit are the plain
    (unfused) ones.
    extra_ctx: more layer-context entries (``trash``: the rows' trash
    block ids under logical shards; ``mesh``: the serve mesh, whose rank
    holds ``rows`` and the cache's part of them).  Returns (last-position
    logits (NB, V), cache)."""
    ctx = dict(extra_ctx or {})
    if rows is not None:
        if sc.cache_layout != "paged":
            raise ValueError("rows= requires the paged cache layout")
        ctx["rows"] = torch.as_tensor(rows, device=cache["bt"].device).long()
    kw = dict(mux=sc.mux, cache=cache, dtype=sc.dtype,
              use_kernels=use_kernels, fuse_io=False, extra_ctx=ctx)
    if sc.kind != "lm" and extra is None:
        raise ValueError(f"a {sc.kind!r} prefill needs the "
                         f"{MODELS[sc.kind].FRONTEND} (extra=)")
    args = () if sc.kind == "lm" else (extra,)
    logits = MODELS[sc.kind].apply(params, sc.cfg, tokens, *args,
                                   **kw)["logits"]
    return logits[:, -1], cache


def prefill_chunk(params, sc: ServeConfig, cache, tokens, *, rows, start,
                  length, use_kernels: bool = True, extra_ctx=None):
    """One bucket-padded prompt chunk for the backbone rows ``rows``.

    tokens: (len(rows) * N, C); KV is written at positions start ..
    start + length - 1 of the rows' pages (the padded tail goes to the
    trash block) and each query attends causally over the rows' written
    blocks.  extra_ctx as ``prefill``'s.  Returns (logits at the chunk's
    last valid position (len(rows) * N, V), cache)."""
    if sc.cache_layout != "paged":
        raise ValueError("prefill_chunk requires the paged cache layout")
    if sc.kind != "lm":
        raise NotImplementedError(
            "chunked prefill supports decoder-only LM families")
    dev = cache["bt"].device
    start = torch.as_tensor(start, device=dev).long()
    length = torch.as_tensor(length, device=dev).long()
    ctx = dict(extra_ctx or {})
    ctx.update({"rows": torch.as_tensor(rows, device=dev).long(),
                "chunked": True, "q_end": start + length})
    h = TransformerLM.apply(params, sc.cfg, tokens, mux=sc.mux, cache=cache,
                            q_offset=start, dtype=sc.dtype,
                            logits_out=False,
                            use_kernels=use_kernels,
                            extra_ctx=ctx)["hidden"]          # (NB, C, D)
    if length.ndim:          # per-row lengths, mux-major instance order
        last = length.repeat(h.shape[0] // length.shape[0]) - 1
    else:
        last = (length - 1).expand(h.shape[0])
    h_last = h[torch.arange(h.shape[0], device=dev), last]
    return TransformerLM.logits(params, sc.cfg, h_last,
                                mesh=ctx.get("mesh")), cache


def decode_step(params, sc: ServeConfig, cache, tokens, pos, *,
                use_kernels: bool = True, extra_ctx=None):
    """One decode step.  tokens (N*B, 1); pos: an int, the position every
    row writes at (the ring's only form), or on the paged layout a (B,)
    tensor of per-row positions (-1 = inactive row).  An encoder-decoder
    step reads the cross-K/V its prefill left in the cache.  extra_ctx as
    ``prefill``'s.  Returns (logits (N*B, 1, V), cache)."""
    if sc.cache_layout == "ring" and isinstance(pos, torch.Tensor):
        raise TypeError("the ring cache decodes at one int position")
    kw = dict(mux=sc.mux, cache=cache, q_offset=pos, dtype=sc.dtype,
              use_kernels=use_kernels)
    if extra_ctx:
        kw["extra_ctx"] = extra_ctx
    out = MODELS[sc.kind].apply(params, sc.cfg, tokens, **kw)
    return out["logits"], cache


def _first_leaf(tree):
    while isinstance(tree, (dict, list, tuple)):
        tree = next(iter(tree.values() if isinstance(tree, dict) else tree))
    return tree


def greedy_generate(params, sc: ServeConfig, prompt, *, steps: int,
                    extra=None):
    """Host-loop greedy decoding of prompt (NB, L) for ``steps`` tokens on
    the params' device (decode steps on the kernel path), from a fresh
    cache of either layout (paged: every row's blocks allocated up
    front); ``extra`` as ``prefill``'s.  Decode step t runs at position
    L + t, as the reference's: for kind 'vlm' that leaves out the P patch
    positions the prefill wrote (ROADMAP.md §3); ``prefill`` and
    ``decode_step`` serve it at the true positions.  Returns (NB, steps)
    tokens."""
    dev = _first_leaf(params).device
    prompt = torch.as_tensor(prompt, device=dev)
    cache = init_cache(sc, prompt.shape[0], device=dev)
    if sc.cache_layout == "paged":
        b = backbone_batch(prompt.shape[0], sc.mux)
        pool = make_pool(sc, prompt.shape[0])
        for j in range(b):
            pool.allocate(j, prompt.shape[1] + steps)
        set_block_tables(cache, pool.table_array(range(b)))
    logits, _ = prefill(params, sc, cache, prompt, extra=extra)
    tok = logits.argmax(-1)[:, None]
    out = [tok]
    for t in range(steps - 1):
        logits, _ = decode_step(params, sc, cache, tok, prompt.shape[1] + t)
        tok = logits[:, -1].argmax(-1)[:, None]
        out.append(tok)
    return torch.cat(out, dim=1)
