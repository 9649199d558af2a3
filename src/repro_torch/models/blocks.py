"""Per-layer blocks (counterpart of ``repro.models.blocks``): the attention
block with its serving branches and the dense (GLU) FFN.

    init_attention(generator, cfg)              -> params
    init_kv_cache(cfg, batch, capacity, dtype, device=...) -> ring cache
    apply_attention(p, cfg, blk, x, ctx, cache) -> x

``cache`` is one layer's KV dict, updated in place: a paged pool
(``kp``/``vp``/``ppos``/``bt``, plus ``ksc``/``vsc`` scales for int8/fp8
pages) or a ring buffer (``k``/``v``/``pos``/``idx``).  ``ctx`` carries
sin/cos, q_offset, q_end, rows, chunked, impl and use_kernels, shared
across layers.  Branches:

  * decode (L == 1, no ``rows``): write the token's K/V, attend over the
    row's pages (``kernels.ops.paged_attention`` under use_kernels) or
    over the ring (``kernels.ops.decode_attention`` under use_kernels),
    else the plain path;
  * paged chunked prefill (``ctx['chunked']``): write the chunk's K/V into
    the rows' pages, attend over every written block —
    ``kernels.ops.paged_prefill_attention`` under use_kernels;
  * blocking (whole-prompt) prefill: write the K/V into the rows' pages or
    the ring, attend over the fresh K/V with ``ctx['impl']`` — naive,
    chunked, or flash (``kernels.ops.flash_attention``, whatever
    use_kernels says, as in the reference).

The MoE, RG-LRU, RWKV and cross-attention branches are later slices.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops
from repro_torch.nn import (ACTIVATIONS, LayerNorm, Linear, RMSNorm,
                            apply_rope, attention_core, make_attention_mask,
                            multi_head_attention)
from repro_torch.serve.kvpool import paged_view, paged_write


def _norm(cfg):
    return RMSNorm if cfg.norm == "rms" else LayerNorm


def init_ffn(generator, cfg):
    d, f = cfg.d_model, cfg.d_ff
    p = {"up": Linear.init(generator, d, f, use_bias=False),
         "down": Linear.init(generator, f, d, use_bias=False)}
    if cfg.glu:
        p["gate"] = Linear.init(generator, d, f, use_bias=False)
    return p


def apply_ffn(p, cfg, x):
    act = ACTIVATIONS[cfg.activation]
    u = Linear.apply(p["up"], x)
    if cfg.glu:
        u = act(Linear.apply(p["gate"], x)) * u
    else:
        u = act(u)
    return Linear.apply(p["down"], u)


def init_attention(generator, cfg):
    d, h, hk, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dev = generator.device
    return {
        "ln1": _norm(cfg).init(dev, d),
        "wq": Linear.init(generator, d, (h, hd), use_bias=cfg.qkv_bias),
        "wk": Linear.init(generator, d, (hk, hd), use_bias=cfg.qkv_bias),
        "wv": Linear.init(generator, d, (hk, hd), use_bias=cfg.qkv_bias),
        "wo": Linear.init(generator, h * hd, d, use_bias=False),
        "ln2": _norm(cfg).init(dev, d),
        "ffn": init_ffn(generator, cfg),
    }


def init_kv_cache(cfg, batch: int, capacity: int, dtype=torch.float32, *,
                  device):
    """One layer's ring buffer on ``device``: K/V (batch, capacity, Hkv,
    Dh), the absolute position each slot holds (-1 = empty, shared by the
    rows) and ``idx``, the next absolute position (a host int)."""
    shape = (batch, capacity, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.full((capacity,), -1, dtype=torch.int32,
                              device=device),
            "idx": 0}


def cache_write(cache, k, v, q_offset: int):
    """Write L new entries at absolute positions q_offset .. q_offset+L-1
    into the ring, modulo its capacity, in place.  When L exceeds the
    capacity (a window prefill) only the last ``capacity`` entries
    survive."""
    cap = cache["k"].shape[1]
    l = k.shape[1]
    if l > cap:
        k, v = k[:, -cap:], v[:, -cap:]
        q_offset += l - cap
        l = cap
    pos = q_offset + torch.arange(l, device=k.device)
    slots = pos % cap
    cache["k"][:, slots] = k.to(cache["k"].dtype)
    cache["v"][:, slots] = v.to(cache["v"].dtype)
    cache["pos"][slots] = pos.to(torch.int32)
    cache["idx"] += l
    return cache


def _per_row(x, batch: int, device):
    if not isinstance(x, torch.Tensor):      # a host int: no host->device copy
        return torch.full((batch,), int(x), dtype=torch.long, device=device)
    x = x.to(device).long()
    return x.expand(batch) if x.ndim == 0 else x


def paged_positions(ctx, batch: int, l: int, device):
    """Per-row absolute positions (B, L) from ctx['q_offset'] (scalar or
    (B,); -1 marks an inactive row).  Positions at or past ctx['q_end']
    (bucket padding) become -1: their writes go to the trash block and
    their queries are fully masked."""
    qo = _per_row(ctx.get("q_offset", 0), batch, device)
    pos = qo[:, None] + torch.arange(l, device=device)[None]
    if ctx.get("q_end") is not None:
        qe = _per_row(ctx["q_end"], batch, device)
        pos = torch.where(pos >= qe[:, None], -1, pos)
    return torch.where(qo[:, None] < 0, -1, pos)


def apply_attention(p, cfg, blk, x, ctx, cache):
    b, l, _ = x.shape
    h = _norm(cfg).apply(p["ln1"], x)
    q = Linear.apply(p["wq"], h)          # (B, L, H, hd)
    k = Linear.apply(p["wk"], h)          # (B, L, Hkv, hd)
    v = Linear.apply(p["wv"], h)
    window = cfg.local_window if blk == "local" else cfg.window
    if ctx.get("sin") is not None:
        q = apply_rope(q, ctx["sin"], ctx["cos"])
        k = apply_rope(k, ctx["sin"], ctx["cos"])
    kernels = ctx.get("use_kernels") and cfg.logit_softcap is None
    rows = ctx.get("rows")
    # a 1-token prompt of a row-subset prefill is not a decode step
    decode = l == 1 and rows is None
    if "bt" in cache:
        bt = cache["bt"] if rows is None else cache["bt"][rows]
        posm = paged_positions(ctx, b, l, x.device)
        paged_write(cache, k, v, posm, block_tables=bt)
        if decode or ctx.get("chunked"):
            o = _paged_attention(q, cfg, window, cache, bt, posm, kernels,
                                 chunked=not decode)
        else:
            o = _fresh_attention(q, k, v, cfg, window, ctx)
    else:
        q_offset = ctx.get("q_offset", 0)
        cache_write(cache, k, v, q_offset)
        if not decode:
            o = _fresh_attention(q, k, v, cfg, window, ctx)
        elif kernels:
            o = kops.decode_attention(q, cache["k"], cache["v"], cache["pos"],
                                      q_pos=q_offset, window=window,
                                      causal=cfg.causal)
        else:
            q_pos = q_offset + torch.arange(l, device=x.device)
            pos = cache["pos"].long()
            mask = make_attention_mask(q_pos, pos, causal=cfg.causal,
                                       window=window, kv_valid=pos >= 0)
            o = attention_core(q, cache["k"], cache["v"], mask=mask[None],
                               logit_softcap=cfg.logit_softcap)
    x = x + Linear.apply(p["wo"], o.reshape(b, l, -1))
    return x + apply_ffn(p["ffn"], cfg, _norm(cfg).apply(p["ln2"], x))


def _paged_attention(q, cfg, window, cache, bt, posm, kernels, *, chunked):
    """Attention over the rows' pages (already holding the new K/V)."""
    if kernels:
        # quantized pages: the kernels take the per-slot scales and fuse
        # the dequant into their page loads
        scale_kw = ({"k_scales": cache["ksc"], "v_scales": cache["vsc"]}
                    if "ksc" in cache else {})
        if chunked:
            return kops.paged_prefill_attention(
                q, cache["kp"], cache["vp"], bt, cache["ppos"], posm[:, 0],
                (posm >= 0).sum(-1), window=window, causal=cfg.causal,
                **scale_kw)
        return kops.paged_attention(q, cache["kp"], cache["vp"], bt,
                                    cache["ppos"], posm[:, 0], window=window,
                                    causal=cfg.causal, **scale_kw)
    kc, vc, kvpos = paged_view(cache, bt)             # fp32, dequantized
    mask = make_attention_mask(posm, kvpos, causal=cfg.causal,
                               window=window, kv_valid=kvpos >= 0)
    mask = mask & (posm >= 0)[..., None]
    return attention_core(q, kc, vc, mask=mask,
                          logit_softcap=cfg.logit_softcap)


def _fresh_attention(q, k, v, cfg, window, ctx):
    """Blocking prefill: the prompt's queries attend over its own fresh
    K/V (right for any window / capacity relation).  Positions are
    relative to the prompt's start, as the reference's naive and flash
    branches take them."""
    return multi_head_attention(q, k, v, impl=ctx.get("impl", "naive"),
                                causal=cfg.causal, window=window,
                                chunk_size=cfg.attn_chunk,
                                logit_softcap=cfg.logit_softcap)
