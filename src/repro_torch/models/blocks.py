"""Per-layer blocks (counterpart of ``repro.models.blocks``): the attention
block with its two paged serving branches and the dense (GLU) FFN.

    init_attention(generator, cfg)          -> params
    apply_attention(p, cfg, blk, x, ctx, cache) -> (x, cache)

``cache`` is one layer's paged KV dict (``kp``/``vp``/``ppos``/``bt``,
plus ``ksc``/``vsc`` scales for int8/fp8 pages), written in place.  ``ctx`` carries sin/cos, q_offset, q_end, rows,
chunked and use_kernels, shared across layers.  Ported branches:

  * paged decode (L == 1, no ``rows``): write the token's K/V, attend over
    the row's pages — ``kernels.ops.paged_attention`` under use_kernels,
    else the plain gather path;
  * paged chunked prefill (``ctx['chunked']``): write the chunk's K/V into
    the rows' pages, attend over every written block —
    ``kernels.ops.paged_prefill_attention`` under use_kernels.

The ring, blocking-prefill, flash, MoE, RG-LRU, RWKV and cross-attention
branches are later slices.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops
from repro_torch.nn import (ACTIVATIONS, LayerNorm, Linear, RMSNorm,
                            apply_rope, attention_core, make_attention_mask)
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


def _per_row(x, batch: int, device):
    x = torch.as_tensor(x, device=device).long()
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
    bt = cache["bt"] if rows is None else cache["bt"][rows]
    posm = paged_positions(ctx, b, l, x.device)
    paged_write(cache, k, v, posm, block_tables=bt)
    # quantized pages: the kernels take the per-slot scales and fuse the
    # dequant into their page loads
    scale_kw = ({"k_scales": cache["ksc"], "v_scales": cache["vsc"]}
                if "ksc" in cache else {})
    if ctx.get("chunked"):
        if kernels:
            o = kops.paged_prefill_attention(
                q, cache["kp"], cache["vp"], bt, cache["ppos"], posm[:, 0],
                (posm >= 0).sum(-1), window=window, causal=cfg.causal,
                **scale_kw)
    elif l == 1 and rows is None:
        if kernels:
            o = kops.paged_attention(q, cache["kp"], cache["vp"], bt,
                                     cache["ppos"], posm[:, 0],
                                     window=window, causal=cfg.causal,
                                     **scale_kw)
    else:
        raise NotImplementedError(
            "blocking (whole-prompt) prefill is a later slice of the port; "
            "serve with chunked prefill")
    if not kernels:
        kc, vc, kvpos = paged_view(cache, bt)         # fp32, dequantized
        mask = make_attention_mask(posm, kvpos, causal=cfg.causal,
                                   window=window, kv_valid=kvpos >= 0)
        mask = mask & (posm >= 0)[..., None]
        o = attention_core(q, kc, vc, mask=mask,
                           logit_softcap=cfg.logit_softcap)
    x = x + Linear.apply(p["wo"], o.reshape(b, l, -1))
    return x + apply_ffn(p["ffn"], cfg, _norm(cfg).apply(p["ln2"], x))
