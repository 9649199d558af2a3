"""Per-layer blocks (counterpart of ``repro.models.blocks``): the attention
block with its serving branches, the dense (GLU) FFN, the RG-LRU
(Griffin / RecurrentGemma) block, the RWKV6 (Finch) block and the
cross-attention decoder block (whisper); ``init_block`` /
``init_block_cache`` / ``apply_block`` dispatch on the block kind
('attn', 'local', 'rglru', 'rwkv', 'xattn').

    init_attention(generator, cfg)              -> params
    init_kv_cache(cfg, batch, capacity, dtype, device=...) -> ring cache
    apply_attention(p, cfg, blk, x, ctx, cache) -> x
    init_rglru(generator, cfg) / init_rglru_cache(cfg, batch, dtype, ...)
    apply_rglru(p, cfg, blk, x, ctx, cache)     -> x
    init_rwkv(generator, cfg) / init_rwkv_cache(cfg, batch, dtype, ...)
    apply_rwkv(p, cfg, blk, x, ctx, cache)      -> x
    init_xattn(generator, cfg) / init_xattn_cache(cfg, batch, capacity,
                                                   enc_len, dtype, ...)
    apply_xattn(p, cfg, blk, x, ctx, cache)     -> x

``cache`` is one layer's KV dict, updated in place: a paged pool
(``kp``/``vp``/``ppos``/``bt``, plus ``ksc``/``vsc`` scales for int8/fp8
pages) or a ring buffer (``k``/``v``/``pos``/``idx``); None is the
no-cache forward (an encoder, or a full forward without serving state).
``ctx`` carries sin/cos, q_offset, q_end, rows, chunked, impl,
use_kernels, the per-row trash block ids of logical shards (``trash``,
one per row of the batch) and, for the cross-attention block, enc_out,
shared across layers.  Branches:

  * decode (L == 1, no ``rows``): write the token's K/V, attend over the
    row's pages (``kernels.ops.paged_attention`` under use_kernels) or
    over the ring (``kernels.ops.decode_attention`` under use_kernels),
    else the plain path;
  * paged chunked prefill (``ctx['chunked']``): write the chunk's K/V into
    the rows' pages, attend over every written block —
    ``kernels.ops.paged_prefill_attention`` under use_kernels;
  * blocking (whole-prompt) prefill, and the no-cache forward: write the
    K/V into the rows' pages or the ring (if there is a cache), attend
    over the fresh K/V with ``ctx['impl']`` — naive, chunked, or flash
    (``kernels.ops.flash_attention``, whatever use_kernels says, as in
    the reference).

An RG-LRU layer's cache is its recurrent state, O(1) per row on either
layout: ``h`` (B, W) in fp32 and ``conv`` (B, 3, W), the last three
inputs of its 4-tap causal depthwise conv, in the cache dtype.
``apply_rglru`` runs the linear recurrence h_t = a_t h_{t-1} + u_t as
``linear_scan``, the odd/even recursion of the reference's
``jax.lax.associative_scan`` in plain tensor ops (the reference has no
Pallas kernel for it).

An RWKV layer's cache is its recurrent state, O(1) per row on either
layout: the (B, H, hd, hd) fp32 matrix state ``s`` and the last token's
normed input to the time mix and to the channel mix (``shift_tm``,
``shift_cm``, (B, D)).  ``apply_rwkv`` runs the recurrence through
``kernels.ops.rwkv6_chunked`` under use_kernels, else its plain version
``rwkv_chunked`` (the reference's ``blocks.rwkv_chunked``, chunk rule
included).

A cross-attention layer (whisper's decoder) runs the attention block's
self-attention over a ring, then attends over the encoder's output:
``ctx['enc_out']`` (B, Lenc, D) at a prefill, whose projected cross-K/V
the layer keeps in its cache (``xk``/``xv``, (B, Lenc, Hkv, Dh)), the
cached cross-K/V at a decode step.  Ring only, as in the reference.

An attention block's FFN is dense (GLU or plain) or, with ``cfg.moe``
set, a mixture of experts (``apply_moe``): a softmax router picks each
token's top_k experts, each expert takes at most ``moe_capacity`` of its
assignments (the rest are dropped), the stacked (E, d, f) expert weights
run as one batched product, and shared experts add a plain GLU.  Its
load-balancing aux loss goes on ``ctx['aux']`` (a list the backbone sums
into its output's ``"aux"``).  The dispatch makes no host sync: static
shapes, sorts and gathers, no boolean-mask indexing.

On a serve mesh (``ctx['mesh']``, a ``launch.mesh.ServeMesh``) a rank
holds its data shard's rows and page segment and its shards of the
params (``nn.layers``):

  * ``data`` > 1: the paged pages are the shard's segment and the block
    tables hold global ids, rebased to the segment for the page writes;
    the kernels run shard-local (``kernels.ops.sharded_paged_*``);
  * ``model`` > 1, both head counts dividing it: q / k / v
    column-parallel by heads (the pages hold the rank's KV heads), ``wo``
    row-parallel, one ``all_reduce``; else (``_want_seq_shard``) q / k /
    v whole, each model rank attends over its L-slice of the queries
    (``_seq_shard``) with K/V whole and the output is gathered (a decode
    step's one query attends whole on every rank);
  * the FFN: ``up`` / ``gate`` column-parallel, ``down`` row-parallel,
    one ``all_reduce``, when d_ff divides the model axis;
  * MoE: expert parallelism (``_ep_constrain``) when E divides the model
    axis — each rank runs its E / M experts on the same capacity
    dispatch and one ``all_reduce`` combines them; else every rank runs
    every expert on the gathered weights.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels.paged_attention import _head_axis, _local_tables
from repro_torch.kernels.rwkv6 import rwkv_chunked
from repro_torch.nn import (ACTIVATIONS, LayerNorm, Linear, RMSNorm,
                            apply_rope, attention_core, make_attention_mask,
                            multi_head_attention)
from repro_torch.nn.activations import gelu_tanh, silu, squared_relu
from repro_torch.nn.layers import model_axis, normal, rounded, tp_view
from repro_torch.serve.kvpool import init_pages, paged_view, paged_write


def _norm(cfg):
    return RMSNorm if cfg.norm == "rms" else LayerNorm


def init_ffn(generator, cfg):
    if cfg.moe is not None:
        return init_moe(generator, cfg)
    d, f = cfg.d_model, cfg.d_ff
    p = {"up": Linear.init(generator, d, f, use_bias=False),
         "down": Linear.init(generator, f, d, use_bias=False)}
    if cfg.glu:
        p["gate"] = Linear.init(generator, d, f, use_bias=False)
    return p


def apply_ffn(p, cfg, x, ctx=None):
    """The dense FFN's output, or the MoE FFN's (output, aux), as the
    reference's."""
    if cfg.moe is not None:
        return apply_moe(p, cfg, x, ctx)
    return _glu(p, cfg, x, "", _tp(ctx))


def _tp(ctx):
    """The mesh when its model axis splits the params, else None."""
    mesh = (ctx or {}).get("mesh")
    return mesh if mesh is not None and mesh.shape["model"] > 1 else None


def _glu(p, cfg, x, prefix, tp=None):
    """The dense FFN over ``p[prefix + 'up' | 'gate' | 'down']``; on a
    model axis that divides its width, column- then row-parallel."""
    act = ACTIVATIONS[cfg.activation]
    # the rules split up / gate on their width exactly when it divides
    split = tp is not None and model_axis(p[prefix + "up"]["w"]) == 1
    col = {"out_axis": 1} if split else {}
    u = Linear.apply(p[prefix + "up"], x, tp, **col)
    if cfg.glu:
        u = act(Linear.apply(p[prefix + "gate"], x, tp, **col)) * u
    else:
        u = act(u)
    return Linear.apply(p[prefix + "down"], u, tp, x_split=split)


def _block_ffn(p, cfg, h, ctx):
    """A block's FFN output; an MoE FFN's aux loss goes on ctx['aux']."""
    y = apply_ffn(p, cfg, h, ctx)
    if isinstance(y, tuple):
        y, aux = y
        if ctx.get("aux") is not None:
            ctx["aux"].append(aux)
    return y


# ---------------------------------------------------------------------------
# MoE FFN: top-k routing, capacity dispatch by a stable sort, stacked experts
# ---------------------------------------------------------------------------

def init_moe(generator, cfg):
    """The reference's leaves: ``router`` (d, E), the stacked experts
    ``w_up`` / ``w_gate`` (E, d, f) and ``w_down`` (E, f, d), and with
    shared experts ``shared_up`` / ``shared_gate`` / ``shared_down``, one
    GLU n_shared * d_shared wide."""
    m = cfg.moe
    d, f, e = cfg.d_model, m.d_expert, m.n_experts
    p = {"router": Linear.init(generator, d, e, use_bias=False),
         "w_up": normal(generator, (e, d, f), 0.02),
         "w_down": normal(generator, (e, f, d), 0.02)}
    if cfg.glu:
        p["w_gate"] = normal(generator, (e, d, f), 0.02)
    if m.n_shared:
        fs = (m.d_shared or m.d_expert) * m.n_shared
        p["shared_up"] = Linear.init(generator, d, fs, use_bias=False)
        p["shared_down"] = Linear.init(generator, fs, d, use_bias=False)
        if cfg.glu:
            p["shared_gate"] = Linear.init(generator, d, fs, use_bias=False)
    return p


def moe_capacity(n_tokens: int, cfg) -> int:
    """Assignments an expert takes from ``n_tokens`` tokens: int(n * k / E
    * capacity_factor) + 1, rounded up to a multiple of 8, at least 8."""
    m = cfg.moe
    c = int(n_tokens * m.top_k / m.n_experts * m.capacity_factor) + 1
    return max(8, -(-c // 8) * 8)


_STATS: list | None = None


@contextlib.contextmanager
def record_moe():
    """Record every MoE layer call made inside: yields a list that gets
    one dict per call — ``shape`` ((B, L) of its input),
    ``tokens`` (the n the capacity is computed from), ``cap``, the
    router's ``logits`` (fp32, rounded to the compute dtype first) and
    chosen experts ``topi``, ``dropped`` (a 0-d tensor: assignments past
    their expert's capacity), ``load`` ((E,) tensor: assignments per
    expert) and ``aux``.  The tensors stay on the device (no sync)."""
    global _STATS
    prev, _STATS = _STATS, []
    try:
        yield _STATS
    finally:
        _STATS = prev


def apply_moe(p, cfg, x, ctx=None):
    """x (B, L, D) -> (out (B, L, D), aux 0-d fp32), by ``cfg.moe.impl``:
    'global_sort' routes the B*L tokens as one group, 'local_group' each
    row as its own (capacity from L)."""
    if cfg.moe.impl == "local_group":
        return apply_moe_grouped(p, cfg, x, ctx)
    return apply_moe_global(p, cfg, x, ctx)


def _ep(ctx, n_experts: int):
    """The mesh when expert parallelism applies (a model axis that divides
    E: the rules then split the stacked expert weights on E), else None."""
    tp = _tp(ctx)
    return tp if tp is not None and n_experts % tp.shape["model"] == 0 \
        else None


def _ep_constrain(x, ctx, expert_axis):
    """The expert-parallel layout the reference pins on its mesh, as this
    rank's part of it: ``x``'s expert dim narrowed to this rank's E / M
    experts under expert parallelism; else ``x``."""
    tp = None if expert_axis is None else _ep(ctx, x.shape[expert_axis])
    if tp is None:
        return x
    n = x.shape[expert_axis] // tp.shape["model"]
    return tp.enter(x, "model").narrow(expert_axis, tp.coords["model"] * n,
                                       n)


def _ep_slots(slot, keep, topv, ctx, n_experts, cap):
    """The assignments of this rank's experts, their slots in its local
    (E / M) * cap slots (others weighted 0), and the gates that weight
    them; unchanged without expert parallelism."""
    tp = _ep(ctx, n_experts)
    if tp is None:
        return slot, keep, topv
    n = n_experts // tp.shape["model"] * cap
    lo = tp.coords["model"] * n
    mine = (slot >= lo) & (slot < lo + n)
    return (slot - lo).clamp(0, n - 1), keep & mine, tp.enter(topv, "model")


def _ep_combine(out, ctx, n_experts):
    """Sum the ranks' expert outputs over ``model`` (one ``all_reduce``)
    under expert parallelism."""
    tp = _ep(ctx, n_experts)
    return out if tp is None else tp.all_reduce(out.contiguous(), "model")


def _route(p, cfg, x, tp=None):
    """Router: logits in the compute dtype, softmax in fp32, the top_k
    gates (ties toward the lower expert index, as ``jax.lax.top_k``: a
    stable descending sort, where ``torch.topk`` promises no order)
    renormalised to sum to 1.  Returns the logits (widened to fp32) and
    gates (..., E), topv and topi (..., K)."""
    k = cfg.moe.top_k
    logits = Linear.apply(p["router"], x, tp).float()
    gates = torch.softmax(logits, dim=-1)
    topv, topi = torch.sort(gates, dim=-1, descending=True, stable=True)
    topv, topi = topv[..., :k], topi[..., :k]
    return (logits, gates,
            topv / topv.sum(-1, keepdim=True).clamp(min=1e-9), topi)


def _dispatch(xs, e_flat, k, n_experts, cap):
    """Capacity dispatch of G groups at once.  xs (G, n, D) tokens; e_flat
    (G, n*k) their experts in (token, choice) order.  An assignment's
    place within its expert is its rank in a stable sort of e_flat; places
    at or past ``cap`` are dropped.  Built from sorts and gathers only, so
    every kept slot is written once and the result is deterministic.
    Returns xe (G, E, cap, D) (empty slots zero), slot (G, n*k) into the
    flattened E*cap slots (clamped in range; a dropped assignment's is
    weighted 0 by ``keep``), keep (G, n*k) and counts (G, E)."""
    g, nk = e_flat.shape
    dev = e_flat.device
    order = torch.sort(e_flat, dim=1, stable=True).indices
    e_sorted = torch.gather(e_flat, 1, order)
    experts = torch.arange(n_experts, device=dev).expand(g, -1).contiguous()
    start = torch.searchsorted(e_sorted, experts)                  # (G, E)
    counts = torch.searchsorted(e_sorted, experts, right=True) - start
    pos_sorted = (torch.arange(nk, device=dev)[None]
                  - torch.gather(start, 1, e_sorted))
    pos = torch.empty_like(pos_sorted).scatter_(1, order, pos_sorted)
    keep = pos < cap
    slot = e_flat * cap + pos.clamp(max=cap - 1)
    # slot (e, c) holds expert e's c-th assignment in sorted order
    c = torch.arange(cap, device=dev)
    src = (start[:, :, None] + c).clamp(max=nk - 1).reshape(g, -1)
    tok = torch.gather(order, 1, src) // k                    # (G, E*cap)
    valid = (c < counts.clamp(max=cap)[:, :, None]).reshape(g, -1, 1)
    d = xs.shape[-1]
    xe = torch.gather(xs, 1, tok[..., None].expand(-1, -1, d))
    xe = torch.where(valid, xe, torch.zeros((), dtype=xs.dtype, device=dev))
    return xe.reshape(g, n_experts, cap, d), slot, keep, counts


def _experts(p, cfg, xe, tp=None):
    """The routed experts: xe (G, E, cap, D) -> (G, E, cap, D), each
    expert's GLU over its slots, the stacked weights cast to the compute
    dtype.  On a mesh: this rank's experts (E split) or every expert's
    weights gathered whole."""
    act = ACTIVATIONS[cfg.activation]
    dt = xe.dtype

    def w(name):
        t = p[name]
        return t if tp is None or model_axis(t) == 0 else tp_view(t, None, tp)

    up = torch.einsum("gecd,edf->gecf", xe, w("w_up").to(dt))
    if cfg.glu:
        up = act(torch.einsum("gecd,edf->gecf", xe, w("w_gate").to(dt))) * up
    else:
        up = act(up)
    return torch.einsum("gecf,efd->gecd", up, w("w_down").to(dt))


def _gathered(ye, slot, keep, topv):
    """Each assignment's expert output times its gate weight, the weight
    rounded to the compute dtype first: (G, n*k, D)."""
    g, _, _, d = ye.shape
    yk = torch.gather(ye.reshape(g, -1, d), 1,
                      slot[..., None].expand(-1, -1, d))
    return yk * (keep * topv.reshape(g, -1)).to(ye.dtype)[..., None]


def _record(x, tokens, cap, logits, topi, keep, counts, aux):
    if _STATS is not None:
        _STATS.append({"shape": tuple(x.shape[:2]),
                       "tokens": tokens, "cap": cap,
                       "logits": logits.detach(), "topi": topi,
                       "dropped": (~keep).sum(), "load": counts.sum(0),
                       "aux": aux.detach()})


def apply_moe_global(p, cfg, x, ctx=None):
    """Sort-based dispatch of all B*L tokens with one static capacity
    (GShard-style drops), as the reference's ``apply_moe_global``.  A
    token's K weighted choices add one after another in the compute
    dtype, as its ``.at[tok].add`` into zeros does (no ``index_add_``,
    whose CUDA atomics add in no fixed order)."""
    m = cfg.moe
    tp = _tp(ctx)
    b, l, d = x.shape
    t = b * l
    xt = x.reshape(t, d)
    cap = moe_capacity(t, cfg)
    logits, gates, topv, topi = _route(p, cfg, xt, tp)    # (T, E), (T, K)
    xe, slot, keep, counts = _dispatch(xt[None], topi.reshape(1, -1),
                                       m.top_k, m.n_experts, cap)
    ye = _experts(p, cfg, _ep_constrain(xe, ctx, 1), tp)
    yk = _gathered(ye, *_ep_slots(slot, keep, topv, ctx, m.n_experts,
                                  cap)).reshape(t, m.top_k, d)
    out = yk[:, 0]
    for j in range(1, m.top_k):
        out = out + yk[:, j]
    out = _ep_combine(out, ctx, m.n_experts)
    if m.n_shared:
        out = out + _glu(p, cfg, xt, "shared_", tp)
    # load-balancing aux loss (Switch): E * sum_e f_e * p_e
    density = counts[0].float() / t
    aux = m.n_experts * torch.sum(density / m.top_k * gates.mean(0))
    _record(x, t, cap, logits, topi, keep, counts, aux)
    return out.reshape(b, l, d), aux


def apply_moe_grouped(p, cfg, x, ctx=None):
    """Per-row dispatch, as the reference's ``apply_moe_grouped``:
    routing, sort and capacity (from L) row by row; a token's K weighted
    choices are summed in fp32 and rounded once (the reference's
    reshape-sum)."""
    m = cfg.moe
    tp = _tp(ctx)
    b, l, d = x.shape
    cap = moe_capacity(l, cfg)
    logits, gates, topv, topi = _route(p, cfg, x, tp)     # (B, L, E), K
    xe, slot, keep, counts = _dispatch(x, topi.reshape(b, -1), m.top_k,
                                       m.n_experts, cap)
    ye = _experts(p, cfg, _ep_constrain(xe, ctx, 1), tp)
    yk = _gathered(ye, *_ep_slots(slot, keep, topv, ctx, m.n_experts, cap))
    out = _ep_combine(yk.reshape(b, l, m.top_k, d).sum(2, dtype=torch.float32),
                      ctx, m.n_experts).to(x.dtype)
    if m.n_shared:
        out = out + _glu(p, cfg, x.reshape(b * l, d), "shared_",
                         tp).reshape(b, l, d)
    density = counts.float().sum(0) / (b * l)
    aux = m.n_experts * torch.sum(density / m.top_k * gates.mean((0, 1)))
    _record(x, l, cap, logits, topi, keep, counts, aux)
    return out, aux


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
    x = _self_attention(p, cfg, blk, x, ctx, cache)
    return x + _block_ffn(p["ffn"], cfg, _norm(cfg).apply(p["ln2"], x), ctx)


def _want_seq_shard(cfg, ctx) -> bool:
    """Whether attention runs sequence-sharded over ``model``: a mesh
    whose model axis one of the head counts does not divide (the head
    split would break the GQA grouping), as the reference's auto policy."""
    mesh = ctx.get("mesh")
    if mesh is None:
        return False
    m = mesh.shape.get("model", 1)
    return m > 1 and _head_axis(mesh.shape, cfg.n_heads,
                                cfg.n_kv_heads) is None


def heads_split(cfg, mesh) -> bool:
    """Whether a rank holds a 1 / M head group (q / k / v, the pages'
    KV heads) on ``mesh``: a model axis both head counts divide."""
    return (mesh is not None
            and _head_axis(mesh.shape, cfg.n_heads, cfg.n_kv_heads)
            is not None)


def _seq_shard(x, ctx, *, on_model: bool):
    """The sequence-sharded attention's layout on this rank: queries
    (``on_model``) keep this model rank's L-slice when M divides L; K/V
    stay whole.  No-op without a mesh."""
    mesh = ctx.get("mesh")
    m = 1 if mesh is None else mesh.shape["model"]
    if not on_model or m == 1 or x.shape[1] % m:
        return x
    n = x.shape[1] // m
    return mesh.enter(x, "model").narrow(1, mesh.coords["model"] * n, n)


def _seq_offset(x, ctx, l: int) -> int:
    """Where this rank's L-slice ``x`` (of l) starts: 0 unless sharded."""
    return 0 if x.shape[1] == l else ctx["mesh"].coords["model"] * x.shape[1]


def _seq_gather(o, ctx, l: int):
    """A sequence-sharded attention output gathered whole along L."""
    return o if o.shape[1] == l else ctx["mesh"].gather(o, "model", 1)


def _self_attention(p, cfg, blk, x, ctx, cache):
    """x plus the block's self-attention (``ln1``, ``wq``/``wk``/``wv``,
    ``wo``) over its cache, or over the fresh K/V without one."""
    b, l, _ = x.shape
    tp = _tp(ctx)
    heads = heads_split(cfg, tp)
    seq = _want_seq_shard(cfg, ctx)
    col = {"out_axis": 1} if heads else {}
    h = _norm(cfg).apply(p["ln1"], x)
    q = Linear.apply(p["wq"], h, tp, **col)          # (B, L, H, hd)
    k = Linear.apply(p["wk"], h, tp, **col)          # (B, L, Hkv, hd)
    v = Linear.apply(p["wv"], h, tp, **col)
    window = cfg.local_window if blk == "local" else cfg.window
    if ctx.get("sin") is not None:
        q = apply_rope(q, ctx["sin"], ctx["cos"])
        k = apply_rope(k, ctx["sin"], ctx["cos"])
    kernels = ctx.get("use_kernels") and cfg.logit_softcap is None
    rows = ctx.get("rows")
    # a 1-token prompt of a row-subset prefill is not a decode step
    decode = l == 1 and rows is None
    if not cache:                         # the no-cache forward
        o = _fresh_attention(q, k, v, cfg, window, ctx, seq)
    elif "bt" in cache:
        bt = cache["bt"] if rows is None else cache["bt"][rows]
        shard = _data_shard(ctx)
        # the tables hold global block ids; the pages are this data
        # shard's segment (its local block 0 the trash block)
        bt_pages = bt if shard is None else _local_tables(
            bt, shard.coords["data"], cache["kp"].shape[0])
        posm = paged_positions(ctx, b, l, x.device)
        paged_write(cache, k, v, posm, block_tables=bt_pages,
                    trash=ctx.get("trash"))
        if decode or ctx.get("chunked"):
            qs = _seq_shard(q, ctx, on_model=seq)
            ps = _seq_shard(posm, ctx, on_model=seq)
            o = _seq_gather(_paged_attention(
                qs, cfg, window, cache, bt, bt_pages, ps, kernels,
                chunked=not decode, shard=shard), ctx, l)
        else:
            o = _fresh_attention(q, k, v, cfg, window, ctx, seq)
    else:
        q_offset = ctx.get("q_offset", 0)
        cache_write(cache, k, v, q_offset)
        if not decode:
            o = _fresh_attention(q, k, v, cfg, window, ctx, seq)
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
    return x + Linear.apply(p["wo"], o.reshape(b, l, -1), tp, x_split=heads)


def _data_shard(ctx):
    """The mesh when its data axis splits the rows and pages, else None."""
    mesh = ctx.get("mesh")
    return mesh if mesh is not None and mesh.shape["data"] > 1 else None


def _paged_attention(q, cfg, window, cache, bt, bt_pages, posm, kernels, *,
                     chunked, shard=None):
    """Attention over the rows' pages (already holding the new K/V).  bt:
    the rows' tables (global ids); bt_pages: the same rebased to this data
    shard's segment (``shard``: its mesh, None on one shard)."""
    if kernels:
        # quantized pages: the kernels take the per-slot scales and fuse
        # the dequant into their page loads
        kw = {"window": window, "causal": cfg.causal}
        if "ksc" in cache:
            kw.update(k_scales=cache["ksc"], v_scales=cache["vsc"])
        if chunked:
            args = (q, cache["kp"], cache["vp"], bt, cache["ppos"],
                    posm[:, 0], (posm >= 0).sum(-1))
            if shard is not None:
                return kops.sharded_paged_prefill_attention(shard, *args,
                                                            **kw)
            return kops.paged_prefill_attention(*args, **kw)
        args = (q, cache["kp"], cache["vp"], bt, cache["ppos"], posm[:, 0])
        if shard is not None:
            return kops.sharded_paged_attention(shard, *args, **kw)
        return kops.paged_attention(*args, **kw)
    kc, vc, kvpos = paged_view(cache, bt_pages)   # as stored, or dequantized
    mask = make_attention_mask(posm, kvpos, causal=cfg.causal,
                               window=window, kv_valid=kvpos >= 0)
    mask = mask & (posm >= 0)[..., None]
    # fp32 or dequantized pages under a bf16 q promote the output to fp32;
    # it returns in q's dtype, as the kernels write it (the reference's
    # plain path fails there instead, ROADMAP §3)
    return attention_core(q, kc, vc, mask=mask,
                          logit_softcap=cfg.logit_softcap).to(q.dtype)


def _fresh_attention(q, k, v, cfg, window, ctx, seq=False):
    """Blocking prefill: the prompt's queries attend over its own fresh
    K/V (right for any window / capacity relation).  Positions are
    relative to the prompt's start, as the reference's naive and flash
    branches take them.  seq: this model rank's L-slice of the queries
    over K/V whole, the output gathered."""
    l = q.shape[1]
    qs = _seq_shard(q, ctx, on_model=seq)
    if qs.shape[1] != l:       # each rank's queries over the whole K/V
        k, v = ctx["mesh"].enter(k, "model"), ctx["mesh"].enter(v, "model")
    o = multi_head_attention(qs, k, v, impl=ctx.get("impl", "naive"),
                             causal=cfg.causal, window=window,
                             q_offset=_seq_offset(qs, ctx, l),
                             chunk_size=cfg.attn_chunk,
                             logit_softcap=cfg.logit_softcap)
    return _seq_gather(o, ctx, l)


# ---------------------------------------------------------------------------
# RG-LRU block (Griffin / RecurrentGemma temporal mixing + MLP)
# ---------------------------------------------------------------------------

def init_rglru(generator, cfg):
    """The reference's leaves; the recurrence is d_model wide."""
    d = w = cfg.d_model
    dev = generator.device
    return {
        "ln1": _norm(cfg).init(dev, d),
        "w_in": Linear.init(generator, d, w, use_bias=False),
        "w_gate": Linear.init(generator, d, w, use_bias=False),
        "conv_w": normal(generator, (4, w), 0.02),       # depthwise, 4 taps
        "conv_b": torch.zeros(w, device=dev),
        "w_a": Linear.init(generator, w, w, use_bias=True),   # recurrence gate
        "w_i": Linear.init(generator, w, w, use_bias=True),   # input gate
        "lam": normal(generator, (w,), 0.5),    # a = exp(-8 softplus(lam) r)
        "w_out": Linear.init(generator, w, d, use_bias=False),
        "ln2": _norm(cfg).init(dev, d),
        "ffn": init_ffn(generator, cfg),
    }


def init_rglru_cache(cfg, batch: int, dtype=torch.float32, *, device):
    """One layer's recurrent state on ``device``: ``h`` in fp32, the conv's
    last three inputs in ``dtype``."""
    w = cfg.d_model
    return {"h": torch.zeros((batch, w), device=device),
            "conv": torch.zeros((batch, 3, w), dtype=dtype, device=device)}


def _causal_depthwise_conv(y, w, b, conv_state=None):
    """y (B, L, W) through the 4-tap causal depthwise conv; conv_state
    (B, 3, W), the inputs before y (None: zeros).  The taps add in the
    reference's order, ((t0 + t1) + t2) + t3, then the bias, each op in
    y's dtype.  Returns (out, the new state: the last three inputs)."""
    if conv_state is None:
        ypad = torch.nn.functional.pad(y, (0, 0, 3, 0))
    else:
        ypad = torch.cat([conv_state.to(y.dtype), y], dim=1)
    l = y.shape[1]
    w = w.to(y.dtype)
    out = ypad[:, :l] * w[0]
    for i in range(1, 4):
        out = out + ypad[:, i:i + l] * w[i]
    return out + b.to(y.dtype), ypad[:, -3:]


def linear_scan(a, u):
    """The first-order recurrence h_t = a_t h_{t-1} + u_t along dim 1 (h
    before the first step 0): (prod a, h), the reference's
    ``jax.lax.associative_scan`` of (a1 a2, a2 u1 + u2) as its odd/even
    recursion, about 2 log2(L) levels of elementwise ops.  a2 u1 + u2 is
    ``torch.addcmul``, one rounding as in the reference's compiled step,
    where XLA fuses it into an FMA."""
    n = a.shape[1]
    if n < 2:
        return a, u
    a1, u1, a2, u2 = a[:, 0:-1:2], u[:, 0:-1:2], a[:, 1::2], u[:, 1::2]
    a_odd, u_odd = linear_scan(a1 * a2, torch.addcmul(u2, a2, u1))
    k = a_odd.shape[1] - (n % 2 == 0)
    a3, u3 = a[:, 2::2], u[:, 2::2]
    a_even = torch.cat([a[:, :1], a_odd[:, :k] * a3], dim=1)
    u_even = torch.cat([u[:, :1], torch.addcmul(u3, a3, u_odd[:, :k])],
                       dim=1)
    out = []
    for even, odd in ((a_even, a_odd), (u_even, u_odd)):
        x = torch.empty_like(a)
        x[:, 0::2] = even
        x[:, 1::2] = odd
        out.append(x)
    return tuple(out)


def _softplus(x):
    """``jax.nn.softplus``: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def apply_rglru(p, cfg, blk, x, ctx, cache):
    """One RG-LRU layer.  ``cache``: the layer's state, read and then
    updated in place (None or empty: a zero state, nothing kept).  The
    gates, the decay and the scan are fp32; the recurrence's output meets
    the GELU gate in x's dtype."""
    if ctx.get("rows") is not None:
        raise NotImplementedError(
            "a row-subset prefill of RG-LRU state: the reference's "
            "apply_rglru ignores ctx['rows'] and its _causal_depthwise_conv "
            "joins the whole batch's conv state to the rows' prompt "
            "('Cannot concatenate arrays'; ROADMAP.md §3)")
    b, l, d = x.shape
    h = _norm(cfg).apply(p["ln1"], x)
    y = Linear.apply(p["w_in"], h)
    gate = Linear.apply(p["w_gate"], h)
    y, conv_state = _causal_depthwise_conv(
        y, p["conv_w"], p["conv_b"], cache["conv"] if cache else None)

    r = torch.sigmoid(Linear.apply(p["w_a"], y).float())
    i = torch.sigmoid(Linear.apply(p["w_i"], y).float())
    log_a = -8.0 * _softplus(p["lam"].float()) * r            # (B, L, W)
    a = torch.exp(log_a)
    gated_in = (torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a),
                                       min=1e-12)) * i * y.float())
    h0 = cache["h"] if cache else torch.zeros((b, d), device=x.device)
    u = torch.cat([torch.addcmul(gated_in[:, :1], a[:, :1], h0[:, None]),
                   gated_in[:, 1:]], dim=1)
    _, h_seq = linear_scan(a, u)
    if cache:
        cache["h"].copy_(h_seq[:, -1])
        cache["conv"].copy_(conv_state)

    x = x + Linear.apply(p["w_out"], h_seq.to(x.dtype) * gelu_tanh(gate))
    return x + _block_ffn(p["ffn"], cfg, _norm(cfg).apply(p["ln2"], x), ctx)


# ---------------------------------------------------------------------------
# RWKV6 block (Finch: data-dependent decay linear attention + channel mix)
# ---------------------------------------------------------------------------

def _rwkv_heads(cfg):
    """(heads, head_dim) of the time mix."""
    nh = cfg.rwkv_heads or cfg.d_model // 64
    return nh, cfg.d_model // nh


def init_rwkv(generator, cfg):
    d = cfg.d_model
    nh, hd = _rwkv_heads(cfg)
    lora = 64
    dev = generator.device
    return {
        "ln1": _norm(cfg).init(dev, d),
        # token-shift lerp coefficients for r, k, v, g
        "mu": normal(generator, (4, d), 0.02),
        "w_r": Linear.init(generator, d, (nh, hd), use_bias=False),
        "w_k": Linear.init(generator, d, (nh, hd), use_bias=False),
        "w_v": Linear.init(generator, d, (nh, hd), use_bias=False),
        "w_g": Linear.init(generator, d, d, use_bias=False),
        # data-dependent decay: w = exp(-exp(w0 + tanh(x A) B))
        "dec_w0": normal(generator, (d,), 0.02),
        "dec_a": normal(generator, (d, lora), 0.02),
        "dec_b": normal(generator, (lora, d), 0.02),
        "u": normal(generator, (nh, hd), 0.02),            # bonus
        "gn_scale": torch.ones(d, device=dev),             # per-head groupnorm
        "gn_bias": torch.zeros(d, device=dev),
        "w_o": Linear.init(generator, d, d, use_bias=False),
        "ln2": _norm(cfg).init(dev, d),
        # channel mix (squared-relu MLP with token shift)
        "mu_cm": normal(generator, (d,), 0.02),
        "cm_k": Linear.init(generator, d, cfg.d_ff, use_bias=False),
        "cm_v": Linear.init(generator, cfg.d_ff, d, use_bias=False),
    }


def init_rwkv_cache(cfg, batch: int, dtype=torch.float32, *, device):
    """One layer's recurrent state on ``device``: ``s`` in fp32, the two
    token shifts in ``dtype``."""
    d = cfg.d_model
    nh, hd = _rwkv_heads(cfg)
    return {"s": torch.zeros((batch, nh, hd, hd), device=device),
            "shift_tm": torch.zeros((batch, d), dtype=dtype, device=device),
            "shift_cm": torch.zeros((batch, d), dtype=dtype, device=device)}


def _token_shift(x, prev):
    """x: (B, L, D); prev: (B, D), the last token of the previous segment
    (None: zeros)."""
    if prev is None:
        prev = torch.zeros_like(x[:, 0])
    return torch.cat([prev[:, None].to(x.dtype), x[:, :-1]], dim=1)


def apply_rwkv(p, cfg, blk, x, ctx, cache):
    """One RWKV6 layer.  ``cache``: the layer's state, read and then
    updated in place (None or empty: a zero state, nothing kept)."""
    if ctx.get("rows") is not None:
        raise NotImplementedError(
            "a row-subset prefill of RWKV state: the reference's apply_rwkv "
            "ignores ctx['rows'] and fails on the batch's token shift "
            "(ROADMAP.md §3)")
    b, l, d = x.shape
    nh, hd = _rwkv_heads(cfg)
    h = _norm(cfg).apply(p["ln1"], x)

    hs = _token_shift(h, cache["shift_tm"] if cache else None)
    # the mixing vectors in the compute dtype, as the reference casts them
    # (a bf16 tensor times an fp32 one would compute in fp32 here)
    mu = p["mu"].to(h.dtype)
    hr, hk, hv, hg = (h + (hs - h) * mu[i] for i in range(4))

    r = Linear.apply(p["w_r"], hr)                  # (B, L, H, hd)
    k = Linear.apply(p["w_k"], hk)
    v = Linear.apply(p["w_v"], hv)
    g = silu(Linear.apply(p["w_g"], hg))            # (B, L, D)

    # the decay LoRA in fp32 from h widened, as the reference's
    dec = p["dec_w0"].float() + torch.tanh(
        h.float() @ p["dec_a"].float()) @ p["dec_b"].float()
    logw = -torch.exp(dec).reshape(b, l, nh, hd)    # log decay < 0

    s0 = cache["s"] if cache else torch.zeros((b, nh, hd, hd),
                                              device=x.device)
    # the reference's chunk rule (blocks.py rwkv_chunked's caller).  r, k
    # and v go in the compute dtype: the kernel and its plain versions widen
    # them to fp32 and round out once, as the reference widens them before
    # its fp32 recurrence and rounds out to x's dtype
    chunk = min(l, cfg.rwkv_chunk if l % cfg.rwkv_chunk == 0 else l)
    intra = (torch.bfloat16 if cfg.rwkv_intra_dtype == "bf16"
             else torch.float32)
    if ctx.get("use_kernels"):
        if intra != torch.float32:
            raise NotImplementedError(
                "rwkv_intra_dtype='bf16' runs on the plain path only "
                "(use_kernels=False): the kernel computes in fp32")
        out, s_t = kops.rwkv6_chunked(r, k, v, logw, p["u"].float(), s0,
                                      chunk=chunk)
    else:
        # nested remat of the training forward (no cache), as the
        # reference's remat_inner
        out, s_t = rwkv_chunked(r, k, v, logw, p["u"].float(), s0, chunk,
                                intra_dtype=intra, remat_inner=not cache)
    out = out.to(x.dtype)
    if cache:
        cache["s"] = s_t
        cache["shift_tm"].copy_(h[:, -1])

    # per-head groupnorm, then gate and project.  As the reference's: the
    # mean and variance of the (bf16) out reduce in fp32 and return in its
    # dtype, the normalisation computes in it, the fp32 scale and bias
    # promote the result to fp32, and it meets g in x's dtype
    o = out.reshape(b, l, nh, hd)
    o32 = o.float()
    mean = o32.mean(-1, keepdim=True).to(o.dtype)
    var = o32.var(-1, unbiased=False, keepdim=True).to(o.dtype)
    o = (o - mean) * torch.rsqrt(var + rounded(1e-5, o.dtype))
    o = o.reshape(b, l, d) * p["gn_scale"].float() + p["gn_bias"].float()
    x = x + Linear.apply(p["w_o"], o.to(x.dtype) * g)

    # channel mix with token shift
    h2 = _norm(cfg).apply(p["ln2"], x)
    h2s = _token_shift(h2, cache["shift_cm"] if cache else None)
    if cache:
        cache["shift_cm"].copy_(h2[:, -1])
    hk2 = h2 + (h2s - h2) * p["mu_cm"].to(h2.dtype)
    kk = squared_relu(Linear.apply(p["cm_k"], hk2))
    return x + Linear.apply(p["cm_v"], kk)


# ---------------------------------------------------------------------------
# Cross-attention decoder block (whisper): self-attn + cross-attn + FFN
# ---------------------------------------------------------------------------

def init_xattn(generator, cfg):
    """The reference's parameter names, so ``interop`` maps them one to
    one: the attention block's plus ``lnx`` and ``xwq``/``xwk``/``xwv``/
    ``xwo`` for the cross-attention."""
    d, h, hk, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = init_attention(generator, cfg)
    p["lnx"] = _norm(cfg).init(generator.device, d)
    p["xwq"] = Linear.init(generator, d, (h, hd), use_bias=cfg.qkv_bias)
    p["xwk"] = Linear.init(generator, d, (hk, hd), use_bias=cfg.qkv_bias)
    p["xwv"] = Linear.init(generator, d, (hk, hd), use_bias=cfg.qkv_bias)
    p["xwo"] = Linear.init(generator, h * hd, d, use_bias=False)
    return p


def init_xattn_cache(cfg, batch: int, capacity: int, enc_len: int,
                     dtype=torch.float32, *, device):
    """A ring of ``capacity`` slots for the self-attention (no window, as
    in the reference) and zero cross-K/V of ``enc_len`` frames."""
    c = init_kv_cache(cfg, batch, capacity, dtype, device=device)
    shape = (batch, enc_len, cfg.n_kv_heads, cfg.head_dim)
    c["xk"] = torch.zeros(shape, dtype=dtype, device=device)
    c["xv"] = torch.zeros(shape, dtype=dtype, device=device)
    return c


def apply_xattn(p, cfg, blk, x, ctx, cache):
    """Whisper-style decoder layer.  ``ctx['enc_out']`` (B, Lenc, D) is
    given for a prefill or a full forward: its cross-K/V are projected and
    kept in the cache; a decode step reads them from the cache.  The
    cross-attention is bidirectional over every frame: at a prefill or a
    full forward it follows ``ctx['impl']`` ('flash': the flash kernel
    with Lq queries over Lenc keys); at a decode step under use_kernels
    it runs ``kernels.ops.decode_attention`` (causal=False) over the
    cached cross-K/V, else the plain path."""
    x = _self_attention(p, cfg, blk, x, ctx, cache)
    b, l, _ = x.shape
    xq = Linear.apply(p["xwq"], _norm(cfg).apply(p["lnx"], x))
    enc_out = ctx.get("enc_out")
    if enc_out is not None:
        e = enc_out.to(x.dtype)
        xk, xv = Linear.apply(p["xwk"], e), Linear.apply(p["xwv"], e)
        if cache:
            cache["xk"], cache["xv"] = xk, xv
    else:
        xk, xv = cache["xk"], cache["xv"]
    decode = bool(cache) and l == 1 and ctx.get("rows") is None
    if decode and ctx.get("use_kernels"):
        frames = torch.arange(xk.shape[1], dtype=torch.int32,
                              device=x.device)
        o = kops.decode_attention(xq, xk, xv, frames, q_pos=0, causal=False)
    elif decode or ctx.get("impl", "naive") == "naive":
        o = attention_core(xq, xk, xv)
    else:
        o = multi_head_attention(xq, xk, xv, impl=ctx["impl"], causal=False,
                                 chunk_size=cfg.attn_chunk)
    x = x + Linear.apply(p["xwo"], o.reshape(b, l, -1))
    return x + _block_ffn(p["ffn"], cfg, _norm(cfg).apply(p["ln2"], x), ctx)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

_INIT = {"attn": init_attention, "local": init_attention,
         "rglru": init_rglru, "rwkv": init_rwkv, "xattn": init_xattn}
_APPLY = {"attn": apply_attention, "local": apply_attention,
          "rglru": apply_rglru, "rwkv": apply_rwkv, "xattn": apply_xattn}
BLOCKS = tuple(_APPLY)
# blocks whose cache is recurrent state: the paged arm refuses them, as the
# reference's fails on them (ROADMAP.md §3)
RECURRENT = ("rglru", "rwkv")


def init_block(generator, cfg, blk: str):
    return _INIT[blk](generator, cfg)


def apply_block(p, cfg, blk: str, x, ctx, cache):
    return _APPLY[blk](p, cfg, blk, x, ctx, cache)


def init_block_cache(cfg, blk: str, batch: int, capacity: int,
                     dtype=torch.float32, *, layout: str = "ring",
                     block_size: int = 16, num_blocks: int | None = None,
                     kv_quant: str | None = None, device):
    """One layer's cache.  Attention: a ring buffer cut to the layer's
    window, or (paged) a page pool with its slot-position map, whose block
    table the caller installs; RG-LRU and RWKV: their recurrent state,
    the same on both layouts; cross-attention: a ring and the cross-K/V of
    ``cfg.encoder.frontend_len`` frames (ring only, as in the
    reference)."""
    if layout not in ("ring", "paged"):
        raise ValueError(f"unknown cache layout {layout!r}")
    if blk == "rglru":
        return init_rglru_cache(cfg, batch, dtype, device=device)
    if blk == "rwkv":
        return init_rwkv_cache(cfg, batch, dtype, device=device)
    if blk == "xattn":
        if layout == "paged":
            raise NotImplementedError("paged layout: decoder-only families")
        return init_xattn_cache(cfg, batch, capacity,
                                cfg.encoder.frontend_len, dtype,
                                device=device)
    if layout == "paged":
        if num_blocks is None:
            raise ValueError("paged layout requires num_blocks (see "
                             "ServeConfig.pool_blocks)")
        return init_pages(num_blocks, block_size, cfg.n_kv_heads,
                          cfg.head_dim, dtype, kv_quant, device=device)
    w = cfg.local_window if blk == "local" else cfg.window
    cap = capacity if w is None else min(capacity, w)
    return init_kv_cache(cfg, batch, cap, dtype, device=device)
