"""TransformerLM — the backbone with data multiplexing (counterpart of
``repro.models.transformer``): decoder-only LMs, whisper's two stacks and
MUX-BERT's encoder.

Params are a nested dict of tensors in the reference's layouts, except
that the layers are a list (one dict per layer): the reference's
``lax.scan`` over period-stacked params becomes a Python loop.
``interop`` converts between the two.  Layers are attention blocks
(global or local), RG-LRU blocks, RWKV6 blocks or cross-attention
decoder blocks (``models.blocks`` dispatches on ``cfg.block_pattern``,
cycled to ``n_layers``: recurrentgemma-9b's (rglru, rglru, local) over
38 layers is 12 periods and a tail of two RG-LRU layers); an attention
block's FFN is dense or, with ``cfg.moe``, a mixture of experts.  The
port serves from a ring cache (blocking prefill, decode at one shared
position) or a paged cache (blocking or chunked prefill, decode at
per-row positions) with fp32, bf16, int8 or fp8 pages; an RG-LRU or RWKV
layer's cache is its recurrent state on either layout.  ``cache=None`` is the no-cache forward (whisper's encoder,
MUX-BERT).  Positions are RoPE, learned (``params["pos_emb"]``, added
after the entry) or none.  Embeddings are tied, or untied with
``params["lm_head"]``; ``embeds=`` replaces the token embedding with
precomputed (N*B, L, D) embeddings (a frontend stub's frames).
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import MuxEngine, MuxSpec
from repro_torch.kernels import ops as kops
from repro_torch.models.blocks import (BLOCKS, apply_block, init_block,
                                      init_block_cache)
from repro_torch.models.config import ModelConfig
from repro_torch.nn import (Embedding, LayerNorm, Linear, RMSNorm,
                            rope_frequencies)
from repro_torch.nn.layers import model_axis, normal, rounded, tp_view


DTYPES = (torch.float32, torch.bfloat16)


def check_dtype(dtype):
    """Raise unless ``dtype`` is a compute dtype of the port: fp32, or bf16
    (the reference's serve default), for every block kind and attention
    implementation."""
    if dtype not in DTYPES:
        raise ValueError(f"compute dtype {dtype}: the port computes in "
                         f"{DTYPES}")


def _check_supported(cfg: ModelConfig, mux: MuxSpec):
    if any(b not in BLOCKS for b in cfg.block_pattern):
        raise NotImplementedError(
            f"block pattern {cfg.block_pattern}: the port runs {BLOCKS} "
            "blocks so far")
    if cfg.positions not in ("rope", "learned", "none"):
        raise NotImplementedError(f"positions {cfg.positions!r}")
    mux.validate()


class TransformerLM:
    @staticmethod
    def init(generator: torch.Generator, cfg: ModelConfig,
             mux: MuxSpec = MuxSpec()):
        """The port's own seeded init, on ``generator.device``, with the
        reference's distributions: N(0, 0.02) weights, embeddings, conv
        taps and RWKV mixing / decay / bonus vectors, N(0, 0.5) RG-LRU
        Λ, zero biases, zero RMSNorm scales (the norm is 1 + scale),
        unit LayerNorm and group-norm scales,
        N(0, 0.02) learned positions, N(0, 1) mux keys v and demux keys
        k.  Draws are the port's own:
        the same seed does not give the reference's values (use
        ``interop.params_from_reference`` for those)."""
        _check_supported(cfg, mux)
        dev = generator.device
        params = {"embed": Embedding.init(generator, cfg.vocab_size,
                                          cfg.d_model)}
        if cfg.positions == "learned":
            params["pos_emb"] = normal(generator,
                                       (cfg.max_seq_len, cfg.d_model), 0.02)
        params["layers"] = [init_block(generator, cfg, blk)
                            for blk in cfg.pattern_layers]
        norm = RMSNorm if cfg.norm == "rms" else LayerNorm
        params["final_norm"] = norm.init(dev, cfg.d_model)
        if not cfg.tie_embeddings:
            params["lm_head"] = Linear.init(generator, cfg.d_model,
                                            cfg.vocab_size, use_bias=False)
        if mux.enabled:
            params["mux_engine"] = MuxEngine.init(generator, mux, cfg.d_model)
        return params

    @staticmethod
    def init_cache(cfg: ModelConfig, batch: int, capacity: int,
                   dtype=torch.float32, *, layout: str = "ring",
                   block_size: int = 16, num_blocks: int | None = None,
                   kv_quant: str | None = None, device):
        """The KV cache for ``batch`` backbone rows on ``device``.

        layout='ring': per layer a contiguous (batch, cap, Hkv, Dh) ring
        with a shared slot-position vector, cap = capacity cut to the
        layer's window.  layout='paged': per layer a page pool and
        slot-position map, and one (batch, max_blocks) block table shared
        by every layer (installed in place by
        ``serve.engine.set_block_tables``); pages are stored as ``dtype``,
        or quantized with per-slot scales under kv_quant='int8'/'fp8'
        (``ServeConfig.page_dtype`` / ``kv_quant`` give both).  An RG-LRU
        or RWKV layer holds its recurrent state on either layout (the
        conv inputs and token shifts in ``dtype``)."""
        layers = [init_block_cache(cfg, blk, batch, capacity, dtype,
                                   layout=layout, block_size=block_size,
                                   num_blocks=num_blocks, kv_quant=kv_quant,
                                   device=device)
                  for blk in cfg.pattern_layers]
        if layout == "ring":
            return {"layers": layers}
        mb = -(-capacity // block_size)
        bt = torch.full((batch, mb), -1, dtype=torch.int32, device=device)
        for c in layers:
            if "ppos" in c:
                c["bt"] = bt
        return {"layers": layers, "bt": bt}

    @staticmethod
    def apply(params, cfg: ModelConfig, tokens=None, *, embeds=None,
              mux: MuxSpec = MuxSpec(), cache=None, q_offset=0,
              dtype=torch.bfloat16, logits_out: bool = True,
              use_kernels: bool = True,
              fuse_io: bool = True, demux: bool = True,
              extra_ctx: dict | None = None):
        """tokens (N*B, L) int (mux-major instance order), or ``embeds``
        (N*B, L, D) precomputed embeddings instead.  q_offset: an int
        start position, or on a paged cache a (B,) vector of per-row
        positions (-1 = inactive row).  The cache is updated in place;
        None runs the no-cache forward.  dtype: the compute dtype, bf16 by
        default as in the reference, or fp32 (``check_dtype``): the
        embeddings enter in it, every layer casts its weights to it per op
        and the norms compute in fp32 and round to it, so the hidden state,
        the attention operands and the logits are in it.  use_kernels: the
        layers' kernels (decode and chunk attention, the RWKV6
        recurrence), the mux-combine kernel of the plain entry and, with
        ``fuse_io``, the fused entry and exit instead (default; their
        plain versions on CPU tensors), False for the plain model path.  As in the reference, the fused entry
        (gather + embedding scale + mux combine) runs for the Gaussian mux
        without the prefix demux, and the fused exit (final norm + demux
        + demux LN) for the RSA demux whatever the mux kind; the other
        kinds take the plain entry (the contextual mux always plain, the
        Gaussian through the mux-combine kernel) or the plain exit.
        fuse_io=False keeps the plain entry and exit, as a blocking
        prefill runs them; ``embeds`` always takes the plain entry.  The
        prefix demux's N prefix positions lead the backbone's row, and
        learned positions cover them.  demux=False returns the backbone's
        normed hidden without the demux (an encoder).  The attention of a
        blocking forward follows ``cfg.attn_impl`` ('auto': chunked above
        2048 tokens, else naive; 'flash' launches the flash kernel).
        Returns dict(logits | hidden, aux): ``aux`` is the MoE layers'
        summed load-balancing loss, a 0-d fp32 tensor (0.0 without MoE
        layers)."""
        _check_supported(cfg, mux)
        check_dtype(dtype)
        d = cfg.d_model
        dev = params["embed"]["table"].device
        mesh = (extra_ctx or {}).get("mesh")
        tp = mesh if mesh is not None and mesh.shape["model"] > 1 else None
        scale = math.sqrt(d) if cfg.embedding_scale else 1.0
        fused = (use_kernels and fuse_io and mux.enabled
                 and "mux_engine" in params)
        fuse_entry = (fused and embeds is None and mux.mux_kind == "gaussian"
                      and mux.demux_kind != "prefix")
        # on a model axis: the mux and demux weights whole, the table split
        mux_engine = _whole(params.get("mux_engine", {}), tp)
        if fuse_entry:
            # fused entry: gather + embedding scale + mux combine, one kernel
            tokens = torch.as_tensor(tokens, device=dev)
            nb, l_in = tokens.shape
            bb = nb // mux.n
            x = _fused_entry(params["embed"]["table"], mux_engine["mux"]["v"],
                             tokens.clamp(min=0).reshape(mux.n, bb * l_in),
                             scale, dtype, tp)
            x = x.reshape(bb, l_in, d)
        else:
            if embeds is None:
                x = Embedding.apply(params["embed"],
                                    torch.as_tensor(tokens, device=dev),
                                    dtype=dtype, mesh=tp)
            else:
                x = torch.as_tensor(embeds, device=dev).to(dtype)
            if cfg.embedding_scale:
                # the scale rounded to the dtype first, as the reference's
                # jnp.asarray(sqrt(d), dtype): 45.25 for d 2048 in bf16
                x = x * rounded(scale, dtype)
            x = MuxEngine.combine(mux_engine, mux, x,
                                  use_kernels=use_kernels)
        b, l, _ = x.shape

        ar = torch.arange(l, device=dev)
        per_row = isinstance(q_offset, torch.Tensor) and q_offset.ndim > 0
        if per_row:
            pos = q_offset.to(dev).long().clamp(min=0)[:, None] + ar[None]
        else:             # an int, or a 0-d tensor (a device value)
            pos = ar + (q_offset.to(dev) if isinstance(q_offset, torch.Tensor)
                        else q_offset)
        impl = cfg.attn_impl
        if impl == "auto":
            # long blocking forwards take the online-softmax chunked path;
            # decode (l == 1) stays naive
            impl = "chunked" if l > 2048 else "naive"
        ctx = {"sin": None, "cos": None, "q_offset": q_offset, "impl": impl,
               "use_kernels": use_kernels}
        if cfg.positions == "rope":
            sin, cos = rope_frequencies(cfg.head_dim, pos,
                                        theta=cfg.rope_theta)
            ctx["sin"], ctx["cos"] = ((sin, cos) if per_row
                                      else (sin[None], cos[None]))
        elif cfg.positions == "learned":
            pe = _whole(params["pos_emb"], tp)[pos].to(dtype)
            x = x + (pe if per_row else pe[None])
        if extra_ctx:
            ctx.update(extra_ctx)

        blocks = cfg.pattern_layers
        pat = len(cfg.block_pattern)
        # training: checkpoint each whole period of the no-cache forward
        # (cfg.remat, as the reference's jax.checkpoint of its period
        # scan; leftover tail layers are not); backward recomputes it.
        # Only where something needs gradients: a serving forward (params
        # that require no grad) runs its periods directly
        remat = (cfg.remat and cache is None and torch.is_grad_enabled()
                 and x.requires_grad)
        n_remat = len(blocks) // pat * pat if remat else 0

        # an MoE layer puts its aux loss on ctx["aux"]; the layers' sum is
        # the output's "aux", in fp32 (0.0 without MoE layers)
        aux = ctx["aux"] = []

        def period(x, start):
            sub = {**ctx, "aux": []}
            for i in range(start, start + pat):
                x = apply_block(params["layers"][i], cfg, blocks[i], x, sub,
                                None)
            return (x, *sub["aux"])

        for start in range(0, n_remat, pat):
            x, *a = checkpoint(period, x, start, use_reentrant=False)
            aux += a
        for i in range(n_remat, len(blocks)):
            x = apply_block(params["layers"][i], cfg, blocks[i], x, ctx,
                            None if cache is None else cache["layers"][i])
        aux_total = sum(aux, torch.zeros((), device=dev)) if aux else 0.0

        norm = RMSNorm if cfg.norm == "rms" else LayerNorm
        if fused and demux and mux.demux_kind == "rsa":
            # fused exit: final norm + RSA demux + demux LN, one kernel
            x = MuxEngine.separate_fused(
                mux_engine, mux, x, final_norm=params["final_norm"],
                norm_kind=cfg.norm)
        else:
            x = norm.apply(params["final_norm"], x)
            if demux:
                x = MuxEngine.separate(mux_engine, mux, x)
        if logits_out:
            return {"logits": TransformerLM.logits(params, cfg, x, mesh=tp),
                    "aux": aux_total}
        return {"hidden": x, "aux": aux_total}

    @staticmethod
    def logits(params, cfg: ModelConfig, hidden, *, mesh=None):
        """hidden @ table.T (tied) or hidden @ lm_head (untied); plain
        matmuls.  mesh: a serve mesh whose model axis splits the table or
        head (the whole logits come back)."""
        if mesh is not None and mesh.shape["model"] == 1:
            mesh = None
        if cfg.tie_embeddings:
            return Embedding.attend(params["embed"], hidden, mesh)
        return Linear.apply(params["lm_head"], hidden, mesh)


def _whole(tree, tp):
    """Every param of ``tree`` whole on this rank (gathered where the
    rules split it over ``model``); ``tree`` itself without a model
    axis."""
    if tp is None:
        return tree
    if isinstance(tree, dict):
        return {k: _whole(v, tp) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_whole(v, tp) for v in tree)
    return tp_view(tree, None, tp)


def _fused_entry(table, v, ids, scale, dtype, tp):
    """The fused entry kernel over this rank's table: whole, a vocab slice
    (ids of other ranks read its zero row; the ranks' partial sums add up
    over ``model``) or a d slice (with the keys' d slice; the output
    gathered over ``model``)."""
    a = None if tp is None else model_axis(table)
    if a == 0:
        ids = Embedding.local_ids(table, ids, tp)
    elif a == 1:
        v = tp_view(v, 1, tp)          # the keys' d slice of the whole v
    x = kops.mux_embed_combine(ids, table, v, scale=scale, out_dtype=dtype)
    if a == 0:            # the plain version's einsum may be strided
        return tp.all_reduce(x.contiguous(), "model")
    return x if a is None else tp.gather(x, "model", -1)
