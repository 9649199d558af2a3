"""Weights across the two packages.

``params_from_reference`` converts a ``repro`` ``TransformerLM`` param
pytree, given with numpy leaves (``jax.tree.map(np.asarray, params)``),
into the port's param tree; ``params_to_reference`` goes back.  An
``EncDecLM`` tree (``encoder``, ``decoder``, ``enc_mux``) converts stack
by stack, the encoder under ``cfg.encoder``; a ``MuxBERT`` tree
(``backbone``, ``mlm``, ``rtd`` where present, and any head dicts kept
beside them) or a ``VLM`` tree (``backbone``, the projector's ``proj1``
and ``proj2``) converts its backbone as a ``TransformerLM`` tree and
every other subtree leaf for leaf, and a fine-tuning tree (``model``: a
MuxBERT tree, ``head``: a classifier head) its two halves.
``opt_state_from_reference`` / ``opt_state_to_reference`` carry an AdamW
state across (``m`` and ``v`` as the params).  A ``mux_engine`` subtree
(Gaussian or contextual mux, RSA or prefix demux) crosses leaf for
leaf.  The
reference groups layers into periods of ``cfg.block_pattern`` and stacks
each pattern position's params over the periods (leading axis
``n_periods``; ``repro/models/transformer.py`` ``_stack_init``), with
leftover layers unstacked under ``tail`` (recurrentgemma-9b: a period
of two RG-LRU layers and a local-attention one, and a tail of two); the
port keeps one dict per layer in a list, whatever the block kind
(attention, RG-LRU or RWKV), and an
untied ``lm_head`` beside the embedding.  Leaf layouts are the
reference's ((in, out) weights), so no leaf is transposed; an MoE
layer's stacked experts (``w_up`` / ``w_gate`` (E, d, f), ``w_down``
(E, f, d)) take the period axis in front, as every leaf does, beside its
``router`` and ``shared_*`` linears.  The cache converters below hold
for the MoE configs as for the dense ones: their caches are attention
pages or rings.
``pages_from_reference`` carries one layer's reference page pool across
bit for bit, ``ring_cache_from_reference`` a whole reference ring cache
(attention rings and recurrent state).
``paged_cache_to_reference`` / ``paged_cache_from_reference`` map a
whole paged cache to and from the reference's layout (the serve
snapshot's tree, ``serve.recovery``).  Nothing here imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _n_periods(cfg) -> int:
    return cfg.n_layers // len(cfg.block_pattern)


def params_from_reference(tree, cfg, *, device):
    """Reference param pytree (numpy leaves) -> the port's param tree on
    ``device`` (fp32 tensors)."""
    pat = len(cfg.block_pattern)

    def tensor(a):
        return torch.as_tensor(np.array(a, dtype=np.float32), device=device)

    if "backbone" in tree:
        return {k: (params_from_reference(v, cfg, device=device)
                    if k == "backbone" else _map(tensor, v))
                for k, v in tree.items()}
    if "model" in tree and "head" in tree:      # a fine-tuning tree
        return {"model": params_from_reference(tree["model"], cfg,
                                               device=device),
                "head": _map(tensor, tree["head"])}
    if "encoder" in tree:
        out = {"encoder": params_from_reference(tree["encoder"], cfg.encoder,
                                                device=device),
               "decoder": params_from_reference(tree["decoder"], cfg,
                                                device=device)}
        if tree.get("enc_mux"):
            out["enc_mux"] = _map(tensor, tree["enc_mux"])
        return out

    layers = []
    for i in range(cfg.n_layers):
        p, pos = divmod(i, pat)
        if p < _n_periods(cfg):
            layers.append(_map(lambda a: tensor(np.asarray(a)[p]),
                               tree["periods"][pos]))
        else:
            layers.append(_map(tensor, tree["tail"][pos]))
    out = {"embed": _map(tensor, tree["embed"]), "layers": layers,
           "final_norm": _map(tensor, tree["final_norm"])}
    for key in ("lm_head", "mux_engine"):
        if tree.get(key):
            out[key] = _map(tensor, tree[key])
    if tree.get("pos_emb") is not None:
        out["pos_emb"] = tensor(tree["pos_emb"])
    return out


def params_to_reference(params, cfg):
    """The port's param tree -> the reference's pytree layout with numpy
    leaves (periods stacked, leftover layers in ``tail``)."""
    pat = len(cfg.block_pattern)
    n_per = _n_periods(cfg)

    def arr(t):
        return t.detach().cpu().numpy()

    if "backbone" in params:
        return {k: (params_to_reference(v, cfg) if k == "backbone"
                    else _map(arr, v))
                for k, v in params.items()}
    if "model" in params and "head" in params:
        return {"model": params_to_reference(params["model"], cfg),
                "head": _map(arr, params["head"])}
    if "encoder" in params:
        out = {"encoder": params_to_reference(params["encoder"], cfg.encoder),
               "decoder": params_to_reference(params["decoder"], cfg)}
        if "enc_mux" in params:
            out["enc_mux"] = _map(arr, params["enc_mux"])
        return out

    def stack(*xs):
        if isinstance(xs[0], dict):
            return {k: stack(*(x[k] for x in xs)) for k in xs[0]}
        return np.stack([arr(x) for x in xs])

    layers = params["layers"]
    out = {"embed": _map(arr, params["embed"]),
           "periods": tuple(stack(*(layers[p * pat + pos]
                                    for p in range(n_per)))
                            for pos in range(pat)) if n_per else
           tuple(None for _ in range(pat)),
           "tail": tuple(_map(arr, layers[n_per * pat + k])
                         for k in range(cfg.n_layers - n_per * pat)),
           "final_norm": _map(arr, params["final_norm"])}
    for key in ("lm_head", "mux_engine", "pos_emb"):
        if key in params:
            out[key] = _map(arr, params[key])
    return out


def opt_state_from_reference(state, cfg, *, device):
    """A reference AdamW state (``m``, ``v`` in the params' layout, numpy
    leaves; ``count`` a 0-d int) -> the port's: ``m`` and ``v`` mapped as
    the params, ``count`` a host int."""
    return {"m": params_from_reference(state["m"], cfg, device=device),
            "v": params_from_reference(state["v"], cfg, device=device),
            "count": int(np.asarray(state["count"]))}


def opt_state_to_reference(state, cfg):
    """The port's AdamW state -> the reference's (numpy leaves, ``count``
    a 0-d int32 as the reference's)."""
    return {"m": params_to_reference(state["m"], cfg),
            "v": params_to_reference(state["v"], cfg),
            "count": np.asarray(state["count"], np.int32)}


# numpy dtypes (from ml_dtypes) that torch.from_numpy refuses: cross as
# raw bits of the same width and reinterpret on the torch side
_BIT_VIEWS = {"float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
              "bfloat16": (np.int16, torch.bfloat16)}


def _tensor(a, device):
    """A numpy or JAX array -> a tensor on ``device``, bit for bit (bf16
    and fp8 through their raw bits)."""
    a = np.asarray(a)
    if a.dtype.name in _BIT_VIEWS:
        bits, dt = _BIT_VIEWS[a.dtype.name]
        return torch.from_numpy(a.view(bits).copy()).view(dt).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def pages_from_reference(pages, *, device):
    """One layer's reference page pool (a dict of numpy or JAX arrays:
    ``kp``, ``vp``, ``ppos``, for int8/fp8 pages ``ksc`` and ``vsc``, and
    ``bt`` where present) -> the port's dict of tensors on ``device``,
    every payload, scale and position bit for bit."""
    return {key: _tensor(a, device) for key, a in pages.items()}


def ring_cache_from_reference(cache, cfg, *, device):
    """A reference ring cache (``TransformerLM.init_cache`` pytree: per
    pattern position the period-stacked leaves of its layers — an
    attention layer's ``k``/``v``/``pos``/``idx``, an RG-LRU layer's ``h``
    and ``conv``, an RWKV layer's ``s`` and token shifts —, then the
    unstacked ``tail``), with numpy or JAX leaves -> the port's ring cache
    (``{"layers": [...]}``, one dict per layer, ``idx`` a host int) on
    ``device``, bit for bit."""
    pat = len(cfg.block_pattern)

    def layer(c, p=None):
        pick = (lambda a: np.asarray(a)) if p is None else (
            lambda a: np.asarray(a)[p])
        return {k: int(pick(a)) if k == "idx" else _tensor(pick(a), device)
                for k, a in c.items()}

    layers = []
    for i in range(cfg.n_layers):
        p, pos = divmod(i, pat)
        layers.append(layer(cache["periods"][pos], p)
                      if p < _n_periods(cfg) else layer(cache["tail"][pos]))
    return {"layers": layers}


# the leaves of one paged attention layer in the reference's cache tree
PAGE_LEAVES = ("bt", "kp", "vp", "ppos", "ksc", "vsc")


def _bits(t):
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def _stack(ts):
    """torch.stack, fp8 through its bytes (no fp8 cat kernel needed)."""
    return torch.stack([_bits(t) for t in ts]).view(ts[0].dtype)


def _paged_layer(cache, i):
    c = cache["layers"][i]
    if "ppos" not in c:
        raise ValueError(f"layer {i} holds no pages: the paged cache's "
                         "reference layout covers attention layers only")
    return {k: cache["bt"] if k == "bt" else c[k]
            for k in PAGE_LEAVES if k in c or k == "bt"}


def paged_cache_to_reference(cache, cfg, *, meta: bool = False):
    """The port's paged cache (``{"layers": [...], "bt": ...}``) in the
    reference's layout: per pattern position under ``periods``, each
    leaf stacked over the periods (``bt`` repeated per layer, as the
    reference holds it), leftover layers unstacked under ``tail``.
    Leaves are tensors on the cache's device (stacked ones are copies);
    meta: meta tensors of the same shapes and dtypes instead, copying
    nothing (a restore target)."""
    pat, n_per = len(cfg.block_pattern), _n_periods(cfg)

    def stacked(ts):
        if meta:
            return torch.empty((len(ts), *ts[0].shape), dtype=ts[0].dtype,
                               device="meta")
        return _stack(ts)

    periods = tuple(
        {k: stacked([_paged_layer(cache, p * pat + pos)[k]
                     for p in range(n_per)])
         for k in _paged_layer(cache, pos)} if n_per else None
        for pos in range(pat))
    tail = tuple(
        {k: torch.empty(t.shape, dtype=t.dtype, device="meta") if meta
         else t for k, t in _paged_layer(cache, i).items()}
        for i in range(n_per * pat, cfg.n_layers))
    return {"periods": periods, "tail": tail}


def paged_cache_from_reference(tree, cfg, cache):
    """Install a reference-layout paged cache tree (``paged_cache_to_
    reference``'s layout, tensors on any device) into the port's cache
    ``cache`` in place, bit for bit.  Every layer's ``bt`` must agree
    before the shared table is installed; dtypes must match the cache's.
    Returns ``cache``."""
    pat, n_per = len(cfg.block_pattern), _n_periods(cfg)
    bts = []
    for i, dst in enumerate(cache["layers"]):
        p, pos = divmod(i, pat)
        src = (tree["periods"][pos] if p < n_per
               else tree["tail"][pos])
        pick = (lambda t: t[p]) if p < n_per else (lambda t: t)
        for k in PAGE_LEAVES[1:]:
            if (k in dst) != (k in src):
                raise ValueError(f"layer {i}: leaf {k!r} in one cache only "
                                 "(page storage differs)")
            if k not in dst:
                continue
            t = pick(src[k])
            if t.dtype != dst[k].dtype or t.shape != dst[k].shape:
                raise ValueError(
                    f"layer {i} {k}: {t.dtype} {tuple(t.shape)} does not "
                    f"fit {dst[k].dtype} {tuple(dst[k].shape)}")
            _bits(dst[k]).copy_(_bits(t))
        bts.append(pick(src["bt"]))
    for i, bt in enumerate(bts[1:], 1):
        if not torch.equal(bt.cpu(), bts[0].cpu()):
            raise ValueError(f"layer {i}'s block table differs from layer "
                             "0's: a paged cache shares one table")
    cache["bt"].copy_(bts[0])
    return cache
