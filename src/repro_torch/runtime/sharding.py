"""Sharding rules: a param's path and shape give its placement over the
``('data', 'model')`` mesh (counterpart of ``repro.runtime.sharding``).

Megatron-style tensor parallelism on ``model``, data parallelism over
``('pod', 'data')``:

  * column-parallel (up / gate / q / k / v projections): the OUTPUT
    feature axis on ``model``;
  * row-parallel (down / output projections): the INPUT feature axis on
    ``model``, so a column-parallel producer and its row-parallel
    consumer cost one ``all_reduce`` over ``model``;
  * expert-stacked MoE weights (E, d, f): E on ``model`` (expert
    parallelism) when it divides, else a feature axis;
  * embeddings (V, d): the vocab axis when it divides, else d;
  * every rule checks divisibility by the axis size and falls down a list
    of candidates that ends at replication (granite's 24 heads on a model
    axis of 16, its vocab of 49155).

A spec is a plain tuple with one entry per dim (``None``, ``"model"`` or
the data axes ``("data",)``), or ``()`` for a replicated leaf; it
compares equal with the reference's ``PartitionSpec`` element for
element.  The rules read only ``mesh.shape``, a ``{axis: size}`` dict
(``launch.mesh.ServeMesh`` or any object with one).

The port keeps one dict per layer where the reference stacks a block
pattern's layers over periods (``optim.adamw.reference_leaves``), so
``param_specs`` and ``opt_state_specs`` read each port leaf's reference
path and rank and give it its reference leaf's spec; ``port_spec`` drops
a stacked spec's period axis for the port leaf's own dims,
``local_shard`` cuts a full tensor to one rank's shard under a spec, and
``shard_params`` places a whole param tree on one rank of a serve mesh.
"""
from __future__ import annotations

import re

# param-name classes (match the LAST named segments of the path)
_ROW_PARALLEL = re.compile(
    r"(down|wo|xwo|w_out|cm_v|shared_down|w2)(/w)?$")
_COL_PARALLEL = re.compile(
    r"(up|gate|wq|wk|wv|xwq|xwk|xwv|w1|w1h|w1k|w_in|w_gate|w_a|w_i|w_r|w_k|"
    r"w_v|w_g|cm_k|shared_up|shared_gate|proj1|proj2|dense|pool|out|"
    r"transform|lm_head)(/w)?$")
_EXPERT_STACKED = re.compile(r"(w_up|w_down|w_gate)$")
_EMBED = re.compile(r"(embed/table|table)$")


def path_of(keypath) -> str:
    """'/'-joined path of a sequence of keys (str or int)."""
    return "/".join(str(k) for k in keypath)


def _axis_size(mesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.shape else 1


def _fits(dim: int, mesh, axis: str) -> bool:
    n = _axis_size(mesh, axis)
    return n > 1 and dim % n == 0


def spec_for_param(path: str, shape, mesh) -> tuple:
    """The spec of one parameter at its reference ``path`` and ``shape``.

    Stacked params (under ``periods/``) carry a leading layer axis that is
    never model-sharded: the rules apply to the per-layer dims."""
    dims = list(shape)
    nd = len(dims)
    stacked = 1 if ("periods/" in path and nd >= 2) else 0
    body = dims[stacked:]
    bnd = len(body)
    if bnd <= 1 or "model" not in mesh.shape:
        return ()

    def try_shard(body_axis: int):
        if _fits(body[body_axis], mesh, "model"):
            spec = [None] * nd
            spec[stacked + body_axis] = "model"
            return tuple(spec)
        return None

    def first(*order):
        for ax in order:
            s = try_shard(ax)
            if s:
                return s
        return ()

    if _EXPERT_STACKED.search(path) and bnd == 3:
        return first(0, 2, 1)          # experts first
    if _EMBED.search(path):
        return first(0, 1)             # vocab, then d
    if _ROW_PARALLEL.search(path):
        return first(0, *range(bnd - 1, 0, -1))
    if _COL_PARALLEL.search(path):
        # output feature axes; the head axis first for (d, H, hd)
        order = (1, 2) if bnd == 3 else tuple(range(bnd - 1, 0, -1))
        return first(*order)
    # default: the largest non-leading dim, then the leading one
    return first(*sorted(range(1, bnd), key=lambda i: -body[i]), 0)


def _ref_leaves(tree, pattern: int):
    """[(reference path, reference shape, port leaf)] of a port tree, as
    ``optim.adamw.reference_leaves`` maps them: layer i of a ``layers``
    list of n is stacked over the n // pattern periods (their count leads
    its reference shape) while i < n // pattern * pattern."""
    out = []

    def walk(t, ref, periods):
        if isinstance(t, dict):
            for k in sorted(t):
                if k == "layers" and isinstance(t[k], list):
                    n = len(t[k]) // pattern
                    for i, layer in enumerate(t[k]):
                        stack = i < n * pattern
                        walk(layer, ref + ("periods" if stack else "tail",
                                           i % pattern), n if stack else 0)
                else:
                    walk(t[k], ref + (k,), periods)
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, ref + (i,), periods)
        elif t is not None:
            lead = (periods,) if periods else ()
            out.append((path_of(ref), lead + tuple(t.shape), t))

    walk(tree, (), 0)
    return out


def _tree_like(tree, leaves):
    """``tree``'s structure with each leaf replaced by ``leaves[id(leaf)]``."""
    if isinstance(tree, dict):
        return {k: _tree_like(v, leaves) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_like(v, leaves) for v in tree)
    return None if tree is None else leaves[id(tree)]


def param_specs(params, mesh, *, pattern: int = 1):
    """The params' tree with each leaf's reference spec (reference layout:
    a stacked leaf's spec leads with the period axis).  ``pattern``:
    ``len(cfg.block_pattern)``."""
    return _tree_like(params, {
        id(leaf): spec_for_param(path, shape, mesh)
        for path, shape, leaf in _ref_leaves(params, pattern)})


def placements(spec, mesh) -> tuple:
    """``spec`` as DTensor placements over the mesh's axes in order (the
    port's counterpart of a ``NamedSharding``): ``Shard(dim)`` on each axis
    the spec puts a dim on, ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for axis in mesh.shape:
        dim = next((i for i, s in enumerate(spec)
                    if s == axis or (isinstance(s, tuple) and axis in s)),
                   None)
        out.append(Replicate() if dim is None else Shard(dim))
    return tuple(out)


def _map_specs(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, list) or (isinstance(tree, tuple) and any(
            isinstance(e, (dict, list)) for e in tree)):
        return type(tree)(_map_specs(fn, v) for v in tree)
    return fn(tree)


def named(tree_specs, mesh):
    """A tree of specs as a tree of ``placements``."""
    return _map_specs(lambda s: placements(s, mesh), tree_specs)


def param_shardings(params, mesh, *, pattern: int = 1):
    return named(param_specs(params, mesh, pattern=pattern), mesh)


def data_axes(mesh) -> tuple:
    """The data-parallel axes of the mesh: ('pod', 'data') or ('data',)."""
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def batch_spec(mesh, ndim: int = 2) -> tuple:
    """The leading (batch) dim over every data-parallel axis."""
    return (data_axes(mesh), *([None] * (ndim - 1)))


def batch_shardings(batch, mesh):
    """Each leaf of ``batch`` split on its leading dim over ``data``."""
    return _map_specs(lambda x: placements(batch_spec(mesh, x.ndim), mesh),
                      batch)


def opt_state_specs(params, mesh, *, zero: bool = True,
                    min_size: int = 1 << 16, pattern: int = 1):
    """AdamW state specs: ``m`` and ``v`` follow the params; with ZeRO-1 a
    large replicated moment's leading dim (the period axis of a stacked
    leaf) goes over ``data`` where it divides."""
    def one(path, shape):
        spec = spec_for_param(path, shape, mesh)
        size = 1
        for n in shape:
            size *= n
        if (not zero or "data" not in mesh.shape or size < min_size
                or any(s is not None for s in spec)):
            return spec
        if shape and _fits(shape[0], mesh, "data"):
            return ("data", *([None] * (len(shape) - 1)))
        return spec

    specs = {id(leaf): one(path, shape)
             for path, shape, leaf in _ref_leaves(params, pattern)}
    moments = _tree_like(params, specs)
    return {"m": moments, "v": moments, "count": ()}


def _cache_leaf_spec(name: str, shape, mesh, dp_axes, dp_size) -> tuple:
    nd = len(shape)
    spec = [None] * nd

    def dp_for(i):
        return dp_axes if dp_size > 1 and shape[i] % dp_size == 0 else None

    def model_on(*dims):
        for i in dims:
            if _fits(shape[i], mesh, "model"):
                spec[i] = "model"
                return

    if name in ("k", "v", "xk", "xv", "kp", "vp"):
        spec[nd - 4] = dp_for(nd - 4)         # batch / blocks
        model_on(nd - 2, nd - 1)              # Hkv, else hd
    elif name == "s":
        spec[nd - 4] = dp_for(nd - 4)
        model_on(nd - 3)
    elif name in ("h", "shift_tm", "shift_cm"):
        spec[nd - 2] = dp_for(nd - 2)
        model_on(nd - 1)
    elif name == "conv":
        spec[nd - 3] = dp_for(nd - 3)
        model_on(nd - 1)
    elif name in ("ksc", "vsc"):
        spec[nd - 3] = dp_for(nd - 3)
        model_on(nd - 1)
    elif name in ("ppos", "bt"):
        spec[nd - 2] = dp_for(nd - 2)
    return tuple(spec)


def cache_specs(cache, mesh):
    """KV / state cache specs, keyed on each leaf's name (its last path
    key), positions resolved from the END of the shape (a stacked leaf
    leads with its period axis).  ``cache``: a tree of dicts, lists and
    leaves with ``.shape`` (the port's cache or the reference's layout):

      k/v/xk/xv (..., B, C, Hkv, hd)  batch on data; Hkv (else hd) on model
      s         (..., B, H, hk, hv)   batch on data; H on model
      h/shift_* (..., B, W)           batch on data; W on model
      conv      (..., B, taps, W)     batch on data; W on model
      kp/vp     (..., P, BS, Hkv, hd) blocks on data (``ShardedKVPool``'s
                                      segments); Hkv (else hd) on model
      ksc/vsc   (..., P, BS, Hkv)     blocks on data; Hkv on model
      ppos      (..., P, BS)          blocks on data
      bt        (..., B, MB)          rows on data
      anything else (pos, idx)        replicated
    """
    dp_axes = data_axes(mesh)
    dp_size = 1
    for a in dp_axes:
        dp_size *= mesh.shape[a]

    def walk(t, name):
        if isinstance(t, dict):
            return {k: walk(v, k) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v, name) for v in t)
        if not hasattr(t, "shape"):
            return ()
        return _cache_leaf_spec(str(name), tuple(t.shape), mesh, dp_axes,
                                dp_size)

    return walk(cache, "")


def port_spec(spec, ndim: int) -> tuple:
    """A reference spec on a port leaf of ``ndim`` dims: a stacked leaf's
    period axis dropped."""
    return tuple(spec[len(spec) - ndim:]) if spec else ()


def local_shard(x, spec, coords: dict, sizes: dict):
    """One rank's shard of the full tensor ``x`` under ``spec`` (one entry
    per dim of ``x``, or ``()``): each dim over an axis, or a tuple of
    axes, keeps the rank's contiguous 1 / size slice.  coords / sizes:
    ``{axis: index}`` / ``{axis: size}``."""
    for dim, s in enumerate(spec):
        if s is None:
            continue
        axes = s if isinstance(s, tuple) else (s,)
        n, i = 1, 0
        for a in axes:
            n, i = n * sizes.get(a, 1), i * sizes.get(a, 1) + coords.get(a, 0)
        if n == 1:
            continue
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"over {n} ranks")
        step = x.shape[dim] // n
        x = x.narrow(dim, i * step, step)
    return x


def shard_params(params, mesh, *, pattern: int = 1):
    """This rank's shards of a whole param tree over ``mesh``'s model axis
    (``param_specs``; data never splits a param): each split leaf becomes
    a contiguous copy of its slice with its split dim in a ``model_axis``
    attribute, and a vocab-split embedding table gets one zero row after
    its ``vocab_rows`` rows (the row ids of another rank read).  Whole
    leaves, and leaves cut already (a ``model_axis`` attribute), are kept
    as they are, so a caller may cut the params first and drop the whole
    ones.  Returns the new tree."""
    import torch

    out = {}
    for path, shape, leaf in _ref_leaves(params, pattern):
        spec = port_spec(spec_for_param(path, shape, mesh), leaf.ndim)
        if "model" not in spec or hasattr(leaf, "model_axis"):
            out[id(leaf)] = leaf
            continue
        axis = spec.index("model")
        local = local_shard(leaf, spec, mesh.coords, mesh.shape)
        if axis == 0 and _EMBED.search(path):
            local = torch.cat([local, local.new_zeros((1, *local.shape[1:]))])
            local.vocab_rows = local.shape[0] - 1
        else:
            local = local.contiguous().clone()
        local.model_axis = axis
        out[id(leaf)] = local
    return _tree_like(params, out)
