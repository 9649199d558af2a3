"""Dry-run builders (counterpart of ``repro.launch.specs``): fake-tensor
input specs, abstract model / optimizer / cache state, a rank's shards of
them, and the train / prefill / decode steps to trace, shared by
``launch.dryrun`` and the tests.

Everything abstract here is allocation-free: the params, the AdamW state
and the caches come from the port's own init functions run under one
``FakeTensorMode`` on the CPU device (``fake_mode``), where the
reference runs ``jax.eval_shape``; inputs are fake tensors of the
reference's shapes.  The meta device does not serve: the inits draw from
a ``torch.Generator``, which has no meta form.  The dry run traces on
fake CPU tensors, where each ``kernels.ops`` wrapper takes its plain
version (the same function); a fake CUDA tensor would reach the kernels'
launchers.

The builders return the reference's call forms (``train_step(params,
opt_state, batch)``, ``prefill_step(params, cache, batch)``,
``decode(params, cache, batch)``) over the port's models, and keep the
reference's defaults: bf16 compute, the plain model path for training and
decode, and ``use_kernels`` a parameter of the LM's prefill.  With
``mesh=`` they run the port's mesh path: ``extra_ctx={"mesh": mesh}`` and
``train.step.make_train_step(mesh=)`` over the rank's shards
(``rank_params``, ``rank_cache``, ``rank_batch``).
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from repro_torch.configs import SHAPES, get_config, model_kind
from repro_torch.core import MuxSpec
from repro_torch.models import VLM, EncDecLM, TransformerLM
from repro_torch.models.blocks import heads_split
from repro_torch.models.vlm import D_VISION
from repro_torch.nn.layers import model_axis, tp_view
from repro_torch.optim import AdamW, linear_warmup_cosine_decay
from repro_torch.runtime import sharding as shard
from repro_torch.train.losses import causal_lm_loss, chunked_vocab_xent
from repro_torch.train.step import _map, make_train_step

_FAKE = None


def fake_mode():
    """The one ``FakeTensorMode`` of the dry run (fake tensors of two modes
    do not mix)."""
    global _FAKE
    if _FAKE is None:
        from torch._subclasses.fake_tensor import FakeTensorMode
        _FAKE = FakeTensorMode()
    return _FAKE


def _fake(shape, dtype):
    with fake_mode():
        return torch.empty(shape, dtype=dtype)


def model_class(kind: str):
    return {"lm": TransformerLM, "vlm": VLM, "encdec": EncDecLM}[kind]


# ---------------------------------------------------------------------------
# input specs
# ---------------------------------------------------------------------------

def input_specs(arch: str, shape_name: str, *, mux_n: int = 1):
    """Fake tensors standing in for every model input of this cell, the
    reference's shapes (int64 token ids, which the port's embedding
    takes; fp32 frontend embeddings)."""
    cfg = get_config(arch)
    kind = model_kind(arch)
    sh = SHAPES[shape_name]
    gb, L = sh.global_batch, sh.seq_len
    if gb % max(mux_n, 1):
        raise ValueError(f"batch {gb} not divisible by mux N={mux_n}")
    if sh.kind == "decode":
        return {"tokens": _fake((gb, 1), torch.int64)}
    if kind == "vlm":
        p = cfg.frontend_len
        return {"tokens": _fake((gb, L - p), torch.int64),
                "patches": _fake((gb, p, D_VISION), torch.float32)}
    if kind == "encdec":
        enc = cfg.encoder
        return {"tokens": _fake((gb, L), torch.int64),
                "frames": _fake((gb, enc.frontend_len, enc.d_model),
                                torch.float32)}
    return {"tokens": _fake((gb, L), torch.int64)}


def batch_shardings_for(specs, mesh):
    """Each input's spec: its batch dim over the data-parallel axes when
    they divide it, else replicated (the port's tuple specs)."""
    dp = shard.data_axes(mesh)
    dp_size = 1
    for a in dp:
        dp_size *= mesh.shape[a]

    def one(x):
        if x.shape and x.shape[0] % dp_size == 0 and dp_size > 1:
            return (dp, *([None] * (x.ndim - 1)))
        return ()
    return shard._map_specs(one, specs)


def rank_batch(batch, mesh, *, n_mux: int = 1):
    """This rank's slice of a global batch over the data-parallel axes
    (``runtime.dp_step.local_batch``'s cut of each mux block, over
    ('pod', 'data') together); a leaf whose rows do not split into n_mux
    blocks over them stays whole on every rank."""
    dp = shard.data_axes(mesh)
    n, i = 1, 0
    for a in dp:
        n, i = n * mesh.shape[a], i * mesh.shape[a] + mesh.coords[a]

    def cut(x):
        if n == 1 or x.shape[0] % (n_mux * n):
            return x
        b = x.shape[0] // n_mux // n
        blocks = x.reshape(n_mux, x.shape[0] // n_mux, *x.shape[1:])
        return blocks[:, i * b:(i + 1) * b].reshape(n_mux * b, *x.shape[1:])
    return _map(cut, batch)


# ---------------------------------------------------------------------------
# abstract state
# ---------------------------------------------------------------------------

def abstract_params(arch: str, mux: MuxSpec, seed: int = 0):
    """The port's seeded init under ``fake_mode``: fake leaves of the real
    shapes and dtypes, nothing allocated."""
    cfg = get_config(arch)
    cls = model_class(model_kind(arch))
    with fake_mode():
        return cls.init(torch.Generator().manual_seed(seed), cfg, mux)


def make_optimizer(total_steps: int = 100_000, *, pattern: int = 1):
    """The reference's optimizer; ``pattern``: the model's
    ``len(cfg.block_pattern)``, which the port's decay mask reads."""
    return AdamW(lr=linear_warmup_cosine_decay(3e-4, 2000, total_steps),
                 pattern=pattern)


def abstract_opt_state(params_struct, optimizer):
    with fake_mode():
        return optimizer.init(params_struct)


def abstract_cache(arch: str, shape_name: str, mux: MuxSpec,
                   dtype=torch.bfloat16):
    """The cell's ring cache under ``fake_mode``: global_batch / N
    backbone rows at capacity seq_len."""
    cfg = get_config(arch)
    cls = model_class(model_kind(arch))
    sh = SHAPES[shape_name]
    b = sh.global_batch // max(mux.n, 1)
    with fake_mode():
        return cls.init_cache(cfg, b, sh.seq_len, dtype, device="cpu")


# ---------------------------------------------------------------------------
# a rank's shards
# ---------------------------------------------------------------------------

def _whole_on_mesh(kind: str, cfg, path: tuple) -> bool:
    """Whether the port's mesh path reads the param at ``path`` (the port's
    tree) whole: RG-LRU and RWKV layers, whisper's encoder and its
    decoder's cross-attention, llava's projector and the embedding its
    patch prefill reads run no tensor parallelism in the port."""
    if kind == "encdec":
        if path[0] in ("encoder", "enc_mux"):
            return True
        path = path[1:]
    elif kind == "vlm":
        if path[0] in ("proj1", "proj2") or path[:2] == ("backbone", "embed"):
            return True
        path = path[1:]
    if len(path) > 2 and path[0] == "layers":
        blk = cfg.pattern_layers[path[1]]
        if blk in ("rglru", "rwkv"):
            return True
        if blk == "xattn" and path[2] in ("xwq", "xwk", "xwv", "xwo", "lnx"):
            return True
    return False


def _pairs(tree, other, path=()):
    """(path, tree's leaf, other's leaf) over two trees of one structure."""
    if isinstance(tree, dict):
        for k in tree:
            yield from _pairs(tree[k], other[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _pairs(v, other[i], path + (i,))
    elif tree is not None:
        yield path, tree, other


def _rebuild(tree, pick, path=()):
    if isinstance(tree, dict):
        return {k: _rebuild(v, pick, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, pick, path + (i,))
                          for i, v in enumerate(tree))
    return None if tree is None else pick[path]


def rank_params(params, arch: str, mesh):
    """This rank's params as the port's mesh path holds them:
    ``runtime.sharding.shard_params`` (the rules' split over ``model``, a
    vocab-split table with its zero row), except the params the port reads
    whole on a mesh (``_whole_on_mesh``), which stay whole."""
    cfg = get_config(arch)
    kind = model_kind(arch)
    if "model" not in mesh.shape or mesh.shape["model"] == 1:
        return params
    with _mode_of(params):
        cut = shard.shard_params(params, mesh,
                                 pattern=len(cfg.block_pattern))
    pick = {p: (whole if _whole_on_mesh(kind, cfg, p) else part)
            for p, whole, part in _pairs(params, cut)}
    return _rebuild(params, pick)


def rank_cache(cache, arch: str, mesh):
    """This rank's cache as the port's mesh path holds it: rows over the
    data axes (``cache_specs``); a self-attention ring's KV heads over
    ``model`` where the rank holds a head group (``blocks.heads_split``),
    every other leaf whole over ``model`` (the port's sequence-sharded
    attention writes whole K/V; its recurrent and cross-attention layers
    run unsplit)."""
    cfg = get_config(arch)
    split_heads = heads_split(cfg, mesh)
    specs = shard.cache_specs(cache, mesh)

    def walk(t, s, name):
        if isinstance(t, dict):
            return {k: walk(v, s[k], k) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v, s[i], name) for i, v in enumerate(t))
        if not isinstance(t, torch.Tensor):
            return t
        keep = split_heads and name in ("k", "v")
        spec = tuple(a if a != "model" or keep else None for a in s)
        out = shard.local_shard(t, spec, mesh.coords, mesh.shape)
        return out if out is t else out.contiguous().clone()
    with _mode_of(cache):
        return walk(cache, specs, "")


def _mode_of(tree):
    """``fake_mode()`` for a tree of fake tensors, else no mode (real
    tensors: a rank of a real mesh)."""
    from torch._subclasses.fake_tensor import FakeTensor
    leaves = [t for t in _leaves(tree) if isinstance(t, torch.Tensor)]
    if leaves and isinstance(leaves[0], FakeTensor):
        return fake_mode()
    return contextlib.nullcontext()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# functions to trace
# ---------------------------------------------------------------------------

def _whole_table(t, mesh):
    """A tied table whole on this rank: gathered over ``model`` where the
    rules split it (a vocab-split table without its zero row)."""
    a = None if mesh is None else model_axis(t)
    if a is None:
        return t
    if a == 0:
        t = t[:t.vocab_rows]
    return mesh.gather(t.contiguous(), "model", a, kind="weight_gather")


def _lm_loss(cfg, params, hidden, tokens, aux, *, vocab_chunk: int,
             mesh=None):
    """Causal-LM loss from backbone hidden states (tied or untied head),
    chunked over the vocab when it is large (the reference's big-vocab
    memory lever).  On a mesh the head is gathered whole first."""
    tp = mesh if mesh is not None and mesh.shape.get("model", 1) > 1 \
        else None
    if cfg.tie_embeddings:
        emb = params["embed"] if "embed" in params else \
            params["backbone"]["embed"]
        table = _whole_table(emb["table"], tp)
    else:
        head = params["lm_head"] if "lm_head" in params else \
            params["backbone"]["lm_head"]
        w = head["w"] if tp is None else tp_view(head["w"], None, tp)
        table = w.T
    lg_h = hidden[:, :-1]
    labels = tokens[:, 1:]
    if cfg.vocab_size >= 65536 or vocab_chunk > 0:
        chunk = vocab_chunk or 512
        loss = chunked_vocab_xent(lg_h, table, labels, chunk=chunk)
    else:
        logits = lg_h @ table.to(lg_h.dtype).T
        loss = causal_lm_loss(F.pad(logits, (0, 0, 0, 1)), tokens)
    if cfg.moe is not None:
        loss = loss + cfg.moe.router_aux_weight * aux
    return loss


def build_train_step(arch: str, *, mux: MuxSpec = MuxSpec(),
                     optimizer=None, dtype=torch.bfloat16,
                     vocab_chunk: int = 0, use_kernels: bool = False,
                     mesh=None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), the params and the state updated in place.  mesh: this
    rank's mesh; the step then takes the rank's shards (``rank_params``,
    the state of ``optimizer.init`` over them, ``rank_batch``) and runs
    the sharded step (gradients and loss averaged over ``data``)."""
    cfg = get_config(arch)
    kind = model_kind(arch)
    optimizer = optimizer or make_optimizer(pattern=len(cfg.block_pattern))
    ectx = {"mesh": mesh} if mesh is not None else None

    def loss_fn(params, batch, generator):
        if kind == "vlm":
            # text positions only (patches occupy the first P slots)
            out = VLM.apply(params, cfg, batch["tokens"], batch["patches"],
                            mux=mux, dtype=dtype, use_kernels=use_kernels,
                            extra_ctx=ectx)
            p = cfg.frontend_len
            loss = causal_lm_loss(out["logits"][:, p:], batch["tokens"])
            if cfg.moe is not None:
                loss = loss + cfg.moe.router_aux_weight * out["aux"]
            return loss, {}
        if kind == "encdec":
            out = EncDecLM.apply(params, cfg, batch["tokens"],
                                 batch["frames"], mux=mux, dtype=dtype,
                                 use_kernels=use_kernels, extra_ctx=ectx)
            return causal_lm_loss(out["logits"], batch["tokens"]), {}
        out = TransformerLM.apply(params, cfg, batch["tokens"], mux=mux,
                                  dtype=dtype, logits_out=False,
                                  use_kernels=use_kernels, extra_ctx=ectx)
        return _lm_loss(cfg, params, out["hidden"], batch["tokens"],
                        out["aux"], vocab_chunk=vocab_chunk, mesh=mesh), {}

    step = make_train_step(loss_fn, optimizer, mesh=mesh)

    def train_step(params, opt_state, batch):
        return step(params, opt_state, batch, torch.Generator())

    return train_step


def build_prefill(arch: str, *, mux: MuxSpec = MuxSpec(),
                  dtype=torch.bfloat16, use_kernels: bool = False,
                  mesh=None):
    """prefill_step(params, cache, batch) -> (last-position logits, cache),
    the cache filled in place.  use_kernels: the LM's kernel path (the
    VLM and encoder-decoder prefill the plain path, as the reference's)."""
    cfg = get_config(arch)
    kind = model_kind(arch)
    ectx = {"mesh": mesh} if mesh is not None else None

    def prefill_step(params, cache, batch):
        kw = dict(mux=mux, cache=cache, dtype=dtype, extra_ctx=ectx)
        if kind == "vlm":
            out = VLM.apply(params, cfg, batch["tokens"], batch["patches"],
                            use_kernels=False, **kw)
        elif kind == "encdec":
            out = EncDecLM.apply(params, cfg, batch["tokens"],
                                 batch["frames"], use_kernels=False, **kw)
        else:
            out = TransformerLM.apply(params, cfg, batch["tokens"],
                                      use_kernels=use_kernels, **kw)
        return out["logits"][:, -1], cache

    return prefill_step


def build_decode_step(arch: str, *, mux: MuxSpec = MuxSpec(),
                      dtype=torch.bfloat16, seq_len: int = 0, mesh=None):
    """decode(params, cache, batch) -> (logits, cache): one token at
    position seq_len - 1 on the plain model path, the cache updated in
    place."""
    cfg = get_config(arch)
    kind = model_kind(arch)
    q_offset = max(seq_len - 1, 0)
    ectx = {"mesh": mesh} if mesh is not None else None

    def decode(params, cache, batch):
        kw = dict(mux=mux, cache=cache, q_offset=q_offset, dtype=dtype,
                  use_kernels=False, extra_ctx=ectx)
        out = model_class(kind).apply(params, cfg, batch["tokens"], **kw)
        return out["logits"], cache

    return decode
