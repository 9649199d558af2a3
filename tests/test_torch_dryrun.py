"""The port's dry run (``repro_torch.launch.specs``, ``hlo_analysis``,
``roofline``, ``dryrun``, the recording mesh and the registry's grid)
against the JAX reference's (``repro.launch``), on the CPU.

The full-width trees come from the port's init under ``FakeTensorMode``
and the reference's ``jax.eval_shape``, so nothing is allocated.  The
reference's steps run jitted, each compiled once a module and shared
(``functools.lru_cache``); its FLOPs are its own ``hlo_analysis.analyze``
of the compiled text.

The gloo ranks import this module to find their work: it imports no JAX
at its top (the reference is imported inside the helpers).
"""
import contextlib
import functools
import json

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.configs import (ARCHS, SHAPES, Shape, cell_status, get_config,
                                 grid, model_kind)
from repro_torch.configs import registry as reg
from repro_torch.core import MuxSpec
from repro_torch.launch import dryrun, roofline
from repro_torch.launch import specs as S
from repro_torch.launch.hlo_analysis import analyze, op_census, roofline_terms
from repro_torch.launch.mesh import (HW, RecordingMesh, make_production_mesh,
                                     make_serve_mesh, spawn)
from repro_torch.models import TransformerLM
from repro_torch.runtime import sharding as sh

# one AdamW step against the reference: tests/test_torch_train.py's
OPT_TOL = dict(rtol=2e-6, atol=1e-7)
LOGIT_TOL = 1e-5
# reduced cells of the builder comparisons: (B, L) instances at N=2
B, L, N = 8, 32, 2
BUILDER_ARCHS = ("qwen2-1.5b", "granite-moe-3b-a800m", "whisper-small")
# The train step's FLOPs over the reference's at (B, L, N) = (8, 32, 2),
# reduced (d 64, 4 backbone rows of 32 tokens), fp32.  Every arch: the
# Gaussian mux's gradient to its input embeddings, the backward of
# ``einsum("nbld,nd->bld")`` (``core/mux.py:33``): torch computes
# x-grad = g (x) v as a batched matmul with a contraction of length 1,
# (d, B*L, 1) @ (d, 1, N), 2 * N * B*L * d = 32,768 FLOPs; XLA emits
# that outer product as an elementwise multiply, no dot.  rwkv6-7b adds
# the same kind of products in the backward of the plain RWKV6
# recurrence (``kernels/rwkv6.py``): both operand gradients of the bonus
# einsum "bhtk,bhtk->bht" (:87), 2 x 16,384 a layer over its 2 layers =
# 65,536, and one of the two length-1 contractions torch makes of the
# three-operand intra-chunk einsum "bhtk,bhjk,bhtjk->bhtj" (:85),
# 1,048,576.  Forward FLOPs match exactly for all ten archs.  (The
# gradient of the logits' sum alone reads 16,777,216 more against
# ``jax.grad``: the forward logits matmul, dead there,
# test_logits_sum_gradient_gap_is_dead_code_and_the_mux.)
MUX_DX_FLOPS = 2 * N * (B // N) * L * 64
GRAD_GAP = {"qwen2-1.5b": MUX_DX_FLOPS,
            "granite-moe-3b-a800m": MUX_DX_FLOPS,
            "whisper-small": MUX_DX_FLOPS,
            "rwkv6-7b": MUX_DX_FLOPS + 65_536 + 1_048_576}
# the four cells of tests/test_dryrun_integration.py (reduced)
DRY_CELLS = [("gemma-2b", "train_4k", 1), ("granite-moe-3b-a800m",
                                           "train_4k", 2),
             ("rwkv6-7b", "decode_32k", 2), ("whisper-small", "train_4k", 1)]
DRY_SHAPES = {"train_4k": Shape("train_4k", 32, 8, "train"),
              "decode_32k": Shape("decode_32k", 64, 8, "decode")}
PRODUCTION = {"single": False, "multi": True}
SPAWN_TIMEOUT = 300


@contextlib.contextmanager
def reduced(shapes=None):
    """Both registries in reduced mode (the port's SHAPES patched with
    ``shapes``); restored after."""
    from repro.configs import registry as ref_reg
    saved = dict(SHAPES)
    reg.set_reduced_mode(True)
    ref_reg.set_reduced_mode(True)
    SHAPES.update(shapes or {})
    try:
        yield
    finally:
        reg.set_reduced_mode(False)
        ref_reg.set_reduced_mode(False)
        SHAPES.clear()
        SHAPES.update(saved)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

def test_grid_equals_reference():
    from repro.configs import grid as ref_grid
    got = grid()
    assert len(got) == 40
    assert got == ref_grid()


def test_overrides_and_reduced_mode_match_reference():
    from repro.configs import registry as ref_reg
    arch = "granite-moe-3b-a800m"
    try:
        for r in (reg, ref_reg):
            r.set_overrides(arch, rwkv_chunk=16, moe_impl="local_group")
        got, want = get_config(arch), ref_reg.get_config(arch)
        assert got.rwkv_chunk == want.rwkv_chunk == 16
        assert got.moe.impl == want.moe.impl == "local_group"
        # a config without MoE ignores moe_* as the reference's does
        for r in (reg, ref_reg):
            r.set_overrides("gemma-2b", moe_impl="local_group")
        assert get_config("gemma-2b").moe is None
        reg.set_overrides("gemma-2b", attn_seq_shard=True)   # not a field
        with pytest.raises(ValueError, match="attn_seq_shard"):
            get_config("gemma-2b")
    finally:
        reg.clear_overrides()
        ref_reg.clear_overrides()
    with reduced():
        for a in ARCHS:
            got, want = get_config(a), ref_reg.get_config(a)
            assert got == get_config(a, reduced=True)
            assert (got.n_layers, got.d_model, got.vocab_size) == \
                (want.n_layers, want.d_model, want.vocab_size)
            assert got.sub_quadratic == want.sub_quadratic
    assert get_config("qwen2-1.5b").d_model == 1536


# ---------------------------------------------------------------------------
# specs at full width, allocation-free
# ---------------------------------------------------------------------------

def _mux_n(shape_name):
    return 2 if SHAPES[shape_name].global_batch % 2 == 0 else 1


@functools.lru_cache(maxsize=None)
def _trees(arch, mux_n):
    """(reference eval_shape params, port fake params) at full width."""
    from repro.core import MuxSpec as RefMux
    from repro.launch import specs as RS
    return (RS.abstract_params(arch, RefMux(n=mux_n)),
            S.abstract_params(arch, MuxSpec(n=mux_n)))


def _ref_flat(tree):
    import jax
    from repro.runtime import sharding as ref_sh
    return {ref_sh.path_of(k): v for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_flat(tree, pattern):
    """{reference path: port leaf} (tensors only: the ring's host ``idx``
    is the reference's int32 leaf)."""
    def tensors(t):
        if isinstance(t, dict):
            return {k: tensors(v) for k, v in t.items()
                    if isinstance(v, (dict, list, tuple, torch.Tensor))}
        if isinstance(t, (list, tuple)):
            return type(t)(tensors(v) for v in t)
        return t
    return {p: (shape, leaf) for p, shape, leaf in
            sh._ref_leaves(tensors(tree), pattern)}


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int32": torch.int32}


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_at_full_width_match_reference(arch):
    """input_specs, batch_shardings_for, abstract_params (leaf by leaf on
    the reference's path) and abstract_cache (shapes and dtypes) of each
    of the arch's ok cells (``cell_status``) against the reference's, at
    the cell's mux N, with nothing allocated."""
    from repro.core import MuxSpec as RefMux
    from repro.launch import specs as RS
    pat = len(get_config(arch).block_pattern)
    cells = [s for s in SHAPES if cell_status(arch, s) == "ok"]
    for shape_name in cells:
        shp = SHAPES[shape_name]
        n = _mux_n(shape_name)
        got = S.input_specs(arch, shape_name, mux_n=n)
        want = RS.input_specs(arch, shape_name, mux_n=n)
        assert set(got) == set(want)
        for k in want:
            assert tuple(got[k].shape) == tuple(want[k].shape), (k, shp)
            assert got[k].dtype == (torch.int64 if k == "tokens"
                                    else torch.float32)
        for kind, multi in PRODUCTION.items():
            shape = make_production_mesh(multi_pod=multi)
            ref_b = RS.batch_shardings_for(want, _abstract_mesh(shape))
            port_b = S.batch_shardings_for(got, RecordingMesh(shape))
            assert all(port_b[k] == ref_b[k].spec for k in want), kind
        if shp.kind == "train":
            continue
        ref_c = _ref_flat(RS.abstract_cache(arch, shape_name,
                                            RefMux(n=n)))
        port_c = _port_flat(S.abstract_cache(arch, shape_name,
                                             MuxSpec(n=n)), pat)
        assert set(port_c) == {p for p in ref_c if not p.endswith("/idx")}
        for p, (shape, leaf) in port_c.items():
            assert shape == tuple(ref_c[p].shape), (p, shape_name)
            assert leaf.dtype == _DTYPES[str(ref_c[p].dtype)], p
    for n in sorted({_mux_n(c) for c in cells}):
        ref_p, port_p = _trees(arch, n)
        want = _ref_flat(ref_p)
        got = _port_flat(port_p, pat)
        assert set(got) == set(want)
        for p, (shape, leaf) in got.items():
            assert shape == tuple(want[p].shape), p
            assert leaf.dtype == torch.float32 and want[p].dtype == np.float32


def _abstract_mesh(shape):
    from jax.sharding import AbstractMesh
    return AbstractMesh(tuple(shape.values()), tuple(shape))


def _shard_bytes(tree, specs, mesh):
    import jax
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P
    leaves = jax.tree_util.tree_leaves(tree)
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, P))
    return sum(int(np.prod(NamedSharding(mesh, s).shard_shape(x.shape)))
               * np.dtype(x.dtype).itemsize
               for x, s in zip(leaves, spec_leaves))


def _with_specs(tree, specs):
    """(leaf, its spec) over a tree and its tree of tuple specs."""
    if isinstance(tree, dict):
        for k in tree:
            yield from _with_specs(tree[k], specs[k])
    elif isinstance(tree, (list, tuple)):
        for t, s in zip(tree, specs):
            yield from _with_specs(t, s)
    else:
        yield tree, specs


def _nbytes(tree):
    return sum(t.numel() * t.element_size() for t in S._leaves(tree)
               if isinstance(t, torch.Tensor))


@pytest.mark.parametrize("arch", ARCHS)
def test_rank_bytes_on_production_meshes(arch):
    """Each rank's param bytes (``shard_params``) and cache bytes
    (``cache_specs``) on both production meshes equal the sum of the
    reference's shard shapes, less or plus what the port holds
    otherwise: a vocab-split table's zero row (+ one row a rank), the
    ring's position index (a host int: - 4 bytes an attention layer)."""
    from repro.core import MuxSpec as RefMux
    from repro.launch import specs as RS
    from repro.runtime import sharding as ref_sh
    cfg = get_config(arch)
    pat = len(cfg.block_pattern)
    ref_p, port_p = _trees(arch, 2)
    for kind, multi in PRODUCTION.items():
        shape = make_production_mesh(multi_pod=multi)
        amesh = _abstract_mesh(shape)
        rmesh = RecordingMesh(shape)
        want = _shard_bytes(ref_p, ref_sh.param_specs(ref_p, amesh), amesh)
        with S.fake_mode():
            cut = sh.shard_params(port_p, rmesh, pattern=pat)
        zero_rows = sum(t.shape[1] * t.element_size()
                        for t in S._leaves(cut) if hasattr(t, "vocab_rows"))
        assert _nbytes(cut) == want + zero_rows, kind
        for shape_name in ("prefill_32k", "decode_32k"):
            ref_c = RS.abstract_cache(arch, shape_name, RefMux(n=2))
            want = _shard_bytes(ref_c, ref_sh.cache_specs(ref_c, amesh),
                                amesh)
            port_c = S.abstract_cache(arch, shape_name, MuxSpec(n=2))
            specs = sh.cache_specs(port_c, rmesh)
            with S.fake_mode():
                got = sum(
                    sh.local_shard(t, s, rmesh.coords, rmesh.shape).numel()
                    * t.element_size()
                    for t, s in _with_specs(port_c, specs)
                    if isinstance(t, torch.Tensor))
            idx_bytes = sum(int(np.prod(x.shape)) * 4 for p, x in
                            _ref_flat(ref_c).items() if p.endswith("/idx"))
            assert got == want - idx_bytes, (kind, shape_name)


# ---------------------------------------------------------------------------
# builders against the reference: reduced, fp32, the same weights
# ---------------------------------------------------------------------------

def _inputs(arch):
    """The reduced cell's batch (B, L) at N and the cache capacity a
    prefill of L - 1 tokens (after the VLM's patches) and one decode step
    need."""
    from repro_torch.models.vlm import D_VISION
    cfg = get_config(arch, reduced=True)
    rng = np.random.default_rng(0)
    tok = rng.integers(4, cfg.vocab_size, (B, L)).astype(np.int32)
    out, cap = {"tokens": tok}, L
    if model_kind(arch) == "encdec":
        enc = cfg.encoder
        out["frames"] = rng.normal(size=(B, enc.frontend_len, enc.d_model)
                                   ).astype(np.float32)
    if model_kind(arch) == "vlm":
        out["patches"] = rng.normal(size=(B, cfg.frontend_len, D_VISION)
                                    ).astype(np.float32)
        cap += cfg.frontend_len
    return out, cap


def _port_batch(batch):
    return {k: torch.as_tensor(v.astype(np.int64) if k == "tokens" else v)
            for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _reference_run(arch):
    """The reference's jitted prefill (L - 1 tokens), decode (at L - 1)
    and one train step on its seeded reduced weights, with its HLO FLOPs
    of each; and the port's same steps on the same weights."""
    import jax
    import jax.numpy as jnp
    from repro.core import MuxSpec as RefMux
    from repro.launch import specs as RS
    from repro.launch.hlo_analysis import analyze as ref_analyze
    mux, rmux = MuxSpec(n=N), RefMux(n=N)
    with reduced():
        cfg = get_config(arch)
        ref_cls = RS.model_class(model_kind(arch))
        ref_params = ref_cls.init(jax.random.PRNGKey(0),
                                  RS.get_config(arch), rmux)
        batch, cap = _inputs(arch)
        pre = {k: (v[:, :L - 1] if k == "tokens" else v)
               for k, v in batch.items()}
        cache = ref_cls.init_cache(RS.get_config(arch), B // N, cap,
                                   jnp.float32)
        out = {}

        def run(fn, *args):
            c = jax.jit(fn).lower(*args).compile()
            return c(*args), ref_analyze(c.as_text())["flops"]
        (lg, cache1), out["prefill_flops"] = run(
            RS.build_prefill(arch, mux=rmux, dtype=jnp.float32),
            ref_params, cache, pre)
        out["prefill"] = np.asarray(lg)
        dec = {"tokens": batch["tokens"][:, L - 1:]}
        (lg, _), out["decode_flops"] = run(
            RS.build_decode_step(arch, mux=rmux, dtype=jnp.float32,
                                 seq_len=cap), ref_params, cache1, dec)
        out["decode"] = np.asarray(lg)
        opt = RS.make_optimizer()
        (p1, _, m), out["train_flops"] = run(
            RS.build_train_step(arch, mux=rmux, optimizer=opt,
                                dtype=jnp.float32),
            ref_params, opt.init(ref_params), batch)
        out["loss"] = float(m["loss"])
        out["params"] = jax.tree.map(np.asarray, p1)

        # the port's steps on the same weights
        port = {}
        params = interop.params_from_reference(
            jax.tree.map(np.asarray, ref_params), cfg, device="cpu")
        pc = S.model_class(model_kind(arch)).init_cache(
            cfg, B // N, cap, torch.float32, device="cpu")
        with torch.no_grad():
            lg, pc = S.build_prefill(arch, mux=mux, dtype=torch.float32)(
                params, pc, _port_batch(pre))
            port["prefill"] = lg.numpy()
            lg, _ = S.build_decode_step(arch, mux=mux, dtype=torch.float32,
                                        seq_len=cap)(params, pc,
                                                     _port_batch(dec))
            port["decode"] = lg.numpy()
        opt = S.make_optimizer(pattern=len(cfg.block_pattern))
        step = S.build_train_step(arch, mux=mux, optimizer=opt,
                                  dtype=torch.float32)
        params, _, m = step(params, opt.init(params), _port_batch(batch))
        port["loss"] = float(m["loss"])
        port["params"] = interop.params_to_reference(params, cfg)
    return out, port


@pytest.mark.parametrize("arch", BUILDER_ARCHS)
def test_builders_match_reference(arch):
    """build_prefill's last-position logits and build_decode_step's logits
    within 1e-5 of the reference's; one build_train_step step: the loss
    and every updated leaf within OPT_TOL."""
    import jax
    want, got = _reference_run(arch)
    for k in ("prefill", "decode"):
        assert got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=LOGIT_TOL,
                                   err_msg=k)
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-6)
    flat_w = _ref_flat(want["params"])
    flat_g = _ref_flat(got["params"])
    assert set(flat_g) == {p for p, v in flat_w.items() if v is not None}
    for p, g in flat_g.items():
        np.testing.assert_allclose(g, flat_w[p], **OPT_TOL, err_msg=p)


def test_prefill_kernel_path_matches_plain_path():
    """``use_kernels=True`` (the wrappers' plain versions on the CPU) gives
    the plain path's prefill logits and calls the entry and exit."""
    from repro_torch.kernels import ops
    arch = "qwen2-1.5b"
    with reduced():
        cfg = get_config(arch)
        params = TransformerLM.init(torch.Generator().manual_seed(0), cfg,
                                    MuxSpec(n=N))
        batch = _port_batch(_inputs(arch)[0])
        out = {}
        for k in (False, True):
            cache = TransformerLM.init_cache(cfg, B // N, L, torch.float32,
                                             device="cpu")
            before = ops.counts("calls")
            with torch.no_grad():
                out[k] = S.build_prefill(arch, mux=MuxSpec(n=N),
                                         dtype=torch.float32,
                                         use_kernels=k)(params, cache,
                                                        batch)[0]
            calls = {w: v - before[w] for w, v in ops.counts("calls").items()}
            assert (calls["mux_embed_combine"], calls["demux_rsa"]) == \
                ((1, 1) if k else (0, 0))
    torch.testing.assert_close(out[True], out[False], rtol=0, atol=LOGIT_TOL)


# ---------------------------------------------------------------------------
# the analysis against the reference's
# ---------------------------------------------------------------------------

def test_flops_of_reference_analysis_programs():
    """tests/test_hlo_analysis.py's three programs: the port's torch
    versions count the reference's HLO FLOPs exactly."""
    import jax
    import jax.numpy as jnp
    from repro.launch.hlo_analysis import analyze as ref_analyze
    X = jax.ShapeDtypeStruct((128, 256), jnp.float32)
    W = jax.ShapeDtypeStruct((256, 256), jnp.float32)

    def text(f):
        return jax.jit(f).lower(X, W).compile().as_text()

    def unrolled(x, w):
        for _ in range(6):
            x = jnp.tanh(x @ w)
        return x

    def scanned(x, w):
        return jax.lax.scan(lambda c, _: (jnp.tanh(c @ w), None), x, None,
                            length=6)[0]

    def nested(x, w):
        def outer(c, _):
            return jax.lax.scan(lambda c2, _: (c2 @ w, None), c, None,
                                length=4)[0], None
        return jax.lax.scan(outer, x, None, length=3)[0]

    def t_loop(x, w):
        for _ in range(6):
            x = torch.tanh(x @ w)
        return x

    def t_nested(x, w):
        for _ in range(3):
            for _ in range(4):
                x = x @ w
        return x

    with S.fake_mode():
        x, w = torch.empty(128, 256), torch.empty(256, 256)
        loop = analyze(t_loop, x, w)["flops"]
        nest = analyze(t_nested, x, w)["flops"]
    assert loop == ref_analyze(text(unrolled))["flops"] \
        == ref_analyze(text(scanned))["flops"] == 6 * 2 * 128 * 256 * 256
    assert nest == ref_analyze(text(nested))["flops"] \
        == 12 * 2 * 128 * 256 * 256


def test_recording_mesh_counts_loop_collectives():
    """An all_reduce inside a 7-trip loop counts 7 times and 7 x its
    bytes (the reference's synthetic HLO case), and a gather its result's
    bytes (max(operand, result)); nothing is allocated."""
    mesh = RecordingMesh({"data": 1, "model": 2})

    def body(x):
        for _ in range(7):
            x = mesh.all_reduce(x, "model")
        return mesh.gather(x, "model", 0)

    with S.fake_mode():
        a = analyze(body, torch.empty(64, 64), mesh=mesh)
    assert a["collectives"]["counts"] == {"all_reduce": 7, "gather": 1}
    assert a["collectives"]["bytes"]["all_reduce"] == 7 * 64 * 64 * 4
    assert a["collectives"]["bytes"]["gather"] == 2 * 64 * 64 * 4
    assert a["collectives"]["total_bytes"] == 9 * 64 * 64 * 4
    assert a["argument_bytes"] == 64 * 64 * 4
    assert op_census(a)["collective:all_reduce"] == 7


def _port_flops(arch, kind):
    mux = MuxSpec(n=N)
    with reduced():
        cfg = get_config(arch)
        params = S.abstract_params(arch, mux)
        batch, cap = _inputs(arch)
        with S.fake_mode():
            pb = _port_batch(batch)
            if kind == "train":
                opt = S.make_optimizer(pattern=len(cfg.block_pattern))
                fn = S.build_train_step(arch, mux=mux, optimizer=opt,
                                        dtype=torch.float32)
                return analyze(fn, params, opt.init(params), pb)["flops"]
            cache = S.model_class(model_kind(arch)).init_cache(
                cfg, B // N, cap, torch.float32, device="cpu")
            if kind == "prefill":
                pb = {k: (v[:, :L - 1] if k == "tokens" else v)
                      for k, v in pb.items()}
                fn = S.build_prefill(arch, mux=mux, dtype=torch.float32)
            else:
                pb = {"tokens": pb["tokens"][:, L - 1:]}
                fn = S.build_decode_step(arch, mux=mux, dtype=torch.float32,
                                         seq_len=cap)
            return analyze(fn, params, cache, pb)["flops"]


@functools.lru_cache(maxsize=None)
def _reference_flops(arch, kind):
    if arch in BUILDER_ARCHS:
        return _reference_run(arch)[0][f"{kind}_flops"]
    import jax
    import jax.numpy as jnp
    from repro.core import MuxSpec as RefMux
    from repro.launch import specs as RS
    from repro.launch.hlo_analysis import analyze as ref_analyze
    rmux = RefMux(n=N)
    with reduced():
        params = RS.abstract_params(arch, rmux)
        inputs, cap = _inputs(arch)
        batch = {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
                 for k, v in inputs.items()}
        if kind == "train":
            opt = RS.make_optimizer()
            fn = RS.build_train_step(arch, mux=rmux, optimizer=opt,
                                     dtype=jnp.float32)
            args = (params, jax.eval_shape(opt.init, params), batch)
        else:
            cache = jax.eval_shape(lambda: RS.model_class(
                model_kind(arch)).init_cache(RS.get_config(arch), B // N,
                                             cap, jnp.float32))
            if kind == "prefill":
                batch["tokens"] = jax.ShapeDtypeStruct((B, L - 1), jnp.int32)
                fn = RS.build_prefill(arch, mux=rmux, dtype=jnp.float32)
            else:
                batch = {"tokens": jax.ShapeDtypeStruct((B, 1), jnp.int32)}
                fn = RS.build_decode_step(arch, mux=rmux, dtype=jnp.float32,
                                          seq_len=cap)
            args = (params, cache, batch)
        return ref_analyze(jax.jit(fn).lower(*args).compile().as_text())[
            "flops"]


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_flops_equal_reference(arch):
    """build_prefill's and build_decode_step's FLOPs equal the reference's
    HLO count exactly, every arch (no gap to pin)."""
    for kind in ("prefill", "decode"):
        assert _port_flops(arch, kind) == _reference_flops(arch, kind), kind


def test_logits_sum_gradient_gap_is_dead_code_and_the_mux():
    """The gradient of the logits' sum (reduced qwen2-1.5b, the cell
    above): against ``jax.grad`` the port counts 16,809,984 more, the
    forward logits matmul (2 * N*B*L * d * V = 16,777,216), which XLA
    drops as dead because the loss is linear in the logits and no value
    is returned, plus ``MUX_DX_FLOPS``; against ``jax.value_and_grad``
    only the latter."""
    import jax
    import jax.numpy as jnp
    from repro.core import MuxSpec as RefMux
    from repro.launch import specs as RS
    from repro.launch.hlo_analysis import analyze as ref_analyze
    from repro.models import TransformerLM as RefLM
    arch = "qwen2-1.5b"
    with reduced():
        cfg = get_config(arch)
        ref_p = RS.abstract_params(arch, RefMux(n=N))
        tok = jax.ShapeDtypeStruct((B, L), jnp.int32)

        def f(p, t):
            return RefLM.apply(p, RS.get_config(arch), t, mux=RefMux(n=N),
                               dtype=jnp.float32)["logits"].sum()
        ref = {name: ref_analyze(jax.jit(g(f)).lower(ref_p, tok).compile()
                                 .as_text())["flops"]
               for name, g in (("grad", jax.grad),
                               ("value_and_grad", jax.value_and_grad))}
        params = S.abstract_params(arch, MuxSpec(n=N))

        def port_grad(params, tokens):
            leaves = list(S._leaves(params))
            for t in leaves:
                t.requires_grad_(True)
            out = TransformerLM.apply(params, cfg, tokens, mux=MuxSpec(n=N),
                                      dtype=torch.float32,
                                      use_kernels=False)["logits"].sum()
            return torch.autograd.grad(out, leaves)
        with S.fake_mode():
            got = analyze(port_grad, params,
                          torch.zeros((B, L), dtype=torch.int64))["flops"]
    logits_fwd = 2 * B * L * cfg.d_model * cfg.vocab_size
    assert logits_fwd == 16_777_216
    assert got - ref["grad"] == logits_fwd + MUX_DX_FLOPS == 16_809_984
    assert got - ref["value_and_grad"] == MUX_DX_FLOPS


@pytest.mark.parametrize("arch", list(GRAD_GAP))
def test_train_flop_gap_is_pinned(arch):
    """The train step counts the reference's FLOPs plus ``GRAD_GAP``:
    length-1 contractions of the backward that XLA emits as multiplies
    (the constant's note)."""
    got = _port_flops(arch, "train")
    assert got - _reference_flops(arch, "train") == GRAD_GAP[arch]


# ---------------------------------------------------------------------------
# the recording mesh against a real gloo mesh
# ---------------------------------------------------------------------------

MESH_STEPS = (("qwen2-1.5b", "prefill"), ("qwen2-1.5b", "train"),
              ("granite-moe-3b-a800m", "train"))


def _step_counts(mesh, arch, kind):
    """A reduced step of ``kind`` on ``mesh`` over this rank's shards
    (real tensors on a real rank, fake ones on a recording mesh): the
    mesh's collective counts and bytes."""
    reg.set_reduced_mode(True)
    mux = MuxSpec(n=N)
    cfg = get_config(arch)
    fake = isinstance(mesh, RecordingMesh)
    ctx = S.fake_mode() if fake else contextlib.nullcontext()
    params = (S.abstract_params(arch, mux) if fake else TransformerLM.init(
        torch.Generator().manual_seed(0), cfg, mux))
    params = S.rank_params(params, arch, mesh)
    with ctx:
        tokens = torch.as_tensor(_inputs(arch)[0]["tokens"].astype(
            np.int64))
    batch = S.rank_batch({"tokens": tokens}, mesh, n_mux=N)
    with ctx:
        if kind == "train":
            opt = S.make_optimizer(pattern=len(cfg.block_pattern))
            fn = S.build_train_step(arch, mux=mux, optimizer=opt,
                                    dtype=torch.float32, mesh=mesh)
            args = (params, opt.init(params), batch)
        else:
            cache = S.rank_cache(TransformerLM.init_cache(
                cfg, B // N, L, torch.float32, device="cpu"), arch, mesh)
            fn = S.build_prefill(arch, mux=mux, dtype=torch.float32,
                                 mesh=mesh)
            args = (params, cache, batch)
        mesh.counts.clear()
        mesh.bytes.clear()
        with torch.no_grad() if kind != "train" else contextlib.nullcontext():
            fn(*args)
    return dict(mesh.counts), dict(mesh.bytes)


def _mesh_rank(mesh12):
    torch.set_num_threads(1)
    out = {}
    mesh21 = make_serve_mesh(2, 1, device="cpu")
    for m in (mesh12, mesh21):
        for arch, kind in MESH_STEPS:
            out[(tuple(m.shape.values()), arch, kind)] = _step_counts(
                m, arch, kind)
    return out


@pytest.fixture(scope="module")
def gloo_counts(tmp_path_factory):
    return spawn(_mesh_rank, 1, 2, device="cpu", timeout=SPAWN_TIMEOUT,
                 tmpdir=str(tmp_path_factory.mktemp("dryrun_mesh")))


@pytest.mark.parametrize("shape", [(1, 2), (2, 1)])
def test_recording_mesh_counts_equal_gloo_mesh(gloo_counts, shape):
    """The collectives a recording mesh counts for a reduced prefill and
    train step equal what a real gloo ServeMesh counts on each rank of
    the same steps; bytes too (no ``shift`` runs in them, so the two
    meshes' byte rules agree: a gather's buffer is its result)."""
    try:
        for arch, kind in MESH_STEPS:
            want = _step_counts(RecordingMesh(dict(zip(("data", "model"),
                                                       shape))), arch, kind)
            # some collective runs but in a prefill on a data axis alone
            assert bool(want[0]) != (kind == "prefill" and shape[1] == 1)
            for rank in gloo_counts:
                assert rank[(shape, arch, kind)] == want, (arch, kind)
    finally:
        reg.set_reduced_mode(False)


# ---------------------------------------------------------------------------
# roofline and the dry run
# ---------------------------------------------------------------------------

def _records():
    ok = {"arch": "gemma-2b", "shape": "train_4k", "mesh": "single",
          "mux_n": 2, "status": "ok", "memory": {"peak_bytes": 3.2e10},
          "model_flops": 1.0e15, "useful_flops_ratio": 0.4183,
          "roofline": {"compute_s": 0.512, "memory_s": 1.25,
                       "collective_s": 0.0321, "bottleneck": "memory"}}
    skip = {"arch": "gemma-7b", "shape": "long_500k", "mesh": "multi",
            "mux_n": 1, "status": "skip: pure full-attention arch — 500k "
            "dense KV cache is out of memory/latency budget; sub-quadratic "
            "archs only (DESIGN.md §6)"}
    err = {"arch": "rwkv6-7b", "shape": "decode_32k", "mesh": "single",
           "mux_n": 4, "status": "error: ValueError: batch 1 not divisible"}
    coll = dict(ok, arch="granite-moe-3b-a800m", useful_flops_ratio=None,
                roofline=dict(ok["roofline"], collective_s=2.5,
                              bottleneck="collective"))
    return [ok, skip, err, coll]


def test_roofline_format_md_equals_reference(tmp_path, capsys):
    from repro.launch import roofline as ref_roofline
    recs = _records()
    assert roofline.format_md(recs) == ref_roofline.format_md(recs)
    path = tmp_path / "r.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in recs))
    md = tmp_path / "r.md"
    assert roofline.main([str(path), "--md", str(md)]) == 0
    assert md.read_text() == ref_roofline.format_md(recs) + "\n"
    assert "bottleneck census: {'memory': 1, 'collective': 1}" in \
        capsys.readouterr().out


def test_roofline_terms_pick_the_reference_bottleneck():
    from repro.launch.hlo_analysis import roofline_terms as ref_terms
    hw_ref = {"peak_flops_bf16": HW["peak_flops_bf16"],
              "hbm_bw": HW["hbm_bw"], "ici_bw": HW["nvlink_bw"]}
    for flops, traffic, coll in [(1e15, 1e9, 1e6), (1e9, 1e12, 1e6),
                                 (1e9, 1e9, 1e12)]:
        a = {"flops": flops, "traffic_bytes": traffic,
             "collectives": {"total_bytes": coll}}
        assert roofline_terms(a, HW) == ref_terms(a, hw_ref)


@pytest.mark.parametrize("arch,shape,mux_n", DRY_CELLS)
def test_run_cell_reduced_on_a_recording_mesh(arch, shape, mux_n):
    """The reference integration test's four cells, reduced, on a
    recording (4, 2) mesh: status ok, FLOPs counted, the record's keys."""
    with reduced(DRY_SHAPES):
        r = dryrun.run_cell(arch, shape, mux_n=mux_n,
                            mesh_shape={"data": 4, "model": 2})
    assert r["status"] == "ok", r.get("traceback")
    assert r["cost"]["flops"] > 0 and r["chips"] == 8
    for k in ("params", "active_params", "memory", "collectives",
              "op_census", "roofline", "model_flops", "useful_flops_ratio"):
        assert k in r
    assert r["memory"]["peak_bytes"] >= r["memory"]["argument_bytes"] > 0
    assert r["collectives"]["counts"]
    assert "bound=" in dryrun.fmt_row(r)


def test_dryrun_main_writes_what_roofline_renders(tmp_path, capsys):
    out = tmp_path / "d.jsonl"
    with reduced(DRY_SHAPES):
        rc = dryrun.main(["--arch", "rwkv6-7b", "--shape", "decode_32k",
                          "--mux-n", "2", "--mesh", "both",
                          "--out", str(out)])
        assert rc == 0
        assert dryrun.main(["--arch", "gemma-7b", "--shape", "long_500k",
                            "--out", str(out)]) == 0
    recs = roofline.load(str(out))
    assert [r["mesh"] for r in recs] == ["single", "multi", "single"]
    assert [r["status"][:4] for r in recs] == ["ok", "ok", "skip"]
    assert recs[1]["chips"] == 512
    capsys.readouterr()
    roofline.main([str(out)])
    text = capsys.readouterr().out
    assert "| rwkv6-7b | decode_32k | multi | 2 |" in text
    assert "| gemma-7b | long_500k | single | - |" in text
