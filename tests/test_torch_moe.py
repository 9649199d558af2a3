"""The mixture-of-experts LMs — granite-moe-3b-a800m (40 experts, top 8,
tied embeddings) and qwen2-moe-a2.7b (60 routed experts, top 4, and 4
shared ones) — against the JAX reference on the CPU, at the reference's
reduced configs (8 experts, top 2; qwen2-moe with 2 shared experts).

  * the MoE FFN alone: ``apply_moe_global`` and ``apply_moe_grouped``
    (out and aux within 1e-6, the dropped assignments equal), at the
    configs' capacity factor and at 0.5 (drops), with a zero router
    (every gate 1/E: the ties go to experts 0..k-1, as ``jax.lax.top_k``
    breaks them), shared experts on and off, in fp32 and bit for bit in
    bf16; the stacked expert leaves and ``interop`` both ways;
  * logits within 1e-5 on the plain and the kernel path (reference:
    Pallas in interpret mode; port: the wrappers' plain versions on CPU
    tensors): paged chunks and a decode step; blocking prefills with
    attn_impl naive, chunked and flash, then ring decode steps;
  * greedy tokens identical on the paged chunked, paged blocking, ring
    and fill-drain arms in fp32, with every MoE layer call's token count,
    dropped assignments and aux equal to the reference's (the reference's
    read through ``jax.debug.callback``), and the prefill accounting;
  * bf16, the reference's default compute dtype: logits within 1e-2 and
    greedy agreement with the reference's bf16 run at least the
    reference's own bf16-vs-fp32 agreement (``REF_BF16_VS_FP32``);
  * training: the causal-LM loss plus ``router_aux_weight * aux`` and its
    gradients against ``jax.value_and_grad`` within ``GRAD_TOL``, remat on
    and off, a three-step AdamW trajectory within ``TRAJ_TOL``, and
    ``launch.train --arch granite-moe-3b-a800m --reduced``;
  * the serve CLI's counts equal the reference CLI's.

The reference runs once per case and is shared through cached fixtures.
"""
import contextlib
import dataclasses
import functools
import inspect
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as ref_config
from repro.core import MuxSpec as RefMux
from repro.launch import serve as ref_cli
from repro.launch.serve import run_continuous as ref_run_continuous
from repro.models import TransformerLM as RefLM
from repro.models import blocks as ref_blocks
from repro.nn import Linear as RefLinear
from repro.optim import AdamW as RefAdamW
from repro.optim import linear_warmup_linear_decay as ref_lin
from repro.serve import engine as ref_engine
from repro.serve import runtime as ref_runtime
from repro.train import causal_lm_loss as ref_causal
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.core import MuxSpec
from repro_torch.launch import serve as cli
from repro_torch.launch import train as train_cli
from repro_torch.models import TransformerLM, blocks
from repro_torch.optim import AdamW, linear_warmup_linear_decay
from repro_torch.serve import engine
from repro_torch.train import causal_lm_loss, make_train_step
from test_torch_model import _leaves
from test_torch_ring import ref_fill_drain
from test_torch_train import GRAD_TOL, TRAJ_SHARE, TRAJ_TOL, _grads_of

torch.set_num_threads(2)

MOE = ("granite-moe-3b-a800m", "qwen2-moe-a2.7b")
TOL = dict(atol=1e-5, rtol=1e-5)      # tests/test_torch_model.py's TOL
FFN_TOL = 1e-6                        # one MoE FFN, out and aux
BF16_TOL = dict(atol=1e-2, rtol=1e-2)
N = 2


def _moe(cfg, **kw):
    return cfg.replace(moe=dataclasses.replace(cfg.moe, **kw))


# ---------------------------------------------------------------------------
# the reference's MoE calls, recorded
# ---------------------------------------------------------------------------

REF_LOG = []


def _ref_dropped(p, cfg, x, grouped):
    """(tokens the capacity is computed from, assignments past their
    expert's capacity) of one reference MoE call, from its own router."""
    m = cfg.moe
    b, l, _ = x.shape
    n = l if grouped else b * l
    cap = ref_blocks.moe_capacity(n, cfg)
    gates = jax.nn.softmax(
        RefLinear.apply(p["router"], x).astype(jnp.float32), axis=-1)
    _, topi = jax.lax.top_k(gates, m.top_k)
    e = topi.reshape(b if grouped else 1, -1)
    counts = (e[..., None] == jnp.arange(m.n_experts)).sum(1)
    return n, jnp.maximum(counts - cap, 0).sum()


def _recording(fn, grouped):
    def wrapped(p, cfg, x, *rest):
        out, aux = fn(p, cfg, x, *rest)
        n, dropped = _ref_dropped(p, cfg, x, grouped)
        jax.debug.callback(
            lambda d, a: REF_LOG.append((n, int(d), float(a))), dropped, aux)
        return out, aux
    return wrapped


@pytest.fixture(scope="module", autouse=True)
def _record_reference():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_blocks, "apply_moe_global",
                   _recording(ref_blocks.apply_moe_global, False))
        mp.setattr(ref_blocks, "apply_moe_grouped",
                   _recording(ref_blocks.apply_moe_grouped, True))
        yield


def _port_log(stats):
    return [(s["tokens"], int(s["dropped"]), float(s["aux"])) for s in stats]


def _same_log(got, want):
    assert [g[:2] for g in got] == [w[:2] for w in want]
    np.testing.assert_allclose([g[2] for g in got], [w[2] for w in want],
                               rtol=0, atol=FFN_TOL)


# ---------------------------------------------------------------------------
# the MoE FFN alone
# ---------------------------------------------------------------------------

FFN_CASES = {
    "granite": ("granite-moe-3b-a800m", {}),
    "granite-cf0.5": ("granite-moe-3b-a800m", {"capacity_factor": 0.5}),
    "qwen2-shared-cf0.5": ("qwen2-moe-a2.7b", {"capacity_factor": 0.5}),
    "qwen2-no-shared": ("qwen2-moe-a2.7b", {"n_shared": 0, "d_shared": 0}),
    "zero-router": ("qwen2-moe-a2.7b", {"capacity_factor": 0.5}),
}


@functools.lru_cache(maxsize=None)
def _ffn_case(case, impl):
    arch, kw = FFN_CASES[case]
    cfg_r = _moe(ref_config(arch, reduced=True), impl=impl, **kw)
    cfg = _moe(get_config(arch, reduced=True), impl=impl, **kw)
    p = jax.tree.map(np.asarray, ref_blocks.init_moe(jax.random.PRNGKey(3),
                                                     cfg_r))
    if case == "zero-router":
        p["router"]["w"] = np.zeros_like(p["router"]["w"])
    # 2 rows of 48 tokens: at capacity factor 0.5 both impls drop
    x = np.random.default_rng(4).standard_normal(
        (2, 48, cfg.d_model)).astype(np.float32)
    return cfg_r, cfg, p, x


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("impl", ["global_sort", "local_group"])
@pytest.mark.parametrize("case", FFN_CASES)
def test_moe_ffn_matches_reference(case, impl, dtype):
    cfg_r, cfg, p, x = _ffn_case(case, impl)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "fp32"
                else (jnp.bfloat16, torch.bfloat16))
    xr = jnp.asarray(x, jdt)
    del REF_LOG[:]
    want, want_aux = ref_blocks.apply_moe(p, cfg_r, xr)
    pt = jax.tree.map(torch.as_tensor, p)
    with blocks.record_moe() as stats:
        got, aux = blocks.apply_moe(pt, cfg, torch.as_tensor(x).to(tdt))
    assert got.dtype == tdt and aux.dtype == torch.float32
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "bf16":      # the same roundings in the same order
        np.testing.assert_array_equal(got.float().numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FFN_TOL)
    assert abs(float(aux) - float(want_aux)) <= FFN_TOL
    _same_log(_port_log(stats), REF_LOG)
    dropped = _port_log(stats)[0][1]
    if "cf0.5" in case or case == "zero-router":
        assert dropped > 0
    if case == "zero-router":
        # every gate 1/E: each token's choices are experts 0..k-1
        assert stats[0]["load"].tolist() == (
            [x.shape[0] * x.shape[1]] * cfg.moe.top_k
            + [0] * (cfg.moe.n_experts - cfg.moe.top_k))


def test_moe_leaves_and_interop():
    """The port's init has the reference's MoE leaves, shapes and stacked
    layout (``jax.eval_shape`` of its init), and ``interop`` carries the
    expert stacks across both ways leaf for leaf."""
    for arch in MOE:
        cfg_r, ref, cfg, port = _ref_params(arch)
        mine = TransformerLM.init(torch.Generator().manual_seed(0), cfg,
                                  MuxSpec(n=N))
        shapes = jax.eval_shape(lambda: RefLM.init(jax.random.PRNGKey(0),
                                                   cfg_r, RefMux(n=N)))
        want = {k: v.shape for k, v in _leaves(shapes)}
        got = {k: v.shape for k, v in
               _leaves(interop.params_to_reference(mine, cfg))}
        assert got == want
        m = cfg.moe
        ffn = port["layers"][1]["ffn"]
        assert ffn["w_up"].shape == (m.n_experts, cfg.d_model, m.d_expert)
        assert ffn["w_down"].shape == (m.n_experts, m.d_expert, cfg.d_model)
        a = dict(_leaves(ref))
        b = dict(_leaves(interop.params_to_reference(port, cfg)))
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        # the cache converters: a reference ring cache, and a paged cache
        # there and back
        sc_r = ref_engine.ServeConfig(cfg=cfg_r, kind="lm", mux=RefMux(n=N),
                                      capacity=12, dtype=jnp.float32)
        ring = interop.ring_cache_from_reference(
            ref_engine.init_cache(sc_r, 2 * N), cfg, device="cpu")
        want = engine.init_cache(engine.ServeConfig(
            cfg=cfg, mux=MuxSpec(n=N), capacity=12, dtype=torch.float32),
            2 * N, device="cpu")
        assert [{k: getattr(v, "shape", v) for k, v in c.items()}
                for c in ring["layers"]] == [
            {k: getattr(v, "shape", v) for k, v in c.items()}
            for c in want["layers"]]
        sc = engine.ServeConfig(cfg=cfg, mux=MuxSpec(n=N), capacity=12,
                                dtype=torch.float32, **{
                                    k: v for k, v in PAGED.items()
                                    if k != "capacity"})
        paged = engine.init_cache(sc, 2 * N, device="cpu")
        for c in paged["layers"]:
            c["kp"].normal_()
        back = interop.paged_cache_from_reference(
            interop.paged_cache_to_reference(paged, cfg), cfg,
            engine.init_cache(sc, 2 * N, device="cpu"))
        assert all(torch.equal(x["kp"], y["kp"])
                   for x, y in zip(back["layers"], paged["layers"]))


# ---------------------------------------------------------------------------
# the served model
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ref_params(arch, impl="auto"):
    """(reference config, reference params as numpy, port config, port
    params): the port's seeded init, carried to the reference's layout
    (its eager init costs seconds a model)."""
    cfg_r = ref_config(arch, reduced=True).replace(attn_impl=impl,
                                                   attn_chunk=8)
    cfg = get_config(arch, reduced=True).replace(attn_impl=impl, attn_chunk=8)
    port = TransformerLM.init(torch.Generator().manual_seed(7), cfg,
                              MuxSpec(n=N))
    return cfg_r, interop.params_to_reference(port, cfg), cfg, port


_REF_STEPS = {name: getattr(ref_engine, name)
              for name in ("prefill", "prefill_chunk", "decode_step")}


@functools.lru_cache(maxsize=None)
def _ref_step(name):
    """The reference engine's step, jitted (its eager steps recompile
    their layer scan every call); the MoE calls still reach the log."""
    fn = _REF_STEPS[name]
    static = [a for a in ("sc", "use_kernels")
              if a in inspect.signature(fn).parameters]
    return jax.jit(fn, static_argnames=static)


@contextlib.contextmanager
def _jitted_reference_loops():
    """The reference's eager serving loops (the continuous ring arm,
    fill-drain, the runtime's blocking prefill) with their steps jitted,
    in fp32 only: the same numbers (XLA's excess precision touches bf16
    alone), minus a scan compile per call."""
    with pytest.MonkeyPatch.context() as mp:
        for mod, name in ((ref_engine, "prefill"),
                          (ref_engine, "decode_step"), (ref_cli, "prefill"),
                          (ref_cli, "decode_step"), (ref_runtime, "prefill")):
            mp.setattr(mod, name, _ref_step(name))
        yield


def _paged_ref(arch, dtype=jnp.float32):
    """The reference's plain path over ``_paged_inputs``: three chunks
    (one crossing a block boundary, one bucket-padded) and one decode step
    of 3 rows (one inactive, whose token is routed all the same).  Returns
    [(logits, MoE log)] a step."""
    cfg_r, ref, _, _ = _ref_params(arch)
    if dtype != jnp.float32:
        ref = jax.tree.map(jnp.asarray, ref)
    sc_r = ref_engine.ServeConfig(cfg=cfg_r, kind="lm", mux=RefMux(n=N),
                                  dtype=dtype, **PAGED)
    cache = ref_engine.init_cache(sc_r, N * 3)
    pool = ref_engine.make_pool(sc_r, N * 3)
    pool.allocate(0, 30)
    pool.allocate(1, 21)          # row 2 stays unallocated (inactive)
    cache = ref_engine.set_block_tables(cache, pool.table_array(range(3)))
    out = []
    chunks, (toks, pos) = _paged_inputs()
    for row, start, length, t in chunks:
        del REF_LOG[:]
        want, cache = _ref_step("prefill_chunk")(
            ref, sc_r, cache, jnp.asarray(t), rows=jnp.asarray([row]),
            start=jnp.asarray(start), length=jnp.asarray(length))
        out.append((np.asarray(want.astype(jnp.float32)), list(REF_LOG)))
    del REF_LOG[:]
    want, _ = _ref_step("decode_step")(ref, sc_r, cache, jnp.asarray(toks),
                                       jnp.asarray(pos))
    out.append((np.asarray(want.astype(jnp.float32)), list(REF_LOG)))
    return out


PAGED = dict(capacity=40, cache_layout="paged", block_size=4)


def _paged_inputs():
    rng = np.random.default_rng(1)
    chunks = [(row, start, length,
               rng.integers(4, 512, size=(N, 8)).astype(np.int32))
              for row, start, length in [(0, 0, 8), (0, 8, 8), (0, 16, 6),
                                         (1, 0, 5)]]
    toks = rng.integers(4, 512, size=(N * 3, 1)).astype(np.int32)
    return chunks, (toks, np.asarray([22, 5, -1], np.int32))


def _paged_port(arch, use_kernels, dtype=torch.float32):
    """The port over ``_paged_inputs``, on either path: [(logits, MoE
    log)] a step."""
    _, _, cfg, port = _ref_params(arch)
    sc = engine.ServeConfig(cfg=cfg, mux=MuxSpec(n=N), dtype=dtype, **PAGED)
    cache = engine.init_cache(sc, N * 3, device="cpu")
    pool = engine.make_pool(sc, N * 3)
    pool.allocate(0, 30)
    pool.allocate(1, 21)
    engine.set_block_tables(cache, pool.table_array(range(3)))
    out = []
    chunks, (toks, pos) = _paged_inputs()
    for row, start, length, t in chunks:
        with blocks.record_moe() as stats:
            got, _ = engine.prefill_chunk(port, sc, cache, torch.as_tensor(t),
                                          rows=[row], start=start,
                                          length=length,
                                          use_kernels=use_kernels)
        out.append((got, _port_log(stats)))
    with blocks.record_moe() as stats:
        got, _ = engine.decode_step(port, sc, cache, torch.as_tensor(toks),
                                    torch.as_tensor(pos),
                                    use_kernels=use_kernels)
    out.append((got, _port_log(stats)))
    return out


_paged_ref_cached = functools.lru_cache(maxsize=None)(_paged_ref)


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("arch", MOE)
def test_paged_logits_match_reference(arch, use_kernels):
    """Both of the port's paths against the reference's plain path (which
    its Pallas path matches within 1e-5, tests/test_torch_dense_configs.py):
    logits and each step's MoE log, one MoE call a layer."""
    n_layers = get_config(arch, reduced=True).n_layers
    for (got, log), (want, ref_log) in zip(
            _paged_port(arch, use_kernels), _paged_ref_cached(arch)):
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        assert len(log) == n_layers
        _same_log(log, ref_log)


@functools.lru_cache(maxsize=None)
def _ring_ref(arch):
    """The reference's naive blocking prefill of a 20-token prompt into a
    ring of capacity 24, then three ring decode steps (plain path):
    [(logits, MoE log)]."""
    cfg_r, ref, _, _ = _ref_params(arch)
    sc_r = ref_engine.ServeConfig(cfg=cfg_r, kind="lm", mux=RefMux(n=N),
                                  capacity=24, dtype=jnp.float32)
    toks = _ring_prompt()
    cache = ref_engine.init_cache(sc_r, 2 * N)
    del REF_LOG[:]
    want, cache = _ref_step("prefill")(ref, sc_r, cache, jnp.asarray(toks))
    out = [(np.asarray(want), list(REF_LOG))]
    tok = np.asarray(want).argmax(-1)[:, None].astype(np.int32)
    for t in range(3):
        del REF_LOG[:]
        want, cache = _ref_step("decode_step")(ref, sc_r, cache,
                                               jnp.asarray(tok),
                                               jnp.asarray(20 + t))
        out.append((np.asarray(want), list(REF_LOG)))
        tok = np.asarray(want)[:, 0].argmax(-1)[:, None].astype(np.int32)
    return out


def _ring_prompt():
    return np.random.default_rng(2).integers(4, 512, (2 * N, 20)).astype(
        np.int32)


@pytest.mark.parametrize("impl,use_kernels", [("naive", False),
                                              ("naive", True),
                                              ("chunked", False),
                                              ("flash", True)])
@pytest.mark.parametrize("arch", MOE)
def test_blocking_prefill_and_ring_decode_match_reference(arch, impl,
                                                          use_kernels):
    """A blocking prefill (attention by ``impl``, 8-key chunks; under
    use_kernels the mux-combine entry, and the flash kernel's plain
    version for 'flash') into a ring of capacity 24, then three ring
    decode steps (under use_kernels the flash-decode and fused entry /
    exit wrappers' plain versions), against the reference's naive plain
    path: logits and each step's MoE log."""
    _, _, cfg, port = _ref_params(arch)
    cfg = cfg.replace(attn_impl=impl)
    sc = engine.ServeConfig(cfg=cfg, mux=MuxSpec(n=N), capacity=24,
                            dtype=torch.float32)
    cache = engine.init_cache(sc, 2 * N, device="cpu")
    want = iter(_ring_ref(arch))
    w, ref_log = next(want)
    with blocks.record_moe() as stats:
        got, _ = engine.prefill(port, sc, cache,
                                torch.as_tensor(_ring_prompt()),
                                use_kernels=use_kernels)
    np.testing.assert_allclose(got.numpy(), w, **TOL)
    _same_log(_port_log(stats), ref_log)
    tok = w.argmax(-1)[:, None].astype(np.int32)
    for t, (w, ref_log) in enumerate(want):
        with blocks.record_moe() as stats:
            got, _ = engine.decode_step(port, sc, cache, torch.as_tensor(tok),
                                        20 + t, use_kernels=use_kernels)
        np.testing.assert_allclose(got.numpy(), w, **TOL)
        _same_log(_port_log(stats), ref_log)
        tok = w[:, 0].argmax(-1)[:, None].astype(np.int32)


def _trace():
    """(step, prompt, max_new): staggered arrivals."""
    rng = np.random.default_rng(4)
    return [(s, rng.integers(4, 512, size=(k,)).tolist(), m)
            for s, k, m in zip([0, 0, 2, 5], [14, 9, 18, 6], [6, 8, 4, 7])]


def _outputs(stats):
    return {r.uid: list(r.output) for r in stats["completed"]}


def _serve_both(arch, arm, dtype=torch.float32, jdtype=jnp.float32):
    """One arm of both packages on ``_trace`` (2 rows, N=2; fill-drain: 5
    prompts of 12), the port on its kernel path (plain versions on the
    CPU).  Returns (port stats, reference stats, port MoE log, reference
    MoE log); fill-drain's stats are the requests' outputs."""
    cfg_r, ref, cfg, port = _ref_params(arch)
    if dtype != torch.float32:
        ref = jax.tree.map(jnp.asarray, ref)
    layout = "ring" if arm in ("ring", "fill-drain") else "paged"
    kw = dict(capacity=40, cache_layout=layout, block_size=4)
    sc_r = ref_engine.ServeConfig(cfg=cfg_r, kind="lm", mux=RefMux(n=N),
                                  dtype=jdtype, **kw)
    sc = engine.ServeConfig(cfg=cfg, mux=MuxSpec(n=N), dtype=dtype, **kw)
    del REF_LOG[:]
    loops = (_jitted_reference_loops() if dtype == torch.float32
             else contextlib.nullcontext())
    if arm == "fill-drain":
        rng = np.random.default_rng(5)
        prompts = [rng.integers(4, 512, 12).astype(np.int32)
                   for _ in range(5)]
        with loops:
            want = ref_fill_drain(ref, sc_r, 2, prompts, 6)
        ref_log = list(REF_LOG)
        with blocks.record_moe() as stats:
            got = cli.fill_drain(port, sc, 2, prompts, 6, device="cpu")
        return ([r.output for r in got["completed"]], want,
                _port_log(stats), ref_log)
    mode = "blocking" if arm == "paged-blocking" else "chunked"
    with loops:
        want = ref_run_continuous(ref, sc_r, 2, _trace(), chunk=8,
                                  prefill_mode=mode)
    ref_log = list(REF_LOG)
    with blocks.record_moe() as stats:
        got = cli.run_continuous(port, sc, 2, _trace(), chunk=8,
                                 prefill_mode=mode, device="cpu")
    return got, want, _port_log(stats), ref_log


ARMS = ("ring", "paged-chunked", "paged-blocking", "fill-drain")


@pytest.mark.parametrize("arm", ARMS)
@pytest.mark.parametrize("arch", MOE)
def test_greedy_arms_token_identical(arch, arm):
    """The same greedy tokens and prefill accounting as the reference's
    arm, and every MoE call (one a layer a forward) with the reference's
    token count, drops and aux: each step hands the FFN the reference's
    (B, L), idle rows and bucket padding included."""
    got, want, log, ref_log = _serve_both(arch, arm)
    assert len(log) % get_config(arch, reduced=True).n_layers == 0
    _same_log(log, ref_log)
    if arm == "fill-drain":
        assert got == want
        return
    assert _outputs(got) == _outputs(want)
    for k in ("prefill_events", "prefill_tokens", "prefill_compute_tokens",
              "prefill_log", "decode_steps"):
        assert got[k] == want[k], k
    if arm != "ring":
        assert got["trace_counts"] == want["trace_counts"]
        assert got["runtime"].pool.n_used_blocks == 0


# The reference's own agreement between its bf16 and fp32 greedy runs of
# the paged chunked trace above (positions agreeing, all positions),
# measured with the reference alone: the floor of the port's bf16 run
# against the reference's bf16 run
REF_BF16_VS_FP32 = {"granite-moe-3b-a800m": (25, 25),
                    "qwen2-moe-a2.7b": (25, 25)}


@pytest.mark.parametrize("arch", MOE)
def test_bf16_logits_and_agreement(arch):
    """bf16 compute, the reference's default: paged chunk and decode
    logits within 1e-2 on the kernel path, and the paged chunked arm's
    greedy agreement with the reference's bf16 run at least the
    reference's own bf16-vs-fp32 agreement."""
    for (got, _), (want, _) in zip(_paged_port(arch, True, torch.bfloat16),
                                   _paged_ref(arch, jnp.bfloat16)):
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), want, **BF16_TOL)
    got, want, _, _ = _serve_both(arch, "paged-chunked", torch.bfloat16,
                                  jnp.bfloat16)
    a, b = _outputs(got), _outputs(want)
    same = sum(x == y for u in a for x, y in zip(a[u], b[u]))
    floor, total = REF_BF16_VS_FP32[arch]
    assert sum(len(v) for v in a.values()) == total and same >= floor


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _lm_batch(cfg, n=4, seq=16, seed=0):
    return np.random.default_rng(seed).integers(
        4, cfg.vocab_size, (n, seq)).astype(np.int32)


def _ref_loss(cfg_r):
    def fn(p, toks):
        out = RefLM.apply(p, cfg_r, toks, mux=RefMux(n=N), dtype=jnp.float32)
        return (ref_causal(out["logits"], toks)
                + cfg_r.moe.router_aux_weight * out["aux"])
    return fn


@functools.lru_cache(maxsize=None)
def _ref_value_and_grad(arch):
    """The reference's jitted value_and_grad of the loss (remat does not
    change its values)."""
    return jax.jit(jax.value_and_grad(_ref_loss(_ref_params(arch)[0])))


def _port_loss(cfg):
    def fn(p, toks):
        out = TransformerLM.apply(p, cfg, toks, mux=MuxSpec(n=N),
                                  dtype=torch.float32, use_kernels=False)
        return (causal_lm_loss(out["logits"], toks)
                + cfg.moe.router_aux_weight * out["aux"])
    return fn


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", MOE)
def test_lm_loss_with_aux_and_grads_match_reference(arch, remat):
    """The causal-LM loss with the router's aux loss, as the reference's
    launcher builds it, and its gradients (the router's through the aux
    and the gates) against ``jax.value_and_grad``: each leaf within
    GRAD_TOL of the largest |grad|."""
    _, ref, cfg, _ = _ref_params(arch)
    cfg = cfg.replace(remat=remat)
    toks = _lm_batch(cfg)
    want_loss, want = _ref_value_and_grad(arch)(ref, jnp.asarray(toks))
    params = interop.params_from_reference(ref, cfg, device="cpu")
    loss, grads = _grads_of(lambda p: _port_loss(cfg)(
        p, torch.as_tensor(toks)), params)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    got = dict(_leaves(interop.params_to_reference(grads, cfg)))
    want = dict(_leaves(jax.tree.map(np.asarray, want)))
    assert got.keys() == want.keys()
    big = max(float(np.abs(w).max()) for w in want.values())
    for path, w in want.items():
        err = float(np.abs(got[path] - w).max()) / big
        assert err <= GRAD_TOL, (path, err)
    router = [p for p in want if p.endswith("/ffn/router/w")]
    assert router and all(np.abs(want[p]).max() > 0 for p in router)


def test_adamw_trajectory_matches_reference():
    """Three AdamW steps of reduced granite-moe (warm-up 1 of 3 to the
    launcher's default peak lr 1e-3, clipping at 1) from the same weights:
    losses and grad norms step by step and the final params within
    TRAJ_TOL, as ``test_torch_train.py``'s.  Each step's gradients agree
    to ~3.5e-7 of the largest; Adam turns fp32 noise on a near-zero
    gradient into a step of about the lr, so the bound scales with the
    summed lr (at a 3e-3 peak one element of 16384 moved 1.04e-4)."""
    arch, steps = "granite-moe-3b-a800m", 3
    cfg_r, ref, cfg, _ = _ref_params(arch)
    ref_opt = RefAdamW(lr=ref_lin(1e-3, 1, steps))
    opt = AdamW(lr=linear_warmup_linear_decay(1e-3, 1, steps))
    grad_fn = _ref_value_and_grad(arch)
    update = jax.jit(ref_opt.update)
    rp = jax.tree.map(jnp.asarray, ref)
    rs = ref_opt.init(rp)
    pp = interop.params_from_reference(ref, cfg, device="cpu")
    ps = opt.init(pp)
    port_loss = _port_loss(cfg)
    step = make_train_step(lambda p, b, g: (port_loss(p, b["tokens"]), {}),
                           opt)
    for i in range(steps):
        toks = _lm_batch(cfg, seed=10 + i)
        loss, grads = grad_fn(rp, jnp.asarray(toks))
        updates, rs, rm = update(grads, rs, rp)
        rp = ref_opt.apply_updates(rp, updates)
        pp, ps, pm = step(pp, ps, {"tokens": torch.as_tensor(toks)}, None)
        np.testing.assert_allclose(float(pm["loss"]), float(loss), rtol=1e-5,
                                   err_msg=f"step {i}")
        np.testing.assert_allclose(float(pm["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=1e-5)
    gl = dict(_leaves(interop.params_to_reference(pp, cfg)))
    wl = dict(_leaves(rp))
    close = total = 0
    for path, w in wl.items():
        np.testing.assert_allclose(gl[path], np.asarray(w), **TRAJ_TOL,
                                   err_msg=path)
        close += int((np.abs(gl[path] - np.asarray(w)) <= 1e-6).sum())
        total += np.size(w)
    assert close >= TRAJ_SHARE * total, (close, total)


def test_train_cli_runs_moe(capsys, tmp_path):
    got = {}
    assert train_cli.main(["--arch", "granite-moe-3b-a800m", "--reduced",
                           "--steps", "2", "--batch", "4", "--seq", "16",
                           "--device", "cpu", "--ckpt", str(tmp_path)],
                          out=got) == 0
    out = capsys.readouterr().out
    assert "--- stage: lm (2 steps) ---" in out and "steps=2  loss" in out
    assert got["cfg"].moe is not None
    assert all(np.isfinite(float(h["loss"]))
               for h in got["stages"][0]["history"] if "loss" in h)


# ---------------------------------------------------------------------------
# the serve CLI against the reference CLI
# ---------------------------------------------------------------------------

# wall-clock figures differ run to run; every other number must match
_CLOCK = re.compile(r"[\d.]+ ?(s|ms|tok/s)\b")


@pytest.mark.parametrize("arch", MOE)
def test_cli_counts_equal_reference_cli(capsys, arch):
    """Paged chunked serving through both CLIs: the same served line
    (requests, tokens, prefill accounting, slot util) but for the clock,
    and the same step signatures as the reference's compiled programs."""
    argv = ["--arch", arch, "--continuous", "--cache", "paged", "--requests",
            "3", "--prompt-len", "6", "--new-tokens", "3", "--block-size",
            "4", "--chunk", "4"]
    assert cli.main(argv + ["--device", "cpu"]) == 0
    mine = capsys.readouterr().out
    ref_cli.main(argv)
    want = capsys.readouterr().out

    def line(text, head):
        got = [ln for ln in text.splitlines() if head in ln]
        assert len(got) == 1, (head, text)
        return _CLOCK.sub("<t>", got[0].split(head, 1)[1])
    assert "served 3 requests (9 tokens)" in mine
    assert line(mine, "continuous[paged/chunked/cpu]") == line(
        want, "continuous[paged/chunked]")
    assert line(mine, "step signatures:") == line(want, "compiled programs:")
