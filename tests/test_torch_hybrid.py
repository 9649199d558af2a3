"""The port's hybrid family (recurrentgemma-9b, reduced: one period of
(rglru, rglru, local) and a tail of two RG-LRU layers, local window 16)
against the JAX reference, on the CPU.

Both packages start from the port's seeded init carried to the
reference's layout (``interop``), N=2; inputs come from numpy seeds.  The
reference's steps run jitted, each compiled once and shared across cases
(its eager steps recompile their layer scan every call):

  * the scan: ``blocks.linear_scan`` bit for bit the jitted
    ``jax.lax.associative_scan`` of the reference's combine, odd and even
    lengths 1 to 64;
  * ``apply_rglru`` fresh and from a cache (zero and carried state): the
    output, ``h`` and ``conv`` within 1e-5 in fp32; in bf16 within
    ``MODEL_ULPS`` bf16 ulps of each tensor's largest value (its layer
    run op by op is ``test_torch_bf16_rest.py``'s bit-for-bit case);
  * the full forward's logits within 1e-4; a ring prefill of 20 tokens
    (past the window of 16) and decode steps from one reference cache
    (``interop.ring_cache_from_reference``) within 1e-4;
  * serving: the ring arm and fill-drain greedy token-identical to the
    reference with prompts past the window, on the plain and the kernel
    path (the wrappers' plain versions here);
  * the paged arm refused where the reference fails (its ``TypeError``
    reproduced), by ``ServeRuntime``, ``apply_rglru`` and the CLI;
  * the interop round trip over periods and tail, the port's init against
    the reference's tree, the decay masks of every LM config against the
    reference's leaf for leaf, and one causal-LM AdamW step (loss,
    gradients and the updated params within ``test_torch_train.py``'s
    tolerances).
"""
import contextlib
import functools

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
from repro.optim import AdamW as RefAdamW
from repro.optim.adamw import default_decay_mask as ref_decay_mask
from repro.serve import engine as ref_engine
from repro.serve.batcher import Request as RefRequest
from repro.serve.runtime import ServeRuntime as RefRuntime
from repro.train import causal_lm_loss as ref_causal
from repro_torch import interop
from repro_torch.configs import ARCHS, get_config, model_kind
from repro_torch.core import MuxSpec
from repro_torch.kernels import ops
from repro_torch.launch import serve as cli
from repro_torch.models import TransformerLM, blocks, param_count
from repro_torch.optim import AdamW, path_str, reference_leaves
from repro_torch.serve import engine
from repro_torch.serve.runtime import ServeRuntime
from repro_torch.train import causal_lm_loss
from test_torch_bf16_rest import MODEL_ULPS
from test_torch_model import _leaves
from test_torch_ring import ref_fill_drain
from test_torch_train import (GRAD_TOL, LOSS_RTOL, TRAJ_SHARE, TRAJ_TOL,
                              _grads_of)

torch.set_num_threads(2)

ARCH = "recurrentgemma-9b"
N = 2
TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=0)
CFG_R, CFG = ref_config(ARCH, reduced=True), get_config(ARCH, reduced=True)
BF = torch.bfloat16
BF16_ULP = 2.0 ** -7


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(jnp.asarray(t).astype(jnp.float32))


@functools.lru_cache(maxsize=None)
def _params():
    """(reference params as numpy, port params): the port's seeded init
    carried to the reference's layout."""
    port = TransformerLM.init(torch.Generator().manual_seed(7), CFG,
                              MuxSpec(n=N))
    return interop.params_to_reference(port, CFG), port


def _ref_shapes(cfg_r):
    return jax.eval_shape(lambda k: RefLM.init(k, cfg_r, RefMux(n=N)),
                          jax.random.PRNGKey(0))


# ------------------------------------------------------------ the scan

def _combine(c1, c2):
    """The reference's combine (``repro/models/blocks.py`` apply_rglru)."""
    a1, u1 = c1
    a2, u2 = c2
    return a1 * a2, a2 * u1 + u2


_ref_scan = jax.jit(lambda a, u: jax.lax.associative_scan(
    _combine, (a, u), axis=1))


@pytest.mark.parametrize("l", [1, 2, 3, 4, 5, 7, 8, 16, 17, 31, 33, 64])
def test_linear_scan_is_the_jitted_associative_scan(l):
    """Bit for bit, the running product and h: the same pairings, and
    ``torch.addcmul`` rounds a2 u1 + u2 once, as XLA's fused FMA does."""
    rng = np.random.default_rng(l)
    a = rng.uniform(0.3, 1.0, (3, l, 16)).astype(np.float32)
    u = rng.standard_normal((3, l, 16)).astype(np.float32)
    want_a, want_h = _ref_scan(a, u)
    got_a, got_h = blocks.linear_scan(torch.as_tensor(a), torch.as_tensor(u))
    np.testing.assert_array_equal(got_h.numpy(), np.asarray(want_h))
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))


# ------------------------------------------------------------ the block

_ref_rglru = jax.jit(lambda p, x, c: ref_blocks.apply_rglru(
    p, CFG_R, "rglru", x, {}, c)[:2])


def _layer(i=0):
    ref, port = _params()
    layer_r = (jax.tree.map(lambda a: a[0], ref["periods"][i]) if i < 3
               else ref["tail"][i - 3])
    return jax.tree.map(jnp.asarray, layer_r), port["layers"][i]


def _block_case(state, l, dtype):
    """(x, reference cache, port cache) for ``apply_rglru``: no cache, a
    zero cache or a carried one (h fp32, conv in ``dtype``), the two
    caches holding the same values."""
    rng = np.random.default_rng(l)
    x = torch.as_tensor(rng.standard_normal((2, l, CFG.d_model)).astype(
        np.float32)).to(dtype)
    if state == "fresh":
        return x, {}, None
    cache = blocks.init_rglru_cache(CFG, 2, dtype, device="cpu")
    if state == "carried":
        cache["h"].copy_(torch.as_tensor(rng.standard_normal((2, 64))))
        cache["conv"].copy_(torch.as_tensor(rng.standard_normal((2, 3, 64))))
    # copies: a JAX array may alias a numpy buffer, which the port's
    # in-place update would then change under the reference's async call
    jdt = jnp.bfloat16 if dtype == BF else jnp.float32
    return x, {"h": jnp.array(cache["h"].numpy().copy()),
               "conv": jnp.array(cache["conv"].float().numpy().copy(),
                                 jdt)}, cache


@pytest.mark.parametrize("l", [1, 12])
@pytest.mark.parametrize("state", ["fresh", "zero", "carried"])
def test_apply_rglru_matches_reference(state, l):
    """One layer (of the period, and of the tail) on a decode step and on
    a 12-token segment; the state's update too."""
    for i in (0, 3):
        layer_r, layer = _layer(i)
        x, cache_r, cache = _block_case(state, l, torch.float32)
        want, new_r = _ref_rglru(layer_r, jnp.asarray(x.numpy()), cache_r)
        got = blocks.apply_block(layer, CFG, "rglru", x, {}, cache)
        np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
        if cache is None:
            assert new_r == {}
            continue
        assert set(cache) == set(new_r) == {"h", "conv"}
        for k in cache:
            np.testing.assert_allclose(cache[k].numpy(), _np(new_r[k]),
                                       **TOL)


def _ulps_close(got, want, ulps=MODEL_ULPS):
    w = _np(want)
    np.testing.assert_allclose(_np(got), w, rtol=0,
                               atol=ulps * BF16_ULP * np.abs(w).max())


@pytest.mark.parametrize("state", ["fresh", "carried"])
def test_apply_rglru_bf16_matches_reference(state):
    """bf16 x and conv state, fp32 h, against the reference's jitted
    layer (which keeps fused chains in fp32): output, h and conv within
    ``MODEL_ULPS`` bf16 ulps of each one's largest value; the state keeps
    its dtypes."""
    layer_r, layer = _layer()
    x, cache_r, cache = _block_case(state, 12, BF)
    want, new_r = _ref_rglru(layer_r, jnp.asarray(x.float().numpy()).astype(
        jnp.bfloat16), cache_r)
    got = blocks.apply_block(layer, CFG, "rglru", x, {}, cache)
    assert got.dtype == BF
    _ulps_close(got, want)
    if cache is not None:
        assert (cache["h"].dtype, cache["conv"].dtype) == (torch.float32, BF)
        for k in cache:
            _ulps_close(cache[k], new_r[k])


def test_causal_depthwise_conv_adds_in_the_reference_order():
    """bf16: ((t0 + t1) + t2) + t3, then the bias, each op rounded —
    the reference's Python ``sum`` run op by op, bit for bit."""
    rng = np.random.default_rng(3)
    y, st = (rng.standard_normal(s).astype(np.float32)
             for s in ((2, 5, 64), (2, 3, 64)))
    w, b = (rng.standard_normal(s).astype(np.float32) for s in ((4, 64),
                                                                 (64,)))
    with jax.disable_jit():
        want, want_st = ref_blocks._causal_depthwise_conv(
            *(jnp.asarray(a, jnp.bfloat16) for a in (y, w, b, st)))
    got, got_st = blocks._causal_depthwise_conv(
        *(torch.as_tensor(a).to(BF) for a in (y, w, b, st)))
    for g, wt in ((got, want), (got_st, want_st)):
        np.testing.assert_array_equal(g.view(torch.int16).numpy(),
                                      np.asarray(wt).view(np.int16))


def test_apply_rglru_refuses_a_row_subset():
    """A row-subset prefill (the reference's paged fault) raises."""
    _, layer = _layer()
    cache = blocks.init_block_cache(CFG, "rglru", 2, 40, layout="paged",
                                    device="cpu")
    assert set(cache) == {"h", "conv"}
    with pytest.raises(NotImplementedError, match="_causal_depthwise_conv"):
        blocks.apply_rglru(layer, CFG, "rglru", torch.zeros(1, 4, 64),
                           {"rows": torch.tensor([0])}, cache)


# ------------------------------------------------------------ the model

def test_interop_round_trip_periods_and_tail():
    """Reference -> port -> reference leaf for leaf: one period of three
    stacked layers and a tail of two unstacked RG-LRU layers."""
    ref, port = _params()
    assert len(ref["periods"]) == 3 and len(ref["tail"]) == 2
    assert ref["periods"][0]["lam"].shape == (1, 64)
    assert ref["tail"][1]["lam"].shape == (64,)
    assert ref["periods"][2]["wk"]["w"].shape == (1, 64, 1, 16)
    back = interop.params_from_reference(ref, CFG, device="cpu")
    assert [sorted(x) for x in back["layers"]] == \
        [sorted(x) for x in port["layers"]]
    a, b = dict(_leaves(ref)), dict(_leaves(interop.params_to_reference(
        back, CFG)))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_port_init_matches_reference_structure():
    ref, _ = _params()
    want = _ref_shapes(CFG_R)
    assert jax.tree.structure(ref) == jax.tree.structure(want)
    assert [a.shape for a in jax.tree.leaves(ref)] == \
        [a.shape for a in jax.tree.leaves(want)]
    assert sum(a.size for k, a in _leaves(ref) if "mux_engine" not in k) \
        == param_count(CFG)
    full = get_config(ARCH)
    assert param_count(full) == 9_396_408_320
    assert full.pattern_layers.count("local") == 12
    assert full.pattern_layers[-2:] == ("rglru", "rglru")


@functools.lru_cache(maxsize=None)
def _ref_forward():
    ref, _ = _params()
    toks = np.random.default_rng(0).integers(4, 512, (N * 2, 20)).astype(
        np.int32)
    fn = jax.jit(lambda p, t: RefLM.apply(p, CFG_R, t, mux=RefMux(n=N),
                                          dtype=jnp.float32)["logits"])
    return toks, np.asarray(fn(ref, toks))


@pytest.mark.parametrize("use_kernels", [False, True])
def test_forward_logits_match_reference(use_kernels):
    """The no-cache forward of 20 tokens (past the window of 16)."""
    toks, want = _ref_forward()
    _, port = _params()
    got = TransformerLM.apply(port, CFG, torch.as_tensor(toks),
                              mux=MuxSpec(n=N), dtype=torch.float32,
                              use_kernels=use_kernels)["logits"]
    np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)


def _sc(capacity=40, layout="ring"):
    sc_r = ref_engine.ServeConfig(cfg=CFG_R, kind="lm", mux=RefMux(n=N),
                                  capacity=capacity, dtype=jnp.float32,
                                  cache_layout=layout, block_size=4)
    sc = engine.ServeConfig(cfg=CFG, mux=MuxSpec(n=N), capacity=capacity,
                            dtype=torch.float32, cache_layout=layout,
                            block_size=4)
    return sc_r, sc


_REF_STEPS = {"prefill": jax.jit(ref_engine.prefill, static_argnames="sc"),
              "decode_step": jax.jit(ref_engine.decode_step,
                                     static_argnames=("sc", "use_kernels"))}


@contextlib.contextmanager
def _jitted_reference_loops():
    """The reference's serving loops with their steps jitted, in fp32:
    the same numbers, minus a scan compile per call."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (ref_engine, ref_cli):
            for name, fn in _REF_STEPS.items():
                mp.setattr(mod, name, fn)
        yield


@functools.lru_cache(maxsize=None)
def _ref_ring_steps():
    """The reference's prefill of 3 rows x 20 tokens and two decode steps
    (every ring wrapped: 20 > 16), its cache after the prefill and each
    step's logits."""
    ref, _ = _params()
    sc_r, _ = _sc()
    rng = np.random.default_rng(2)
    toks = rng.integers(4, 512, (N * 3, 20)).astype(np.int32)
    steps = [rng.integers(4, 512, (N * 3, 1)).astype(np.int32)
             for _ in range(2)]
    cache = ref_engine.init_cache(sc_r, N * 3)
    logits, cache = _REF_STEPS["prefill"](ref, sc_r, cache, toks)
    carried = jax.tree.map(np.asarray, cache)
    out = [np.asarray(logits)]
    for i, d in enumerate(steps):
        lg, cache = _REF_STEPS["decode_step"](ref, sc_r, cache, d, 20 + i)
        out.append(np.asarray(lg))
    return toks, steps, carried, out


@pytest.mark.parametrize("use_kernels", [False, True])
def test_ring_prefill_and_decode_match_reference(use_kernels):
    """The port's prefill from a zero cache, then its decode steps from
    the reference's post-prefill cache (every RG-LRU state and local ring
    carried across bit for bit): logits within 1e-4."""
    toks, steps, carried, want = _ref_ring_steps()
    _, port = _params()
    _, sc = _sc()
    cache = engine.init_cache(sc, N * 3, device="cpu")
    got, _ = engine.prefill(port, sc, cache, torch.as_tensor(toks),
                            use_kernels=use_kernels)
    np.testing.assert_allclose(got.numpy(), want[0], **LOGIT_TOL)
    cache = interop.ring_cache_from_reference(carried, CFG, device="cpu")
    kinds = [sorted(c) for c in cache["layers"]]
    assert kinds == [["conv", "h"]] * 2 + [["idx", "k", "pos", "v"]] + \
        [["conv", "h"]] * 2
    assert cache["layers"][2]["k"].shape[1] == CFG.local_window
    for i, d in enumerate(steps):
        got, _ = engine.decode_step(port, sc, cache, torch.as_tensor(d),
                                    20 + i, use_kernels=use_kernels)
        np.testing.assert_allclose(got.numpy(), want[i + 1], **LOGIT_TOL)


def test_calls_per_step():
    """A blocking prefill calls only the mux-combine of its plain entry
    (attn_impl 'auto' is naive here), a ring decode step decode_attention
    once per local layer plus the fused entry and exit."""
    _, port = _params()
    _, sc = _sc()
    cache = engine.init_cache(sc, N * 2, device="cpu")
    ops.reset_counts()
    engine.prefill(port, sc, cache, torch.zeros((N * 2, 8), dtype=torch.long),
                   use_kernels=True)
    assert ops.counts("calls") == {**dict.fromkeys(ops.counts(), 0),
                                   "mux_combine": 1}
    ops.reset_counts()
    engine.decode_step(port, sc, cache,
                       torch.zeros((N * 2, 1), dtype=torch.long), 8)
    assert ops.counts("calls") == {**dict.fromkeys(ops.counts(), 0),
                                   "decode_attention": 1,
                                   "mux_embed_combine": 1, "demux_rsa": 1}
    assert not any(ops.counts("launches").values())           # CPU: plain


# ------------------------------------------------------------ serving

def _trace():
    """(step, prompt, max_new): staggered arrivals, prompts past the
    window of 16."""
    rng = np.random.default_rng(0)
    return [(s, rng.integers(4, 512, size=(k,)).tolist(), m)
            for s, k, m in zip([0, 0, 1, 4], [20, 22, 20, 21], [4, 6, 3, 5])]


def _outputs(stats):
    return {r.uid: list(r.output) for r in stats["completed"]}


@functools.lru_cache(maxsize=None)
def _ref_ring():
    ref, _ = _params()
    with _jitted_reference_loops():
        return ref_run_continuous(ref, _sc()[0], 2, _trace())


@pytest.mark.parametrize("use_kernels", [False, True])
def test_ring_arm_token_identical(use_kernels):
    """Grid-wide re-prefills from a zero state, right-padded with the pad
    token, whose pads enter the RG-LRU state in both packages."""
    want = _ref_ring()
    _, port = _params()
    got = cli.run_continuous(port, _sc()[1], 2, _trace(),
                             use_kernels=use_kernels, device="cpu")
    assert {r.uid: len(r.output) for r in got["completed"]} == \
        {0: 4, 1: 6, 2: 3, 3: 5}
    assert _outputs(got) == _outputs(want)
    for k in ("prefill_events", "prefill_tokens", "prefill_log",
              "decode_steps", "max_grid_pos"):
        assert got[k] == want[k], k
    assert got["prefill_events"] == 3


@functools.lru_cache(maxsize=None)
def _ref_fill_drain():
    ref, _ = _params()
    rng = np.random.default_rng(3)
    prompts = [rng.integers(4, 512, 20).astype(np.int32) for _ in range(5)]
    with _jitted_reference_loops():
        return prompts, ref_fill_drain(ref, _sc()[0], 2, prompts, 4)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_fill_drain_token_identical(use_kernels):
    """3 + 2 requests of 20 tokens in a grid of 4 slots (one duplicate,
    its logits averaged)."""
    prompts, want = _ref_fill_drain()
    _, port = _params()
    got = cli.fill_drain(port, _sc()[1], 2, prompts, 4,
                         use_kernels=use_kernels, device="cpu")
    assert [r.output for r in got["completed"]] == want
    assert (got["prefill_events"], got["decode_steps"]) == (2, 6)


def test_reference_paged_rglru_fails():
    """The reference's paged runtime falls back to blocking prefill for
    recurrent blocks, whose one-row prefill joins the whole batch's conv
    state to the row's prompt."""
    ref, _ = _params()
    rt = RefRuntime(jax.tree.map(jnp.asarray, ref), _sc(layout="paged")[0],
                    2, chunk=8)
    assert rt.chunk is None                       # the fallback
    rt.submit(RefRequest(uid=0, prompt=list(range(4, 24)), max_new=2))
    with pytest.raises(TypeError, match="Cannot concatenate"):
        rt.step()


def test_paged_serving_refused():
    _, port = _params()
    _, sc = _sc(layout="paged")
    with pytest.raises(NotImplementedError, match="_causal_depthwise_conv"):
        ServeRuntime(port, sc, 2, device="cpu")
    with pytest.raises(NotImplementedError, match="Cannot concatenate"):
        cli.run_continuous(port, sc, 2, _trace()[:1], device="cpu")


def test_cli_refuses_paged(capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["--arch", ARCH, "--continuous", "--cache", "paged",
                  "--device", "cpu"])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "--cache paged with recurrentgemma-9b" in err
    assert "rglru" in err and "Cannot concatenate" in err


@pytest.mark.parametrize("argv,want", [
    (["--continuous"],
     ["continuous[ring/cpu] served 4 requests (24 tokens)",
      "prefill 178 backbone tokens (178 padded) in 4 events"]),
    ([], ["served 4 requests x 6 tokens in ",
          "(mux N=2, backbone batch 2; throughput "]),
], ids=["ring", "fill-drain"])
def test_cli_serves_on_cpu(capsys, argv, want):
    """The reference CLI's counts for the same flags (``python -m
    repro.launch.serve --arch recurrentgemma-9b --reduced --requests 4
    --prompt-len 20 --new-tokens 6 [--continuous]``)."""
    assert cli.main(["--arch", ARCH, "--device", "cpu", "--requests", "4",
                     "--prompt-len", "20", "--new-tokens", "6", *argv]) == 0
    out = capsys.readouterr().out
    for line in want:
        assert line in out


# ------------------------------------------------------------ training

LM_ARCHS = [a for a in ARCHS if model_kind(a) == "lm"]


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_decay_masks_match_reference_leaf_for_leaf(arch):
    """The port's masks read each leaf's reference path and rank
    (``reference_leaves`` with the config's pattern length): layer i at
    ``periods/<i % P>`` with a stacked axis, leftovers at ``tail/<k>``
    at their own rank.  recurrentgemma-9b's tail vectors (``lam``,
    ``conv_b``, the gate biases) are 1-D in the reference, so not
    decayed, while its periods' are."""
    cfg_r, cfg = ref_config(arch, reduced=True), get_config(arch,
                                                             reduced=True)
    port = (_params()[1] if arch == ARCH else TransformerLM.init(
        torch.Generator().manual_seed(0), cfg, MuxSpec(n=N)))
    want = {path_str([getattr(k, "key", getattr(k, "idx", None))
                      for k in p]): ref_decay_mask(p, leaf)
            for p, leaf in jax.tree_util.tree_flatten_with_path(
                _ref_shapes(cfg_r))[0]}
    opt = AdamW(lr=1.0, pattern=len(cfg.block_pattern))
    got = {path_str(p): opt.decay_mask(p, nd) for p, nd, _ in
           reference_leaves(port, pattern=opt.pattern)}
    assert got == want
    if arch == ARCH:
        assert got["periods/0/lam"] and not got["tail/0/lam"]
        assert got["periods/1/conv_b"] and not got["tail/1/conv_b"]


def _lm_loss_ref(p, toks):
    out = RefLM.apply(p, CFG_R, toks, mux=RefMux(n=N), dtype=jnp.float32)
    return ref_causal(out["logits"], toks)


@functools.lru_cache(maxsize=None)
def _ref_train_step():
    """One AdamW step of the reference (weight decay 1.0, so a wrong mask
    shows): its loss, gradients and updated params."""
    ref, _ = _params()
    toks = np.random.default_rng(9).integers(4, 512, (4, 24)).astype(
        np.int32)
    rp = jax.tree.map(jnp.asarray, ref)
    loss, grads = jax.jit(jax.value_and_grad(_lm_loss_ref))(rp, toks)
    opt = RefAdamW(lr=1e-3, weight_decay=1.0)
    upd, _, _ = jax.jit(opt.update)(grads, opt.init(rp), rp)
    new = opt.apply_updates(rp, upd)
    return toks, float(loss), *(jax.tree.map(np.asarray, t)
                               for t in (grads, new))


def test_causal_lm_step_matches_reference():
    """Loss within ``LOSS_RTOL``, every gradient within ``GRAD_TOL`` of
    the largest, and after one AdamW step every param within
    ``TRAJ_TOL`` (at least ``TRAJ_SHARE`` of the elements within 1e-6,
    as ``test_torch_train.py``'s trajectories: where a gradient is near
    zero, Adam's first step g / (|g| + eps) amplifies fp32 noise).  At
    weight decay 1.0 a wrong decay mask on the tail's ``lam`` would move
    its elements by up to 1e-3 |lam| past TRAJ_TOL."""
    toks, want_loss, want_g, want_p = _ref_train_step()
    ref, _ = _params()
    params = interop.params_from_reference(ref, CFG, device="cpu")
    t = torch.as_tensor(toks)

    def loss_fn(p):
        return causal_lm_loss(TransformerLM.apply(
            p, CFG, t, mux=MuxSpec(n=N), dtype=torch.float32,
            use_kernels=False)["logits"], t)
    loss, grads = _grads_of(loss_fn, params)
    np.testing.assert_allclose(float(loss), want_loss, rtol=LOSS_RTOL)
    got = dict(_leaves(interop.params_to_reference(grads, CFG)))
    want = dict(_leaves(want_g))
    assert got.keys() == want.keys()
    big = max(float(np.abs(w).max()) for w in want.values())
    for path, w in want.items():
        assert float(np.abs(got[path] - w).max()) <= GRAD_TOL * big, path
    opt = AdamW(lr=1e-3, weight_decay=1.0, pattern=len(CFG.block_pattern))
    opt.update(grads, opt.init(params), params)
    got = dict(_leaves(interop.params_to_reference(params, CFG)))
    near = total = 0
    for path, w in _leaves(want_p):
        np.testing.assert_allclose(got[path], w, **TRAJ_TOL, err_msg=path)
        near += int((np.abs(got[path] - w) <= 1e-6).sum())
        total += w.size
    assert near >= TRAJ_SHARE * total, (near, total)
