"""The port's vision-language family (llava-next-mistral-7b, reduced: two
layers, d 64, 4 heads over 2 KV heads, 8 patches of width 1024) against
the JAX reference, on the CPU.

Both packages start from the port's seeded init carried to the
reference's layout (``interop``), at N=1 and N=2 (Gaussian mux, RSA
demux); tokens and patch embeddings come from numpy seeds.  The
reference's steps run jitted, each compiled once and its result shared
across cases (``_jitted_reference_loops``):

  * the configs field for field, the param tree, and the interop round
    trip bit for bit (backbone, ``proj1``, ``proj2``);
  * ``VLM.embed_multimodal`` (the projector, tanh GELU, patches in front
    of the tokens) within 1e-6 in fp32 and one bf16 ulp in bf16;
  * ``VLM.apply`` logits (N*B, P + L, V) within 1e-4 in fp32 and
    ``MODEL_ULPS`` bf16 ulps of their largest value in bf16, on the plain
    and the kernel path (the wrappers' plain versions here); a prefill
    and two decode steps;
  * fill-drain and ``greedy_generate`` greedy token-identical to the
    reference's, with zero patch embeddings (the reference CLI's) and
    with random ones, at the reference's decode positions;
  * the reference's decode positions leave out the patches
    (``test_reference_vlm_decode_positions_overlap_the_prompt``,
    ROADMAP.md §3), where the port's engine at the true positions
    matches the no-cache forward;
  * the refusals the reference has (paged layout, continuous serving);
    the CLIs; the reference's forward-and-train-step smoke test against
    the port's autograd; ``launch.train --arch`` on the text backbone.
"""
import argparse
import contextlib
import functools
import io
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as ref_config
from repro.core import MuxSpec as RefMux
from repro.launch import serve as ref_serve_cli
from repro.launch import train as ref_train_cli
from repro.models import VLM as RefVLM
from repro.models.config import param_count as ref_param_count
from repro.models.vlm import D_VISION as REF_D_VISION
from repro.serve import engine as ref_engine
from repro.serve.batcher import MuxBatcher as RefBatcher
from repro.serve.runtime import ServeRuntime as RefRuntime
from repro.train import causal_lm_loss as ref_causal
from repro_torch import interop
from repro_torch.configs import get_config, model_kind
from repro_torch.core import MuxSpec
from repro_torch.kernels import ops
from repro_torch.launch import serve as cli
from repro_torch.launch import train as train_cli
from repro_torch.models import VLM, param_count
from repro_torch.models.vlm import D_VISION
from repro_torch.serve import engine
from repro_torch.serve.runtime import ServeRuntime
from repro_torch.serve.telemetry import Telemetry
from repro_torch.train import causal_lm_loss
from test_torch_bf16_rest import MODEL_ULPS
from test_torch_dense_configs import _same_config
from test_torch_model import _leaves
from test_torch_train import GRAD_TOL, LOSS_RTOL, _grads_of

torch.set_num_threads(2)

ARCH = "llava-next-mistral-7b"
CFG_R, CFG = ref_config(ARCH, reduced=True), get_config(ARCH, reduced=True)
P = CFG.frontend_len
L = 6                     # prompt tokens
B = 2                     # backbone rows
BF = torch.bfloat16
BF16_ULP = 2.0 ** -7
EMBED_TOL = dict(atol=1e-6, rtol=0)
LOGIT_TOL = dict(atol=1e-4, rtol=0)


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(jnp.asarray(t).astype(jnp.float32))


def _ulps_close(got, want, ulps=MODEL_ULPS):
    """``got`` within ``ulps`` bf16 ulps of |want|'s largest value."""
    w = _np(want)
    np.testing.assert_allclose(_np(got), w, rtol=0,
                               atol=ulps * BF16_ULP * np.abs(w).max())


@functools.lru_cache(maxsize=None)
def _params(n):
    """(reference params as JAX arrays, port params): the port's seeded
    init carried to the reference's layout.  JAX arrays, as the
    reference's plain RSA demux computes its key bias in fp32 from numpy
    bf16 weights (ROADMAP.md §3)."""
    port = VLM.init(torch.Generator().manual_seed(7), CFG, MuxSpec(n=n))
    ref = jax.tree.map(jnp.asarray, interop.params_to_reference(port, CFG))
    return ref, port


def _inputs(n, length=L, seed=0, zeros=False):
    """(tokens (n*B, length), patch embeddings (n*B, P, 1024)), numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(4, CFG.vocab_size, (n * B, length)).astype(np.int32)
    pe = rng.standard_normal((n * B, P, D_VISION)).astype(np.float32)
    return toks, (np.zeros_like(pe) if zeros else pe)


def _sc(n, capacity, layout="ring", cfg=CFG):
    """(reference, port) fp32 ``ServeConfig``s of kind 'vlm'."""
    sc_r = ref_engine.ServeConfig(
        cfg=CFG_R.replace(attn_impl=cfg.attn_impl), kind="vlm",
        mux=RefMux(n=n), capacity=capacity, dtype=jnp.float32,
        cache_layout=layout)
    sc = engine.ServeConfig(cfg=cfg, mux=MuxSpec(n=n), capacity=capacity,
                            dtype=torch.float32, cache_layout=layout,
                            kind="vlm")
    return sc_r, sc


_REF_STEPS = {"prefill": jax.jit(ref_engine.prefill, static_argnames="sc"),
              "decode_step": jax.jit(ref_engine.decode_step,
                                     static_argnames=("sc", "use_kernels"))}


@contextlib.contextmanager
def _jitted_reference_loops():
    """The reference's serving loops with their steps jitted: the same
    numbers, one compile per step signature."""
    with pytest.MonkeyPatch.context() as mp:
        for name, fn in _REF_STEPS.items():
            mp.setattr(ref_engine, name, fn)
        yield


# ------------------------------------------------------------ the model

@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_configs_match_reference(reduced):
    """Field for field, with the reference's param count, kind and
    patch width; the full config is the published one."""
    mine, want = get_config(ARCH, reduced=reduced), ref_config(
        ARCH, reduced=reduced)
    _same_config(mine, want)
    assert param_count(mine) == ref_param_count(want)
    assert model_kind(ARCH) == "vlm" and D_VISION == REF_D_VISION == 1024
    if not reduced:
        assert (mine.n_layers, mine.d_model, mine.n_heads, mine.n_kv_heads,
                mine.head_dim, mine.d_ff, mine.vocab_size,
                mine.frontend_len) == (32, 4096, 32, 8, 128, 14336, 32000,
                                       576)
        assert (mine.rope_theta, mine.tie_embeddings) == (1e6, False)
        assert param_count(mine) == 7_241_732_096


@pytest.mark.parametrize("n", [1, 2])
def test_interop_round_trip_bit_for_bit(n):
    """The port's tree -> the reference's -> the port's, leaf for leaf,
    with the reference's structure and shapes (``VLM.init``'s tree)."""
    ref, port = _params(n)
    want = jax.eval_shape(lambda k: RefVLM.init(k, CFG_R, RefMux(n=n)),
                          jax.random.PRNGKey(0))
    assert jax.tree.structure(ref) == jax.tree.structure(want)
    assert [a.shape for a in jax.tree.leaves(ref)] == \
        [a.shape for a in jax.tree.leaves(want)]
    assert ref["proj1"]["w"].shape == (1024, 64)
    back = interop.params_from_reference(jax.tree.map(np.asarray, ref), CFG,
                                         device="cpu")
    a, b = dict(_leaves(port)), dict(_leaves(back))
    assert a.keys() == b.keys() and any("proj2" in k for k in a)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    again = dict(_leaves(interop.params_to_reference(back, CFG)))
    for k, x in _leaves(ref):
        np.testing.assert_array_equal(again[k], np.asarray(x), err_msg=k)


@functools.lru_cache(maxsize=None)
def _ref_embed(dtype):
    ref, _ = _params(2)
    toks, pe = _inputs(2)
    jdt = jnp.float32 if dtype == "fp32" else jnp.bfloat16
    with jax.disable_jit():       # the reference's ops, each rounded
        return _np(RefVLM.embed_multimodal(ref, CFG_R, jnp.asarray(toks),
                                           jnp.asarray(pe), jdt))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_embed_multimodal_matches_reference(dtype):
    """The projected patches, then the token embeddings: (N*B, P + L, d)
    in the compute dtype; fp32 within 1e-6, bf16 within one bf16 ulp of
    each element."""
    _, port = _params(2)
    toks, pe = _inputs(2)
    dt = torch.float32 if dtype == "fp32" else BF
    got = VLM.embed_multimodal(port, CFG, torch.as_tensor(toks),
                               torch.as_tensor(pe), dt)
    want = _ref_embed(dtype)
    assert got.dtype == dt and got.shape == (2 * B, P + L, CFG.d_model)
    if dtype == "fp32":
        np.testing.assert_allclose(got.numpy(), want, **EMBED_TOL)
    else:
        np.testing.assert_array_less(np.abs(_np(got) - want),
                                     BF16_ULP * np.abs(want) + 1e-30)
    # the token half is the embedding table's rows
    assert torch.equal(got[:, P:], port["backbone"]["embed"]["table"][
        torch.as_tensor(toks).long()].to(dt))


@functools.lru_cache(maxsize=None)
def _ref_forward(n, dtype):
    ref, _ = _params(n)
    toks, pe = _inputs(n)
    jdt = jnp.float32 if dtype == "fp32" else jnp.bfloat16
    fn = jax.jit(lambda p, t, x: RefVLM.apply(p, CFG_R, t, x, mux=RefMux(n=n),
                                              dtype=jdt)["logits"])
    return _np(fn(ref, toks, pe))


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("n", [1, 2])
def test_forward_logits_match_reference(n, dtype, use_kernels):
    """The full forward over P patches and L tokens: (N*B, P + L, V),
    fp32 within 1e-4, bf16 within ``MODEL_ULPS`` bf16 ulps of the largest
    logit (``test_torch_bf16_rest.py``'s bar)."""
    _, port = _params(n)
    toks, pe = _inputs(n)
    dt = torch.float32 if dtype == "fp32" else BF
    got = VLM.apply(port, CFG, torch.as_tensor(toks), torch.as_tensor(pe),
                    mux=MuxSpec(n=n), dtype=dt,
                    use_kernels=use_kernels)["logits"]
    assert got.shape == (n * B, P + L, CFG.vocab_size) and got.dtype == dt
    want = _ref_forward(n, dtype)
    if dtype == "fp32":
        np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)
    else:
        _ulps_close(got, want)


@functools.lru_cache(maxsize=None)
def _ref_steps(n):
    """The reference's prefill of P patches + L tokens and two decode
    steps at the true positions P + L, P + L + 1: each one's logits."""
    ref, _ = _params(n)
    sc_r, _ = _sc(n, P + L + 8)
    toks, pe = _inputs(n)
    steps = [np.random.default_rng(5 + i).integers(
        4, 512, (n * B, 1)).astype(np.int32) for i in range(2)]
    cache = ref_engine.init_cache(sc_r, n * B)
    logits, cache = _REF_STEPS["prefill"](ref, sc_r, cache, toks, extra=pe)
    out = [_np(logits)]
    for i, d in enumerate(steps):
        lg, cache = _REF_STEPS["decode_step"](ref, sc_r, cache, d, P + L + i)
        out.append(_np(lg))
    return steps, out


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("n", [1, 2])
def test_prefill_and_decode_match_reference(n, use_kernels):
    """``engine.prefill`` with the patch embeddings (``extra``), then two
    decode steps from the port's own ring: logits within 1e-4."""
    _, port = _params(n)
    _, sc = _sc(n, P + L + 8)
    toks, pe = _inputs(n)
    steps, want = _ref_steps(n)
    cache = engine.init_cache(sc, n * B, device="cpu")
    got, _ = engine.prefill(port, sc, cache, torch.as_tensor(toks),
                            extra=torch.as_tensor(pe),
                            use_kernels=use_kernels)
    np.testing.assert_allclose(got.numpy(), want[0], **LOGIT_TOL)
    assert sorted(cache["layers"][0]["pos"][:P + L].tolist()) == \
        list(range(P + L))
    for i, d in enumerate(steps):
        got, _ = engine.decode_step(port, sc, cache, torch.as_tensor(d),
                                    P + L + i, use_kernels=use_kernels)
        np.testing.assert_allclose(got.numpy(), want[i + 1], **LOGIT_TOL)


@pytest.mark.parametrize("impl", ["naive", "flash"])
def test_calls_per_step(impl):
    """A prefill under use_kernels runs the mux-combine kernel of its
    plain entry once over the P + L row and, under 'flash', the flash
    kernel once a layer, no demux kernel; a decode step runs
    decode_attention once a layer and the fused entry and exit once."""
    _, port = _params(2)
    cfg = CFG.replace(attn_impl=impl)
    _, sc = _sc(2, P + L + 8, cfg=cfg)
    toks, pe = _inputs(2)
    cache = engine.init_cache(sc, 2 * B, device="cpu")
    ops.reset_counts()
    engine.prefill(port, sc, cache, torch.as_tensor(toks),
                   extra=torch.as_tensor(pe), use_kernels=True)
    flash = CFG.n_layers if impl == "flash" else 0
    assert ops.counts("calls") == {**dict.fromkeys(ops.counts(), 0),
                                   "mux_combine": 1, "flash_attention": flash}
    ops.reset_counts()
    engine.decode_step(port, sc, cache, torch.as_tensor(toks[:, :1]), P + L)
    assert ops.counts("calls") == {**dict.fromkeys(ops.counts(), 0),
                                   "decode_attention": CFG.n_layers,
                                   "mux_embed_combine": 1, "demux_rsa": 1}
    assert not any(ops.counts("launches").values())           # CPU: plain


# ------------------------------------------------------------ serving

def _ref_fill_drain(ref, sc_r, prompts, patches, new_tokens, rows=B):
    """The reference CLI's fill-drain loop (``repro/launch/serve.py``
    ``_fill_drain``), greedy, with each request's patches stacked in slot
    order where that CLI stacks zeros: each request's tokens, in batch
    order."""
    batcher = RefBatcher(n_mux=sc_r.mux.n, backbone_batch=rows)
    patch_of = {}
    for p, x in zip(prompts, patches):
        patch_of[batcher.submit(p, max_new=new_tokens).uid] = x
    out = []
    while True:
        slots, owners = batcher.next_batch()
        if slots is None:
            return out
        uniq = list({id(s): s for s in slots}.values())
        toks = jnp.stack([jnp.asarray(s.prompt) for s in slots])
        extra = jnp.asarray(np.stack([patch_of[s.uid] for s in slots]))
        cache = ref_engine.init_cache(sc_r, toks.shape[0])
        logits, cache = ref_engine.prefill(ref, sc_r, cache, toks,
                                           extra=extra)
        tok = jnp.argmax(RefBatcher.combine_logits(logits, owners,
                                                   len(uniq)), -1)
        outs = [tok]
        for t in range(new_tokens - 1):
            lg, cache = ref_engine.decode_step(
                ref, sc_r, cache, tok[jnp.asarray(owners)][:, None],
                toks.shape[1] + t)
            tok = jnp.argmax(RefBatcher.combine_logits(lg[:, 0], owners,
                                                       len(uniq)), -1)
            outs.append(tok)
        out += [[int(o[j]) for o in outs] for j in range(len(uniq))]


FD_SEED, FD_REQUESTS, FD_NEW = 3, 5, 4


def _fill_drain_case(patches):
    """The reference CLI's prompts for ``--seed 3 --requests 5
    --prompt-len 6``, and zero (the CLI's) or random patch embeddings."""
    rng = np.random.default_rng(FD_SEED)
    prompts = [rng.integers(4, CFG.vocab_size, size=(L,)).astype(np.int32)
               for _ in range(FD_REQUESTS)]
    pe = np.zeros((FD_REQUESTS, P, D_VISION), np.float32)
    if patches == "random":
        pe = np.random.default_rng(4).standard_normal(pe.shape).astype(
            np.float32)
    return prompts, pe


def _ref_cli_fill_drain(ref, sc_r):
    """The reference CLI's own ``_fill_drain`` (its prompts, its zero
    patches), its steps jitted: each request's tokens, in batch order."""
    seen = []

    class Recording(RefBatcher):
        def submit(self, *a, **kw):
            seen.append(super().submit(*a, **kw))
            return seen[-1]
    args = argparse.Namespace(backbone_batch=B, seed=FD_SEED,
                              requests=FD_REQUESTS, prompt_len=L,
                              new_tokens=FD_NEW)
    with pytest.MonkeyPatch.context() as mp, \
            contextlib.redirect_stdout(io.StringIO()):
        mp.setattr(ref_serve_cli, "MuxBatcher", Recording)
        for name, fn in _REF_STEPS.items():
            mp.setattr(ref_serve_cli, name, fn)
        ref_serve_cli._fill_drain(ref, sc_r, CFG_R, "vlm", args, None)
    assert all(r.done for r in seen)
    return [r.output for r in seen]


@functools.lru_cache(maxsize=None)
def _ref_fill_drain_tokens(patches):
    ref, _ = _params(2)
    sc_r = _sc(2, L + FD_NEW + 8)[0]          # the reference CLI's capacity
    if patches == "zeros":
        return _ref_cli_fill_drain(ref, sc_r)
    prompts, pe = _fill_drain_case(patches)
    with _jitted_reference_loops():
        return _ref_fill_drain(ref, sc_r, prompts, pe, FD_NEW)


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("patches", ["zeros", "random"])
def test_fill_drain_token_identical(patches, use_kernels):
    """5 requests in a grid of 4 slots (the second batch one request with
    three duplicates, its logits averaged), at the reference CLI's
    capacity (prompt + new + 8) and decode positions.  Zero patches
    (``frames=None``) are held against the reference CLI's own
    ``_fill_drain`` on its prompts; random ones, which make the projector
    carry data and which that CLI cannot take, against its loop fed
    them."""
    _, port = _params(2)
    prompts, pe = _fill_drain_case(patches)
    ops.reset_counts()
    tele = Telemetry()
    got = cli.fill_drain(port, _sc(2, L + FD_NEW + 8)[1], B, prompts,
                         FD_NEW,
                         frames=None if patches == "zeros" else list(pe),
                         use_kernels=use_kernels, telemetry=tele,
                         device="cpu")
    assert [r.output for r in got["completed"]] == \
        _ref_fill_drain_tokens(patches)
    assert (got["prefill_events"], got["decode_steps"]) == (2, 6)
    assert ops.mux_combine.calls == 2 * use_kernels
    # each prefill span counts the P + L positions of its 4 slots
    assert [ev[6]["tokens"] for ev in tele.tracer.events
            if ev[:2] == ("X", "prefill")] == [2 * B * (P + L)] * 2


@functools.lru_cache(maxsize=None)
def _ref_greedy(patches):
    ref, _ = _params(2)
    toks, pe = _inputs(2, seed=2, zeros=patches == "zeros")
    with _jitted_reference_loops():
        return np.asarray(ref_engine.greedy_generate(
            ref, _sc(2, L + 5 + 8)[0], jnp.asarray(toks), steps=5,
            extra=jnp.asarray(pe)))


@pytest.mark.parametrize("patches", ["zeros", "random"])
def test_greedy_generate_token_identical(patches):
    _, port = _params(2)
    toks, pe = _inputs(2, seed=2, zeros=patches == "zeros")
    got = engine.greedy_generate(port, _sc(2, L + 5 + 8)[1],
                                 torch.as_tensor(toks), steps=5,
                                 extra=torch.as_tensor(pe))
    assert got.tolist() == _ref_greedy(patches).tolist()


def test_reference_vlm_decode_positions_overlap_the_prompt():
    """The reference's ``greedy_generate`` decodes at L + t after a prefill
    of P + L positions, in a ring of the CLI's size (L + steps + 8): the
    first step overwrites a prompt position's slot and the causal mask by
    slot position hides the rest, so its decode logits are far from its
    own no-cache forward over [patches, prompt, tokens so far].  The
    port's engine at the true positions P + L + t and a capacity of P + L
    + steps matches that forward within 1e-4."""
    ref, port = _params(2)
    toks, pe = _inputs(2, seed=4)
    steps = 4
    sc_r, _ = _sc(2, L + steps + 8)
    seen = []

    def recording(*args, **kw):
        lg, cache = _REF_STEPS["decode_step"](*args, **kw)
        seen.append(_np(lg[:, 0]))
        return lg, cache
    with _jitted_reference_loops(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_engine, "decode_step", recording)
        out = np.array(ref_engine.greedy_generate(
            ref, sc_r, jnp.asarray(toks), steps=steps, extra=jnp.asarray(pe)))
    assert len(seen) == steps - 1
    seq = np.concatenate([toks, out[:, :-1]], axis=1)
    full = _np(jax.jit(lambda p, t, x: RefVLM.apply(
        p, CFG_R, t, x, mux=RefMux(n=2), dtype=jnp.float32)["logits"])(
            ref, seq, pe))
    want = full[:, P + L:]                  # decode step t's position
    ref_err = max(float(np.abs(s - want[:, t]).max())
                  for t, s in enumerate(seen))
    assert ref_err > 100 * LOGIT_TOL["atol"], ref_err
    # the port at the true positions, fed the reference's tokens
    _, sc = _sc(2, P + L + steps)
    cache = engine.init_cache(sc, 2 * B, device="cpu")
    got, _ = engine.prefill(port, sc, cache, torch.as_tensor(toks),
                            extra=torch.as_tensor(pe), use_kernels=True)
    np.testing.assert_allclose(got.numpy(), full[:, P + L - 1], **LOGIT_TOL)
    for t in range(steps - 1):
        got, _ = engine.decode_step(port, sc, cache,
                                    torch.as_tensor(out[:, t:t + 1]),
                                    P + L + t)
        np.testing.assert_allclose(got[:, 0].numpy(), want[:, t],
                                   **LOGIT_TOL)


def test_paged_layout_and_continuous_serving_refused():
    """As in the reference: no paged cache, no continuous serving, no
    chunked prefill of a VLM; a prefill needs the patch embeddings."""
    ref, port = _params(2)
    sc_pr, sc_p = _sc(2, 24, layout="paged")
    with pytest.raises(NotImplementedError):
        ref_engine.init_cache(sc_pr, 4)
    with pytest.raises(NotImplementedError):
        RefRuntime(ref, sc_pr, 2)
    with pytest.raises(NotImplementedError, match="decoder-only"):
        engine.init_cache(sc_p, 4, device="cpu")
    with pytest.raises(NotImplementedError, match="decoder-only"):
        ServeRuntime(port, sc_p, 2, device="cpu")
    with pytest.raises(NotImplementedError, match="decoder-only"):
        cli.run_continuous(port, _sc(2, 24)[1], 2, [(0, [5, 6], 2)],
                           device="cpu")
    with pytest.raises(NotImplementedError, match="decoder-only"):
        engine.prefill_chunk(port, sc_p, {"bt": torch.zeros(2, 2)},
                             torch.zeros((4, 4), dtype=torch.long),
                             rows=[0, 1], start=0, length=4)
    _, sc = _sc(2, 24)
    with pytest.raises(ValueError, match="patch embeddings"):
        engine.prefill(port, sc, engine.init_cache(sc, 4, device="cpu"),
                       torch.zeros((4, 3), dtype=torch.long))


def test_cli_serves_llava_in_fill_drain(capsys):
    """``python -m repro_torch.launch.serve --arch llava-next-mistral-7b
    --reduced``: the reference CLI's ``served`` line; ``--continuous`` an
    argparse error naming the reference's refusal."""
    assert cli.main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
                     "--prompt-len", "6", "--new-tokens", "3"]) == 0
    assert re.search(r"^served 3 requests x 3 tokens in \d+\.\ds  \(mux N=2, "
                     r"backbone batch 2; throughput \d+\.\d tok/s\)$",
                     capsys.readouterr().out, re.M)
    with pytest.raises(SystemExit) as e:
        cli.main(["--arch", ARCH, "--continuous", "--device", "cpu"])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "decoder-only LM families" in err
    assert "repro/serve/runtime.py:128" in err


# ------------------------------------------------------------ training

def _vlm_loss_ref(p, toks, pe):
    """``tests/test_models.py``'s loss for the VLM: the causal-LM loss on
    the text positions of the fp32 forward."""
    out = RefVLM.apply(p, CFG_R, toks, pe, mux=RefMux(n=2),
                       dtype=jnp.float32)
    return ref_causal(out["logits"][:, -toks.shape[1]:], toks)


@functools.lru_cache(maxsize=None)
def _ref_train():
    ref, _ = _params(2)
    toks, pe = _inputs(2, length=16, seed=9)
    loss, grads = jax.jit(jax.value_and_grad(_vlm_loss_ref))(ref, toks, pe)
    return toks, pe, float(loss), jax.tree.map(np.asarray, grads)


def test_arch_smoke_forward_and_train_step_matches_reference():
    """The reference's ``test_arch_smoke_forward_and_train_step`` for the
    VLM (B 4, L 16, N=2): the loss within ``LOSS_RTOL`` and every
    gradient, the projector's included, within ``GRAD_TOL`` of the
    largest, against the port's autograd on the plain model path."""
    toks, pe, want_loss, want_g = _ref_train()
    _, port = _params(2)
    t, x = torch.as_tensor(toks), torch.as_tensor(pe)

    def loss_fn(p):
        lg = VLM.apply(p, CFG, t, x, mux=MuxSpec(n=2), dtype=torch.float32,
                       use_kernels=False)["logits"]
        return causal_lm_loss(lg[:, -t.shape[1]:], t)
    loss, grads = _grads_of(loss_fn, port)
    np.testing.assert_allclose(float(loss), want_loss, rtol=LOSS_RTOL)
    got = dict(_leaves(interop.params_to_reference(grads, CFG)))
    want = dict(_leaves(want_g))
    assert got.keys() == want.keys()
    assert float(np.abs(want["/proj1/w"]).max()) > 0
    big = max(float(np.abs(w).max()) for w in want.values())
    for path, w in want.items():
        assert float(np.abs(got[path] - w).max()) <= GRAD_TOL * big, path


def test_train_cli_trains_the_text_backbone(capsys, tmp_path):
    """``launch.train --arch llava-next-mistral-7b --reduced --steps 2``:
    the reference's model line (its param count: the text backbone) and
    stage lines, on a ``TransformerLM`` as the reference's."""
    argv = ["--arch", ARCH, "--reduced", "--steps", "2", "--batch", "4",
            "--seq", "16"]
    got = {}
    assert train_cli.main(argv + ["--device", "cpu", "--ckpt",
                                  str(tmp_path / "port")], out=got) == 0
    mine = capsys.readouterr().out.splitlines()
    assert ref_train_cli.main(argv + ["--ckpt", str(tmp_path / "ref")]) == 0
    want = capsys.readouterr().out.splitlines()
    assert mine[0] == want[0] + " (cpu)"
    assert want[0].startswith(f"model: {ARCH}  params=0.3M  mux N=2")
    assert mine[1] == want[1] == "--- stage: lm (2 steps) ---"
    for line in (mine[2], want[2]):
        assert re.fullmatch(r"    steps=2  loss \d+\.\d{4} -> \d+\.\d{4}  "
                            r"\(\d+s, \d+ ms/step, stragglers=\d+\)", line)
    assert mine[3:] == want[3:] == ["done."]
    assert "proj1" not in got["params"] and got["cfg"].family == "vlm"

