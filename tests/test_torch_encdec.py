"""The port's encoder-decoder path (whisper-small, reduced) against the JAX
reference, on the CPU.

Weights come from the reference's init through ``repro_torch.interop``;
tokens and frame embeddings from numpy seeds.  Held to the reference:
the muxed encoder output (``EncDecLM.encode``), full-forward logits, a
prefill of 11 tokens then one decode step (as ``tests/test_models.py``
test_arch_decode_matches_full does for whisper), each with
``attn_impl`` naive and chunked, and with the port's kernel path (the
wrappers' plain versions on CPU tensors); ``fill_drain`` greedy
token-identical to the reference engine's ``prefill`` / ``decode_step``
loop with zero frames (the reference CLI's) and with random ones, and
``greedy_generate`` token-identical to the reference's.
Tolerance: 2e-4 absolute and relative on hidden states and logits — both
sides compute in fp32 and differ in summation order only (the chunked
path's online softmax, the port's cross-attention following
``attn_impl`` where the reference's takes the naive core under 2048
queries); |logits| stay below ~1.  Also: the mux-combine entry under
``use_kernels`` equals the einsum bit for bit, the wrappers each step
calls, the parameter count, the CLI, and the refusals the reference has
(paged layout, continuous serving).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as ref_config
from repro.core import MuxSpec as RefMux
from repro.models import EncDecLM as RefEncDec
from repro.models.config import param_count as ref_param_count
from repro.serve import engine as ref_engine
from repro.serve.batcher import MuxBatcher as RefBatcher
from repro_torch import interop
from repro_torch.configs import get_config, model_kind
from repro_torch.core import GaussianMux, MuxEngine, MuxSpec
from repro_torch.kernels import ops
from repro_torch.launch import serve as cli
from repro_torch.models import EncDecLM, param_count
from repro_torch.models.blocks import init_block_cache
from repro_torch.serve import engine
from repro_torch.serve.runtime import ServeRuntime

torch.set_num_threads(2)

ARCH = "whisper-small"
TOL = dict(atol=2e-4, rtol=2e-4)


def _pair(n=2, impl="auto", capacity=20):
    cfg_r = ref_config(ARCH, reduced=True)
    cfg_r = cfg_r.replace(attn_impl=impl,
                          encoder=cfg_r.encoder.replace(attn_impl=impl))
    ref = RefEncDec.init(jax.random.PRNGKey(7), cfg_r, RefMux(n=n))
    cfg = get_config(ARCH, reduced=True)
    cfg = cfg.replace(attn_impl=impl,
                      encoder=cfg.encoder.replace(attn_impl=impl))
    port = interop.params_from_reference(jax.tree.map(np.asarray, ref), cfg,
                                          device="cpu")
    sc_r = ref_engine.ServeConfig(cfg=cfg_r, kind="encdec", mux=RefMux(n=n),
                                  capacity=capacity, dtype=jnp.float32)
    sc = engine.ServeConfig(cfg=cfg, mux=MuxSpec(n=n), capacity=capacity,
                            dtype=torch.float32, kind="encdec")
    return ref, port, sc_r, sc


def _inputs(cfg, batch=4, length=12, seed=0):
    rng = np.random.default_rng(seed)
    enc = cfg.encoder
    return (rng.integers(4, cfg.vocab_size, (batch, length)).astype(np.int32),
            rng.standard_normal((batch, enc.frontend_len, enc.d_model),
                                np.float32))


def test_interop_round_trip_and_param_count():
    """The encdec tree crosses both ways unchanged, and the port's
    ``param_count`` (learned positions, the cross-attention block, the
    encoder) is the reference's and counts every backbone parameter."""
    ref, port, _, sc = _pair()
    back = interop.params_to_reference(port, sc.cfg)
    want = jax.tree.map(np.asarray, ref)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
    for arch in ("whisper-small", "qwen2-1.5b", "rwkv6-7b"):
        for reduced in (True, False):
            assert param_count(get_config(arch, reduced=reduced)) == \
                ref_param_count(ref_config(arch, reduced=reduced)), arch
    plain = EncDecLM.init(torch.Generator().manual_seed(0),
                          get_config(ARCH, reduced=True))
    n = sum(t.numel() for t in jax.tree.leaves(plain))
    assert n == param_count(get_config(ARCH, reduced=True))
    assert model_kind(ARCH) == "encdec"


def test_mux_combine_entry_bit_identical_on_cpu():
    """Under use_kernels the Gaussian entry goes through the mux-combine
    wrapper; on CPU tensors it equals the einsum bit for bit, counts its
    calls and launches nothing."""
    rng = np.random.default_rng(0)
    p = {"mux": {"v": torch.as_tensor(rng.standard_normal((3, 40),
                                                          np.float32))}}
    x = torch.as_tensor(rng.standard_normal((3 * 2, 17, 40), np.float32))
    ops.reset_counts()
    want = MuxEngine.combine(p, MuxSpec(n=3), x)
    assert ops.mux_combine.calls == 0
    got = MuxEngine.combine(p, MuxSpec(n=3), x, use_kernels=True)
    assert torch.equal(got, want) and got.shape == (2, 17, 40)
    xg = x.reshape(3, 2, 17, 40)
    assert torch.equal(GaussianMux.apply(p["mux"], xg, use_kernel=True),
                       GaussianMux.apply(p["mux"], xg))
    assert ops.mux_combine.calls == 2 and ops.mux_combine.launches == 0


@pytest.mark.parametrize("impl", ["naive", "chunked"])
def test_encode_matches_reference(impl):
    ref, port, sc_r, sc = _pair(impl=impl)
    _, frames = _inputs(sc.cfg)
    want = RefEncDec.encode(ref, sc_r.cfg, jnp.asarray(frames), mux=RefMux(n=2),
                            dtype=jnp.float32)
    for use_kernels in (False, True):
        got = EncDecLM.encode(port, sc.cfg, torch.as_tensor(frames),
                              mux=MuxSpec(n=2), dtype=torch.float32,
                              use_kernels=use_kernels)
        assert got.shape == (2, sc.cfg.encoder.frontend_len, 64)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("impl", ["naive", "chunked"])
@pytest.mark.parametrize("use_kernels", [False, True])
def test_full_forward_logits_match_reference(impl, use_kernels):
    """The no-cache forward (encoder, then the decoder over all 12
    tokens); on the kernel path with the fused entry and exit."""
    ref, port, sc_r, sc = _pair(impl=impl)
    toks, frames = _inputs(sc.cfg)
    want = RefEncDec.apply(ref, sc_r.cfg, jnp.asarray(toks),
                           jnp.asarray(frames), mux=RefMux(n=2),
                           dtype=jnp.float32)["logits"]
    got = EncDecLM.apply(port, sc.cfg, torch.as_tensor(toks),
                         torch.as_tensor(frames), mux=MuxSpec(n=2),
                         dtype=torch.float32,
                         use_kernels=use_kernels)["logits"]
    assert got.shape == (4, 12, sc.cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("impl", ["naive", "chunked"])
@pytest.mark.parametrize("use_kernels", [False, True])
def test_prefill_then_decode_matches_reference(impl, use_kernels):
    """Prefill 11 tokens (the encoder runs, the cross-K/V are cached),
    decode the 12th from the cache: both against the reference's, and
    the decode step against the reference's full forward."""
    ref, port, sc_r, sc = _pair(impl=impl)
    toks, frames = _inputs(sc.cfg)
    cache_r = ref_engine.init_cache(sc_r, 4)
    pre_r, cache_r = ref_engine.prefill(ref, sc_r, cache_r,
                                        jnp.asarray(toks[:, :11]),
                                        extra=jnp.asarray(frames))
    dec_r, _ = ref_engine.decode_step(ref, sc_r, cache_r,
                                      jnp.asarray(toks[:, 11:]), 11)
    full_r = RefEncDec.apply(ref, sc_r.cfg, jnp.asarray(toks),
                             jnp.asarray(frames), mux=RefMux(n=2),
                             dtype=jnp.float32)["logits"]
    cache = engine.init_cache(sc, 4, device="cpu")
    pre, _ = engine.prefill(port, sc, cache, torch.as_tensor(toks[:, :11]),
                            extra=torch.as_tensor(frames),
                            use_kernels=use_kernels)
    assert all(c["xk"].shape == (2, sc.cfg.encoder.frontend_len, 4,
                                 sc.cfg.head_dim)
               for c in cache["layers"])
    dec, _ = engine.decode_step(port, sc, cache, torch.as_tensor(toks[:, 11:]),
                                11, use_kernels=use_kernels)
    np.testing.assert_allclose(pre.numpy(), np.asarray(pre_r), **TOL)
    np.testing.assert_allclose(dec.numpy(), np.asarray(dec_r), **TOL)
    np.testing.assert_allclose(dec[:, 0].numpy(), np.asarray(full_r[:, -1]),
                               atol=5e-3)    # tests/test_models.py's bound


def _reference_fill_drain(ref, sc_r, prompts, frames, new_tokens, rows=2):
    """The reference CLI's fill-drain loop (greedy), its frames stacked in
    slot order."""
    batcher = RefBatcher(n_mux=sc_r.mux.n, backbone_batch=rows)
    frame_of = {}
    for p, f in zip(prompts, frames):
        frame_of[batcher.submit(p, max_new=new_tokens).uid] = f
    out = []
    while True:
        slots, owners = batcher.next_batch()
        if slots is None:
            break
        uniq = list({id(s): s for s in slots}.values())
        toks = jnp.stack([jnp.asarray(s.prompt) for s in slots])
        extra = jnp.asarray(np.stack([frame_of[s.uid] for s in slots]))
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
    return out


@pytest.mark.parametrize("frames", ["zeros", "random"])
def test_fill_drain_token_identical(frames):
    """5 requests in a grid of 4 slots: a full batch, then one request
    with three duplicates (its logits averaged).  Zero frames are the
    reference CLI's; random ones make the encoder's mux carry data."""
    ref, port, sc_r, sc = _pair()
    rng = np.random.default_rng(3)
    prompts = [rng.integers(4, 512, 6).astype(np.int32) for _ in range(5)]
    enc = sc.cfg.encoder
    fr = np.zeros((5, enc.frontend_len, enc.d_model), np.float32)
    if frames == "random":
        fr = rng.standard_normal(fr.shape).astype(np.float32)
    want = _reference_fill_drain(ref, sc_r, prompts, fr, 4)
    ops.reset_counts()
    got = cli.fill_drain(port, sc, 2, prompts, 4,
                         frames=None if frames == "zeros" else list(fr),
                         device="cpu")
    assert [r.output for r in got["completed"]] == want
    assert (got["prefill_events"], got["decode_steps"]) == (2, 6)
    # two entries per prefill (encoder, decoder) through mux_combine
    assert ops.mux_combine.calls == 4 and ops.mux_combine.launches == 0


def test_greedy_generate_token_identical():
    """``engine.greedy_generate`` with frames (``extra``) against the
    reference's."""
    ref, port, sc_r, sc = _pair()
    toks, frames = _inputs(sc.cfg, length=7, seed=2)
    want = ref_engine.greedy_generate(ref, sc_r, jnp.asarray(toks), steps=5,
                                      extra=jnp.asarray(frames))
    got = engine.greedy_generate(port, sc, torch.as_tensor(toks), steps=5,
                                 extra=torch.as_tensor(frames))
    assert got.tolist() == np.asarray(want).tolist()


@pytest.mark.parametrize("impl", ["naive", "flash"])
def test_wrapper_calls_per_step(impl):
    """A prefill under use_kernels runs the mux-combine entry twice
    (encoder, decoder) and, under 'flash', the flash kernel once per
    encoder layer and twice per decoder layer (self, cross); a decode
    step runs decode_attention twice per decoder layer (self over the
    ring, cross over the frames) plus the fused entry and exit."""
    _, port, _, sc = _pair(impl=impl)
    layers = sc.cfg.n_layers
    toks, frames = _inputs(sc.cfg, length=6)
    cache = engine.init_cache(sc, 4, device="cpu")
    ops.reset_counts()
    engine.prefill(port, sc, cache, torch.as_tensor(toks),
                   extra=torch.as_tensor(frames), use_kernels=True)
    flash = sc.cfg.encoder.n_layers + 2 * layers if impl == "flash" else 0
    assert ops.counts("calls") == {**dict.fromkeys(ops.counts(), 0),
                                   "mux_combine": 2, "flash_attention": flash}
    ops.reset_counts()
    engine.decode_step(port, sc, cache, torch.as_tensor(toks[:, :1]), 6)
    assert ops.counts("calls") == {**dict.fromkeys(ops.counts(), 0),
                                   "decode_attention": 2 * layers,
                                   "mux_embed_combine": 1, "demux_rsa": 1}
    assert not any(ops.counts("launches").values())           # CPU: plain


def test_paged_layout_and_continuous_serving_refused():
    """As in the reference: no paged cache for cross-attention layers or
    an encoder-decoder model, no continuous serving of one."""
    _, port, sc_r, sc = _pair()
    sc_pr = ref_engine.ServeConfig(cfg=sc_r.cfg, kind="encdec", mux=sc_r.mux,
                                   capacity=20, dtype=jnp.float32,
                                   cache_layout="paged")
    with pytest.raises(NotImplementedError):
        ref_engine.init_cache(sc_pr, 4)
    sc_p = engine.ServeConfig(cfg=sc.cfg, mux=sc.mux, capacity=20,
                              dtype=torch.float32, cache_layout="paged",
                              kind="encdec")
    with pytest.raises(NotImplementedError, match="decoder-only"):
        engine.init_cache(sc_p, 4, device="cpu")
    with pytest.raises(NotImplementedError, match="decoder-only"):
        init_block_cache(sc.cfg, "xattn", 2, 20, layout="paged",
                         num_blocks=9, device="cpu")
    with pytest.raises(NotImplementedError, match="decoder-only"):
        ServeRuntime(port, sc_p, 2, device="cpu")
    with pytest.raises(NotImplementedError, match="decoder-only"):
        cli.run_continuous(port, sc, 2, [(0, [5, 6], 2)], device="cpu")
    with pytest.raises(ValueError, match="frame embeddings"):
        engine.prefill(port, sc, engine.init_cache(sc, 4, device="cpu"),
                       torch.zeros((4, 3), dtype=torch.long))


def test_cli_serves_whisper_in_fill_drain(capsys):
    assert cli.main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
                     "--prompt-len", "6", "--new-tokens", "3"]) == 0
    assert "served 3 requests x 3 tokens" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        cli.main(["--arch", ARCH, "--continuous", "--device", "cpu"])
    assert "decoder-only LM families" in capsys.readouterr().err
