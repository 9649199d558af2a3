"""The rest of the port in the reference's bf16 compute dtype against the
JAX reference, on the CPU: the flash and RWKV6 kernels with bf16
operands, whisper-small, rwkv6-7b and MUX-BERT computing in bf16.

Inputs come from numpy seeds; weights from the reference's init through
``repro_torch.interop``; the reference runs as its own tests run it
(Pallas in interpret mode).

(a) Kernels: the plain versions the wrappers run on CPU tensors against
    the Pallas kernels in bf16.  ``flash_attention`` causal, windowed,
    bidirectional, with a query offset, a softcap, GQA, Lq != Lk, Lk not a
    multiple of the block, and blocks of 32 (as the reference's
    ``test_flash_attention_bf16``); bf16 q, K and V are widened, the
    attention runs in fp32 and the output is rounded once on both sides,
    so they agree bit for bit but for an element whose fp32 sums, taken in
    another order, round to the other neighbour: within one bf16 ulp of
    the row's largest value, at most 2% of the elements off
    (``test_torch_bf16.py``'s bound; measured: 0 to 7 elements of 2560
    to 16384).  ``rwkv6_chunked``: ``out`` under the same bound, ``sT`` (fp32)
    within ``RWKV_TOL``, the reference suite's kernel tolerance, at
    decode, in one chunk and over several, and over two halves chained
    through the state; the sequential oracle ``rwkv6_ref`` in bf16 too.
(b) Reduced models in bf16, the same seeded weights on both sides: one
    layer of each new kind bit for bit the reference's run op by op; the
    port on its kernel path (the wrappers' plain versions here) and its
    plain path: teacher-forced logits within ``LOGIT_TOL`` (its reason
    below), the state after a prefill; and greedy tokens on the plain
    path agreeing with the reference's bf16 tokens at least as often as
    the reference's bf16 tokens agree with its own fp32 run of the same
    trace (``REF_BF16_VS_FP32``, measured with the reference alone).
    whisper-small: ``EncDecLM.apply`` and a prefill then decode steps, with
    ``attn_impl`` auto and ``'flash'`` on both sides, and fill-drain;
    rwkv6-7b: a prefill and decode steps, the ring arm and fill-drain, its
    prompts under ~90 tokens in one chunk (the reference's
    ``blocks.rwkv_chunked`` overflows past that, ROADMAP §3); MUX-BERT:
    the five heads for the four (mux, demux) pairs at N=2.
"""
import functools
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as ref_config
from repro.core import MuxSpec as RefMux
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.kernels.rwkv6 import rwkv6_chunked as pallas_rwkv
from repro.launch.serve import run_continuous as ref_run_continuous
from repro.models import EncDecLM as RefEncDec
from repro.models.bert import MuxBERT as RefBERT
from repro.models import blocks as ref_blocks
from repro.models.bert import bert_config as ref_bert_config
from repro.serve import engine as ref_engine
from repro.serve.batcher import MuxBatcher as RefBatcher
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.core import MuxSpec
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve as cli
from repro_torch.models import (EncDecLM, MuxBERT, TransformerLM, bert_config,
                                blocks)
from repro_torch.serve import engine

from test_torch_bf16 import BF, _agreement, _assert_bf16_close, _tokens
from test_torch_kernels import _to_jax

torch.set_num_threads(2)

RWKV_TOL = dict(atol=5e-4, rtol=1e-3)       # tests/test_kernels.py:104-107


def _bf16(rng, *shape, s=1.0):
    return torch.as_tensor((rng.standard_normal(shape) * s).astype(
        np.float32)).to(BF)


# ------------------------------------------------------------ (a) kernels

# (H, Hkv, Lq, Lk, Dh, block) and keyword arguments
FLASH = {
    "causal": (4, 4, 64, 64, 32, 16, {}),
    "window": (4, 4, 64, 64, 32, 16, dict(window=13)),
    "bidirectional": (4, 4, 64, 64, 32, 16, dict(causal=False)),
    "q_offset": (4, 2, 24, 64, 32, 16, dict(q_offset=40)),
    "softcap": (4, 4, 64, 64, 32, 16, dict(logit_softcap=20.0)),
    "gqa": (8, 1, 32, 96, 32, 16, {}),
    "lq_ne_lk": (4, 2, 20, 48, 16, 16, dict(causal=False)),
    "ragged_lk": (4, 4, 50, 50, 32, 16, dict(window=20)),
    "blocks_32": (2, 2, 64, 64, 32, 32, {}),
}


@pytest.mark.parametrize("case", sorted(FLASH))
def test_flash_attention_bf16_plain_matches_pallas(case):
    h, hkv, lq, lk, dh, blk, kw = FLASH[case]
    rng = np.random.default_rng(len(case))
    q, k, v = (_bf16(rng, 2, lq, h, dh), _bf16(rng, 2, lk, hkv, dh),
               _bf16(rng, 2, lk, hkv, dh))
    want = pallas_flash(_to_jax(q), _to_jax(k), _to_jax(v), block_q=blk,
                        block_k=blk, interpret=True, **kw)
    ops.reset_counts()
    got = ops.flash_attention(q, k, v, **kw)
    assert ops.flash_attention.calls == 1 and got.shape == q.shape
    _assert_bf16_close(got, want)


def _rwkv_inputs(b, l, h, hd, seed=0):
    """r, k, v in bf16, logw, u, s0 in fp32, drawn as the reference suite
    draws them (logw = -exp(0.5 z))."""
    rng = np.random.default_rng(seed)

    def r(*shape, s=1.0):
        return torch.as_tensor((rng.standard_normal(shape) * s).astype(
            np.float32))
    shape = (b, l, h, hd)
    return (r(*shape).to(BF), r(*shape, s=0.5).to(BF), r(*shape).to(BF),
            -torch.exp(r(*shape, s=0.5)), r(h, hd, s=0.1),
            r(b, h, hd, hd, s=0.1))


def _pallas_rwkv(a, chunk):
    out, s = pallas_rwkv(*map(_to_jax, a), chunk=chunk, interpret=True)
    return out, np.asarray(s)


# (B, L, H, hd, chunk): decode, one chunk, several chunks
RWKV = [(2, 1, 2, 16, 1), (2, 24, 2, 32, 24), (1, 64, 3, 16, 16)]


@pytest.mark.parametrize("b,l,h,hd,chunk", RWKV)
def test_rwkv6_bf16_plain_matches_pallas(b, l, h, hd, chunk):
    a = _rwkv_inputs(b, l, h, hd)
    want_o, want_s = _pallas_rwkv(a, chunk)
    assert want_o.dtype == jnp.bfloat16 and want_s.dtype == np.float32
    ops.reset_counts()
    got_o, got_s = ops.rwkv6_chunked(*a, chunk=chunk)
    assert ops.rwkv6_chunked.calls == 1
    _assert_bf16_close(got_o, want_o)
    assert got_s.dtype == torch.float32
    np.testing.assert_allclose(got_s.numpy(), want_s, **RWKV_TOL)
    seq_o, seq_s = ref.rwkv6_ref(*a)          # the sequential oracle
    _assert_bf16_close(seq_o, want_o)
    np.testing.assert_allclose(seq_s.numpy(), want_s, **RWKV_TOL)


def test_rwkv6_bf16_halves_chained_through_the_state():
    a = _rwkv_inputs(2, 32, 2, 16, seed=3)
    half = [tuple(x[:, sl] for x in a[:4]) for sl in (slice(0, 16),
                                                       slice(16, 32))]
    o1, s1 = _pallas_rwkv((*half[0], a[4], a[5]), 16)
    o2, s2 = _pallas_rwkv((*half[1], a[4], torch.from_numpy(s1.copy())), 16)
    g1, t1 = ops.rwkv6_chunked(*half[0], a[4], a[5], chunk=16)
    g2, t2 = ops.rwkv6_chunked(*half[1], a[4], t1, chunk=16)
    _assert_bf16_close(torch.cat([g1, g2], 1), jnp.concatenate([o1, o2], 1))
    np.testing.assert_allclose(t2.numpy(), s2, **RWKV_TOL)
    whole_o, whole_s = ops.rwkv6_chunked(*a, chunk=16)
    assert torch.equal(whole_o, torch.cat([g1, g2], 1))
    np.testing.assert_allclose(whole_s.numpy(), t2.numpy(), atol=1e-6)


# ------------------------------------------------------------ (b) models

# Teacher-forced logits, bf16 on both sides: the port rounds where JAX's
# ops round (``test_bf16_layers_match_the_reference_op_by_op``), but the
# reference's compiled layer scan keeps some fused chains in fp32, so the
# hidden states part by a bf16 ulp here and there.  The logits of these
# reduced models stay below 1 in magnitude; measured at most 6.8e-3 apart
# (rwkv6-7b), under one bf16 ulp at 1 (2**-7); LOGIT_TOL is 1e-2, PR 23's
# bar.  Hidden states and states of larger magnitude (the encoder's
# output, RWKV's state and token shifts, MUX-BERT's heads) are held within
# MODEL_ULPS bf16 ulps of their largest value, the card's
# ``BF16_LOGIT_ULPS`` (measured: at most 1.7).
LOGIT_TOL = dict(atol=1e-2, rtol=0)
MODEL_ULPS = 4


def _close(got, want, tol=LOGIT_TOL):
    assert got.dtype == BF
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jnp.asarray(want).astype(
                                   jnp.float32)), **tol)


def _ulps_close(got, want):
    """``got`` within MODEL_ULPS bf16 ulps of |want|'s largest value."""
    w = np.asarray(jnp.asarray(want).astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), w, rtol=0,
                               atol=MODEL_ULPS * 2 ** -7 * np.abs(w).max())


# The reference's own agreement between its bf16 and its fp32 greedy run
# of each trace below (positions agreeing, all positions), measured with
# the reference alone: the floor the port's bf16 run is held to against
# the reference's bf16 run.  Both serve on the plain path, whose rounding
# points the two share (as ``test_torch_bf16.py`` holds its arms): the
# port's kernel path rounds where the Pallas kernels do (whisper's decode
# attention keeps its scores and P in fp32, where the reference's decode
# steps round both to bf16), a near tie then flips either way, and the
# logits tests above hold that path teacher-forced.
REF_BF16_VS_FP32 = {
    ("whisper-small", "fill-drain, auto"): (20, 20),
    ("whisper-small", "fill-drain, flash"): (20, 20),
    ("rwkv6-7b", "ring"): (20, 20),
    ("rwkv6-7b", "fill-drain"): (20, 20),
}


def _ref_fill_drain(ref_p, sc_r, prompts, new_tokens, frames=None, rows=2):
    """The reference CLI's fill-drain loop (greedy, its decode steps on
    the plain path), frames (encdec) stacked in slot order: {request:
    tokens}."""
    batcher = RefBatcher(n_mux=sc_r.mux.n, backbone_batch=rows)
    frame_of = {}
    for i, p in enumerate(prompts):
        uid = batcher.submit(p, max_new=new_tokens).uid
        if frames is not None:
            frame_of[uid] = frames[i]
    out = []
    while True:
        slots, owners = batcher.next_batch()
        if slots is None:
            break
        uniq = list({id(s): s for s in slots}.values())
        toks = jnp.stack([jnp.asarray(s.prompt) for s in slots])
        extra = (jnp.asarray(np.stack([frame_of[s.uid] for s in slots]))
                 if frame_of else None)
        cache = ref_engine.init_cache(sc_r, toks.shape[0])
        logits, cache = ref_engine.prefill(ref_p, sc_r, cache, toks,
                                           extra=extra)
        tok = jnp.argmax(RefBatcher.combine_logits(logits, owners,
                                                   len(uniq)), -1)
        outs = [tok]
        for t in range(new_tokens - 1):
            lg, cache = ref_engine.decode_step(
                ref_p, sc_r, cache, tok[jnp.asarray(owners)][:, None],
                toks.shape[1] + t)
            tok = jnp.argmax(RefBatcher.combine_logits(lg[:, 0], owners,
                                                       len(uniq)), -1)
            outs.append(tok)
        out += [[int(o[j]) for o in outs] for j in range(len(uniq))]
    return dict(enumerate(out))


def _fill_drain(port, sc, prompts, new_tokens, frames=None):
    """The port's ``fill_drain`` on the plain path, as the reference's
    loop decodes."""
    got = cli.fill_drain(port, sc, 2, prompts, new_tokens, device="cpu",
                         frames=None if frames is None else list(frames),
                         use_kernels=False)
    return {i: r.output for i, r in enumerate(got["completed"])}


@functools.lru_cache(maxsize=None)
def _whisper_params():
    cfg = get_config("whisper-small", reduced=True)
    port = EncDecLM.init(torch.Generator().manual_seed(7), cfg,
                         MuxSpec(n=2))
    return _ref_params(port, cfg), port


def _whisper(impl):
    """Both configs with ``attn_impl`` ``impl`` in both stacks, and the
    reference's and the port's copies of seeded weights at N=2."""
    cfg_r, cfg = (ref_config("whisper-small", reduced=True),
                  get_config("whisper-small", reduced=True))
    cfg_r, cfg = (c.replace(attn_impl=impl,
                            encoder=c.encoder.replace(attn_impl=impl))
                  for c in (cfg_r, cfg))
    return (cfg_r, cfg, *_whisper_params())


def _ref_params(port, cfg):
    """The reference's copy of the port's seeded weights (the port's init
    draws from the reference's distributions, and much faster than the
    reference's eager one), as JAX arrays: given numpy weights, the
    reference's plain RSA demux computes its key bias with numpy's bf16
    matmul, which returns fp32, and its exit and logits then run in fp32
    (ROADMAP §3)."""
    return jax.tree.map(jnp.asarray, interop.params_to_reference(port, cfg))


def _whisper_inputs(length=12, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(4, 512, (4, length)).astype(np.int32),
            rng.standard_normal((4, 24, 64)).astype(np.float32))


@pytest.mark.parametrize("kind", ["attn", "xattn", "rwkv", "rglru"])
def test_bf16_layers_match_the_reference_op_by_op(kind):
    """One layer of each new kind in bf16, the reference run op by op
    (``jax.disable_jit``): whisper-small's encoder block and its
    cross-attention decoder block bit for bit, so the port rounds where
    JAX's ops round; the RWKV6 block (from a carried state) bit for bit
    but for an element whose recurrence sums, taken in another order,
    round the other way (``_assert_bf16_close``), its state within
    ``RWKV_TOL``; recurrentgemma-9b's RG-LRU block (from a carried state)
    the same way, its bf16 conv state bit for bit and its fp32 ``h``
    within 1e-6 (the port's scan rounds a2 u1 + u2 once, the reference's
    ops twice).  The reference's model path runs its layers inside a
    compiled ``lax.scan``, where XLA keeps fused elementwise chains in
    fp32 (``xla_allow_excess_precision``, on by default) and skips some
    of those roundings: the source of the model-level differences the
    tests below bound (ROADMAP §3)."""
    rng = np.random.default_rng(4)
    x = _bf16(rng, 2, 10, 64)
    ctx, ctx_r, cache, cache_r = {"impl": "naive"}, {"impl": "naive"}, None, {}
    if kind == "rwkv":
        ref_p, port = _rwkv_params()
        cfg_r, cfg = (ref_config("rwkv6-7b", reduced=True),
                      get_config("rwkv6-7b", reduced=True))
        s0 = torch.as_tensor((rng.standard_normal((2, 2, 32, 32)) * 0.1)
                             .astype(np.float32))
        shifts = _bf16(rng, 2, 2, 64)
        cache = {"s": s0, "shift_tm": shifts[0].clone(),
                 "shift_cm": shifts[1].clone()}
        cache_r = {"s": jnp.asarray(s0.numpy()), "shift_tm": _to_jax(shifts[0]),
                   "shift_cm": _to_jax(shifts[1])}
        layer_r, layer = ref_p["periods"][0], port["layers"][0]
    elif kind == "rglru":
        cfg_r, cfg = (ref_config("recurrentgemma-9b", reduced=True),
                      get_config("recurrentgemma-9b", reduced=True))
        port = TransformerLM.init(torch.Generator().manual_seed(5), cfg,
                                  MuxSpec(n=2))
        ref_p = _ref_params(port, cfg)
        h0 = torch.as_tensor(rng.standard_normal((2, 64)).astype(np.float32))
        conv = _bf16(rng, 2, 3, 64)
        cache = {"h": h0.clone(), "conv": conv.clone()}
        cache_r = {"h": jnp.array(h0.numpy()), "conv": _to_jax(conv)}
        layer_r, layer = ref_p["periods"][0], port["layers"][0]
    else:
        cfg_r, cfg, ref_p, port = _whisper("auto")
        stack = "encoder" if kind == "attn" else "decoder"
        if kind == "attn":
            cfg_r, cfg = cfg_r.encoder, cfg.encoder
        else:
            e = _bf16(rng, 2, 24, 64)
            ctx["enc_out"], ctx_r["enc_out"] = e, _to_jax(e)
        layer_r, layer = ref_p[stack]["periods"][0], port[stack]["layers"][0]
    with jax.disable_jit():
        want, new_r, _ = ref_blocks.apply_block(
            jax.tree.map(lambda a: a[0], layer_r), cfg_r, kind, _to_jax(x),
            ctx_r, cache_r)
    got = blocks.apply_block(layer, cfg, kind, x, ctx, cache)
    if kind not in ("rwkv", "rglru"):
        assert np.array_equal(got.view(torch.int16).numpy(),
                              np.asarray(want).view(np.int16))
        return
    _assert_bf16_close(got, want)
    if kind == "rglru":
        assert np.array_equal(cache["conv"].view(torch.int16).numpy(),
                              np.asarray(new_r["conv"]).view(np.int16))
        np.testing.assert_allclose(cache["h"].numpy(),
                                   np.asarray(new_r["h"]), rtol=0, atol=1e-6)
        return
    np.testing.assert_allclose(cache["s"].numpy(), np.asarray(new_r["s"]),
                               **RWKV_TOL)
    for key in ("shift_tm", "shift_cm"):
        _assert_bf16_close(cache[key], new_r[key])


@pytest.mark.parametrize("impl", ["auto", "flash"])
def test_whisper_bf16_forward_matches_reference(impl):
    """The encoder output and the full forward's logits, N=2, on the
    port's kernel and plain paths; under 'flash' the reference runs its
    Pallas flash kernel in its encoder (its decoder's attention takes the
    naive core either way), the port the flash kernel's plain version in
    both stacks."""
    cfg_r, cfg, ref_p, port = _whisper(impl)
    toks, frames = _whisper_inputs()
    enc_r = RefEncDec.encode(ref_p, cfg_r, jnp.asarray(frames),
                             mux=RefMux(n=2))
    want = RefEncDec.apply(ref_p, cfg_r, jnp.asarray(toks),
                           enc_out=enc_r, mux=RefMux(n=2))["logits"]
    assert enc_r.dtype == want.dtype == jnp.bfloat16
    for use_kernels in (True, False):
        ops.reset_counts()
        enc = EncDecLM.encode(port, cfg, torch.as_tensor(frames),
                              mux=MuxSpec(n=2), use_kernels=use_kernels)
        assert enc.dtype == BF
        _ulps_close(enc, enc_r)
        got = EncDecLM.apply(port, cfg, torch.as_tensor(toks),
                             torch.as_tensor(frames), mux=MuxSpec(n=2),
                             use_kernels=use_kernels)["logits"]
        assert got.shape == (4, 12, 512)
        _close(got, want)
        # the encoder twice (encode, apply), self and cross in the decoder
        flash = 2 * cfg.encoder.n_layers + 2 * cfg.n_layers
        assert ops.flash_attention.calls == (flash if impl == "flash"
                                             else 0)


@pytest.mark.parametrize("impl", ["auto", "flash"])
def test_whisper_bf16_prefill_then_decode_matches_reference(impl):
    """``engine.prefill`` of 11 tokens, then decode steps from the bf16
    ring and cross-K/V (``decode_attention`` with causal=False over the
    frames on the kernel path), at the default ``ServeConfig.dtype``."""
    cfg_r, cfg, ref_p, port = _whisper(impl)
    toks, frames = _whisper_inputs(length=13, seed=1)
    sc_r = ref_engine.ServeConfig(cfg=cfg_r, kind="encdec", mux=RefMux(n=2),
                                  capacity=20)
    sc = engine.ServeConfig(cfg=cfg, mux=MuxSpec(n=2), capacity=20,
                            kind="encdec")
    assert sc.dtype == BF
    cache_r = ref_engine.init_cache(sc_r, 4)
    want, cache_r = ref_engine.prefill(ref_p, sc_r, cache_r,
                                       jnp.asarray(toks[:, :11]),
                                       extra=jnp.asarray(frames))
    steps = []
    for pos in (11, 12):
        w, cache_r = ref_engine.decode_step(
            ref_p, sc_r, cache_r, jnp.asarray(toks[:, pos:pos + 1]), pos)
        steps.append((pos, w))
    for use_kernels in (True, False):
        cache = engine.init_cache(sc, 4, device="cpu")
        assert cache["layers"][0]["xk"].dtype == BF
        got, _ = engine.prefill(port, sc, cache, torch.as_tensor(
            toks[:, :11]), extra=torch.as_tensor(frames),
            use_kernels=use_kernels)
        _close(got, want)
        for pos, w in steps:
            ops.reset_counts()
            g, _ = engine.decode_step(port, sc, cache, torch.as_tensor(
                toks[:, pos:pos + 1]), pos, use_kernels=use_kernels)
            _close(g, w)
            assert ops.decode_attention.calls == (2 * cfg.n_layers
                                                  if use_kernels else 0)


@pytest.mark.parametrize("impl", ["auto", "flash"])
def test_whisper_bf16_fill_drain_greedy_agreement(impl):
    """5 requests with random frames in a grid of 4 slots (one request
    with duplicates, its logits averaged), the reference CLI's loop
    against the port's ``fill_drain``, both in bf16."""
    cfg_r, cfg, ref_p, port = _whisper(impl)
    sc_r = ref_engine.ServeConfig(cfg=cfg_r, kind="encdec", mux=RefMux(n=2),
                                  capacity=20)
    sc = engine.ServeConfig(cfg=cfg, mux=MuxSpec(n=2), capacity=20,
                            kind="encdec")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(4, 512, 6).astype(np.int32) for _ in range(5)]
    frames = rng.standard_normal((5, 24, 64)).astype(np.float32)
    want = _ref_fill_drain(ref_p, sc_r, prompts, 4, frames)
    got = _fill_drain(port, sc, prompts, 4, frames)
    floor, total = REF_BF16_VS_FP32["whisper-small", f"fill-drain, {impl}"]
    same, n_tok = _agreement(got, want)
    assert n_tok == total and same >= floor, (same, floor, total)


@functools.lru_cache(maxsize=None)
def _rwkv_params():
    cfg = get_config("rwkv6-7b", reduced=True)
    port = TransformerLM.init(torch.Generator().manual_seed(5), cfg,
                              MuxSpec(n=2))
    return _ref_params(port, cfg), port


def _rwkv(capacity=40):
    """The reference's and the port's copies of seeded weights at N=2,
    and both packages' default (bf16) ``ServeConfig``."""
    cfg_r, cfg = (ref_config("rwkv6-7b", reduced=True),
                  get_config("rwkv6-7b", reduced=True))
    sc_r = ref_engine.ServeConfig(cfg=cfg_r, kind="lm", mux=RefMux(n=2),
                                  capacity=capacity)
    sc = engine.ServeConfig(cfg=cfg, mux=MuxSpec(n=2), capacity=capacity)
    return (*_rwkv_params(), sc_r, sc)


def test_rwkv_bf16_logits_and_state_match_reference():
    """A 12-token prefill of 3 rows, N=2, then two decode steps from the
    carried state, at the default ``ServeConfig.dtype``: the logits, and
    the state after the prefill, each layer's fp32 matrix state and bf16
    token shifts within ``MODEL_ULPS``: the first layer's matrix state
    agrees to fp32 summation order (4.5e-8), but its inputs k and v, and
    the shifts, are bf16 values of hidden states that part by an ulp here
    and there and compound over the layers (measured: at most 1.2 ulps,
    the second layer's matrix state)."""
    ref_p, port, sc_r, sc = _rwkv()
    rng = np.random.default_rng(2)
    toks = rng.integers(4, 512, (6, 12)).astype(np.int32)
    cache_r = ref_engine.init_cache(sc_r, 6)
    want, cache_r = ref_engine.prefill(ref_p, sc_r, cache_r,
                                       jnp.asarray(toks))
    steps = [rng.integers(4, 512, (6, 1)).astype(np.int32) for _ in range(2)]
    for use_kernels in (True, False):
        cache = engine.init_cache(sc, 6, device="cpu")
        got, _ = engine.prefill(port, sc, cache, torch.as_tensor(toks),
                                use_kernels=use_kernels)
        _close(got, want)
        layers_r = [jax.tree.map(lambda a, i=i: a[i], cache_r["periods"][0])
                    for i in range(sc.cfg.n_layers)]
        for lay, lay_r in zip(cache["layers"], layers_r):
            assert lay["s"].dtype == torch.float32
            assert lay["shift_tm"].dtype == lay["shift_cm"].dtype == BF
            for key in ("s", "shift_tm", "shift_cm"):
                _ulps_close(lay[key], lay_r[key])
        c_r = cache_r
        for pos, d in zip((12, 13), steps):
            w, c_r = ref_engine.decode_step(ref_p, sc_r, c_r, jnp.asarray(d),
                                            pos, use_kernels=use_kernels)
            ops.reset_counts()
            g, _ = engine.decode_step(port, sc, cache, torch.as_tensor(d),
                                      pos, use_kernels=use_kernels)
            assert ops.rwkv6_chunked.calls == (sc.cfg.n_layers if use_kernels
                                               else 0)
            _close(g, w)


def _rwkv_churn(seed=0):
    """Staggered arrivals, mixed lengths: the first three of
    ``tests/test_torch_rwkv.py``'s churn; at capacity 18 the write position
    reaches capacity and forces a rebuild between admissions."""
    rng = np.random.default_rng(seed)
    return [(s, rng.integers(4, 512, size=(k,)).tolist(), m)
            for s, k, m in zip([0, 0, 1], [14, 3, 5], [2, 12, 6])]


def test_rwkv_bf16_ring_arm_greedy_agreement():
    ref_p, port, sc_r, sc = _rwkv(capacity=18)
    arrivals = _rwkv_churn()
    want = _tokens(ref_run_continuous(ref_p, sc_r, 2, arrivals))
    got = _tokens(cli.run_continuous(port, sc, 2, arrivals, device="cpu",
                                     use_kernels=False))
    floor, total = REF_BF16_VS_FP32["rwkv6-7b", "ring"]
    same, n_tok = _agreement(got, want)
    assert n_tok == total and same >= floor, (same, floor, total)


def test_rwkv_bf16_fill_drain_greedy_agreement():
    """3 + 2 requests in a grid of 4 slots, the reference CLI's loop
    against the port's ``fill_drain``."""
    ref_p, port, sc_r, sc = _rwkv(capacity=20)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(4, 512, 6).astype(np.int32) for _ in range(5)]
    want = _ref_fill_drain(ref_p, sc_r, prompts, 4)
    got = _fill_drain(port, sc, prompts, 4)
    floor, total = REF_BF16_VS_FP32["rwkv6-7b", "fill-drain"]
    same, n_tok = _agreement(got, want)
    assert n_tok == total and same >= floor, (same, floor, total)


BERT = dict(n_layers=2, d_model=64, n_heads=4, d_ff=128, vocab_size=512,
            max_seq_len=64)
PAIRS = [("gaussian", "rsa"), ("contextual", "rsa"), ("gaussian", "prefix"),
         ("contextual", "prefix")]
HEADS = ["hidden", "mlm_logits", "rtd_logits", "classify", "classify_tokens"]


@functools.lru_cache(maxsize=None)
def _bert(mux_kind, demux_kind):
    """Seeded MuxBERT weights at N=2 (ELECTRA head, a 3-class classifier
    and a 5-tag token head), tokens, and the reference's five heads in
    bf16 on a copy of the weights (its backbone run once: the heads are
    its own head code over that ``hidden``)."""
    rs = RefMux(n=2, mux_kind=mux_kind, demux_kind=demux_kind)
    cfg_r, cfg = ref_bert_config("base", **BERT), bert_config("base", **BERT)
    gen = torch.Generator().manual_seed(2)
    port = MuxBERT.init(gen, cfg, MuxSpec(n=2, mux_kind=mux_kind,
                                          demux_kind=demux_kind),
                        electra=True)
    port["cls"] = MuxBERT.init_classifier(gen, cfg, 3)
    port["tok"] = MuxBERT.init_token_classifier(gen, cfg, 5)
    ref_p = _ref_params(port, cfg)
    toks = np.random.default_rng(2).integers(0, 512, (4, 12)).astype(
        np.int32)
    t = jnp.asarray(toks)
    want = {"hidden": RefBERT.hidden(ref_p, cfg_r, t, mux=rs,
                                     dtype=jnp.bfloat16)}
    with mock.patch.object(RefBERT, "hidden",
                           lambda *a, **kw: want["hidden"]):
        want["mlm_logits"] = RefBERT.mlm_logits(ref_p, cfg_r, t, mux=rs,
                                                dtype=jnp.bfloat16)
        want["rtd_logits"] = RefBERT.rtd_logits(ref_p, cfg_r, t, mux=rs,
                                                dtype=jnp.bfloat16)
        for head, hp in (("classify", "cls"), ("classify_tokens", "tok")):
            want[head] = getattr(RefBERT, head)(ref_p, ref_p[hp], cfg_r, t,
                                                mux=rs, dtype=jnp.bfloat16)
    return port, toks, want


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("mux_kind,demux_kind", PAIRS)
def test_bert_bf16_heads_match_reference(mux_kind, demux_kind, use_kernels):
    """The five heads through ``dtype=torch.bfloat16`` at N=2, the
    reference's plain path in bf16 against the port's kernel path (the
    fused Gaussian / RSA entry and exit, the wrappers' plain versions
    here) and plain path: each within ``MODEL_ULPS`` of its largest value
    (the demuxed hidden state is a LayerNorm output of magnitude ~3;
    measured: at most 1.7 ulps, the contextual / prefix pair)."""
    port, toks, want = _bert(mux_kind, demux_kind)
    cfg = bert_config("base", **BERT)
    ps = MuxSpec(n=2, mux_kind=mux_kind, demux_kind=demux_kind)
    t = torch.as_tensor(toks)
    for head in HEADS:
        args = ((port, port["cls" if head == "classify" else "tok"])
                if head.startswith("classify") else (port,))
        got = getattr(MuxBERT, head)(*args, cfg, t, mux=ps, dtype=BF,
                                     use_kernels=use_kernels)
        w = want[head]
        assert w.dtype == jnp.bfloat16 and tuple(got.shape) == w.shape
        assert got.dtype == BF
        _ulps_close(got, w)
