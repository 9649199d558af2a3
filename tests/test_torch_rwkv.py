"""The port's RWKV6 path (rwkv6-7b, reduced) against the JAX reference, on
the CPU.

The same numpy-seeded inputs go through the reference and the port:

  * the recurrence: the port's plain ``rwkv_chunked`` against the
    reference's ``blocks.rwkv_chunked`` under the reference's chunk rule
    (within 1e-5), and against the Pallas ``rwkv6_chunked`` in interpret
    mode and the sequential oracle ``rwkv6_ref`` at the reference suite's
    kernel tolerance (atol 5e-4, rtol 1e-3, ``tests/test_kernels.py``),
    over its shapes, strong and weak decay and state chaining;
  * a reference fault: ``blocks.rwkv_chunked`` takes exp() of the whole
    pairwise log-decay tensor before masking its upper triangle, so a
    chunk holding more than ~88 nats of decay (100 tokens at the default
    decay) overflows to inf and returns NaN; the port masks first and
    stays on the oracle there.  The reference comparisons above therefore
    draw decays whose chunks stay below that (shown by the first test);
  * the demux's LN entry (the plain fused exit) against the Pallas kernel
    in interpret mode;
  * ``apply_rwkv`` with and without a cache, model logits for a prefill
    and a decode step from the carried state (within 1e-5, plain and
    kernel path), interop with ``lm_head``, the port's own init;
  * serving: the ring arm and fill-drain greedy token-identical to the
    reference's at N=2, on the plain and the kernel path (the wrappers'
    plain versions here); paged serving refused, as the reference fails
    there; the CLI on ``--device cpu``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as ref_config
from repro.core import MuxSpec as RefMux
from repro.kernels import ref as jref
from repro.kernels.demux_rsa import demux_rsa as pallas_demux
from repro.kernels.rwkv6 import rwkv6_chunked as pallas_rwkv
from repro.launch.serve import run_continuous as ref_run_continuous
from repro.models import TransformerLM as RefLM
from repro.models import blocks as ref_blocks
from repro.serve import engine as ref_engine
from repro.serve.batcher import MuxBatcher as RefBatcher
from repro.serve.batcher import Request as RefRequest
from repro.serve.runtime import ServeRuntime as RefRuntime
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.core import MuxSpec
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve as cli
from repro_torch.models import TransformerLM, blocks, param_count
from repro_torch.serve import engine
from repro_torch.serve.runtime import ServeRuntime

torch.set_num_threads(2)

ARCH = "rwkv6-7b"
TOL = dict(atol=1e-5, rtol=1e-5)
KERNEL_TOL = dict(atol=5e-4, rtol=1e-3)      # tests/test_kernels.py:104-107


def _inputs(b, l, h, d, seed=0, logw=None, decay_scale=1.0):
    """r, k, v, logw, u, s0 as ``tests/test_kernels.py`` draws them
    (logw = -exp(0.5 z), times ``decay_scale``), or a fixed ``logw``."""
    rng = np.random.default_rng(seed)

    def r(*shape, s=1.0):
        return (rng.standard_normal(shape) * s).astype(np.float32)
    shape = (b, l, h, d)
    lw = (-np.exp(r(*shape, s=0.5)) * decay_scale if logw is None
          else np.full(shape, logw))
    return (r(*shape), r(*shape, s=0.5), r(*shape), lw.astype(np.float32),
            r(h, d, s=0.1), r(b, h, d, d, s=0.1))


def _chunk(l, rwkv_chunk=32):
    """The reference's chunk rule (``blocks.apply_rwkv``)."""
    return min(l, rwkv_chunk if l % rwkv_chunk == 0 else l)


def _np(x):
    return np.asarray(x)


# ------------------------------------------------------------ recurrence

def test_reference_chunked_overflows_where_port_stays_on_oracle():
    """One 100-token chunk at the default decay (~1.1 nats a token): the
    reference's ``rwkv_chunked`` returns NaN; the port's plain version
    equals the reference's sequential oracle within the kernel
    tolerance, and so do both at a decay scaled to keep the chunk's
    upper triangle finite."""
    args = _inputs(1, 100, 2, 16)
    out_r, _ = ref_blocks.rwkv_chunked(*map(jnp.asarray, args), 100)
    assert np.isnan(_np(out_r)).any()
    got = ref.rwkv_chunked(*map(torch.as_tensor, args), 100)
    want = jref.rwkv6_ref(*map(jnp.asarray, args))
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), _np(w), **KERNEL_TOL)
    args = _inputs(1, 100, 2, 16, decay_scale=0.5)
    out_r, _ = ref_blocks.rwkv_chunked(*map(jnp.asarray, args), 100)
    assert np.isfinite(_np(out_r)).all()


@pytest.mark.parametrize("l", [1, 12, 32, 64, 100])
def test_rwkv_chunked_matches_reference_blocks(l):
    """The chunk rule's cases at rwkv_chunk 32: one chunk of L for L = 1,
    12, 100; chunks of 32 for L = 32, 64.  The 100-token chunk draws half
    the default decay, so that the reference stays finite (see above).
    Tolerance: 1e-5 of the output's scale (|out| reaches 15-21 here).
    The two packages round the cumulative log decay differently (XLA's
    CPU cumsum is an associative scan, torch's sequential: 8e-6 apart at
    L=100), and each is ~2e-5 from the float64 recurrence there."""
    args = _inputs(2, l, 2, 16, seed=l, decay_scale=0.5 if l > 64 else 1.0)
    c = _chunk(l)
    want = ref_blocks.rwkv_chunked(*map(jnp.asarray, args), c)
    got = ref.rwkv_chunked(*map(torch.as_tensor, args), c)
    for g, w in zip(got, want):
        w = _np(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())


def test_rwkv_chunked_bf16_intra_matches_reference_blocks():
    args = _inputs(2, 32, 2, 16, seed=3)
    want = ref_blocks.rwkv_chunked(*map(jnp.asarray, args), 16,
                                   intra_dtype=jnp.bfloat16)
    got = ref.rwkv_chunked(*map(torch.as_tensor, args), 16,
                           intra_dtype=torch.bfloat16)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _np(w), atol=2e-2, rtol=2e-2)


# tests/test_kernels.py:92 shapes, then the decay edges
@pytest.mark.parametrize("b,l,h,d,chunk,logw", [
    (1, 32, 2, 8, 8, None), (2, 64, 3, 16, 16, None),
    (1, 64, 1, 32, 64, None), (2, 32, 2, 16, 8, -5.0),
    (2, 64, 2, 16, 32, -1e-3)],
    ids=["s1", "s2", "s3", "strong_decay", "weak_decay"])
def test_rwkv_plain_matches_pallas_and_oracle(b, l, h, d, chunk, logw):
    args = _inputs(b, l, h, d, seed=d, logw=logw)
    jargs = list(map(jnp.asarray, args))
    pallas = pallas_rwkv(*jargs, chunk=chunk, interpret=True)
    oracle = jref.rwkv6_ref(*jargs)
    targs = list(map(torch.as_tensor, args))
    for got in (ref.rwkv_chunked(*targs, chunk), ref.rwkv6_ref(*targs)):
        for g, p, o in zip(got, pallas, oracle):
            np.testing.assert_allclose(g.numpy(), _np(p), **KERNEL_TOL)
            np.testing.assert_allclose(g.numpy(), _np(o), **KERNEL_TOL)


def test_rwkv_plain_state_chaining():
    """Two halves chained through the final state == one pass."""
    r, k, v, logw, u, _ = map(torch.as_tensor, _inputs(1, 64, 2, 8, seed=9))
    s0 = torch.zeros(1, 2, 8, 8)
    o_full, s_full = ref.rwkv_chunked(r, k, v, logw, u, s0, 16)
    o1, s1 = ref.rwkv_chunked(r[:, :32], k[:, :32], v[:, :32],
                              logw[:, :32], u, s0, 16)
    o2, s2 = ref.rwkv_chunked(r[:, 32:], k[:, 32:], v[:, 32:],
                              logw[:, 32:], u, s1, 16)
    torch.testing.assert_close(torch.cat([o1, o2], 1), o_full, atol=1e-4,
                               rtol=0)
    torch.testing.assert_close(s2, s_full, atol=1e-4, rtol=0)


# ------------------------------------------------------ demux LN entry

@pytest.mark.parametrize("t", [4, 32, 5])
def test_demux_ln_entry_plain_matches_pallas(t):
    rng = np.random.default_rng(t)

    def r(*shape, s=1.0):
        return (rng.standard_normal(shape) * s).astype(np.float32)
    d, f = 64, 128
    args = (r(t, d) + 3.0, r(2, d), r(d, f, s=0.1), r(d, f, s=0.1),
            r(f, s=0.1), r(f, d, s=0.1), r(d, s=0.1))
    norms = {"entry_scale": r(d, s=0.1) + 1.0, "entry_bias": r(d, s=0.1),
             "exit_scale": r(d, s=0.1) + 1.0, "exit_bias": r(d, s=0.1)}
    want = pallas_demux(*map(jnp.asarray, args), entry_kind="ln",
                        block_t=16, block_f=64, interpret=True,
                        **{k: jnp.asarray(v) for k, v in norms.items()})
    got = ref.demux_rsa_fused_ref(
        *map(torch.as_tensor, args), entry_kind="ln",
        **{k: torch.as_tensor(v) for k, v in norms.items()})
    np.testing.assert_allclose(got.numpy(), _np(want), atol=2e-4, rtol=2e-4)


# ------------------------------------------------------------ the block

def _layer(seed=0):
    cfg_r = ref_config(ARCH, reduced=True)
    p_r = ref_blocks.init_rwkv(jax.random.PRNGKey(seed), cfg_r)
    p = interop._map(lambda a: torch.as_tensor(np.array(a)),
                     jax.tree.map(np.asarray, p_r))
    return cfg_r, get_config(ARCH, reduced=True), p_r, p


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("cached", [False, True])
def test_apply_rwkv_matches_reference(cached, use_kernels):
    """One layer on a 12-token segment: without a cache (zero state,
    nothing kept) and from a carried state, whose update must match."""
    cfg_r, cfg, p_r, p = _layer()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    nh = cfg.rwkv_heads
    hd = cfg.d_model // nh
    cache_np = {}
    if cached:
        cache_np = {"s": rng.standard_normal((2, nh, hd, hd)).astype(
                        np.float32) * 0.1,
                    "shift_tm": rng.standard_normal((2, cfg.d_model)).astype(
                        np.float32),
                    "shift_cm": rng.standard_normal((2, cfg.d_model)).astype(
                        np.float32)}
    want, new_r, _ = ref_blocks.apply_rwkv(
        p_r, cfg_r, "rwkv", jnp.asarray(x), {},
        {k: jnp.asarray(v) for k, v in cache_np.items()})
    cache = {k: torch.as_tensor(v.copy()) for k, v in cache_np.items()}
    got = blocks.apply_block(p, cfg, "rwkv", torch.as_tensor(x),
                             {"use_kernels": use_kernels},
                             cache if cached else None)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    assert set(cache) == set(new_r)
    for k in cache:
        np.testing.assert_allclose(cache[k].numpy(), _np(new_r[k]), **TOL)


def test_apply_rwkv_refusals():
    """A row-subset prefill (the reference's paged fault) and the bf16
    intra dtype on the kernel path raise; bf16 runs on the plain path."""
    _, cfg, _, p = _layer()
    x = torch.zeros(1, 4, cfg.d_model)
    cache = blocks.init_block_cache(cfg, "rwkv", 1, 8, device="cpu")
    with pytest.raises(NotImplementedError, match="rows"):
        blocks.apply_rwkv(p, cfg, "rwkv", x, {"rows": torch.tensor([0])},
                          cache)
    bf16 = cfg.replace(rwkv_intra_dtype="bf16")
    with pytest.raises(NotImplementedError, match="bf16"):
        blocks.apply_rwkv(p, bf16, "rwkv", x, {"use_kernels": True}, cache)
    assert blocks.apply_rwkv(p, bf16, "rwkv", x, {}, cache).shape == x.shape


# ------------------------------------------------------------ the model

def _ref_params(n, seed=0):
    cfg = ref_config(ARCH, reduced=True)
    return jax.tree.map(np.asarray, RefLM.init(jax.random.PRNGKey(seed), cfg,
                                               RefMux(n=n)))


def _pair(n, capacity=40, layout="ring"):
    cfg_r = ref_config(ARCH, reduced=True)
    ref_p = RefLM.init(jax.random.PRNGKey(5), cfg_r, RefMux(n=n))
    cfg = get_config(ARCH, reduced=True)
    port = interop.params_from_reference(jax.tree.map(np.asarray, ref_p),
                                         cfg, device="cpu")
    sc_r = ref_engine.ServeConfig(cfg=cfg_r, kind="lm", mux=RefMux(n=n),
                                  capacity=capacity, dtype=jnp.float32,
                                  cache_layout=layout, block_size=4)
    sc = engine.ServeConfig(cfg=cfg, mux=MuxSpec(n=n), capacity=capacity,
                            dtype=torch.float32, cache_layout=layout,
                            block_size=4)
    return ref_p, port, sc_r, sc


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    elif tree is not None:
        yield prefix, tree


def test_interop_round_trip_with_lm_head():
    cfg = get_config(ARCH, reduced=True)
    ref_p = _ref_params(2)
    port = interop.params_from_reference(ref_p, cfg, device="cpu")
    assert port["lm_head"]["w"].shape == (cfg.d_model, cfg.vocab_size)
    assert port["layers"][1]["w_r"]["w"].shape == (cfg.d_model, 2, 32)
    back = interop.params_to_reference(port, cfg)
    a, b = dict(_leaves(ref_p)), dict(_leaves(back))
    assert a.keys() == b.keys() and "/lm_head/w" in a
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_port_init_matches_reference_structure():
    cfg = get_config(ARCH, reduced=True)
    p = TransformerLM.init(torch.Generator().manual_seed(0), cfg,
                           MuxSpec(n=2))
    mine = dict(_leaves(interop.params_to_reference(p, cfg)))
    assert {k: v.shape for k, v in mine.items()} == \
        {k: v.shape for k, v in _leaves(_ref_params(2))}
    n_dense = sum(v.size for k, v in mine.items() if "mux_engine" not in k)
    assert n_dense == param_count(cfg)
    from repro.models.config import param_count as ref_param_count
    full = get_config(ARCH)
    assert param_count(full) == ref_param_count(ref_config(ARCH)) \
        == 6_997_811_200
    assert (full.n_layers, full.d_model, full.rwkv_heads, full.d_ff,
            full.vocab_size, full.tie_embeddings) == (32, 4096, 64, 14336,
                                                      65536, False)


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("use_kernels", [False, True])
def test_logits_match_reference(n, use_kernels):
    """A 12-token prefill of 3 rows, then two decode steps from the
    carried state (the reference's decode runs its fused exit with the LN
    entry in interpret mode under use_kernels)."""
    ref_p, port, sc_r, sc = _pair(n)
    rng = np.random.default_rng(n)
    toks = rng.integers(4, 512, (3 * n, 12)).astype(np.int32)
    cache_r = ref_engine.init_cache(sc_r, 3 * n)
    cache = engine.init_cache(sc, 3 * n, device="cpu")
    want, cache_r = ref_engine.prefill(ref_p, sc_r, cache_r,
                                       jnp.asarray(toks))
    got, _ = engine.prefill(port, sc, cache, torch.as_tensor(toks),
                            use_kernels=use_kernels)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    for pos in (12, 13):
        d = rng.integers(4, 512, (3 * n, 1)).astype(np.int32)
        want, cache_r = ref_engine.decode_step(
            ref_p, sc_r, cache_r, jnp.asarray(d), pos,
            use_kernels=use_kernels)
        got, _ = engine.decode_step(port, sc, cache, torch.as_tensor(d), pos,
                                    use_kernels=use_kernels)
        assert got.shape == (3 * n, 1, 512)
        np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


def test_cache_holds_recurrent_state_only():
    """An RWKV layer's cache is O(1) per row on either layout: fp32 state
    and shifts, no pages, no KV bytes."""
    _, _, _, sc = _pair(2)
    cfg = sc.cfg
    assert sc.kv_bytes_per_token() == 0
    for layout in ("ring", "paged"):
        c = TransformerLM.init_cache(cfg, 3, 40, layout=layout,
                                     num_blocks=11, device="cpu")
        assert [sorted(x) for x in c["layers"]] == \
            [["s", "shift_cm", "shift_tm"]] * cfg.n_layers
        lay = c["layers"][0]
        assert lay["s"].shape == (3, 2, 32, 32)
        assert lay["shift_tm"].shape == (3, cfg.d_model)
        assert all(t.dtype == torch.float32 and not t.any()
                   for t in lay.values())


def test_rwkv_calls_per_step():
    """A blocking prefill calls rwkv6_chunked once per layer under
    use_kernels and, of the entry and exit wrappers, only the mux-combine
    of the plain (unfused) entry, as the reference's prefill; a decode
    step calls it once per layer plus the fused entry and exit."""
    _, port, _, sc = _pair(2)
    layers = sc.cfg.n_layers
    cache = engine.init_cache(sc, 4, device="cpu")
    ops.reset_counts()
    engine.prefill(port, sc, cache, torch.zeros((4, 8), dtype=torch.long),
                   use_kernels=True)
    assert ops.counts("calls") == {**dict.fromkeys(ops.counts(), 0),
                                   "rwkv6_chunked": layers,
                                   "mux_combine": 1}
    ops.reset_counts()
    engine.decode_step(port, sc, cache, torch.zeros((4, 1), dtype=torch.long),
                       8)
    assert ops.counts("calls") == {**dict.fromkeys(ops.counts(), 0),
                                   "rwkv6_chunked": layers,
                                   "mux_embed_combine": 1, "demux_rsa": 1}
    assert not any(ops.counts("launches").values())           # CPU: plain


# ------------------------------------------------------------ serving

def _ring_churn(seed=0):
    """Staggered arrivals, mixed lengths; at capacity 18 the write
    position reaches capacity and forces a rebuild between admissions
    (``tests/test_torch_ring.py``)."""
    rng = np.random.default_rng(seed)
    return [(s, rng.integers(4, 512, size=(k,)).tolist(), m)
            for s, k, m in zip([0, 0, 1, 4, 6], [14, 3, 5, 8, 2],
                               [2, 12, 6, 4, 9])]


def _outputs(stats):
    return {r.uid: list(r.output) for r in stats["completed"]}


@pytest.mark.parametrize("use_kernels", [False, True])
def test_ring_arm_token_identical(use_kernels):
    """Grid-wide re-prefills right-padded with the pad token, whose pads
    enter the RWKV state in both packages."""
    ref_p, port, sc_r, sc = _pair(2, capacity=18)
    arrivals = _ring_churn()
    want = ref_run_continuous(ref_p, sc_r, 2, arrivals)
    got = cli.run_continuous(port, sc, 2, arrivals, use_kernels=use_kernels,
                             device="cpu")
    assert [len(r.output) for r in got["completed"]] == [2, 6, 4, 12, 9]
    assert _outputs(got) == _outputs(want)
    for k in ("prefill_events", "prefill_tokens", "prefill_log",
              "decode_steps", "max_grid_pos"):
        assert got[k] == want[k], k
    assert got["prefill_events"] == 5


@pytest.mark.parametrize("use_kernels", [False, True])
def test_fill_drain_token_identical(use_kernels):
    """3 + 2 requests in a grid of 4 slots (one duplicate, its logits
    averaged): the reference CLI's loop against the port's
    ``fill_drain``."""
    ref_p, port, sc_r, sc = _pair(2, capacity=20)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(4, 512, 6).astype(np.int32) for _ in range(5)]
    batcher = RefBatcher(n_mux=2, backbone_batch=2)
    for p in prompts:
        batcher.submit(p, max_new=4)
    want = []
    while True:
        slots, owners = batcher.next_batch()
        if slots is None:
            break
        uniq = list({id(s): s for s in slots}.values())
        own = jnp.asarray(owners)
        toks = jnp.stack([jnp.asarray(s.prompt) for s in slots])
        cache = ref_engine.init_cache(sc_r, toks.shape[0])
        logits, cache = ref_engine.prefill(ref_p, sc_r, cache, toks)
        tok = jnp.argmax(RefBatcher.combine_logits(logits, owners,
                                                   len(uniq)), -1)
        outs = [tok]
        for t in range(3):
            lg, cache = ref_engine.decode_step(ref_p, sc_r, cache,
                                               tok[own][:, None], 6 + t)
            tok = jnp.argmax(RefBatcher.combine_logits(lg[:, 0], owners,
                                                       len(uniq)), -1)
            outs.append(tok)
        want += [[int(o[j]) for o in outs] for j in range(len(uniq))]
    got = cli.fill_drain(port, sc, 2, prompts, 4, use_kernels=use_kernels,
                         device="cpu")
    assert [r.output for r in got["completed"]] == want
    assert (got["prefill_events"], got["decode_steps"]) == (2, 6)


def test_paged_serving_refused_where_the_reference_fails():
    """The reference's paged runtime falls back to blocking prefill for
    RWKV and fails there; the port refuses with NotImplementedError."""
    ref_p, port, sc_r, sc = _pair(2, layout="paged")
    rt_r = RefRuntime(ref_p, sc_r, 2, chunk=8)
    assert rt_r.chunk is None                    # the fallback
    rt_r.submit(RefRequest(uid=0, prompt=list(range(4, 15)), max_new=2))
    with pytest.raises(TypeError, match="Cannot concatenate"):
        rt_r.step()
    with pytest.raises(NotImplementedError, match="blocking prefill"):
        ServeRuntime(port, sc, 2, device="cpu")
    with pytest.raises(NotImplementedError, match="Cannot concatenate"):
        cli.run_continuous(port, sc, 2, _ring_churn()[:1], device="cpu")


@pytest.mark.parametrize("argv,want", [
    (["--continuous"],
     ["continuous[ring/cpu] served 3 requests (9 tokens)",
      "prefill 36 backbone tokens (36 padded) in 3 events"]),
    ([], ["served 3 requests x 3 tokens in ",
          "(mux N=2, backbone batch 2; throughput "]),
], ids=["ring", "fill-drain"])
def test_cli_serves_rwkv_on_cpu(capsys, argv, want):
    """The reference CLI's counts for the same flags (its ring
    re-prefills both rows at every admission: 3 events of 6 tokens x 2
    rows)."""
    assert cli.main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
                     "--prompt-len", "6", "--new-tokens", "3", *argv]) == 0
    out = capsys.readouterr().out
    for line in want:
        assert line in out


def test_cli_refuses_paged_rwkv(capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["--arch", ARCH, "--continuous", "--cache", "paged",
                  "--device", "cpu"])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "--cache paged with rwkv6-7b" in err
    assert "Cannot concatenate" in err
