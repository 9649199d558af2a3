"""The port's dense-attention kernels and model paths against the JAX
reference, on the CPU: ``decode_attention`` (flash-decode over a ring
cache) and ``flash_attention`` (attention over fresh K/V), then the ring
cache and blocking prefill of ``TransformerLM``.

Kernels: each plain PyTorch version against the Pallas kernel in
interpret mode, at the reference suite's tolerance (atol 3e-5, rtol 1e-4:
fp32 on both sides, summation order only), over ring-wrapped (non-
monotone) slot positions, empty slots, caches and sequences that are not
a multiple of the Pallas block, sliding windows, bidirectional attention
with a softcap, a query offset with Lq < Lk, and queries that see nothing.
Pallas pads the cache and the keys to its block with zeros, which a query
that sees nothing then averages in; the fully masked cases therefore use
sizes that are block multiples, where Pallas and the plain version agree
by construction (the card tests hold the kernels to the plain version on
ragged sizes too).

Model: logits of the port against the reference within 1e-5 (fp32, two
small layers, summation order only), from weights carried across with
``interop``: ring decode steps past the ring's wrap on the plain and
kernel paths, from the reference's own cache and from the port's, and the
blocking prefill with ``attn_impl`` naive, chunked (small ``attn_chunk``)
and flash, into a ring and into a paged row.

Tensor-core arithmetic: the flash kernel's products run in three TF32
products with fp32 accumulation (hi/lo split of each operand).  A CPU
model of that arithmetic (TF32 rounding emulated here, tiled online
softmax as the kernel's) stays within the card tests' tolerance of an
fp64 reference at whisper's, qwen2's and gemma's head dims, where one
plain TF32 product does not.

CUDA (marked ``cuda``, skipped without a card): each kernel against its
plain version on the card at these shapes, ragged and fully masked ones
included, at qwen2-1.5b's widths, at whisper-small's two attention shapes
(the second splits the key axis), at gemma-2b's heads (Dh 256, one KV
head), at head dims that pad to the mma depth, and bit for bit over two
calls.  The card's machine has no JAX, so
the reference is imported inside the CPU tests only (``_reference``):
``pytest --noconftest -m cuda`` runs there.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.core import MuxSpec
from repro_torch.kernels import ops, ref
from repro_torch.models import TransformerLM
from repro_torch.nn import multi_head_attention
from repro_torch.serve import engine

torch.set_num_threads(2)

ATT_TOL = dict(atol=3e-5, rtol=1e-4)
TOL = dict(atol=1e-5, rtol=1e-5)
ARCH = "qwen2-1.5b"
HEADS = [(4, 4), (4, 2), (6, 1)]


def _reference():
    """The JAX reference's modules, imported on use."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.core import MuxSpec
    from repro.kernels import ops
    from repro.models import TransformerLM
    from repro.nn import attention
    from repro.serve import engine
    return types.SimpleNamespace(jax=jax, jnp=jnp, config=get_config,
                                 Mux=MuxSpec, ops=ops, LM=TransformerLM,
                                 attention=attention, engine=engine)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def ring_positions(capacity, written, start=0):
    """Slot positions of a ring of ``capacity`` after writing positions
    start .. written-1 (slot s holds the last p with p % capacity == s)."""
    pos = np.full((capacity,), -1, np.int32)
    for p in range(start, written):
        pos[p % capacity] = p
    return pos


# name: (C, slot_pos, q_pos, window, causal, block_k)
DECODE_CASES = {
    # 30 positions into a 20-slot ring: slot_pos is not monotone
    "wrapped": (20, ring_positions(20, 30), 29, None, True, 8),
    "wrapped_window": (20, ring_positions(20, 30), 29, 7, True, 8),
    "empty_slots": (24, ring_positions(24, 15), 14, None, True, 16),
    "bidirectional": (20, ring_positions(20, 13), 5, None, False, 8),
    # window 2 at position 40 over positions 0..15: no slot is visible
    "fully_masked": (16, ring_positions(16, 16), 40, 2, True, 8),
}

# name: (Lq, Lk, causal, window, q_offset, softcap, block)
FLASH_CASES = {
    "causal_ragged": (13, 13, True, None, 0, None, 8),
    "window": (21, 21, True, 6, 0, None, 8),
    "bidirectional_softcap": (11, 11, False, None, 0, 5.0, 8),
    "q_offset": (5, 19, True, None, 14, None, 8),
    # queries at 16..23, keys 0..15, window 4: queries from 19 on see none
    "fully_masked": (8, 16, True, 4, 16, None, 8),
}


def _decode_inputs(case, h, hkv, b=2, dh=16, seed=0):
    c, pos, q_pos, window, causal, _ = DECODE_CASES[case]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, 1, h, dh), np.float32)
    k = rng.standard_normal((b, c, hkv, dh), np.float32)
    v = rng.standard_normal((b, c, hkv, dh), np.float32)
    return (q, k, v, pos), dict(q_pos=q_pos, window=window, causal=causal)


def _flash_inputs(case, h, hkv, b=2, dh=16, seed=0):
    lq, lk, causal, window, q_offset, softcap, _ = FLASH_CASES[case]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, lq, h, dh), np.float32)
    k = rng.standard_normal((b, lk, hkv, dh), np.float32)
    v = rng.standard_normal((b, lk, hkv, dh), np.float32)
    return (q, k, v), dict(causal=causal, window=window, q_offset=q_offset,
                           logit_softcap=softcap)


def _torch(args, device="cpu"):
    return [torch.as_tensor(a, device=device) for a in args]


@pytest.mark.parametrize("h,hkv", HEADS)
@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_attention_plain_matches_pallas(case, h, hkv):
    R = _reference()
    args, kw = _decode_inputs(case, h, hkv)
    want = R.ops.decode_attention(*map(R.jnp.asarray, args),
                                 block_k=DECODE_CASES[case][-1],
                                 interpret=True, **kw)
    got = ref.decode_attention_ref(*_torch(args), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATT_TOL)


@pytest.mark.parametrize("h,hkv", HEADS)
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_attention_plain_matches_pallas(case, h, hkv):
    R = _reference()
    args, kw = _flash_inputs(case, h, hkv)
    blk = FLASH_CASES[case][-1]
    want = R.ops.flash_attention(*map(R.jnp.asarray, args), block_q=blk,
                                block_k=blk, interpret=True, **kw)
    got = ref.flash_attention_ref(*_torch(args), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATT_TOL)


def test_fully_masked_queries_average_every_key():
    """The edge both kernels must reproduce on the card: a query that sees
    nothing returns the uniform mean of V over every slot / key (the
    finite mask value), not NaN and not zero."""
    args, kw = _decode_inputs("fully_masked", 4, 2)
    got = ref.decode_attention_ref(*_torch(args), **kw)
    v = torch.as_tensor(args[2])
    want = v.mean(1).repeat_interleave(2, dim=1)[:, None]
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    args, kw = _flash_inputs("fully_masked", 4, 2)
    got = ref.flash_attention_ref(*_torch(args), **kw)
    v = torch.as_tensor(args[2])
    blind = got[:, 3:]                       # queries at 19 .. 23
    torch.testing.assert_close(
        blind, v.mean(1).repeat_interleave(2, dim=1)[:, None].expand_as(
            blind), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("impl", ["naive", "chunked", "flash"])
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_multi_head_attention_matches_reference(case, impl):
    """Every implementation of the dispatch agrees with the reference's
    (chunked with 4-key chunks, so Lk spans several and a ragged last)."""
    R = _reference()
    args, kw = _flash_inputs(case, 4, 2)
    softcap = kw.pop("logit_softcap")
    want = R.attention.multi_head_attention(
        *map(R.jnp.asarray, args), impl="chunked" if impl == "flash" else impl,
        chunk_size=4, logit_softcap=softcap, **kw)
    got = multi_head_attention(*_torch(args), impl=impl, chunk_size=4,
                               logit_softcap=softcap, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATT_TOL)


def test_wrappers_dispatch_and_count_on_cpu():
    """On CPU tensors both wrappers count the call, launch nothing and
    return exactly their plain versions; the kernel launchers refuse CPU
    tensors (no silent fallback)."""
    from repro_torch.kernels import decode_attention as kd
    from repro_torch.kernels import flash_attention as kf
    ops.reset_counts()
    args, kw = _decode_inputs("wrapped", 4, 2)
    t = _torch(args)
    assert torch.equal(ops.decode_attention(*t, **kw),
                       ref.decode_attention_ref(*t, **kw))
    with pytest.raises(ValueError, match="CUDA"):
        kd.decode_attention_cuda(*t, **kw)
    args, kw = _flash_inputs("window", 4, 2)
    t = _torch(args)
    assert torch.equal(ops.flash_attention(*t, **kw),
                       ref.flash_attention_ref(*t, **kw))
    with pytest.raises(ValueError, match="CUDA"):
        kf.flash_attention_cuda(*t, **kw)
    calls = ops.counts("calls")
    assert calls["decode_attention"] == calls["flash_attention"] == 1
    assert not any(ops.counts("launches").values())


def test_decode_splits_cover_the_cache():
    """The split policy: whole tiles, no empty split, ~2 blocks per SM."""
    from repro_torch.kernels.decode_attention import TILE, splits
    for b, hkv, c in [(4, 2, 124), (1, 1, 5), (2, 8, 4096), (4, 2, 16)]:
        n, per = splits(b, hkv, c)
        assert per % TILE == 0 and n * per >= c > (n - 1) * per
        assert b * hkv * n <= max(264, b * hkv)
    assert splits(4, 2, 124) == (8, 16)


# ------------------------------------------ the kernel's TF32 arithmetic

def _tf32(x):
    """cvt.rna.tf32.f32: round fp32 to 10 mantissa bits, ties away from
    zero (the magnitude's half ulp added to the bits, then truncated)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split_mm(a, b, passes):
    """fp32-accumulated a @ b of TF32 operands: one product of the rounded
    operands (plain TF32), or hi*hi + hi*lo + lo*hi (the kernel's 3xTF32:
    hi = tf32(x), lo = tf32(x - hi)); products of TF32 values are exact
    in fp32, so fp32 matmuls of them model the tensor core."""
    ah, bh = _tf32(a), _tf32(b)
    if passes == 1:
        return ah @ bh
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def _tf32_attention(q, k, v, passes, block_k=64):
    """Bidirectional attention for one head, q (L, Dh), k, v (Lk, Dh), the
    kernel's way: Q pre-scaled, tiles of ``block_k`` keys, online softmax
    in fp32 (log2 units), P unnormalised through the same products."""
    q = q * q.shape[-1] ** -0.5
    m = torch.full((q.shape[0], 1), -torch.inf)
    l = torch.zeros((q.shape[0], 1))
    o = torch.zeros_like(q)
    for k0 in range(0, k.shape[0], block_k):
        s = _split_mm(q, k[k0:k0 + block_k].T, passes) * 1.4426950408889634
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp2(s - m_new)
        alpha = torch.exp2(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + _split_mm(p, v[k0:k0 + block_k], passes)
        m = m_new
    return o / l


@pytest.mark.parametrize("lq,dh", [(1500, 64), (116, 128), (256, 256)])
def test_3xtf32_attention_keeps_fp32_accuracy(lq, dh):
    """The split keeps fp32's accuracy where plain TF32 breaks the card
    tests' tolerance (whisper's encoder, qwen2-1.5b's and gemma's head
    dims)."""
    rng = np.random.default_rng(lq)
    q, k, v = (torch.as_tensor(rng.standard_normal((lq, dh), np.float32))
               for _ in range(3))
    s = (q.double() * dh ** -0.5) @ k.double().T
    want = torch.softmax(s, -1) @ v.double()
    got = _tf32_attention(q, k, v, passes=3)
    torch.testing.assert_close(got.double(), want, **ATT_TOL)
    plain = _tf32_attention(q, k, v, passes=1)
    assert not torch.allclose(plain.double(), want, **ATT_TOL)


def test_flash_splits_fill_the_card():
    """The key-split policy: whole tiles, no empty split, a split only
    where the query tiles leave SMs idle."""
    from repro_torch.kernels.flash_attention import TILES, padded_head_dim, \
        splits
    assert [padded_head_dim(d) for d in (4, 12, 20, 32, 64, 96, 128, 256)] \
        == [32, 32, 32, 32, 64, 128, 128, 256]
    for b, lq, lk, h, dh in [(4, 100, 1500, 12, 64), (4, 1500, 1500, 12, 64),
                             (4, 116, 116, 12, 128), (1, 1, 5, 1, 256),
                             (2, 9, 37, 8, 256), (1, 64, 4096, 2, 20)]:
        n, per = splits(b, lq, lk, h, dh)
        tiles = -(-lk // TILES[padded_head_dim(dh)][0])
        assert n * per >= tiles > (n - 1) * per
    assert splits(4, 100, 1500, 12, 64) == (6, 8)      # whisper's cross
    assert splits(4, 1500, 1500, 12, 64) == (1, 47)    # whisper's encoder
    assert splits(4, 116, 116, 12, 128) == (3, 3)      # qwen2's prefill


# ----------------------------------------------------------- the model

def _ref_params(R, n, seed=0):
    cfg = R.config(ARCH, reduced=True)
    return R.jax.tree.map(np.asarray, R.LM.init(R.jax.random.PRNGKey(seed),
                                                cfg, R.Mux(n=n)))


@pytest.mark.parametrize("use_kernels", [False, True])
def test_ring_decode_logits_match_reference(use_kernels):
    """As the reference's ``test_kernel_decode_path_matches_naive``: a
    10-token prefill into a 12-slot ring, then decode steps at positions
    10 .. 13 that wrap it (ring decode under use_kernels: the reference's
    Pallas flash-decode in interpret mode, the port's wrapper).  The port
    decodes from its own prefill's cache and from the reference's cache
    carried across; its cache holds the reference's bits throughout."""
    R, n = _reference(), 2
    jnp, RefLM = R.jnp, R.LM
    cfg_r, cfg = R.config(ARCH, reduced=True), get_config(ARCH, reduced=True)
    ref = _ref_params(R, n)
    port = interop.params_from_reference(ref, cfg, device="cpu")
    mux_r, mux = R.Mux(n=n), MuxSpec(n=n)
    toks = np.random.default_rng(0).integers(4, 512, (2 * n, 14)).astype(
        np.int32)
    cache_r = RefLM.init_cache(cfg_r, 2, 12, dtype=jnp.float32)
    out_r = RefLM.apply(ref, cfg_r, jnp.asarray(toks[:, :10]), mux=mux_r,
                        cache=cache_r, dtype=jnp.float32)
    cache = TransformerLM.init_cache(cfg, 2, 12, device="cpu")
    out = TransformerLM.apply(port, cfg, torch.as_tensor(toks[:, :10]),
                              mux=mux, cache=cache, use_kernels=False)
    np.testing.assert_allclose(out["logits"].numpy(),
                               np.asarray(out_r["logits"]), **TOL)
    cache_r = out_r["cache"]
    carried = interop.ring_cache_from_reference(cache_r, cfg, device="cpu")
    for t in range(10, 14):
        step = jnp.asarray(toks[:, t:t + 1])
        want = RefLM.apply(ref, cfg_r, step, mux=mux_r, cache=cache_r,
                           q_offset=t, dtype=jnp.float32,
                           use_kernels=use_kernels)
        cache_r = want["cache"]
        for c in (cache, carried):
            got = TransformerLM.apply(port, cfg, torch.as_tensor(toks[:, t:
                                                                      t + 1]),
                                      mux=mux, cache=c, q_offset=t,
                                      use_kernels=use_kernels)
            np.testing.assert_allclose(got["logits"].numpy(),
                                       np.asarray(want["logits"]), **TOL)
    want = interop.ring_cache_from_reference(cache_r, cfg, device="cpu")
    assert [lc["idx"] for lc in cache["layers"]] == [14] * cfg.n_layers
    for got_l, want_l in zip(cache["layers"], want["layers"]):
        assert torch.equal(got_l["pos"], want_l["pos"])
        assert got_l["idx"] == want_l["idx"]
        torch.testing.assert_close(got_l["k"], want_l["k"], **TOL)
    assert want["layers"][0]["pos"].tolist()[:2] == [12, 13]      # wrapped


@pytest.mark.parametrize("layout", ["ring", "paged"])
@pytest.mark.parametrize("impl", ["naive", "chunked", "flash"])
def test_blocking_prefill_logits_match_reference(impl, layout):
    """``engine.prefill`` of whole prompts (13 tokens, N=2): into a ring,
    or into paged row 1 through ``rows=`` (row 0 and the rest of the pool
    untouched); attention over the fresh K/V with each ``attn_impl``
    (chunked at 4-key chunks; flash: the reference's Pallas kernel in
    interpret mode, the port's wrapper)."""
    R, n = _reference(), 2
    jnp, ref_engine = R.jnp, R.engine
    cfg_r = R.config(ARCH, reduced=True).replace(attn_impl=impl,
                                                 attn_chunk=4)
    cfg = get_config(ARCH, reduced=True).replace(attn_impl=impl,
                                                 attn_chunk=4)
    ref = _ref_params(R, n)
    port = interop.params_from_reference(ref, cfg, device="cpu")
    sc_r = ref_engine.ServeConfig(cfg=cfg_r, kind="lm", mux=R.Mux(n=n),
                                  capacity=24, dtype=jnp.float32,
                                  cache_layout=layout, block_size=4)
    sc = engine.ServeConfig(cfg=cfg, mux=MuxSpec(n=n), capacity=24,
                            cache_layout=layout, block_size=4)
    cache_r = ref_engine.init_cache(sc_r, 2 * n)
    cache = engine.init_cache(sc, 2 * n, device="cpu")
    kw = {}
    toks = np.random.default_rng(1).integers(4, 512, (2 * n, 13)).astype(
        np.int32)
    if layout == "paged":
        pool = ref_engine.make_pool(sc_r, 2 * n)
        pool.allocate(0, 9)
        pool.allocate(1, 13)
        tables = pool.table_array(range(2))
        cache_r = ref_engine.set_block_tables(cache_r, tables)
        engine.set_block_tables(cache, tables)
        kw = {"rows": [1]}
        toks = toks[:n]
    ops.reset_counts()
    want, cache_r = ref_engine.prefill(ref, sc_r, cache_r, jnp.asarray(toks),
                                       **kw)
    got, _ = engine.prefill(port, sc, cache, torch.as_tensor(toks), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    calls = ops.counts("calls")
    assert calls["flash_attention"] == (cfg.n_layers if impl == "flash"
                                        else 0)
    assert sum(calls.values()) == calls["flash_attention"]   # entry, exit
    if layout == "paged":
        layer_r = cache_r["periods"][0]
        for i, lc in enumerate(cache["layers"]):
            want_l = interop.pages_from_reference(
                {k: np.asarray(layer_r[k])[i] for k in ("kp", "ppos")},
                device="cpu")
            assert torch.equal(lc["ppos"], want_l["ppos"])
            torch.testing.assert_close(lc["kp"], want_l["kp"], **TOL)
        row0 = torch.as_tensor(tables[0][:3], dtype=torch.long)
        assert not (cache["layers"][0]["ppos"][row0] >= 0).any()
    else:
        want_c = interop.ring_cache_from_reference(cache_r, cfg,
                                                   device="cpu")
        for got_l, want_l in zip(cache["layers"], want_c["layers"]):
            assert torch.equal(got_l["pos"], want_l["pos"])
            assert got_l["idx"] == want_l["idx"] == 13
            torch.testing.assert_close(got_l["v"], want_l["v"], **TOL)


# ------------------------------------------------------------- on the card

@pytest.mark.cuda
@pytest.mark.parametrize("h,hkv", HEADS)
@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_attention_kernel_on_card(cuda, case, h, hkv):
    args, kw = _decode_inputs(case, h, hkv)
    t = _torch(args, cuda)
    torch.testing.assert_close(ops.decode_attention(*t, **kw),
                               ref.decode_attention_ref(*t, **kw), **ATT_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("h,hkv", HEADS)
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_attention_kernel_on_card(cuda, case, h, hkv):
    args, kw = _flash_inputs(case, h, hkv)
    t = _torch(args, cuda)
    torch.testing.assert_close(ops.flash_attention(*t, **kw),
                               ref.flash_attention_ref(*t, **kw), **ATT_TOL)


@pytest.mark.cuda
def test_dense_kernels_full_width_on_card(cuda):
    """qwen2-1.5b widths (H=12 over Hkv=2, Dh=128): a ring-wrapped decode
    at C=124 and a causal 116-token prefill of 4 rows, plus ragged sizes
    whose fully masked queries Pallas could not show (C=37, Lk=37)."""
    rng = np.random.default_rng(2)

    def r(*s):
        return torch.as_tensor(rng.standard_normal(s, np.float32),
                               device=cuda)
    for c, written, q_pos, window in [(124, 140, 139, None),
                                      (37, 37, 80, 3)]:
        q, k, v = r(4, 1, 12, 128), r(4, c, 2, 128), r(4, c, 2, 128)
        pos = torch.as_tensor(ring_positions(c, written), device=cuda)
        torch.testing.assert_close(
            ops.decode_attention(q, k, v, pos, q_pos=q_pos, window=window),
            ref.decode_attention_ref(q, k, v, pos, q_pos=q_pos,
                                     window=window), **ATT_TOL)
    for lq, lk, kw in [(116, 116, {}), (9, 37, dict(q_offset=36, window=3)),
                       (40, 40, dict(causal=False, logit_softcap=30.0))]:
        q, k, v = r(4, lq, 12, 128), r(4, lk, 2, 128), r(4, lk, 2, 128)
        torch.testing.assert_close(ops.flash_attention(q, k, v, **kw),
                                   ref.flash_attention_ref(q, k, v, **kw),
                                   **ATT_TOL)


@pytest.mark.cuda
def test_dense_kernels_reject_other_dtypes_on_card(cuda):
    q = torch.zeros(1, 4, 4, 16, device=cuda, dtype=torch.bfloat16)
    k = torch.zeros(1, 4, 2, 16, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="fp32"):
        ops.flash_attention(q, k, k)
    pos = torch.arange(4, device=cuda, dtype=torch.int32)
    with pytest.raises(ValueError, match="fp32"):
        ops.decode_attention(q[:, :1], k, k, pos, q_pos=3)


def _dense_inputs(cuda, rng, lq, lk, h, hkv, dh, b=2):
    def r(*s):
        return torch.as_tensor(rng.standard_normal(s, np.float32),
                               device=cuda)
    return r(b, lq, h, dh), r(b, lk, hkv, dh), r(b, lk, hkv, dh)


@pytest.mark.cuda
@pytest.mark.parametrize("lq,kw", [(1500, {}), (100, {})],
                         ids=["encoder", "cross"])
def test_flash_attention_whisper_shapes_on_card(cuda, lq, kw):
    """whisper-small's encoder (bidirectional L=1500) and cross-attention
    (Lq 100 over 1500 frames: the key axis is split over blocks), 12 heads
    of 64, bit for bit over two calls."""
    q, k, v = _dense_inputs(cuda, np.random.default_rng(3), lq, 1500, 12,
                            12, 64)
    got = ops.flash_attention(q, k, v, causal=False)
    torch.testing.assert_close(
        got, ref.flash_attention_ref(q, k, v, causal=False), **ATT_TOL)
    assert torch.equal(got, ops.flash_attention(q, k, v, causal=False))


@pytest.mark.cuda
@pytest.mark.parametrize("lq,lk,dh,kw", [
    (116, 116, 256, {}),                              # gemma-2b's heads
    (9, 37, 256, dict(q_offset=28)),
    (70, 70, 12, {}),                                 # Dh padded to 32
    (100, 130, 20, dict(causal=False, logit_softcap=5.0)),
    (96, 96, 128, dict(window=17)),                   # windowed
    (80, 37, 128, dict(q_offset=36, window=3)),       # fully masked rows
], ids=["gemma_causal", "gemma_offset", "dh12", "dh20_softcap", "window",
        "fully_masked"])
def test_flash_attention_head_dims_on_card(cuda, lq, lk, dh, kw):
    """Dh 256 over one KV head (8 heads), the head dims that pad to the mma
    depth, and a windowed and a fully masked case with Lq >= 64 (several
    warps of a block), bit for bit over two calls."""
    h, hkv = (8, 1) if dh == 256 else (4, 2)
    q, k, v = _dense_inputs(cuda, np.random.default_rng(dh), lq, lk, h, hkv,
                            dh)
    got = ops.flash_attention(q, k, v, **kw)
    torch.testing.assert_close(got, ref.flash_attention_ref(q, k, v, **kw),
                               **ATT_TOL)
    assert torch.equal(got, ops.flash_attention(q, k, v, **kw))
