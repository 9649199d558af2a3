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

Flash-decode's split walk: the plan (shapes only) and a CPU model of the
kernel's walk of each split in tiles and its in-order merge, held to the
plain version and the Pallas kernel over the cases above and a cache
split several times; ``q_pos`` as a 0-d tensor in the plain version.

CUDA (marked ``cuda``, skipped without a card): each kernel against its
plain version on the card at these shapes, ragged and fully masked ones
included, at qwen2-1.5b's widths, at whisper-small's two attention shapes
(the second splits the key axis), at mux-bert-base's (80 rows of 128
and of 130 tokens, bidirectional), at gemma-2b's heads (Dh 256, one KV
head), at head dims that pad to the mma depth, and bit for bit over two
calls; flash-decode with ``q_pos`` as a device tensor, captured in a CUDA
graph and replayed at new positions, at 16 query heads over one KV head
and head dim 256, and at whisper's cross-attention decode; the reduced
VLM's kernel path against its plain path.  The card's machine has no JAX, so
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
from repro_torch.models import VLM, TransformerLM
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


# (batch, heads, kv heads, capacity, head_dim): chip_smoke.py phase 3's
# ring decode and whisper's cross-attention decode, recurrentgemma's 16
# heads over one, gemma-2b's 8 over 1, and small edges
PLAN_SHAPES = [(4, 12, 2, 124, 128), (4, 12, 12, 1500, 64),
               (1, 16, 1, 90, 256), (4, 8, 1, 4096, 256), (1, 1, 1, 5, 8),
               (2, 8, 8, 4096, 128), (4, 12, 2, 16, 128), (1, 2, 2, 100, 16),
               (64, 32, 8, 4096, 128)]


def test_decode_splits_cover_the_cache():
    """The split plan: whole tiles, each slot in exactly one split, none
    empty, at most one cluster of splits (8 past head_dim 128); the main
    path's shape and whisper's as chosen by measurement on the card."""
    from repro_torch.kernels.decode_attention import MAX_SPLITS, TILE, plan
    for b, h, hkv, c, dh in PLAN_SHAPES:
        n, per = plan(b, h, hkv, c, dh)
        assert per % TILE == 0 and n * per >= c > (n - 1) * per
        assert n <= (MAX_SPLITS if dh <= 128 else MAX_SPLITS // 2)
    assert plan(4, 12, 2, 124, 128) == (8, 16)     # 8 splits of one tile
    assert plan(4, 12, 12, 1500, 64) == (16, 96)   # 16 splits of 6 tiles
    assert plan(4, 8, 1, 4096, 256)[0] == 8
    assert plan(64, 32, 8, 4096, 128)[0] <= 2      # enough rows fill it


def test_decode_plan_depends_on_shapes_only():
    """The plan takes integers, never a tensor, and the launcher takes
    q_pos as it comes (an int or a device tensor): no wrapper reads a
    device tensor on the host, so a captured launch can replay."""
    import inspect

    from repro_torch.kernels import decode_attention as kd
    params = inspect.signature(kd.plan).parameters.values()
    assert all(p.annotation in (int, "int") for p in params)
    src = inspect.getsource(kd.decode_attention_cuda)
    assert "plan(b, h, hkv, c, dh)" in src
    assert ".item()" not in src and ".cpu()" not in src
    assert ".tolist()" not in src


NEG = -2.0 ** 30                       # the reference's finite mask value
LOG2E = 1.4426950408889634


def decode_split_model(q, k, v, slot_pos, q_pos, *, plan, tile,
                       window=None, causal=True):
    """The decode kernel's arithmetic: split s walks slots [s * per,
    min(C, (s + 1) * per)) in tiles of ``tile`` with an online softmax in
    log2 units (masked slots at the finite mask value, slots past the run
    at -inf); the splits merge by their log-sum-exp in split order.
    q (B, 1, H, Dh); k, v (B, C, Hkv, Dh); slot_pos (C,)."""
    nsplit, per = plan
    b_n, _, h, dh = q.shape
    c, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    qs = q[:, 0] * dh ** -0.5                              # (B, H, Dh)
    kk = k.repeat_interleave(g, 2)                         # (B, C, H, Dh)
    vv = v.repeat_interleave(g, 2)
    pos = slot_pos.long()
    ok = pos >= 0
    if causal:
        ok = ok & (pos <= q_pos)
    if window is not None:
        ok = ok & (pos > q_pos - window)
    parts = []
    for s in range(nsplit):
        lo, hi = s * per, min(c, (s + 1) * per)
        m = torch.full((b_n, h), -torch.inf)
        l = torch.zeros((b_n, h))
        acc = torch.zeros((b_n, h, dh))
        for t0 in range(lo, lo + -(-(hi - lo) // tile) * tile, tile):
            idx = torch.arange(t0, t0 + tile)
            inside = idx < hi
            idx = idx.clamp(max=c - 1)
            sc = torch.einsum("bhd,bnhd->bhn", qs, kk[:, idx])
            x = torch.where(ok[idx], sc, NEG) * LOG2E
            x = torch.where(inside, x, -torch.inf)
            m_new = torch.maximum(m, x.amax(-1))
            p = torch.exp2(x - m_new[..., None])
            alpha = torch.exp2(m - m_new)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum("bhn,bnhd->bhd", p,
                                                        vv[:, idx])
            m = m_new
        parts.append((m, l, acc))
    m_all = torch.stack([p[0] for p in parts]).amax(0)
    l_all = sum(p[1] * torch.exp2(p[0] - m_all) for p in parts)
    o = sum(p[2] * torch.exp2(p[0] - m_all)[..., None] for p in parts)
    return (o / l_all[..., None])[:, None]


# DECODE_CASES with the card's plan, with one-tile splits, and a cache of
# 300 slots whose plan gives several splits of several tiles
SPLIT_CASES = [(case, "plan") for case in sorted(DECODE_CASES)] + [
    (case, "one_tile") for case in sorted(DECODE_CASES)] + [
    ("long", "plan"), ("long_window", "plan")]
LONG_CASES = {
    # 330 positions into a 300-slot ring, window 40, block_k 20
    "long": (300, ring_positions(300, 330), 329, None, True, 20),
    "long_window": (300, ring_positions(300, 330), 329, 40, True, 20),
}


@pytest.mark.parametrize("case,how", SPLIT_CASES,
                         ids=[f"{c}-{h}" for c, h in SPLIT_CASES])
def test_decode_split_model_matches_plain_and_pallas(case, how):
    """The split walk and in-order merge give the plain version and the
    Pallas kernel (interpret) within ATT_TOL: a wrapped ring, empty slots,
    a window, bidirectional, a query that sees no slot (the mean of V over
    every slot), and several splits of several tiles."""
    from repro_torch.kernels import decode_attention as kd
    R = _reference()
    cases = {**DECODE_CASES, **LONG_CASES}
    c, pos, q_pos, window, causal, block_k = cases[case]
    rng = np.random.default_rng(7)
    q = rng.standard_normal((2, 1, 6, 16), np.float32)
    k = rng.standard_normal((2, c, 2, 16), np.float32)
    v = rng.standard_normal((2, c, 2, 16), np.float32)
    args, kw = (q, k, v, pos), dict(q_pos=q_pos, window=window,
                                    causal=causal)
    t = _torch(args)
    plan = (kd.plan(2, 6, 2, c, 16) if how == "plan"
            else (-(-c // kd.TILE), kd.TILE))
    if case == "long":
        assert plan[0] > 1 and plan[1] > kd.TILE
    got = decode_split_model(*t, q_pos, plan=plan, tile=kd.TILE,
                             window=window, causal=causal)
    torch.testing.assert_close(got, ref.decode_attention_ref(*t, **kw),
                               **ATT_TOL)
    want = R.ops.decode_attention(*map(R.jnp.asarray, args), block_k=block_k,
                                  interpret=True, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATT_TOL)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_plain_takes_q_pos_as_a_tensor(case, dtype):
    """q_pos as a 0-d integer tensor gives the Pallas kernel's result at
    the same int, and the plain version's at the int exactly."""
    R = _reference()
    args, kw = _decode_inputs(case, 4, 2)
    want = R.ops.decode_attention(*map(R.jnp.asarray, args),
                                 block_k=DECODE_CASES[case][-1],
                                 interpret=True, **kw)
    t = _torch(args)
    got = ref.decode_attention_ref(
        *t, **{**kw, "q_pos": torch.tensor(kw["q_pos"], dtype=dtype)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATT_TOL)
    assert torch.equal(got, ref.decode_attention_ref(*t, **kw))


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
                              mux=mux, cache=cache, dtype=torch.float32,
                              use_kernels=False)
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
                                      dtype=torch.float32,
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
                            dtype=torch.float32, cache_layout=layout,
                            block_size=4)
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


def _ring_inputs(cuda, rng, b, c, h, hkv, dh, written):
    def r(*s):
        return torch.as_tensor(rng.standard_normal(s, np.float32),
                               device=cuda)
    pos = torch.as_tensor(ring_positions(c, written), device=cuda)
    return r(b, 1, h, dh), r(b, c, hkv, dh), r(b, c, hkv, dh), pos


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_decode_attention_q_pos_tensor_on_card(cuda, dtype):
    """q_pos as a 0-d device tensor gives the int's result bit for bit,
    over one split and several (the main path's shape), with a window."""
    rng = np.random.default_rng(11)
    for c, written, q_pos, window in [(124, 117, 116, None),
                                      (124, 140, 139, 50), (20, 20, 19, 5)]:
        q, k, v, pos = _ring_inputs(cuda, rng, 4, c, 12, 2, 128, written)
        got = ops.decode_attention(q, k, v, pos, q_pos=q_pos, window=window)
        qp = torch.tensor(q_pos, dtype=dtype, device=cuda)
        assert torch.equal(ops.decode_attention(q, k, v, pos, q_pos=qp,
                                                window=window), got)
        torch.testing.assert_close(
            got, ref.decode_attention_ref(q, k, v, pos, q_pos=qp,
                                          window=window), **ATT_TOL)


@pytest.mark.cuda
def test_decode_attention_replays_under_graph_capture_on_card(cuda):
    """A ring decode captured in a CUDA graph with q_pos in a device
    tensor: after the position tensor, the ring's slot positions and the
    query are overwritten in place, a replay matches the plain version at
    the new position (the split counters reset themselves, so replays
    repeat)."""
    rng = np.random.default_rng(12)
    q, k, v, pos = _ring_inputs(cuda, rng, 4, 124, 12, 2, 128, 117)
    qp = torch.tensor(116, dtype=torch.int32, device=cuda)
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(2):                     # warm up off the graph
            ops.decode_attention(q, k, v, pos, q_pos=qp)
    torch.cuda.current_stream().wait_stream(s)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ops.decode_attention(q, k, v, pos, q_pos=qp)
    for written in (117, 130, 140):
        q.copy_(torch.as_tensor(rng.standard_normal(q.shape, np.float32),
                                device=cuda))
        pos.copy_(torch.as_tensor(ring_positions(124, written), device=cuda))
        qp.fill_(written - 1)
        graph.replay()
        want = ref.decode_attention_ref(q, k, v, pos, q_pos=written - 1)
        torch.testing.assert_close(out, want, **ATT_TOL)
        first = out.clone()
        graph.replay()
        assert torch.equal(out, first)


DECODE_CARD_SHAPES = dict(argnames="b,c,h,hkv,dh,written,q_pos,causal,window",
                          argvalues=[
    (4, 124, 12, 2, 128, 117, 116, True, None),   # the ring decode, 4 splits
    (4, 1500, 12, 12, 64, 1500, 0, False, None),  # whisper's cross decode
    (2, 90, 16, 1, 256, 100, 99, True, None),     # G = 16, Dh = 256
    (2, 37, 16, 1, 256, 37, 80, True, 3),         # ... a query that sees none
    (4, 124, 32, 8, 80, 160, 159, True, 40),      # h2o-danube: Dh 80, window
    (4, 124, 16, 16, 256, 117, 116, True, None),  # gemma-7b: MHA at Dh 256
], ids=["ring", "whisper_cross", "g16_dh256", "g16_dh256_blind",
        "h2o_dh80_window", "gemma7b_mha_dh256"])


@pytest.mark.cuda
@pytest.mark.parametrize(**DECODE_CARD_SHAPES)
def test_decode_attention_limits_and_repeats_on_card(cuda, b, c, h, hkv, dh,
                                                     written, q_pos, causal,
                                                     window):
    """The main shape, whisper's cross-attention decode (several splits of
    several tiles), the limits of 16 query heads over one KV head and head
    dim 256, h2o-danube-1.8b's heads (32 over 8 of 80) over a wrapped ring
    with a window, and gemma-7b's (16 over 16 of 256); within ATT_TOL of
    the plain version and bit for bit over two calls, whichever block
    merges the splits."""
    rng = np.random.default_rng(dh + c)
    q, k, v, pos = _ring_inputs(cuda, rng, b, c, h, hkv, dh, written)
    if not causal:
        pos = torch.arange(c, dtype=torch.int32, device=cuda)
    kw = dict(q_pos=q_pos, causal=causal, window=window)
    got = ops.decode_attention(q, k, v, pos, **kw)
    torch.testing.assert_close(got, ref.decode_attention_ref(q, k, v, pos,
                                                             **kw),
                               **ATT_TOL)
    for _ in range(3):
        assert torch.equal(ops.decode_attention(q, k, v, pos, **kw), got)


@pytest.mark.cuda
@pytest.mark.parametrize(**DECODE_CARD_SHAPES)
def test_decode_attention_bf16_on_card(cuda, b, c, h, hkv, dh, written,
                                       q_pos, causal, window):
    """bf16 q and ring (the compute dtype's): the kernel against its plain
    version (widened, fp32 attention, one rounding) within a bf16 ulp of
    each row's largest value, and bit for bit over repeats."""
    rng = np.random.default_rng(dh + c)
    q, k, v, pos = (x.to(torch.bfloat16) if x.is_floating_point() else x
                    for x in _ring_inputs(cuda, rng, b, c, h, hkv, dh,
                                          written))
    if not causal:
        pos = torch.arange(c, dtype=torch.int32, device=cuda)
    kw = dict(q_pos=q_pos, causal=causal, window=window)
    got = ops.decode_attention(q, k, v, pos, **kw)
    want = ref.decode_attention_ref(q, k, v, pos, **kw)
    assert got.dtype == want.dtype == torch.bfloat16
    err = (got.float() - want.float()).abs()
    assert bool((err <= 2.0 ** -7 * want.float().abs().amax(
        -1, keepdim=True)).all()), err.max().item()
    for _ in range(2):
        assert torch.equal(ops.decode_attention(q, k, v, pos, **kw), got)


@pytest.mark.cuda
def test_decode_attention_bf16_replays_under_graph_capture_on_card(cuda):
    """The bf16 ring decode captured in a CUDA graph, q_pos in a device
    tensor: replays after q, the slot positions and q_pos are overwritten
    equal an eager call at the new position, bit for bit."""
    rng = np.random.default_rng(13)
    q, k, v, pos = (x.to(torch.bfloat16) if x.is_floating_point() else x
                    for x in _ring_inputs(cuda, rng, 4, 124, 12, 2, 128,
                                          117))
    qp = torch.tensor(116, dtype=torch.int32, device=cuda)
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(2):
            ops.decode_attention(q, k, v, pos, q_pos=qp)
    torch.cuda.current_stream().wait_stream(s)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ops.decode_attention(q, k, v, pos, q_pos=qp)
    for written in (117, 130, 140):
        q.copy_(torch.as_tensor(rng.standard_normal(q.shape, np.float32),
                                device=cuda).to(torch.bfloat16))
        pos.copy_(torch.as_tensor(ring_positions(124, written), device=cuda))
        qp.fill_(written - 1)
        graph.replay()
        assert torch.equal(out, ops.decode_attention(q, k, v, pos,
                                                     q_pos=written - 1))


@pytest.mark.cuda
def test_dense_kernels_reject_other_dtypes_on_card(cuda):
    q = torch.zeros(1, 4, 4, 16, device=cuda, dtype=torch.bfloat16)
    k = torch.zeros(1, 4, 2, 16, device=cuda, dtype=torch.bfloat16)
    # flash_attention takes fp32 or bf16, one dtype for q, k and v, and a
    # bf16 head_dim in whole 16-byte rows
    with pytest.raises(ValueError, match="fp32 or bf16"):
        ops.flash_attention(q.half(), k.half(), k.half())
    with pytest.raises(ValueError, match="q's dtype"):
        ops.flash_attention(q, k.float(), k.float())
    with pytest.raises(ValueError, match="head_dim 12"):
        ops.flash_attention(q[..., :12], k[..., :12], k[..., :12])
    pos = torch.arange(4, device=cuda, dtype=torch.int32)
    # decode_attention takes fp32 or bf16, one dtype for q and the cache
    with pytest.raises(ValueError, match="fp32 or bf16"):
        ops.decode_attention(q[:, :1].half(), k.half(), k.half(), pos,
                             q_pos=3)
    with pytest.raises(ValueError, match="q's dtype"):
        ops.decode_attention(q[:, :1], k.float(), k.float(), pos, q_pos=3)
    qf, kf = q[:, :1].float(), k.float()
    for bad in (torch.tensor(3.0, device=cuda), torch.tensor([3], device=cuda),
                torch.tensor(3)):
        with pytest.raises(ValueError, match="q_pos"):
            ops.decode_attention(qf, kf, kf, pos, q_pos=bad)


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
@pytest.mark.parametrize("l", [128, 130], ids=["row", "prefix_row"])
def test_flash_attention_bert_shapes_on_card(cuda, l):
    """mux-bert-base's encoder attention: 80 rows, bidirectional, 12 heads
    of 64, over 128 tokens and over the prefix demux's 2 + 128, bit for
    bit over two calls."""
    q, k, v = _dense_inputs(cuda, np.random.default_rng(l), l, l, 12, 12,
                            64, b=80)
    got = ops.flash_attention(q, k, v, causal=False)
    torch.testing.assert_close(
        got, ref.flash_attention_ref(q, k, v, causal=False), **ATT_TOL)
    assert torch.equal(got, ops.flash_attention(q, k, v, causal=False))


@pytest.mark.cuda
@pytest.mark.parametrize("lq,lk,dh,h,hkv,kw", [
    (116, 116, 256, 8, 1, {}),                        # gemma-2b's heads
    (9, 37, 256, 8, 1, dict(q_offset=28)),
    (70, 70, 12, 4, 2, {}),                           # Dh padded to 32
    (100, 130, 20, 4, 2, dict(causal=False, logit_softcap=5.0)),
    (96, 96, 128, 4, 2, dict(window=17)),             # windowed
    (80, 37, 128, 4, 2, dict(q_offset=36, window=3)),  # fully masked rows
    (300, 300, 80, 32, 8, dict(window=64)),           # h2o-danube's heads
    (116, 116, 256, 16, 16, {}),                      # gemma-7b's heads
], ids=["gemma_causal", "gemma_offset", "dh12", "dh20_softcap", "window",
        "fully_masked", "h2o_dh80_window", "gemma7b_mha_dh256"])
def test_flash_attention_head_dims_on_card(cuda, lq, lk, dh, h, hkv, kw):
    """Dh 256 over one KV head (8 heads) and over 16 (gemma-7b's MHA), the
    head dims that pad to the mma depth (h2o-danube-1.8b's 80 in the 128
    instantiation, 32 heads over 8, windowed), and a windowed and a fully
    masked case with Lq >= 64 (several warps of a block), bit for bit over
    two calls."""
    q, k, v = _dense_inputs(cuda, np.random.default_rng(dh), lq, lk, h, hkv,
                            dh)
    got = ops.flash_attention(q, k, v, **kw)
    torch.testing.assert_close(got, ref.flash_attention_ref(q, k, v, **kw),
                               **ATT_TOL)
    assert torch.equal(got, ops.flash_attention(q, k, v, **kw))


@pytest.mark.cuda
def test_vlm_kernel_path_matches_plain_on_card(cuda):
    """The reduced llava-next-mistral-7b at N=2, 8 patches and 6 tokens:
    the prefill (the mux-combine kernel over the patch-prefixed row, the
    flash kernel once a layer) and a decode step at the true position
    (fused entry, decode attention, fused exit) against the plain path
    from identical caches, within 1e-4."""
    cfg = get_config("llava-next-mistral-7b", reduced=True)
    mux = MuxSpec(n=2)
    params = VLM.init(torch.Generator(device=cuda).manual_seed(7), cfg, mux)
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(4, cfg.vocab_size, (4, 6)),
                           device=cuda)
    pe = torch.as_tensor(rng.standard_normal(
        (4, cfg.frontend_len, 1024)).astype(np.float32), device=cuda)
    p = cfg.frontend_len + 6
    sc = engine.ServeConfig(cfg=cfg.replace(attn_impl="flash"), mux=mux,
                            capacity=p + 8, dtype=torch.float32, kind="vlm")
    sc_plain = engine.ServeConfig(cfg=cfg, mux=mux, capacity=p + 8,
                                  dtype=torch.float32, kind="vlm")
    caches = [engine.init_cache(s, 4, device=cuda) for s in (sc, sc_plain)]
    ops.reset_counts()
    lk, _ = engine.prefill(params, sc, caches[0], toks, extra=pe,
                           use_kernels=True)
    lp, _ = engine.prefill(params, sc_plain, caches[1], toks, extra=pe)
    torch.testing.assert_close(lk, lp, atol=1e-4, rtol=0)
    for a, b in zip(caches[0]["layers"], caches[1]["layers"]):
        for key in ("k", "v", "pos"):
            b[key].copy_(a[key])
    d = lk.argmax(-1)[:, None]
    dk, _ = engine.decode_step(params, sc, caches[0], d, p)
    dp, _ = engine.decode_step(params, sc_plain, caches[1], d, p,
                               use_kernels=False)
    torch.testing.assert_close(dk, dp, atol=1e-4, rtol=0)
    launches = ops.counts("launches")
    assert (launches["mux_combine"], launches["flash_attention"],
            launches["decode_attention"], launches["mux_embed_combine"],
            launches["demux_rsa"]) == (1, cfg.n_layers, cfg.n_layers, 1, 1)
