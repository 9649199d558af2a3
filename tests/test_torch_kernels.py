"""The port's main-path kernels (``repro_torch.kernels``), the two paged
ones for every page storage kind (fp32, bf16, int8, fp8).  The plain
RWKV6 versions and the demux's LN entry are held to the reference in
``tests/test_torch_rwkv.py``; their card tests are here.

CPU: each kernel's plain PyTorch version against the JAX Pallas kernel in
interpret mode, over the edge shapes of ``tests/test_paged_attention.py``
(single-block rows, a chunk ending on a block boundary, non-power-of-2
lengths, B=1, -1 table entries, inactive rows — compared whole: both sides
return the uniform mean of V for a fully masked query), plus the wrappers'
CPU dispatch and counts.  Inputs come from ``np.random.default_rng``.

Tolerances: fp32 on both sides, differing only in summation order — the
reference suite's own kernel-vs-oracle bounds (atol 3e-5 / rtol 1e-4 for
attention over O(1) inputs, 2e-4 for the demux MLP whose two products sum
over D=64 and F=128 terms).

Storage parity (after ``tests/test_paged_attention.py``'s layer): pages
stored as bf16, int8 or fp8 (with their per-slot scales) go through the
port's plain versions and the Pallas kernels in interpret mode; the two
agree within the reference's ``KERNEL_ATOL`` (3e-5: identical dequantized
inputs, reordered fp32 sums), and both stay within the analytic bound of
the pristine fp32 oracle (``core.quant.paged_attention_error_bound`` for
int8/fp8, its relative-rounding analogue for bf16).

The mux-combine entry (``mux_combine_ref``) is held to the Pallas
``mux_combine`` in interpret mode at the reference suite's shapes and
tolerance (``tests/test_kernels.py`` test_mux_combine: fp32 2e-5, bf16
5e-2, where both sides round the bf16 output once); the fused entry
(``mux_embed_ref``) to the Pallas ``mux_embed_combine`` in fp32 and with
a bf16 table, keys and ``out_dtype``.  The two entry kernels' plans
(``csrc/mux_entry.cu``) are checked on shapes alone: every element
covered once, shared memory inside 227 KB, whole 16-byte words or the
per-thread branch.

CUDA (marked ``cuda``, skipped without a card): each kernel against its
plain version on the card, at these shapes and at the full qwen2-1.5b
widths, for every storage kind; the mux-combine kernel in fp32 and bf16
at odd T and D, at N 1 to 10, and at whisper-small's encoder entry,
the qwen2-1.5b and rwkv6-7b prefill entries and mux-bert-base's entry
(2, 10240, 768); the fused entry at its phase-3 shapes (mux-bert-base's
T 10240 over vocab 30522 among them) with fp32 and bf16 tables, keys and
outputs, bit for bit over two calls and replayed from a CUDA graph after
its token ids are overwritten; the demux at T 32 and 40 (two row jobs)
at d 1536, without its exit LayerNorm, with its LN entry at rwkv6-7b's
width and at mux-bert-base's exit (T 10240 at N=2, T 2048 at N=10), and
bit for bit over two calls; the RWKV6 kernel against the chunkwise plain version
(the reference's chunk rule) and the sequential oracle at the reference
suite's kernel tolerance (atol 5e-4, rtol 1e-3), over decode, L of 7,
100, 109, 128 and 300, head dims 16 / 32 / 64 / 128, strong and weak
decay, two halves chained through the state, and bit for bit over two
calls.  The card's machine
has no JAX, so the reference is imported inside the CPU tests only:
``pytest -m cuda`` runs there.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import quant as tq
from repro_torch.kernels import ops, ref
from repro_torch.kernels.demux_rsa import F_TILE
from repro_torch.kernels.demux_rsa import plan as demux_plan

torch.set_num_threads(2)

ATT_TOL = dict(atol=3e-5, rtol=1e-4)
DEMUX_TOL = dict(atol=2e-4, rtol=2e-4)
KERNEL_ATOL = 3e-5              # the reference suite's kernel tolerance
BF16_REL = 2.0 ** -8            # bf16 half-ulp relative rounding error
STORE_KINDS = ["fp32", "bf16", "int8", "fp8"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def build_pool(rng, lens, *, num_blocks, block_size, max_blocks, hkv, dh):
    """Per-row blocks (block 0 = trash) with random K/V; a negative length
    is an unallocated (all -1) row."""
    kp = rng.standard_normal((num_blocks, block_size, hkv, dh), np.float32)
    vp = rng.standard_normal((num_blocks, block_size, hkv, dh), np.float32)
    bt = np.full((len(lens), max_blocks), -1, np.int32)
    ppos = np.full((num_blocks, block_size), -1, np.int32)
    free = list(range(1, num_blocks))
    for b, n in enumerate(lens):
        if n < 0:
            continue
        blocks = [free.pop() for _ in range(-(-n // block_size))]
        bt[b, :len(blocks)] = blocks
        for t in range(n):
            ppos[blocks[t // block_size], t % block_size] = t
    return kp, vp, bt, ppos


# (B, H, Hkv, Dh, BS, MB, P, lens, q_pos, window)
DECODE_CASES = {
    "hetero_inactive": (3, 8, 2, 16, 8, 6, 16, [37, 12, -1], [36, 11, -1],
                        None),
    "window": (3, 8, 2, 16, 8, 6, 16, [37, 12, 20], [36, 11, 19], 12),
    "mha": (3, 8, 8, 16, 8, 6, 16, [37, 12, 5], [36, 11, 4], None),
    "single_block_rows": (3, 4, 2, 8, 8, 1, 8, [8, 3, 1], [7, 2, 0], None),
    "non_pow2": (3, 8, 2, 16, 8, 4, 16, [29, 13, 7], [28, 12, 6], None),
    "b1": (1, 4, 2, 8, 4, 4, 8, [13], [12], None),
}

# (B, Lq, H, Hkv, Dh, BS, MB, P, lens, q_start, q_len)
PREFILL_CASES = {
    "single_block_rows": (2, 4, 4, 2, 8, 8, 1, 8, [8, 6], [4, 2], [4, 4]),
    "block_boundary": (2, 4, 4, 2, 8, 4, 6, 16, [16, 12], [12, 8], [4, 4]),
    "non_pow2_padded": (2, 7, 4, 2, 8, 8, 4, 12, [23, 11], [16, 6], [7, 5]),
    "inactive_row": (2, 4, 4, 2, 8, 4, 4, 12, [10, -1], [6, -1], [4, 0]),
    "b1": (1, 4, 4, 2, 8, 4, 4, 8, [13], [9], [4]),
}


# the card tests' cases besides those above: the split page walk with
# several splits, block sizes 4 and 16, head_dim 256 over one KV head
# (gemma-2b's heads), 16 query heads over one KV head (two blocks of
# heads in the decode kernel), head_dim 32 with a key tile of 64 slots
# over pages of 4, queries that see no slot (a window past the row's
# context), h2o-danube-1.8b's heads (head_dim 80 in the 128 instantiation,
# 32 over 8 KV heads) with a window that cuts the context and skips whole
# pages, and gemma-7b's (MHA at head_dim 256, 16 over 16); a prefill case
# may end in its window
CARD_DECODE_CASES = {
    **DECODE_CASES,
    "bs4_splits": (4, 12, 2, 32, 4, 32, 70, [117, 100, 37, -1],
                   [116, 99, 36, -1], None),
    "bs16_splits": (3, 12, 2, 64, 16, 8, 24, [117, 60, 5], [116, 59, 4],
                    None),
    "dh256_one_kv": (2, 8, 1, 256, 16, 8, 20, [117, 30], [116, 29], None),
    "g16_head_groups": (2, 16, 1, 32, 8, 4, 10, [29, 13], [28, 12], None),
    "window_blind": (3, 8, 2, 16, 4, 8, 24, [20, 12, 30], [40, 11, 29], 8),
    "dh80_g4_window": (3, 32, 8, 80, 16, 8, 16, [117, 60, 5], [116, 59, 4],
                       40),
    "dh256_mha16": (2, 16, 16, 256, 16, 8, 20, [117, 30], [116, 29], None),
}
CARD_PREFILL_CASES = {
    **PREFILL_CASES,
    "chunk32_bs4": (1, 32, 12, 2, 128, 4, 32, 40, [96], [64], [32]),
    "bs16_splits_dh64": (2, 8, 12, 2, 64, 16, 8, 20, [48, 100], [40, 92],
                         [8, 8]),
    "dh256_one_kv": (1, 16, 8, 1, 256, 16, 8, 12, [80], [64], [16]),
    "dh32_bs4": (2, 5, 4, 2, 32, 4, 16, 40, [50, 23], [45, 18], [5, 3]),
    "dh80_g4_window": (2, 16, 32, 8, 80, 16, 8, 20, [80, 48], [64, 40],
                       [16, 8], 24),
    "dh256_mha16": (1, 16, 16, 16, 256, 16, 8, 12, [80], [64], [16]),
}


def _prefill_window(case):
    """The window of a card prefill case (None: no window)."""
    spec = CARD_PREFILL_CASES[case]
    return spec[11] if len(spec) > 11 else None


def _decode_inputs(case, seed=0):
    b, h, hkv, dh, bs, mb, p, lens, q_pos, window = CARD_DECODE_CASES[case]
    rng = np.random.default_rng(seed)
    kp, vp, bt, ppos = build_pool(rng, lens, num_blocks=p, block_size=bs,
                                  max_blocks=mb, hkv=hkv, dh=dh)
    q = rng.standard_normal((b, 1, h, dh), np.float32)
    return (q, kp, vp, bt, ppos, np.asarray(q_pos, np.int32)), window


def _prefill_inputs(case, seed=0):
    spec = CARD_PREFILL_CASES[case][:11]
    b, lq, h, hkv, dh, bs, mb, p, lens, qs, ql = spec
    rng = np.random.default_rng(seed)
    kp, vp, bt, ppos = build_pool(rng, lens, num_blocks=p, block_size=bs,
                                  max_blocks=mb, hkv=hkv, dh=dh)
    q = rng.standard_normal((b, lq, h, dh), np.float32)
    return (q, kp, vp, bt, ppos, np.asarray(qs, np.int32),
            np.asarray(ql, np.int32))


def _pallas():
    """The reference's kernel wrappers and jnp (imported on use)."""
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    return jops, jnp


def _torch(args, device="cpu"):
    return [torch.as_tensor(a, device=device) for a in args]


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_paged_attention_plain_matches_pallas(case):
    jops, jnp = _pallas()
    args, window = _decode_inputs(case)
    want = jops.paged_attention(*map(jnp.asarray, args), window=window,
                                interpret=True)
    got = ref.paged_attention_ref(*_torch(args), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATT_TOL)


@pytest.mark.parametrize("case", sorted(PREFILL_CASES))
def test_paged_prefill_plain_matches_pallas(case):
    jops, jnp = _pallas()
    args = _prefill_inputs(case)
    want = jops.paged_prefill_attention(*map(jnp.asarray, args),
                                        interpret=True)
    got = ref.paged_prefill_attention_ref(*_torch(args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATT_TOL)


def _mux_inputs(n, t, vocab=97, d=48, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, vocab, (n, t)).astype(np.int32),
            rng.standard_normal((vocab, d), np.float32),
            rng.standard_normal((n, d), np.float32))


MUX_COMBINE_TOL = {"fp32": 2e-5, "bf16": 5e-2}   # tests/test_kernels.py TOL


def _combine_inputs(n, t, d, dtype="fp32", seed=0):
    """x (N, T, D), v (N, D) from numpy, as torch tensors of ``dtype``."""
    rng = np.random.default_rng(seed)
    dt = torch.float32 if dtype == "fp32" else torch.bfloat16
    return (torch.as_tensor(rng.standard_normal((n, t, d), np.float32)).to(dt),
            torch.as_tensor(rng.standard_normal((n, d), np.float32)).to(dt))


@pytest.mark.parametrize("n,t,d", [(2, 64, 128), (5, 100, 96), (10, 33, 200)])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_mux_combine_plain_matches_pallas(n, t, d, dtype):
    """The reference suite's shapes (T and D not multiples of its tiles)
    and tolerance; the bf16 inputs are the same bf16 values on both
    sides."""
    import jax.numpy as jnp
    from repro.kernels.mux_combine import mux_combine
    x, v = _combine_inputs(n, t, d, dtype)
    jdt = jnp.float32 if dtype == "fp32" else jnp.bfloat16
    want = mux_combine(jnp.asarray(x.float().numpy()).astype(jdt),
                       jnp.asarray(v.float().numpy()).astype(jdt),
                       block_t=32, block_d=64, interpret=True)
    got = ref.mux_combine_ref(x, v)
    assert got.dtype == x.dtype and got.shape == (t, d)
    tol = MUX_COMBINE_TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("n,t,scale,dtype", [(2, 4, 1.0, "fp32"),
                                             (2, 32, 1.0, "fp32"),
                                             (4, 7, 8.0, "fp32"),
                                             (1, 3, 1.0, "fp32"),
                                             (2, 4, 1.0, "bf16"),
                                             (4, 7, 8.0, "bf16")])
def test_mux_embed_plain_matches_pallas(n, t, scale, dtype):
    """fp32: within 1e-5.  bf16 (bf16 table and keys, ``out_dtype``
    bf16): the same bf16 inputs on both sides, and each side's output
    within one bf16 half-ulp (relative) of the Pallas kernel's fp32 sum,
    since both round that sum once."""
    jops, jnp = _pallas()
    args = _mux_inputs(n, t)
    if dtype == "fp32":
        want = jops.mux_embed_combine(*map(jnp.asarray, args), scale=scale,
                                      block_d=16, interpret=True)
        got = ref.mux_embed_ref(*_torch(args), scale=scale)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-5)
        return
    tok, emb, v = _torch(args)
    emb, v = emb.to(torch.bfloat16), v.to(torch.bfloat16)
    jargs = (jnp.asarray(tok.numpy()),
             jnp.asarray(emb.float().numpy()).astype(jnp.bfloat16),
             jnp.asarray(v.float().numpy()).astype(jnp.bfloat16))
    sum32, want = (np.asarray(jops.mux_embed_combine(
        *jargs, scale=scale, block_d=16, out_dtype=od,
        interpret=True).astype(jnp.float32))
        for od in (jnp.float32, jnp.bfloat16))
    got = ref.mux_embed_ref(tok, emb, v, scale=scale,
                            out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == (t, 48)
    bound = BF16_REL * np.abs(sum32) + 1e-6
    assert (np.abs(got.float().numpy() - sum32) <= bound).all()
    assert (np.abs(want - sum32) <= bound).all()


def _demux_inputs(t, n=2, d=64, f=128, seed=0, entry="rms"):
    rng = np.random.default_rng(seed)

    def r(*shape, s=1.0):
        return (rng.standard_normal(shape) * s).astype(np.float32)
    args = (r(t, d), r(n, d), r(d, f, s=0.1), r(d, f, s=0.1), r(f, s=0.1),
            r(f, d, s=0.1), r(d, s=0.1))
    norms = {"entry_kind": entry, "entry_scale": r(d, s=0.1),
             "exit_scale": r(d, s=0.1) + 1.0, "exit_bias": r(d, s=0.1)}
    if entry == "ln":
        # a backbone state with an offset, as LayerNorm's input has
        args = (args[0] + 3.0, *args[1:])
        norms["entry_scale"] += 1.0
        norms["entry_bias"] = r(d, s=0.1)
    return args, norms


@pytest.mark.parametrize("t", [4, 32, 5])
def test_demux_rsa_plain_matches_pallas(t):
    jops, jnp = _pallas()
    args, norms = _demux_inputs(t)
    want = jops.demux_rsa(*map(jnp.asarray, args), block_t=16, block_f=64,
                          interpret=True,
                          **{k: v if isinstance(v, str) else jnp.asarray(v)
                             for k, v in norms.items()})
    got = ref.demux_rsa_fused_ref(
        *_torch(args), **{k: v if isinstance(v, str) else torch.as_tensor(v)
                          for k, v in norms.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **DEMUX_TOL)


def _rwkv_inputs(b, l, h, d, seed=0, logw=None):
    """r, k, v, logw (B, L, H, d), u (H, d), s0 (B, H, d, d) as the
    reference suite draws them (``tests/test_kernels.py`` test_rwkv6);
    ``logw`` fixes the log decay instead (the strong / weak edges)."""
    rng = np.random.default_rng(seed)

    def r(*shape, s=1.0):
        return (rng.standard_normal(shape) * s).astype(np.float32)
    shape = (b, l, h, d)
    lw = (-np.exp(r(*shape, s=0.5)) if logw is None else
          np.full(shape, logw, np.float32))
    return (r(*shape), r(*shape, s=0.5), r(*shape), lw.astype(np.float32),
            r(h, d, s=0.1), r(b, h, d, d, s=0.1))


def test_wrappers_use_plain_versions_on_cpu():
    """On CPU tensors every wrapper counts the call, launches nothing and
    returns exactly its plain version's result."""
    ops.reset_counts()
    args, window = _decode_inputs("hetero_inactive")
    t = _torch(args)
    assert torch.equal(ops.paged_attention(*t, window=window),
                       ref.paged_attention_ref(*t, window=window))
    t = _torch(_prefill_inputs("block_boundary"))
    assert torch.equal(ops.paged_prefill_attention(*t),
                       ref.paged_prefill_attention_ref(*t))
    t = _torch(_mux_inputs(2, 4))
    assert torch.equal(ops.mux_embed_combine(*t), ref.mux_embed_ref(*t))
    args, norms = _demux_inputs(4)
    norms = {k: v if isinstance(v, str) else torch.as_tensor(v)
             for k, v in norms.items()}
    t = _torch(args)
    h3 = t[0].reshape(2, 2, -1)
    got = ops.demux_rsa(h3, *t[1:], **norms)
    assert got.shape == (2, 2, 2, 64)
    assert torch.equal(got.reshape(2, 4, 64),
                       ref.demux_rsa_fused_ref(*t, **norms))
    rng = np.random.default_rng(0)
    q, k, v = (torch.as_tensor(rng.standard_normal(s, np.float32))
               for s in ((2, 1, 4, 8), (2, 6, 2, 8), (2, 6, 2, 8)))
    pos = torch.tensor([0, 1, 2, -1, 4, 5], dtype=torch.int32)
    assert torch.equal(ops.decode_attention(q, k, v, pos, q_pos=4),
                       ref.decode_attention_ref(q, k, v, pos, q_pos=4))
    assert torch.equal(ops.flash_attention(q, k, v, q_offset=3),
                       ref.flash_attention_ref(q, k, v, q_offset=3))
    rw = _torch(_rwkv_inputs(2, 8, 2, 8))
    got = ops.rwkv6_chunked(*rw, chunk=4)
    want = ref.rwkv_chunked(*rw, 4)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    x, v = _combine_inputs(3, 5, 24)
    assert torch.equal(ops.mux_combine(x, v), ref.mux_combine_ref(x, v))
    assert ops.counts("calls") == dict.fromkeys(ops.counts(), 1)
    assert ops.counts("launches") == dict.fromkeys(ops.counts(), 0)


def test_kernel_launchers_reject_cpu_tensors():
    """The kernel entry points launch on CUDA tensors only — a CPU tensor
    is an error there, never a silent fallback."""
    from repro_torch.kernels import (demux_rsa, mux_combine, mux_embed,
                                     paged_attention, rwkv6)
    args, _ = _decode_inputs("b1")
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention.paged_attention_cuda(*_torch(args))
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention.paged_prefill_attention_cuda(
            *_torch(_prefill_inputs("b1")))
    with pytest.raises(ValueError, match="CUDA"):
        mux_embed.mux_embed_combine_cuda(*_torch(_mux_inputs(2, 4)))
    args, _ = _demux_inputs(4)
    with pytest.raises(ValueError, match="CUDA"):
        demux_rsa.demux_rsa_cuda(*_torch(args))
    with pytest.raises(ValueError, match="CUDA"):
        rwkv6.rwkv6_cuda(*_torch(_rwkv_inputs(1, 3, 2, 16)))
    with pytest.raises(ValueError, match="CUDA"):
        mux_combine.mux_combine_cuda(*_combine_inputs(2, 4, 8))


# ------------------------------------------------- page storage kinds

def _store(kind, kp, vp, device="cpu"):
    """fp32 numpy pages stored as ``kind`` the way the pool stores them:
    (k_pages, v_pages, scale kwargs) as tensors on ``device``."""
    k, v = torch.as_tensor(kp, device=device), torch.as_tensor(vp,
                                                               device=device)
    if kind not in tq.KV_QUANT_KINDS:
        dt = tq.kv_store_dtype(kind)
        return k.to(dt), v.to(dt), {}
    kq, ks = tq.quantize_kv(k, kind)
    vq, vs = tq.quantize_kv(v, kind)
    return kq, vq, {"k_scales": ks, "v_scales": vs}


def _to_jax(t):
    """A CPU tensor as a JAX array, bit for bit (bf16 and fp8 cross as
    raw bits: ``.numpy()`` refuses them)."""
    import jax.numpy as jnp
    views = {torch.bfloat16: (torch.int16, jnp.bfloat16),
             torch.float8_e4m3fn: (torch.uint8, jnp.float8_e4m3fn)}
    if t.dtype in views:
        bits, dt = views[t.dtype]
        return jnp.asarray(t.view(bits).numpy().view(dt))
    return jnp.asarray(t.numpy())


def _storage_bound(q, kind, kp, vp, scale_kw):
    """Analytic |attention over stored pages - pristine fp32 oracle|
    bound (tests/test_paged_attention.py ``_storage_bound``)."""
    if kind == "fp32":
        return 0.0
    if kind == "bf16":
        q_l1 = float(q.abs().sum(-1).max())
        e_k = BF16_REL * float(np.abs(kp).max())
        v_max = float(np.abs(vp).max())
        e_v = BF16_REL * v_max
        return 2.0 * q_l1 * e_k * q.shape[-1] ** -0.5 * (v_max + e_v) + e_v
    return float(tq.paged_attention_error_bound(
        q, scale_kw["k_scales"], scale_kw["v_scales"], kind))


# tests/test_paged_attention.py's storage-parity cases: (lens, q_pos, MB)
# at B=len(lens), H=8, Hkv=2, Dh=16, BS=8, P=32
STORAGE_DECODE_CASES = {
    "hetero_inactive": ([37, 12, -1], [36, 11, -1], 6),
    "single_block_rows": ([8, 3, 1], [7, 2, 0], 1),
    "non_pow2": ([29, 13, 7], [28, 12, 6], 4),
}


@pytest.mark.parametrize("case", sorted(STORAGE_DECODE_CASES))
@pytest.mark.parametrize("kind", STORE_KINDS)
def test_paged_decode_storage_parity(kind, case):
    jops, jnp = _pallas()
    lens, q_pos, mb = STORAGE_DECODE_CASES[case]
    rng = np.random.default_rng(mb)
    kp, vp, bt, ppos = build_pool(rng, lens, num_blocks=32, block_size=8,
                                  max_blocks=mb, hkv=2, dh=16)
    q = torch.as_tensor(rng.standard_normal((len(lens), 1, 8, 16),
                                            np.float32))
    qp, bt, ppos = map(torch.as_tensor, (np.asarray(q_pos, np.int32), bt,
                                         ppos))
    ks, vs, scale_kw = _store(kind, kp, vp)
    got = ops.paged_attention(q, ks, vs, bt, ppos, qp, **scale_kw)
    want = jops.paged_attention(
        *map(_to_jax, (q, ks, vs, bt, ppos, qp)), interpret=True,
        **{k: _to_jax(v) for k, v in scale_kw.items()})
    # (a) the plain version == the Pallas kernel on the same stored pages
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=KERNEL_ATOL, rtol=1e-4)
    # (b) within the analytic bound of the pristine fp32 oracle
    act = qp.numpy() >= 0
    pristine = ref.paged_attention_ref(q, torch.as_tensor(kp),
                                       torch.as_tensor(vp), bt, ppos, qp)
    err = (got - pristine).abs().numpy()[act].max()
    assert err <= _storage_bound(q, kind, kp, vp, scale_kw) + KERNEL_ATOL
    assert kind == "fp32" or err > 0          # the storage is not fp32


@pytest.mark.parametrize("kind", STORE_KINDS)
def test_paged_prefill_storage_parity(kind):
    """A non-power-of-2 chunk with a padded row (the reference's case)."""
    jops, jnp = _pallas()
    rng = np.random.default_rng(0)
    kp, vp, bt, ppos = build_pool(rng, [23, 11], num_blocks=12, block_size=8,
                                  max_blocks=4, hkv=2, dh=8)
    q = torch.as_tensor(rng.standard_normal((2, 7, 4, 8), np.float32))
    qs, ql, bt, ppos = map(torch.as_tensor, (np.asarray([16, 6], np.int32),
                                             np.asarray([7, 5], np.int32),
                                             bt, ppos))
    ks, vs, scale_kw = _store(kind, kp, vp)
    got = ops.paged_prefill_attention(q, ks, vs, bt, ppos, qs, ql,
                                      **scale_kw)
    want = jops.paged_prefill_attention(
        *map(_to_jax, (q, ks, vs, bt, ppos, qs, ql)), interpret=True,
        **{k: _to_jax(v) for k, v in scale_kw.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=KERNEL_ATOL, rtol=1e-4)
    pristine = ref.paged_prefill_attention_ref(
        q, torch.as_tensor(kp), torch.as_tensor(vp), bt, ppos, qs, ql)
    bound = _storage_bound(q, kind, kp, vp, scale_kw) + KERNEL_ATOL
    for sl in (np.s_[0], np.s_[1, :5]):          # skip padded queries
        assert (got - pristine).abs().numpy()[sl].max() <= bound


def test_wrappers_check_page_storage():
    """Quantized pages need both scales, fp pages take none, scales must
    be fp32 (P, BS, Hkv); on the CPU a wrapper with scales returns its
    dequantize-then-attend plain version."""
    args, _ = _decode_inputs("hetero_inactive")
    q, kp, vp, bt, ppos, qp = _torch(args)
    k8, v8, sc = _store("int8", args[1], args[2])
    ops.reset_counts()
    assert torch.equal(ops.paged_attention(q, k8, v8, bt, ppos, qp, **sc),
                       ref.paged_attention_quant_ref(q, k8, v8, sc["k_scales"],
                                                     sc["v_scales"], bt, ppos,
                                                     qp))
    assert ops.paged_attention.launches == 0            # CPU: plain version
    assert not ops.paged_attention.by_storage
    with pytest.raises(ValueError, match="need both"):
        ops.paged_attention(q, k8, v8, bt, ppos, qp)
    with pytest.raises(ValueError, match="need both"):
        ops.paged_attention(q, k8, v8, bt, ppos, qp,
                            k_scales=sc["k_scales"])
    with pytest.raises(ValueError, match="not quantized"):
        ops.paged_attention(q, kp, vp, bt, ppos, qp, **sc)
    with pytest.raises(ValueError, match="not quantized"):
        ops.paged_attention(q, kp.bfloat16(), vp.bfloat16(), bt, ppos, qp,
                            **sc)
    with pytest.raises(ValueError, match="k_scales"):
        ops.paged_attention(q, k8, v8, bt, ppos, qp,
                            k_scales=sc["k_scales"][..., :1],
                            v_scales=sc["v_scales"])
    with pytest.raises(ValueError, match="need one of"):
        ops.paged_attention(q, kp.half(), vp.half(), bt, ppos, qp)
    t = _torch(_prefill_inputs("b1"))
    with pytest.raises(ValueError, match="need both"):
        ops.paged_prefill_attention(t[0], *_store("fp8", *_prefill_inputs(
            "b1")[1:3])[:2], *t[3:])


# ------------------------------------------------------------- on the card

@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CARD_DECODE_CASES))
def test_paged_attention_kernel_on_card(cuda, case):
    args, window = _decode_inputs(case)
    t = _torch(args, cuda)
    got = ops.paged_attention(*t, window=window)
    want = ref.paged_attention_ref(*t, window=window)
    torch.testing.assert_close(got, want, **ATT_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CARD_PREFILL_CASES))
def test_paged_prefill_kernel_on_card(cuda, case):
    t = _torch(_prefill_inputs(case), cuda)
    window = _prefill_window(case)
    torch.testing.assert_close(ops.paged_prefill_attention(*t, window=window),
                               ref.paged_prefill_attention_ref(
                                   *t, window=window), **ATT_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, 8])
def test_paged_prefill_window_on_card(cuda, window):
    """A window, and a chunk past the row's context, so that some queries
    see no slot and return the uniform mean of V over every gathered
    slot."""
    rng = np.random.default_rng(3)
    kp, vp, bt, ppos = build_pool(rng, [20, 40], num_blocks=24,
                                  block_size=4, max_blocks=12, hkv=2, dh=64)
    q = rng.standard_normal((2, 8, 12, 64), np.float32)
    t = _torch((q, kp, vp, bt, ppos, np.asarray([40, 30], np.int32),
                np.asarray([8, 6], np.int32)), cuda)
    torch.testing.assert_close(
        ops.paged_prefill_attention(*t, window=window),
        ref.paged_prefill_attention_ref(*t, window=window), **ATT_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", STORE_KINDS)
def test_paged_kernels_are_bitwise_repeatable_on_card(cuda, kind):
    """The splits merge in a fixed order with no atomics: two calls give
    the same bits, at the main path's widths and at BS 4."""
    for dcase, pcase in [("bs16_splits", "chunk32_bs4"),
                         ("bs4_splits", "bs16_splits_dh64")]:
        (q, kp, vp, *rest), window = _decode_inputs(dcase)
        ks, vs, sc = _store(kind, kp, vp, cuda)
        t = _torch((q, *rest), cuda)
        a, b = (ops.paged_attention(t[0], ks, vs, *t[1:], window=window,
                                    **sc) for _ in range(2))
        assert torch.equal(a, b)
        q, kp, vp, *rest = _prefill_inputs(pcase)
        ks, vs, sc = _store(kind, kp, vp, cuda)
        t = _torch((q, *rest), cuda)
        a, b = (ops.paged_prefill_attention(t[0], ks, vs, *t[1:], **sc)
                for _ in range(2))
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("n,t,d", [(2, 64, 128), (5, 100, 96), (10, 33, 200),
                                   (1, 7, 5), (3, 17, 257),
                                   (2, 6000, 768), (2, 400, 1536),
                                   (2, 436, 4096), (10, 64, 4096),
                                   (2, 10240, 768)])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_mux_combine_kernel_on_card(cuda, n, t, d, dtype):
    """The kernel against its plain version in the working dtype: fp32
    within 2e-5, bf16 within 5e-2 (the reference suite's tolerance; both
    round the fp32 sum to bf16 once).  The wrapper launches it."""
    x, v = (a.to(cuda) for a in _combine_inputs(n, t, d, dtype))
    ops.reset_counts()
    got = ops.mux_combine(x, v)
    assert ops.mux_combine.launches == 1
    assert got.dtype == x.dtype and got.shape == (t, d)
    tol = MUX_COMBINE_TOL[dtype]
    torch.testing.assert_close(got.float(), ref.mux_combine_ref(x, v).float(),
                               atol=tol, rtol=tol)


# (N, T, vocab, D): phase 3's shapes (qwen2-1.5b decode and chunk,
# rwkv6-7b, whisper's decoder, mux-bert-base's entry of 80 rows of 128
# tokens), narrow and odd widths (D % 8 != 0 takes the per-thread
# branch), N up to 10
EMBED_CARD_CASES = [(2, 4, 97, 48), (2, 4, 151936, 1536),
                    (2, 32, 151936, 1536), (2, 4, 65536, 4096),
                    (2, 4, 51865, 768), (2, 10240, 30522, 768),
                    (3, 5, 1000, 600), (1, 7, 97, 5), (10, 3, 50, 12),
                    (10, 9, 300, 4096)]
# (emb, v, out) dtypes
EMBED_DTYPES = {"fp32": (torch.float32,) * 3, "bf16": (torch.bfloat16,) * 3,
                "fp32 emb, bf16 v and out": (torch.float32, torch.bfloat16,
                                             torch.bfloat16)}


@pytest.mark.cuda
@pytest.mark.parametrize("n,t,vocab,d", EMBED_CARD_CASES)
@pytest.mark.parametrize("dtypes", sorted(EMBED_DTYPES))
def test_mux_embed_kernel_on_card(cuda, n, t, vocab, d, dtypes):
    """The kernel against its plain version: fp32 within 1e-5; a bf16
    output within one bf16 half-ulp (relative) of the plain version's
    fp32 sum, which both round once.  The wrapper launches it once."""
    et, vt, ot = EMBED_DTYPES[dtypes]
    tok, emb, v = _torch(_mux_inputs(n, t, vocab=vocab, d=d), cuda)
    emb, v = emb.to(et), v.to(vt)
    ops.reset_counts()
    got = ops.mux_embed_combine(tok, emb, v, scale=2.0, out_dtype=ot)
    assert ops.mux_embed_combine.launches == 1
    assert got.dtype == ot and got.shape == (t, d)
    sum32 = ref.mux_embed_ref(tok, emb, v, scale=2.0)
    if ot == torch.float32:
        torch.testing.assert_close(got, sum32, atol=1e-5, rtol=1e-5)
    else:
        err = (got.float() - sum32).abs()
        assert (err <= BF16_REL * sum32.abs() + 1e-5).all()


@pytest.mark.cuda
def test_mux_entry_kernels_are_bitwise_repeatable_on_card(cuda):
    """Each output element is one thread's sum in a fixed order: two calls
    give the same bits, for both entry kernels, at the serving shapes and
    at mux-bert-base's (T 10240, d 768, vocab 30522)."""
    for t, vocab, d in ((32, 151936, 1536), (10240, 30522, 768)):
        a = _torch(_mux_inputs(2, t, vocab=vocab, d=d), cuda)
        assert torch.equal(ops.mux_embed_combine(*a),
                           ops.mux_embed_combine(*a))
    for t in (6000, 10240):
        x, v = (a.to(cuda) for a in _combine_inputs(2, t, 768))
        assert torch.equal(ops.mux_combine(x, v), ops.mux_combine(x, v))


@pytest.mark.cuda
def test_mux_embed_replays_in_a_cuda_graph_on_card(cuda):
    """One launch captured in a CUDA graph reads the token ids where they
    lie: replayed after the ids are overwritten, it gives the new ids'
    rows (the plan reads shapes only, the kernel keeps no state)."""
    tok, emb, v = _torch(_mux_inputs(2, 4, vocab=151936, d=1536), cuda)
    new = torch.as_tensor(_mux_inputs(2, 4, vocab=151936, d=1536, seed=1)[0],
                          device=cuda)
    ops.mux_embed_combine(tok, emb, v, scale=2.0)      # build and warm up
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = ops.mux_embed_combine(tok, emb, v, scale=2.0)
    tok.copy_(new)
    g.replay()
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref.mux_embed_ref(new, emb, v, scale=2.0),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("elt", [4, 2])
@pytest.mark.parametrize("n", [1, 2, 5, 10])
def test_mux_embed_plan_covers_each_row_once(n, elt):
    """The entry kernel's D-slices (one block each) cover a token's row
    once; the vector branch is taken exactly where d % 8 == 0 and the
    tensors are aligned, and then every slice is whole 16-byte words; a
    block fits in 256 threads, enough for one 16-byte word a thread; at
    T=4 the real widths take at least 2 slices a token."""
    from repro_torch.kernels import mux_embed as km
    for t in (1, 4, 32, 400):
        for d in (5, 12, 48, 257, 600, 768, 1536, 2048, 3072, 4096):
            for aligned in (True, False):
                p = km.plan(n, t, d, elt, aligned)
                slices = -(-d // p.cols)
                starts = [s * p.cols for s in range(slices)]
                widths = [min(p.cols, d - c0) for c0 in starts]
                assert sum(widths) == d and min(widths) > 0
                assert p.vector == (aligned and d % 8 == 0)
                assert p.threads <= 256
                assert p.threads % 32 == 0 and p.cols <= d
                if p.vector:
                    assert all(c0 * elt % 16 == 0 and w * elt % 16 == 0
                               for c0, w in zip(starts, widths))
                    assert 16 * p.threads >= p.cols * elt
                if t == 4 and d >= 512:
                    assert slices >= 2


def _combine_tiles(p, t, d):
    """The tiles ``mux_combine_kernel`` takes under plan ``p``, as the
    source computes them: block (x, y) of the grid (tiles, slices) takes
    row tile x of D-slice y (the per-thread branch: one slice).  Yields
    (rows, columns) ranges and the block."""
    tiles = p.grid // p.slices
    assert tiles == -(-t // p.rows)
    for x in range(tiles):
        for y in range(p.slices):
            t0, c0 = x * p.rows, y * p.cols
            yield (t0, min(t0 + p.rows, t)), (c0, min(c0 + p.cols, d)), (x, y)


def _direct_rows_once(p, elt):
    """The vector branch's block (chunks, groups): thread row ty takes rows
    r0 + u * groups of its tile, r0 = ty, ty + groups * U, ..., U rows at
    once (``combine_direct``); every row of a full tile exactly once."""
    from repro_torch.kernels import mux_combine as kc
    groups = p.threads // -(-p.cols * elt // 16)
    unroll = kc.UNROLL[elt]
    rows = [r0 + u * groups for ty in range(groups)
            for r0 in range(ty, p.rows, groups * unroll)
            for u in range(min(unroll, -(-(p.rows - r0) // groups)))]
    assert sorted(rows) == list(range(p.rows))


@pytest.mark.parametrize("elt", [4, 2])
@pytest.mark.parametrize("n", [1, 2, 5, 10])
def test_mux_combine_plan_covers_each_element_once(n, elt):
    """The combine kernel's grid covers every (t, d) element exactly once
    with one tile a block, for N up to 10 and D up to 4096 (no shape is
    refused); in the vector branch every tile row is whole 16-byte words
    and a block holds a thread for each of them, else the per-thread
    branch is taken."""
    from repro_torch.kernels import mux_combine as kc
    for t in (1, 7, 33, 400, 436, 6000):
        for d in (5, 96, 200, 257, 768, 1536, 4096):
            for aligned in (True, False):
                p = kc.plan(n, t, d, elt, aligned=aligned)
                assert p.vector == (aligned and d % 8 == 0)
                assert p.grid % p.slices == 0 and p.cols <= d
                assert p.slices == -(-d // p.cols)
                assert 1 <= p.threads <= 256
                if p.vector:                 # a thread a chunk of a row
                    assert p.threads % -(-p.cols * elt // 16) == 0
                seen = np.zeros((t, p.slices), np.int32)
                blocks = set()
                for (t0, t1), (c0, c1), b in _combine_tiles(p, t, d):
                    seen[t0:t1, c0 // p.cols] += 1
                    blocks.add(b)
                    if p.vector:
                        assert (c1 - c0) * elt % 16 == 0
                        assert c0 * elt % 16 == 0
                assert (seen == 1).all() and len(blocks) == p.grid
                if p.vector:
                    _direct_rows_once(p, elt)
    # whisper's encoder entry: whole rows of D, several rows a tile
    p = kc.plan(2, 6000, 768, 4)
    assert p.slices == 1 and p.rows > 1


def test_demux_plan_streams_each_weight_once():
    """The demux kernels' split: slices cover the reduction axes with none
    empty, whole ring stages, at most 32 slices of D (one lane each), and
    a block's staged rows and ring inside three blocks an SM."""
    from repro_torch.kernels import demux_rsa as kd
    for t, n, d, f, entry in [(4, 2, 1536, 3072, "rms"),
                              (32, 2, 1536, 3072, "rms"),
                              (32, 2, 4096, 8192, "ln"),
                              (4, 2, 768, 1536, "ln"), (40, 2, 1536, 3072,
                                                        None),
                              (5, 2, 64, 100, "rms"), (3, 35, 64, 128, "ln")]:
        p = kd.plan(t, n, d, f, entry)
        for depth, s, ln in [(d, p["s1"], p["len1"]), (f, p["s2"], p["len2"])]:
            assert ln % kd.DEPTH == 0 and s * ln >= depth > (s - 1) * ln
        assert p["s1"] <= kd.MAX_SPLIT
        naff = 2 if entry == "ln" else 0
        rows1 = max(min(t, kd.ROWS_H) + naff, min(n, kd.ROWS_H))
        assert kd.RING_BYTES + 4 * rows1 * (p["len1"] + 4) <= kd.BLOCK_SMEM
        assert p["zp"] == p["s1"] * (t + naff + n) * f
        assert p["st"] % 4 == 0 and p["g"] == n * t * f
    assert kd.plan(4, 2, 1536, 3072, "rms")["s1"] == 2      # one wave


@pytest.mark.cuda
@pytest.mark.parametrize("t,d,f", [(4, 64, 128), (5, 64, 100),
                                   (4, 1536, 3072), (33, 1536, 3072),
                                   (32, 1536, 3072), (40, 1536, 3072)])
def test_demux_rsa_kernel_on_card(cuda, t, d, f):
    args, norms = _demux_inputs(t, d=d, f=f)
    a = _torch(args, cuda)
    nm = {k: v if isinstance(v, str) else torch.as_tensor(v, device=cuda)
          for k, v in norms.items()}
    torch.testing.assert_close(ops.demux_rsa(*a, **nm),
                               ref.demux_rsa_fused_ref(*a, **nm),
                               atol=1e-3, rtol=1e-3)


@pytest.mark.cuda
def test_paged_kernels_full_width_on_card(cuda):
    """qwen2-1.5b widths: H=12 over Hkv=2, Dh=128, BS=16, decode rows and a
    32-token chunk."""
    rng = np.random.default_rng(1)
    kp, vp, bt, ppos = build_pool(rng, [117, 100, 37, -1], num_blocks=33,
                                  block_size=16, max_blocks=8, hkv=2, dh=128)
    q = rng.standard_normal((4, 1, 12, 128), np.float32)
    t = _torch((q, kp, vp, bt, ppos, np.asarray([116, 99, 36, -1],
                                                np.int32)), cuda)
    torch.testing.assert_close(ops.paged_attention(*t),
                               ref.paged_attention_ref(*t), **ATT_TOL)
    qc = rng.standard_normal((1, 32, 12, 128), np.float32)
    t = _torch((qc, kp, vp, bt[:1], ppos, np.asarray([64], np.int32),
                np.asarray([32], np.int32)), cuda)
    torch.testing.assert_close(ops.paged_prefill_attention(*t),
                               ref.paged_prefill_attention_ref(*t),
                               **ATT_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CARD_DECODE_CASES))
@pytest.mark.parametrize("kind", ["bf16", "int8", "fp8"])
def test_quantized_paged_attention_kernel_on_card(cuda, kind, case):
    (q, kp, vp, bt, ppos, qp), window = _decode_inputs(case)
    ks, vs, sc = _store(kind, kp, vp, cuda)
    t = _torch((q, bt, ppos, qp), cuda)
    got = ops.paged_attention(t[0], ks, vs, *t[1:], window=window, **sc)
    want = (ref.paged_attention_quant_ref(t[0], ks, vs, sc["k_scales"],
                                          sc["v_scales"], *t[1:],
                                          window=window) if sc else
            ref.paged_attention_ref(t[0], ks, vs, *t[1:], window=window))
    torch.testing.assert_close(got, want, **ATT_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CARD_PREFILL_CASES))
@pytest.mark.parametrize("kind", ["bf16", "int8", "fp8"])
def test_quantized_paged_prefill_kernel_on_card(cuda, kind, case):
    q, kp, vp, *rest = _prefill_inputs(case)
    window = _prefill_window(case)
    ks, vs, sc = _store(kind, kp, vp, cuda)
    t = _torch((q, *rest), cuda)
    got = ops.paged_prefill_attention(t[0], ks, vs, *t[1:], window=window,
                                      **sc)
    want = (ref.paged_prefill_attention_quant_ref(
                t[0], ks, vs, sc["k_scales"], sc["v_scales"], *t[1:],
                window=window)
            if sc else ref.paged_prefill_attention_ref(t[0], ks, vs, *t[1:],
                                                       window=window))
    torch.testing.assert_close(got, want, **ATT_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bf16", "int8", "fp8"])
def test_quantized_paged_kernels_full_width_on_card(cuda, kind):
    """qwen2-1.5b widths with stored pages: decode rows (one inactive) and
    a 32-token chunk."""
    rng = np.random.default_rng(2)
    kp, vp, bt, ppos = build_pool(rng, [117, 100, 37, -1], num_blocks=33,
                                  block_size=16, max_blocks=8, hkv=2, dh=128)
    ks, vs, sc = _store(kind, kp, vp, cuda)
    plain = ((lambda *a: ref.paged_attention_quant_ref(
                  a[0], ks, vs, sc["k_scales"], sc["v_scales"], *a[1:]))
             if sc else (lambda *a: ref.paged_attention_ref(a[0], ks, vs,
                                                             *a[1:])))
    q = rng.standard_normal((4, 1, 12, 128), np.float32)
    t = _torch((q, bt, ppos, np.asarray([116, 99, 36, -1], np.int32)), cuda)
    torch.testing.assert_close(ops.paged_attention(t[0], ks, vs, *t[1:], **sc),
                               plain(*t), **ATT_TOL)
    qc = rng.standard_normal((1, 32, 12, 128), np.float32)
    t = _torch((qc, bt[:1], ppos, np.asarray([64], np.int32),
                np.asarray([32], np.int32)), cuda)
    want = (ref.paged_prefill_attention_quant_ref(
                t[0], ks, vs, sc["k_scales"], sc["v_scales"], *t[1:])
            if sc else ref.paged_prefill_attention_ref(t[0], ks, vs, *t[1:]))
    torch.testing.assert_close(
        ops.paged_prefill_attention(t[0], ks, vs, *t[1:], **sc), want,
        **ATT_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("t,d,f", [(4, 64, 128), (5, 64, 100),
                                   (4, 4096, 8192), (33, 512, 1024)])
def test_demux_rsa_ln_entry_kernel_on_card(cuda, t, d, f):
    """The LN entry (rwkv6-7b's final norm) at small and full width."""
    args, norms = _demux_inputs(t, d=d, f=f, entry="ln")
    a = _torch(args, cuda)
    nm = {k: v if isinstance(v, str) else torch.as_tensor(v, device=cuda)
          for k, v in norms.items()}
    torch.testing.assert_close(ops.demux_rsa(*a, **nm),
                               ref.demux_rsa_fused_ref(*a, **nm),
                               atol=1e-3, rtol=1e-3)


RWKV_TOL = dict(atol=5e-4, rtol=1e-3)   # tests/test_kernels.py test_rwkv6
# (B, L, H, hd, chunk of the plain version, fixed log decay or None)
RWKV_CASES = {
    "decode": (4, 1, 8, 64, 1, None),
    "one_chunk_100": (2, 100, 4, 64, 100, None),
    "chunks_of_32": (2, 128, 4, 64, 32, None),
    "hd32_ragged": (2, 37, 3, 32, 37, None),
    "hd16": (1, 40, 2, 16, 8, None),
    "hd128": (1, 20, 2, 128, 20, None),
    "strong_decay": (2, 64, 4, 64, 32, -5.0),
    "weak_decay": (2, 100, 4, 64, 100, -1e-3),
    "L7": (2, 7, 4, 64, 7, None),
    "L109": (1, 109, 4, 64, 109, None),
    "L300_chunks_of_100": (1, 300, 2, 64, 100, None),
    "hd128_L100": (1, 100, 2, 128, 100, None),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(RWKV_CASES))
def test_rwkv6_kernel_on_card(cuda, case):
    b, l, h, hd, chunk, logw = RWKV_CASES[case]
    a = _torch(_rwkv_inputs(b, l, h, hd, logw=logw), cuda)
    out, s_t = ops.rwkv6_chunked(*a, chunk=chunk)
    for want in (ref.rwkv_chunked(*a, chunk), ref.rwkv6_ref(*a)):
        torch.testing.assert_close(out, want[0], **RWKV_TOL)
        torch.testing.assert_close(s_t, want[1], **RWKV_TOL)


@pytest.mark.cuda
def test_rwkv6_kernel_state_chaining_on_card(cuda):
    """Two halves chained through the final state == one pass
    (``tests/test_kernels.py`` test_rwkv6_state_chaining)."""
    r, k, v, logw, u, s0 = _torch(_rwkv_inputs(2, 64, 2, 64), cuda)
    o_full, s_full = ops.rwkv6_chunked(r, k, v, logw, u, s0, chunk=32)
    o1, s1 = ops.rwkv6_chunked(r[:, :32], k[:, :32], v[:, :32],
                               logw[:, :32], u, s0, chunk=32)
    o2, s2 = ops.rwkv6_chunked(r[:, 32:], k[:, 32:], v[:, 32:],
                               logw[:, 32:], u, s1, chunk=32)
    torch.testing.assert_close(torch.cat([o1, o2], 1), o_full, atol=1e-4,
                               rtol=0)
    torch.testing.assert_close(s2, s_full, atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
def test_rwkv6_kernel_is_bitwise_repeatable_on_card(cuda, hd):
    """Each output and state element is summed in a fixed order (the row
    groups' partials in order): two calls give the same bits."""
    a = _torch(_rwkv_inputs(2, 37, 2, hd), cuda)
    o1, s1 = ops.rwkv6_chunked(*a, chunk=37)
    o2, s2 = ops.rwkv6_chunked(*a, chunk=37)
    assert torch.equal(o1, o2) and torch.equal(s1, s2)


@pytest.mark.cuda
@pytest.mark.parametrize("t,n", [(10240, 2), (2048, 10)])
def test_demux_rsa_bert_shapes_on_card(cuda, t, n):
    """mux-bert-base's exit (the LN entry, d 768, F 1536) over a whole
    encoder batch: 80 rows of 128 tokens at N=2, 16 at N=10 (hundreds of
    row jobs a column tile), against the plain version and bit for bit
    over two calls."""
    args, norms = _demux_inputs(t, n=n, d=768, f=1536, entry="ln")
    a = _torch(args, cuda)
    nm = {k: v if isinstance(v, str) else torch.as_tensor(v, device=cuda)
          for k, v in norms.items()}
    got = ops.demux_rsa(*a, **nm)
    torch.testing.assert_close(got, ref.demux_rsa_fused_ref(*a, **nm),
                               atol=1e-3, rtol=1e-3)
    assert torch.equal(got, ops.demux_rsa(*a, **nm))


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["rms", "ln"])
def test_demux_rsa_without_exit_ln_on_card(cuda, entry):
    """No exit LayerNorm (the third launch writes y + b2), at d 1536."""
    args, norms = _demux_inputs(32, d=1536, f=3072, entry=entry)
    a = _torch(args, cuda)
    nm = {k: v if isinstance(v, str) else torch.as_tensor(v, device=cuda)
          for k, v in norms.items() if not k.startswith("exit")}
    torch.testing.assert_close(ops.demux_rsa(*a, **nm),
                               ref.demux_rsa_fused_ref(*a, **nm),
                               atol=1e-3, rtol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("t,d,f,entry", [(32, 1536, 3072, "rms"),
                                         (4, 4096, 8192, "ln")])
def test_demux_rsa_is_bitwise_repeatable_on_card(cuda, t, d, f, entry):
    """The split partials are added in a fixed order whichever block
    arrives last: two calls give the same bits."""
    args, norms = _demux_inputs(t, d=d, f=f, entry=entry)
    a = _torch(args, cuda)
    nm = {k: v if isinstance(v, str) else torch.as_tensor(v, device=cuda)
          for k, v in norms.items()}
    assert torch.equal(ops.demux_rsa(*a, **nm), ops.demux_rsa(*a, **nm))


# ------------------------------------------------- bf16 (the compute dtype)

BF16_ULP = 2.0 ** -7        # one bf16 ulp, relative


def assert_bf16_close(got, want, ulps=1):
    """Two bf16 results that round fp32 sums taken in different orders:
    within ``ulps`` bf16 ulps of each row's largest value (a flip at a
    rounding point moves a row's later values by at most that)."""
    assert got.dtype == want.dtype == torch.bfloat16
    g, w = got.float(), want.float()
    bound = ulps * BF16_ULP * w.abs().amax(-1, keepdim=True)
    err = (g - w).abs()
    assert bool((err <= bound).all()), \
        f"max {err.max().item()} over {ulps} ulp(s) of the row max"


def _bf16_paged(case, kind, cuda, prefill):
    """A card case's inputs with a bf16 q and pages stored as ``kind``."""
    if prefill:
        q, kp, vp, *rest = _prefill_inputs(case)
        window = _prefill_window(case)
    else:
        (q, kp, vp, *rest), window = _decode_inputs(case)
    ks, vs, sc = _store(kind, kp, vp, cuda)
    qb = torch.as_tensor(q, device=cuda).to(torch.bfloat16)
    return qb, ks, vs, _torch(rest, cuda), sc, window


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CARD_DECODE_CASES))
@pytest.mark.parametrize("kind", STORE_KINDS)
def test_paged_attention_bf16_q_on_card(cuda, kind, case):
    """bf16 q (and output) over every page storage: the kernel against its
    plain version (q widened, fp32 attention, one rounding), within a bf16
    ulp, and bit for bit over two calls."""
    q, ks, vs, rest, sc, window = _bf16_paged(case, kind, cuda, False)
    got = ops.paged_attention(q, ks, vs, *rest, window=window, **sc)
    want = (ref.paged_attention_quant_ref(
        q, ks, vs, sc["k_scales"], sc["v_scales"], *rest, window=window)
        if sc else ref.paged_attention_ref(q, ks, vs, *rest, window=window))
    assert_bf16_close(got, want)
    assert torch.equal(ops.paged_attention(q, ks, vs, *rest, window=window,
                                           **sc), got)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CARD_PREFILL_CASES))
@pytest.mark.parametrize("kind", STORE_KINDS)
def test_paged_prefill_bf16_q_on_card(cuda, kind, case):
    q, ks, vs, rest, sc, window = _bf16_paged(case, kind, cuda, True)
    got = ops.paged_prefill_attention(q, ks, vs, *rest, window=window, **sc)
    want = (ref.paged_prefill_attention_quant_ref(
        q, ks, vs, sc["k_scales"], sc["v_scales"], *rest, window=window)
        if sc else ref.paged_prefill_attention_ref(q, ks, vs, *rest,
                                                   window=window))
    assert_bf16_close(got, want)
    assert torch.equal(ops.paged_prefill_attention(q, ks, vs, *rest,
                                                   window=window, **sc), got)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", STORE_KINDS)
def test_paged_kernels_bf16_full_width_on_card(cuda, kind):
    """qwen2-1.5b widths in bf16: decode rows and a 32-token chunk."""
    rng = np.random.default_rng(1)
    kp, vp, bt, ppos = build_pool(rng, [117, 100, 37, -1], num_blocks=33,
                                  block_size=16, max_blocks=8, hkv=2, dh=128)
    ks, vs, sc = _store(kind, kp, vp, cuda)
    q = torch.as_tensor(rng.standard_normal((4, 1, 12, 128), np.float32),
                        device=cuda).to(torch.bfloat16)
    t = _torch((bt, ppos, np.asarray([116, 99, 36, -1], np.int32)), cuda)
    assert_bf16_close(ops.paged_attention(q, ks, vs, *t, **sc),
                      ref.paged_attention_quant_ref(
                          q, ks, vs, sc["k_scales"], sc["v_scales"], *t)
                      if sc else ref.paged_attention_ref(q, ks, vs, *t))
    qc = torch.as_tensor(rng.standard_normal((1, 32, 12, 128), np.float32),
                         device=cuda).to(torch.bfloat16)
    t = _torch((bt[:1], ppos, np.asarray([64], np.int32),
                np.asarray([32], np.int32)), cuda)
    assert_bf16_close(ops.paged_prefill_attention(qc, ks, vs, *t, **sc),
                      ref.paged_prefill_attention_quant_ref(
                          qc, ks, vs, sc["k_scales"], sc["v_scales"], *t)
                      if sc else ref.paged_prefill_attention_ref(qc, ks, vs,
                                                                 *t))


def _bf16_demux(t, d, f, entry, exit_ln=True, cuda=None):
    args, norms = _demux_inputs(t, d=d, f=f, entry=entry)
    a = [torch.as_tensor(x, device=cuda).to(torch.bfloat16) for x in args]
    nm = {k: v if v is None or isinstance(v, str)
          else torch.as_tensor(v, device=cuda) for k, v in norms.items()}
    if not exit_ln:
        nm.pop("exit_scale"), nm.pop("exit_bias")
    return a, nm


@pytest.mark.cuda
@pytest.mark.parametrize("t,d,f,entry,exit_ln", [
    (4, 1536, 3072, "rms", True), (32, 1536, 3072, "rms", True),
    (40, 1536, 3072, "rms", True), (5, 64, 1104, "rms", True),
    (4, 1536, 3072, "rms", False), (4, 4096, 8192, "ln", True),
    (32, 768, 1536, None, True)])
def test_demux_rsa_bf16_on_card(cuda, t, d, f, entry, exit_ln):
    """bf16 h, keys and weights (fp32 norm params) at qwen2-1.5b's exit
    (T 4 and 32, two row jobs at 40, without the exit LayerNorm), F not a
    multiple of the 512-column rounding tile, the LN entry at rwkv6-7b's
    width, no entry: the kernel against ``demux_rsa_fused_ref`` (the
    Pallas kernel's rounding points), within two bf16 ulps of the row's
    largest value (a sum flipped at a rounding point moves later sums),
    and bit for bit over two calls."""
    a, nm = _bf16_demux(t, d, f, entry, exit_ln, cuda)
    got = ops.demux_rsa(*a, **nm)
    assert got.dtype == torch.bfloat16 and got.shape == (2, t, d)
    assert_bf16_close(got, ref.demux_rsa_fused_ref(*a, **nm), ulps=2)
    assert torch.equal(ops.demux_rsa(*a, **nm), got)


@pytest.mark.parametrize("t,n,d,f", [(4, 2, 1536, 3072), (32, 2, 1536, 3072),
                                     (10240, 2, 768, 1536), (4, 2, 64, 1104),
                                     (4, 2, 4096, 8192), (2048, 10, 768, 64)])
def test_demux_plan_bf16_slices_lie_in_rounding_tiles(t, n, d, f):
    """In bf16 the second product's slices of F are powers of two that
    divide the 512-column tile the output rounds after, cover F once and
    stay at most 64; the first product's split is fp32's."""
    p, p32 = demux_plan(t, n, d, f, bf16=True), demux_plan(t, n, d, f)
    assert F_TILE % p["len2"] == 0 and p["len2"] % 32 == 0
    assert (p["s2"] - 1) * p["len2"] < f <= p["s2"] * p["len2"] <= f + 511
    assert p["s2"] <= 64 and p["yp"] == p["s2"] * n * t * d
    assert {k: p[k] for k in ("s1", "len1", "zp", "st", "g")} == \
        {k: p32[k] for k in ("s1", "len1", "zp", "st", "g")}


def test_kernel_sweep_variants_apply_to_the_sources():
    """Every variant ``repro_torch.launch.kernel_sweep`` times is the
    shipped source with text that is really there replaced, and its
    plans cover the cache as the kernel requires."""
    from repro_torch.kernels import build
    from repro_torch.launch import kernel_sweep as ks
    for name, (src, subs) in ks.VARIANTS.items():
        text = (build.CSRC / f"{src}.cu").read_text()
        assert src in build.SOURCES
        for old, new in subs:
            assert text.count(old) == 1 and old != new, name
    for shape, c in (("ring", 124), ("whisper", 1500)):
        for n, per in ks.DECODE_PLANS[shape]:
            assert n * per >= c > (n - 1) * per and per % 16 == 0
    assert {name.split()[0] for name in ks.VARIANTS} == set(ks.KERNELS)
    for cols in ks.EMBED_COLS:           # whole 16-byte words of d 1536
        assert cols % 8 == 0 and cols <= 1536
    from repro_torch.kernels import mux_combine as kc
    shipped = next(n for n in ks.VARIANTS if n.startswith("mux")
                   and "shipped" in n)
    assert ks.mux_unroll(shipped) == kc.UNROLL      # the source's constants
    for t, d, elt in ((6000, 768, 4), (400, 1536, 4), (6000, 768, 2),
                      (436, 4096, 4)):
        assert ks.combine_tiling(t, d, elt, kc.UNROLL[elt]) == kc.plan(
            2, t, d, elt)
        for name in (n for n in ks.VARIANTS if n.startswith("mux")):
            for chunks, threads in ks.COMBINE_TILINGS:
                p = ks.combine_tiling(t, d, elt, ks.mux_unroll(name)[elt],
                                      chunks, threads)
                assert p.threads <= threads and p.rows >= 1
                assert p.slices == -(-d // p.cols) and p.cols % 8 == 0
                assert p.threads % -(-p.cols * elt // 16) == 0


# ------------------------------------ flash attention and RWKV6 in bf16

# (B, Lq, Lk, H, Hkv, Dh) and keyword arguments: the main path's shapes
# (qwen2-1.5b's causal prefill, whisper's encoder and cross-attention,
# gemma-2b's and h2o-danube-1.8b's heads, mux-bert-base's 80 rows) and
# the edges (a query offset, a softcap, a split of the keys over blocks)
FLASH_BF16_CASES = {
    "qwen2_causal_116": (2, 116, 116, 12, 2, 128, {}),
    "whisper_encoder": (2, 1500, 1500, 12, 12, 64, dict(causal=False)),
    "whisper_cross": (2, 100, 1500, 12, 12, 64, dict(causal=False)),
    "gemma_dh256": (2, 116, 116, 8, 1, 256, {}),
    "h2o_dh80_window": (2, 300, 300, 32, 8, 80, dict(window=64)),
    "bert_80x130": (80, 130, 130, 12, 12, 64, dict(causal=False)),
    "offset_softcap": (1, 9, 37, 4, 2, 32, dict(q_offset=28,
                                                 logit_softcap=5.0)),
    "split_keys": (1, 16, 4096, 4, 4, 64, dict(causal=False)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FLASH_BF16_CASES))
def test_flash_attention_bf16_on_card(cuda, case):
    """bf16 q, K and V: the kernel against its plain version (widened to
    fp32, one rounding) within one bf16 ulp of the row's largest value,
    bit for bit over two calls; ``split_keys`` runs the split and the
    combine (which alone rounds)."""
    from repro_torch.kernels import flash_attention as kfl
    b, lq, lk, h, hkv, dh, kw = FLASH_BF16_CASES[case]
    rng = np.random.default_rng(dh)
    q, k, v = (torch.as_tensor(rng.standard_normal(s, np.float32),
                               device=cuda).to(torch.bfloat16)
               for s in ((b, lq, h, dh), (b, lk, hkv, dh), (b, lk, hkv, dh)))
    if case == "split_keys":
        assert kfl.splits(b, lq, lk, h, dh)[0] > 1
    got = ops.flash_attention(q, k, v, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert_bf16_close(got, ref.flash_attention_ref(q, k, v, **kw))
    assert torch.equal(got, ops.flash_attention(q, k, v, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("hd,l", [(16, 40), (32, 37), (64, 1), (64, 100),
                                  (128, 20)])
def test_rwkv6_bf16_on_card(cuda, hd, l):
    """bf16 r, k and v (fp32 logw, u, s0): ``out`` in bf16 against the
    sequential oracle (the kernel's form) within one bf16 ulp of the row's
    largest value and against the chunkwise plain version within
    ``RWKV_TOL`` plus that ulp (the two fp32 forms part within
    ``RWKV_TOL`` before each rounds), ``sT`` in fp32 within ``RWKV_TOL``,
    bit for bit over two calls, and two halves chained through the state
    as one pass."""
    a = _torch(_rwkv_inputs(2, l, 4, hd), cuda)
    a = [x.to(torch.bfloat16) for x in a[:3]] + a[3:]
    out, s_t = ops.rwkv6_chunked(*a, chunk=l)
    assert out.dtype == torch.bfloat16 and s_t.dtype == torch.float32
    oracle, chunked = ref.rwkv6_ref(*a), ref.rwkv_chunked(*a, l)
    assert_bf16_close(out, oracle[0])
    w = chunked[0].float()
    tol = (RWKV_TOL["atol"] + RWKV_TOL["rtol"] * w.abs()
           + BF16_ULP * w.abs().amax(-1, keepdim=True))
    assert bool(((out.float() - w).abs() <= tol).all())
    for want in (oracle, chunked):
        torch.testing.assert_close(s_t, want[1], **RWKV_TOL)
    again = ops.rwkv6_chunked(*a, chunk=l)
    assert torch.equal(out, again[0]) and torch.equal(s_t, again[1])
    if l > 1:
        m = l // 2
        o1, s1 = ops.rwkv6_chunked(*(x[:, :m] for x in a[:4]), a[4], a[5],
                                   chunk=m)
        o2, s2 = ops.rwkv6_chunked(*(x[:, m:] for x in a[:4]), a[4], s1,
                                   chunk=l - m)
        assert_bf16_close(torch.cat([o1, o2], 1), out)
        torch.testing.assert_close(s2, s_t, atol=1e-4, rtol=0)


def test_bf16_launchers_reject_mixed_and_other_dtypes():
    """The flash and RWKV6 launchers take fp32 or bf16 operands of one
    dtype (RWKV6's logw, u and s0 fp32): mixed dtypes and fp16 raise
    before the device is looked at, so the refusal shows on the CPU."""
    from repro_torch.kernels import flash_attention as kfl
    from repro_torch.kernels import rwkv6
    q = torch.zeros(1, 4, 4, 16, dtype=torch.bfloat16)
    k = torch.zeros(1, 4, 2, 16, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="q's dtype"):
        kfl.flash_attention_cuda(q, k.float(), k.float())
    with pytest.raises(ValueError, match="q's dtype"):
        kfl.flash_attention_cuda(q, k, k.float())
    with pytest.raises(ValueError, match="fp32 or bf16"):
        kfl.flash_attention_cuda(q.half(), k.half(), k.half())
    with pytest.raises(ValueError, match="CUDA"):
        kfl.flash_attention_cuda(q, k, k)
    a = _torch(_rwkv_inputs(1, 3, 2, 16))
    bf = [x.to(torch.bfloat16) for x in a[:3]]
    with pytest.raises(ValueError, match="r's dtype"):
        rwkv6.rwkv6_cuda(bf[0], a[1], a[2], *a[3:])
    with pytest.raises(ValueError, match="fp32 or bf16"):
        rwkv6.rwkv6_cuda(*(x.half() for x in a[:3]), *a[3:])
    with pytest.raises(ValueError, match="logw: need fp32"):
        rwkv6.rwkv6_cuda(*bf, a[3].to(torch.bfloat16), *a[4:])
    with pytest.raises(ValueError, match="CUDA"):
        rwkv6.rwkv6_cuda(*bf, *a[3:])
