"""Fused RSA demux exit: the CUDA kernels (``csrc/demux_rsa.cu``) and the
plain PyTorch versions.

Counterpart of ``repro/kernels/demux_rsa.py`` (``demux_rsa``):

    out[n] = LN_exit( gelu_tanh( norm(h) @ W1h + k[n] @ W1k + b1 ) @ W2 + b2 )

``kb = k @ W1k + b1`` is a small (N, F) product that the reference leaves
to XLA; the kernel streams W1k in its first launch beside W1h.
``plan`` sets how the kernels split the weights over blocks.  h, k, the
weights and the output are fp32 or bf16; in bf16 the kernel and
``demux_rsa_fused_ref`` round where the Pallas kernel rounds.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.nn.activations import gelu_tanh
from repro_torch.nn.layers import LayerNorm, RMSNorm


def demux_rsa_ref(h, k, w1h, w1k, b1, w2, b2):
    """h (T, D); k (N, D); w1h, w1k (D, F); b1 (F,); w2 (F, D); b2 (D,)
    -> (N, T, D) = gelu(h W1h + k W1k + b1) W2 + b2."""
    shared = h @ w1h
    kb = k @ w1k + b1[None]
    return gelu_tanh(shared[None] + kb[:, None]) @ w2 + b2


F_TILE = 512        # the Pallas kernel's block_f: its bf16 output rounds
                    # after each F tile of this many columns


def _entry(h, kind, scale, bias):
    """The backbone's final norm fused into the kernel's entry."""
    if kind == "rms":
        return RMSNorm.apply({"scale": scale}, h)
    if kind == "ln":
        return LayerNorm.apply({"scale": scale, "bias": bias}, h)
    return h


def demux_rsa_fused_ref(h, k, w1h, w1k, b1, w2, b2, *, entry_kind=None,
                        entry_scale=None, entry_bias=None, exit_scale=None,
                        exit_bias=None):
    """Backbone final norm (``entry_kind`` 'rms' / 'ln') -> RSA demux MLP
    -> demux LayerNorm, with the Pallas kernel's arithmetic on h, k and
    weights in h's dtype (fp32 or bf16; norm params fp32), rounding to
    that dtype where it rounds: the entry norm, both products and GELU in
    fp32; ``kb = r(r(k @ W1k) + b1)``, as its wrapper computes it in h's
    dtype; the output rounded after ``+ b2`` with the first F tile's
    product and after each further tile's, in tile order (``F_TILE``
    columns, the last one short); the exit LayerNorm in fp32 on that,
    rounded once.  In fp32 every rounding is the identity."""
    dt = h.dtype
    z = _entry(h.float(), entry_kind, entry_scale, entry_bias)
    kb = ((k.float() @ w1k.float()).to(dt).float() + b1.float()).to(dt)
    g = gelu_tanh((z @ w1h.float())[None] + kb.float()[:, None])  # (N, T, F)
    out = b2.float()
    for f0 in range(0, w2.shape[0], F_TILE):
        part = g[..., f0:f0 + F_TILE] @ w2[f0:f0 + F_TILE].float()
        out = (out + part).to(dt).float()
    if exit_scale is not None:
        out = LayerNorm.apply({"scale": exit_scale, "bias": exit_bias}, out)
    return out.to(dt)


ENTRY_KINDS = {None: 0, "rms": 1, "ln": 2}      # the source's kEntry*
DTYPES = (torch.float32, torch.bfloat16)   # h, k, weights, biases, output
# the source's tiles: columns per block, depth rows per ring stage, ring
# stages, rows per job of the first and the second product, slices of D
COLS, DEPTH, STAGES, ROWS_H, ROWS_G, MAX_SPLIT = 64, 32, 4, 32, 64, 32
RING_BYTES = 4 * STAGES * DEPTH * (COLS + 8)    # the first product's W ring
TARGET_BLOCKS = 2 * 132         # ~2 blocks on each of an H100's 132 SMs
BLOCK_SMEM = 68 * 1024          # a first-product block's ring and rows
PARTIAL_SHARE = 0.25            # partial-sum bytes / weight bytes, at most


def _slices(depth, jobs, rows, max_split, staged):
    """(slices, slice length) of a reduction axis of ``depth``: at most
    TARGET_BLOCKS blocks over ``jobs`` (column tile, row job) pairs (one
    wave), partial sums of ``rows`` rows under PARTIAL_SHARE of the
    weight bytes, each slice a whole number of ring stages and none
    empty; with ``staged`` rows held whole in shared memory, the block
    inside BLOCK_SMEM where ``max_split`` allows."""
    chunks = -(-depth // DEPTH)
    top = min(max_split, chunks)
    s = max(1, min(top, TARGET_BLOCKS // jobs,
                   int(PARTIAL_SHARE * depth / rows)))
    while True:
        per = -(-chunks // s) * DEPTH
        if (RING_BYTES + 4 * staged * (per + 4) <= BLOCK_SMEM
                or s >= top):
            return -(-depth // per), per
        s += 1


def plan(t, n, d, f, entry_kind=None, bf16=False):
    """The kernels' split of the weights and the scratch they need for
    h (t, d), k (n, d), W1h (d, f): {"s1", "len1", "s2", "len2", the int
    count "counters" and the float counts "zp", "st", "g", "yp"}.  The
    second product's slices are capped at 64: its last block per column
    tile adds them.  bf16: its slices are cut to a power of two that
    divides ``F_TILE``, so each lies inside one of the tiles whose end
    rounds the output."""
    naff = 2 if entry_kind == "ln" else 0
    f_tiles, d_tiles, nt = -(-f // COLS), -(-d // COLS), n * t
    jobs1 = f_tiles * (-(-t // ROWS_H) + -(-n // ROWS_H))
    rows1 = max(min(t, ROWS_H) + naff, min(n, ROWS_H))
    s1, len1 = _slices(d, jobs1, t + naff + n, MAX_SPLIT, rows1)
    s2, len2 = _slices(f, d_tiles * -(-nt // ROWS_G), nt, 64, 0)
    if bf16:
        cut = F_TILE
        while cut > DEPTH and cut > len2:
            cut //= 2
        while -(-f // cut) > 64 and cut < F_TILE:
            cut *= 2
        s2, len2 = -(-f // cut), cut
    return {"s1": s1, "len1": len1, "s2": s2, "len2": len2,
            "counters": f_tiles + d_tiles, "zp": s1 * (t + naff + n) * f,
            "st": -(-f_tiles * s1 * t * 2 // 4) * 4,     # keeps g aligned
            "g": nt * f, "yp": s2 * nt * d}


_COUNTERS = {}      # device -> int32 zeros the first launch counts in


def _counter(dev, size):
    c = _COUNTERS.get(dev)
    if c is None or c.numel() < size:
        c = _COUNTERS[dev] = torch.zeros(size, dtype=torch.int32, device=dev)
    return c


def demux_rsa_cuda(h, k, w1h, w1k, b1, w2, b2, *, entry_kind=None,
                   entry_scale=None, entry_bias=None, exit_scale=None,
                   exit_bias=None):
    """Launch the demux kernels on (T, D) ``h``; arguments as
    ``demux_rsa_fused_ref`` (the LN entry needs ``entry_bias``): h, k,
    the weights and biases all fp32 or all bf16 (the output's dtype), the
    norm params fp32."""
    if h.device.type != "cuda":
        raise ValueError(f"the demux kernel runs on CUDA tensors, got "
                         f"{h.device}")
    if entry_kind not in ENTRY_KINDS:
        raise ValueError(f"entry_kind {entry_kind!r}: the kernel fuses "
                         "None, 'rms' or 'ln'")
    if entry_kind is not None and entry_scale is None:
        raise ValueError(f"entry_kind {entry_kind!r} needs entry_scale")
    if entry_kind == "ln" and entry_bias is None:
        raise ValueError("the LN entry needs entry_bias")
    if entry_kind != "ln":
        entry_bias = None
    t, d = h.shape
    n, f = k.shape[0], w1h.shape[1]
    ts = [h, k, w1h, w1k, b1, w2, b2]
    ts += [x for x in (entry_scale, entry_bias, exit_scale, exit_bias)
           if x is not None]
    if h.dtype not in DTYPES:
        raise ValueError(f"h: need fp32 or bf16, got {h.dtype}")
    for i, x in enumerate(ts):
        want = h.dtype if i < 7 else torch.float32     # norm params: fp32
        if x.dtype != want or x.device != h.device:
            raise ValueError(f"need {want} on {h.device}, got {x.dtype} on "
                             f"{x.device}")
    vecs = [(b1, f), (b2, d)] + [(x, d) for x in ts[7:]]
    if (tuple(w1h.shape) != (d, f) or tuple(w1k.shape) != (d, f)
            or tuple(w2.shape) != (f, d) or tuple(k.shape) != (n, d)
            or any(tuple(x.shape) != (m,) for x, m in vecs)):
        raise ValueError(f"shapes h {tuple(h.shape)} k {tuple(k.shape)} "
                         f"w1h {tuple(w1h.shape)} w1k {tuple(w1k.shape)} "
                         f"w2 {tuple(w2.shape)}")
    if (exit_scale is None) != (exit_bias is None):
        raise ValueError("exit_scale and exit_bias come together")
    vec = 16 // h.element_size()      # elements a 16-byte copy moves
    if d % vec or f % vec:
        raise ValueError(f"D={d}, F={f}: the kernel takes multiples of "
                         f"{vec} in {h.dtype}")

    def prep(x):     # contiguous, 16-byte aligned (the kernel copies 16 B)
        if x is None:
            return None
        x = x.contiguous()
        return x if x.data_ptr() % 16 == 0 else x.clone()
    h, k, w1h, w1k, b1, w2, b2 = map(prep, (h, k, w1h, w1k, b1, w2, b2))
    es, eb, xs, xb = map(prep, (entry_scale if entry_kind else None,
                                entry_bias, exit_scale, exit_bias))
    bf16 = h.dtype == torch.bfloat16
    p = plan(t, n, d, f, entry_kind, bf16)
    scratch = torch.empty(p["zp"] + p["st"] + p["g"] + p["yp"],
                          device=h.device)
    zp, st, g, yp = torch.split(scratch, [p["zp"], p["st"], p["g"], p["yp"]])
    out = torch.empty((n, t, d), dtype=h.dtype, device=h.device)

    def ptr(x):
        return None if x is None else x.data_ptr()

    err = build.load("demux_rsa").demux_rsa_forward(
        h.data_ptr(), k.data_ptr(), ptr(es), ptr(eb), w1h.data_ptr(),
        w1k.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), ptr(xs),
        ptr(xb), zp.data_ptr(), st.data_ptr(), g.data_ptr(), yp.data_ptr(),
        out.data_ptr(), _counter(h.device, p["counters"]).data_ptr(),
        ENTRY_KINDS[entry_kind], t, n, d, f, p["s1"], p["len1"], p["s2"],
        p["len2"], int(bf16), torch.cuda.current_stream(h.device).cuda_stream)
    build.check(err, "demux_rsa kernels")
    return out
