"""The column split of the port's RWKV6 kernel, on the CPU.

``csrc/rwkv6.cu`` splits a head's value columns over blocks where
``kernels/rwkv6.py`` ``PLAN`` says so (hd 128; hd 64 runs one block a
head, as measured on the card): column j of the state and of the output
depends on r, k, w, u and v[:, j] only, so the split needs no merge.
Inside a block each thread holds a (rows, columns) tile of the state;
a token's output is the row groups' partial sums added in order plus the
bonus (r_t * u) . k_t (one scalar a token) times v_t.  The kernel runs
only on the card; here a torch model of that arithmetic
(``column_split_model``) is held to the sequential oracle ``rwkv6_ref``,
the chunkwise plain version ``rwkv_chunked`` and the reference's Pallas
``rwkv6_chunked`` (interpret) at the reference suite's kernel tolerance
(atol 5e-4, rtol 1e-3, ``tests/test_kernels.py``), at every head dim the
kernel takes, over several staged tiles with a ragged last one, strong
and weak decay and two halves chained through the state.  The plan's
cover (each state element in exactly one thread of one block) and its
agreement with the source's constants are checked too.
"""
import pathlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ref as jref
from repro.kernels.rwkv6 import rwkv6_chunked as pallas_rwkv
from repro_torch.kernels import ref
from repro_torch.kernels import rwkv6 as kr
from test_torch_kernels import _rwkv_inputs

torch.set_num_threads(2)

KERNEL_TOL = dict(atol=5e-4, rtol=1e-3)      # tests/test_kernels.py:104-107
SOURCE = (pathlib.Path(kr.__file__).parent / "csrc" / "rwkv6.cu").read_text()


def column_split_model(r, k, v, logw, u, s0):
    """The kernel's arithmetic: blocks of ``PLAN[hd][0]`` value columns,
    each token's output the row groups' partial sums r_i S_ij added in
    group order plus ((r * u) . k) v_j, then S_ij = S_ij w_i + k_i v_j.
    Returns (out, sT) as ``rwkv6_ref``."""
    b, l, h, hd = r.shape
    cb, rg, _, _ = kr.PLAN[hd]
    w = torch.exp(logw)
    bonus = torch.einsum("blhk,hk,blhk->blh", r, u, k)
    out, s_t = torch.empty_like(r), torch.empty_like(s0)
    for c0 in range(0, hd, cb):
        s = s0[..., c0:c0 + cb].clone()                    # (B, H, hd, CB)
        for t in range(l):
            rt, kt, wt = r[:, t], k[:, t], w[:, t]         # (B, H, hd)
            vt = v[:, t, :, c0:c0 + cb]                    # (B, H, CB)
            part = (rt[..., None] * s).reshape(b, h, rg, hd // rg, cb).sum(3)
            o = part[:, :, 0]
            for g in range(1, rg):
                o = o + part[:, :, g]
            out[:, t, :, c0:c0 + cb] = o + bonus[:, t, :, None] * vt
            s = s * wt[..., None] + kt[..., None] * vt[:, :, None, :]
        s_t[..., c0:c0 + cb] = s
    return out, s_t


# (B, L, H, hd, fixed log decay or None): every head dim the kernel takes,
# L across several staged tiles (PLAN's tokens a tile) with a ragged last
# one, decode, and the decay edges
CASES = {
    "hd16": (1, 19, 2, 16, None),
    "hd32": (2, 9, 1, 32, None),
    "hd64_decode": (2, 1, 2, 64, None),
    "hd64": (1, 37, 2, 64, None),
    "hd128": (1, 7, 1, 128, None),
    "strong_decay": (1, 12, 2, 32, -5.0),
    "weak_decay": (1, 12, 2, 32, -1e-3),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_column_split_model_matches_oracle_plain_and_pallas(case):
    b, l, h, hd, logw = CASES[case]
    args = _rwkv_inputs(b, l, h, hd, seed=hd + l, logw=logw)
    t = [torch.as_tensor(a) for a in args]
    got = column_split_model(*t)
    for want in (ref.rwkv6_ref(*t), ref.rwkv_chunked(*t, l)):
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, **KERNEL_TOL)
    pallas = pallas_rwkv(*map(jnp.asarray, args), chunk=l, interpret=True)
    oracle = jref.rwkv6_ref(*map(jnp.asarray, args))
    for g, p, o in zip(got, pallas, oracle):
        np.testing.assert_allclose(g.numpy(), np.asarray(p), **KERNEL_TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(o), **KERNEL_TOL)


def test_column_split_model_chains_through_the_state():
    """Two halves chained through sT equal one pass (1e-4)."""
    r, k, v, logw, u, s0 = map(torch.as_tensor, _rwkv_inputs(1, 20, 2, 64))
    o_full, s_full = column_split_model(r, k, v, logw, u, s0)
    o1, s1 = column_split_model(r[:, :9], k[:, :9], v[:, :9], logw[:, :9],
                                u, s0)
    o2, s2 = column_split_model(r[:, 9:], k[:, 9:], v[:, 9:], logw[:, 9:],
                                u, s1)
    torch.testing.assert_close(torch.cat([o1, o2], 1), o_full, atol=1e-4,
                               rtol=0)
    torch.testing.assert_close(s2, s_full, atol=1e-4, rtol=0)


@pytest.mark.parametrize("hd", kr.HEAD_DIMS)
def test_column_plan_covers_the_state_once(hd):
    """Blocks of CB columns and threads of (rows, columns) tiles hold each
    state element exactly once; every thread's rows and columns come in
    16-byte loads and a block's threads split each token's bonus
    evenly."""
    cb, rg, cpt, tt = kr.PLAN[hd]
    kpt, nc = hd // rg, cb // cpt
    threads = nc * rg
    assert hd % cb == 0 and cb % cpt == 0 and hd % rg == 0
    assert kpt % 4 == 0 and cpt % 4 == 0
    assert tt <= threads <= 1024 and threads % tt == 0
    assert (hd // (threads // tt)) % 4 == 0
    seen = np.zeros((hd, hd), np.int32)
    for blk in range(hd // cb):
        for tid in range(threads):
            cg, g = tid % nc, tid // nc
            rows = slice(g * kpt, (g + 1) * kpt)
            cols = slice(blk * cb + cpt * cg, blk * cb + cpt * (cg + 1))
            seen[rows, cols] += 1
    assert (seen == 1).all()


def test_column_plan_mirrors_the_source():
    """``PLAN`` is the source's ``Cfg``, one entry per head dim."""
    cfg = {int(m[0]): tuple(map(int, m[1:])) for m in re.findall(
        r"struct Cfg<(\d+)> \{ static constexpr int CB = (\d+), RG = (\d+), "
        r"CPT = (\d+), TT = (\d+);", SOURCE)}
    assert cfg == kr.PLAN
    assert set(cfg) == set(kr.HEAD_DIMS)
