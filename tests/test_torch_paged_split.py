"""The split page walk of the port's paged-attention kernels, on the CPU.

``csrc/paged_attention.cu`` splits each row's block table across blocks
(``kernels/paged_attention.py`` ``decode_plan`` / ``prefill_plan``): a
split walks a contiguous run of table entries in tiles of slots with an
online softmax in log2 units, and the splits merge by their log-sum-exp in
split order.  The kernels run only on the card; here a torch model of that
arithmetic (``split_model``) is held to the plain versions over the edge
cases of ``tests/test_torch_kernels.py`` (-1 entries, an inactive row,
bucket padding, single-block rows, Lq = 7, a window, a query that sees
no slot, and h2o-danube-1.8b's head_dim 80 with a window that skips
whole pages and whole splits), within the attention tolerance
``ATT_TOL`` (fp32 on both sides, summation order only).  A query that
sees no slot returns the uniform mean of V over all MB * BS gathered
slots, -1 entries read as page 0.  The chunk kernel's products take the
3xTF32 split; its CPU model
(``_split_mm`` of ``tests/test_torch_dense_attention.py``) over
page-gathered K/V keeps fp32's accuracy where one TF32 product does not.
"""
import inspect

import numpy as np
import pytest
import torch

from repro_torch.kernels import paged_attention as kp
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import TILES, padded_head_dim
from test_torch_dense_attention import _split_mm
from test_torch_kernels import (ATT_TOL, CARD_DECODE_CASES,
                                CARD_PREFILL_CASES, STORE_KINDS,
                                _decode_inputs, _prefill_inputs,
                                _prefill_window, _store, build_pool)

torch.set_num_threads(2)

NEG = -2.0 ** 30                       # the reference's finite mask value
LOG2E = 1.4426950408889634


def _mm(a, b, passes):
    return a @ b if passes is None else _split_mm(a, b, passes)


def split_model(q, k_pages, v_pages, block_tables, page_pos, q_pos, *, plan,
                tile, window=None, causal=True, passes=None):
    """The kernels' arithmetic: q (B, Lq, H, Dh); pages fp32 (dequantized);
    q_pos (B, Lq) each query's position (-1: sees no slot).  Split s walks
    table entries [s * per, (s + 1) * per) in tiles of ``tile`` slots,
    -1 entries read as page 0 and masked; the splits merge in order.
    ``passes``: None for fp32 products, 1 or 3 for TF32 / 3xTF32."""
    nsplit, per = plan
    b_n, lq, h, dh = q.shape
    _, bs, hkv, _ = k_pages.shape
    mb = block_tables.shape[1]
    g = h // hkv
    qs = (q * dh ** -0.5).transpose(1, 2)                  # (B, H, Lq, Dh)
    out = torch.empty_like(q)
    for b in range(b_n):
        qp = q_pos[b][:, None]                             # (Lq, 1)
        parts = []
        for s in range(nsplit):
            ent = block_tables[b, s * per:min(mb, (s + 1) * per)].long()
            pages = ent.clamp(min=0)
            k = k_pages[pages].reshape(-1, hkv, dh).repeat_interleave(g, 1)
            v = v_pages[pages].reshape(-1, hkv, dh).repeat_interleave(g, 1)
            pos = page_pos[pages].reshape(-1)
            alloc = (ent >= 0).repeat_interleave(bs)
            m = torch.full((h, lq), -torch.inf)
            l = torch.zeros((h, lq))
            acc = torch.zeros((h, lq, dh))
            for t0 in range(0, len(pos), tile):
                kt, vt = k[t0:t0 + tile], v[t0:t0 + tile]   # (n, H, Dh)
                p_, a_ = pos[t0:t0 + tile][None], alloc[t0:t0 + tile][None]
                ok = a_ & (p_ >= 0) & (qp >= 0)
                if causal:
                    ok = ok & (p_ <= qp)
                if window is not None:
                    ok = ok & (p_ > qp - window)
                sc = _mm(qs[b], kt.permute(1, 2, 0), passes)  # (H, Lq, n)
                x = torch.where(ok[None], sc, NEG) * LOG2E
                m_new = torch.maximum(m, x.amax(-1))
                p = torch.exp2(x - m_new[..., None])
                alpha = torch.exp2(m - m_new)
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[..., None] + _mm(p, vt.transpose(0, 1),
                                                   passes)
                m = m_new
            parts.append((m, l, acc))
        m_all = torch.stack([p[0] for p in parts]).amax(0)
        w = [torch.exp2(p[0] - m_all) for p in parts]
        l_all = sum(p[1] * wi for p, wi in zip(parts, w))
        o = sum(p[2] * wi[..., None] for p, wi in zip(parts, w))
        out[b] = (o / l_all[..., None]).transpose(0, 1)
    return out


def _prefill_q_pos(q_start, q_len, lq):
    li = torch.arange(lq)[None]
    q_pos = q_start.long()[:, None] + li
    return torch.where((li >= q_len.long()[:, None])
                       | (q_start.long()[:, None] < 0), -1, q_pos)


def _blind_mean(v_pages, block_tables):
    """The uniform mean of V over every gathered slot of each row, -1
    entries read as page 0: (B, Hkv, Dh)."""
    v = v_pages[block_tables.long().clamp(min=0)]          # (B, MB, BS, ..)
    return v.reshape(v.shape[0], -1, *v.shape[3:]).mean(1)


def _decode_plan(q, pages, bt):
    b, _, h, _ = q.shape
    return kp.decode_plan(b, h, pages.shape[2], bt.shape[1], pages.shape[1])


def _prefill_plan(q, pages, bt):
    b, lq, h, dh = q.shape
    return kp.prefill_plan(b, lq, h, pages.shape[2], dh, bt.shape[1],
                           pages.shape[1])


# ------------------------------------------------------------ the plan

# (what, batch, lq, heads, kv heads, head_dim, MB, BS): chip_smoke.py phase
# 3's shapes, phase 4's (4 rows at capacity 124 in blocks of 16: MB 8; a
# 32-token chunk and a 4-token bucket of one row), the CLI's block size 4
# at the same capacity, gemma-2b's, gemma-7b's and h2o-danube-1.8b's heads,
# h2o's 4200-token request (MB 263), and small edges
PLAN_SHAPES = [
    ("decode", 4, 1, 12, 2, 128, 8, 16),
    ("prefill", 1, 32, 12, 2, 128, 8, 16),
    ("prefill", 1, 4, 12, 2, 128, 8, 16),
    ("prefill", 2, 16, 12, 2, 128, 8, 16),
    ("decode", 4, 1, 12, 2, 128, 31, 4),
    ("prefill", 1, 32, 12, 2, 128, 31, 4),
    ("prefill", 4, 4, 12, 2, 128, 31, 4),
    ("decode", 2, 1, 8, 1, 256, 8, 16),
    ("prefill", 1, 16, 8, 1, 256, 8, 16),
    ("decode", 4, 1, 16, 16, 256, 8, 16),
    ("prefill", 1, 32, 16, 16, 256, 8, 16),
    ("decode", 4, 1, 32, 8, 80, 8, 16),
    ("prefill", 1, 32, 32, 8, 80, 8, 16),
    ("decode", 4, 1, 32, 8, 80, 263, 16),
    ("prefill", 1, 32, 32, 8, 80, 263, 16),
    ("decode", 3, 1, 16, 1, 64, 1, 8),
    ("prefill", 2, 7, 4, 2, 8, 4, 8),
    ("decode", 64, 1, 32, 8, 128, 256, 16),
    ("prefill", 8, 32, 32, 8, 128, 256, 16),
]


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=lambda s: "-".join(
    map(str, s)))
def test_split_plan_covers_each_entry_once(shape):
    """Each table entry in exactly one split, in order, none empty; a split
    holds at least one tile of slots unless it is the whole row."""
    what, b, lq, h, hkv, dh, mb, bs = shape
    if what == "decode":
        nsplit, per = kp.decode_plan(b, h, hkv, mb, bs)
        tile = kp.DECODE_TILE
    else:
        nsplit, per = kp.prefill_plan(b, lq, h, hkv, dh, mb, bs)
        tile = TILES[padded_head_dim(dh)][0]
    runs = [list(range(s * per, min(mb, (s + 1) * per)))
            for s in range(nsplit)]
    assert all(runs) and sum(runs, []) == list(range(mb))
    assert per * bs >= tile or per == mb


def test_split_plan_fills_the_card_at_the_main_path():
    """Eight splits of one page at both main-path shapes (64 decode blocks,
    48 chunk blocks: MB bounds the split); four entries of four slots at
    BS 4."""
    assert kp.decode_plan(4, 12, 2, 8, 16) == (8, 1)
    assert kp.prefill_plan(1, 32, 12, 2, 128, 8, 16) == (8, 1)
    assert kp.prefill_plan(1, 4, 12, 2, 128, 8, 16) == (8, 1)
    assert kp.decode_plan(4, 12, 2, 31, 4) == (8, 4)
    # enough rows fill the card without splitting
    assert kp.decode_plan(64, 32, 8, 256, 16)[0] <= 2


def test_split_plan_depends_on_shapes_only():
    """The plan takes integers (shapes), never a tensor: the wrappers read
    no device tensor on the host, and a captured launch can replay."""
    for fn in (kp.decode_plan, kp.prefill_plan, kp.splits):
        params = inspect.signature(fn).parameters.values()
        assert all(p.annotation in (int, "int") for p in params), fn
    src = inspect.getsource(kp.paged_attention_cuda)
    assert "decode_plan(b, h, hkv, mb, bs)" in src
    src = inspect.getsource(kp.paged_prefill_attention_cuda)
    assert "prefill_plan(b, lq, h, hkv, dh, mb, bs)" in src


# ------------------------------------------------- the model of the splits

@pytest.mark.parametrize("case", sorted(CARD_DECODE_CASES))
def test_decode_split_model_matches_plain(case):
    args, window = _decode_inputs(case)
    q, k, v, bt, pp, qp = map(torch.as_tensor, args)
    plan = _decode_plan(q, k, bt)
    got = split_model(q, k, v, bt, pp, qp[:, None], plan=plan,
                      tile=kp.DECODE_TILE, window=window)
    want = ref.paged_attention_ref(q, k, v, bt, pp, qp, window=window)
    torch.testing.assert_close(got, want, **ATT_TOL)


@pytest.mark.parametrize("case", sorted(CARD_PREFILL_CASES))
@pytest.mark.parametrize("passes", [None, 3])
def test_prefill_split_model_matches_plain(case, passes):
    """In fp32 and in the chunk kernel's 3xTF32 products."""
    q, k, v, bt, pp, qs, ql = map(torch.as_tensor, _prefill_inputs(case))
    window = _prefill_window(case)
    plan = _prefill_plan(q, k, bt)
    got = split_model(q, k, v, bt, pp, _prefill_q_pos(qs, ql, q.shape[1]),
                      plan=plan, tile=TILES[padded_head_dim(q.shape[-1])][0],
                      window=window, passes=passes)
    want = ref.paged_prefill_attention_ref(q, k, v, bt, pp, qs, ql,
                                           window=window)
    torch.testing.assert_close(got, want, **ATT_TOL)


@pytest.mark.parametrize("what", ["decode", "prefill"])
def test_window_past_whole_splits_matches_plain(what):
    """h2o-danube-1.8b's heads (32 over 8 of 80) over a long row of pages
    of 16 whose window (48) ends before most of it: the splits over the
    early pages see no slot (m = the mask value), yet the merge weighs them
    exactly 0 beside the splits that see the window, as the plain version
    does; in the chunk kernel's 3xTF32 products too."""
    rng = np.random.default_rng(80)
    ctx, window = 300, 48
    k, v, bt, pp = map(torch.as_tensor, build_pool(
        rng, [ctx, 120], num_blocks=40, block_size=16, max_blocks=19, hkv=8,
        dh=80))
    lq = 1 if what == "decode" else 16
    q = torch.as_tensor(rng.standard_normal((2, lq, 32, 80), np.float32))
    if what == "decode":
        qp = torch.tensor([ctx - 1, 119], dtype=torch.int32)
        plan, tile = _decode_plan(q, k, bt), kp.DECODE_TILE
        q_pos = qp.long()[:, None]
        want = ref.paged_attention_ref(q, k, v, bt, pp, qp, window=window)
    else:
        qs, ql = torch.tensor([ctx - lq, 120 - lq]), torch.tensor([lq, lq])
        plan, tile = _prefill_plan(q, k, bt), TILES[128][0]
        q_pos = _prefill_q_pos(qs, ql, lq)
        want = ref.paged_prefill_attention_ref(q, k, v, bt, pp, qs, ql,
                                               window=window)
    nsplit, per = plan
    # some split of row 0 lies wholly before every query's window
    first_seen = (ctx - lq - window + 1) // 16
    assert nsplit > 1 and per <= first_seen
    for passes in ((None, 3) if what == "prefill" else (None,)):
        got = split_model(q, k, v, bt, pp, q_pos, plan=plan, tile=tile,
                          window=window, passes=passes)
        torch.testing.assert_close(got, want, **ATT_TOL)


@pytest.mark.parametrize("kind", STORE_KINDS)
@pytest.mark.parametrize("case", ["hetero_inactive", "bs4_splits"])
def test_split_model_matches_quantized_plain(kind, case):
    """Stored pages, widened times their slot's scale (the kernels' single
    rounding, ``dequantize_kv``'s bits), against the dequantize-then-attend
    plain version."""
    (q, k, v, bt, pp, qp), window = _decode_inputs(case)
    ks, vs, sc = _store(kind, k, v)
    q, bt, pp, qp = map(torch.as_tensor, (q, bt, pp, qp))
    if sc:
        want = ref.paged_attention_quant_ref(q, ks, vs, sc["k_scales"],
                                             sc["v_scales"], bt, pp, qp,
                                             window=window)
        kd = ks.float() * sc["k_scales"][..., None]
        vd = vs.float() * sc["v_scales"][..., None]
    else:
        want = ref.paged_attention_ref(q, ks, vs, bt, pp, qp, window=window)
        kd, vd = ks.float(), vs.float()
    got = split_model(q, kd, vd, bt, pp, qp[:, None],
                      plan=_decode_plan(q, ks, bt), tile=kp.DECODE_TILE,
                      window=window)
    torch.testing.assert_close(got, want, **ATT_TOL)


def test_blind_queries_average_every_gathered_slot():
    """A query that sees no slot — an inactive row, bucket padding, a
    window past the row's context — returns the uniform mean of V over all
    MB * BS gathered slots (-1 entries read as page 0), in the plain
    version and in the split model, whatever the split."""
    # decode: row 2 inactive, row 0 active but its window excludes every
    # written slot
    (q, k, v, bt, pp, qp), _ = _decode_inputs("window_blind")
    q, k, v, bt, pp = map(torch.as_tensor, (q, k, v, bt, pp))
    qp = torch.as_tensor(np.asarray([40, 11, -1], np.int32))
    mean = _blind_mean(v, bt).repeat_interleave(q.shape[2] // k.shape[2], 1)
    plan = _decode_plan(q, k, bt)
    assert plan[0] > 1
    for got in (ref.paged_attention_ref(q, k, v, bt, pp, qp, window=8),
                split_model(q, k, v, bt, pp, qp[:, None], plan=plan,
                            tile=kp.DECODE_TILE, window=8)):
        torch.testing.assert_close(got[0, 0], mean[0], **ATT_TOL)
        torch.testing.assert_close(got[2, 0], mean[2], **ATT_TOL)
    # a chunk: bucket padding (row 0 past q_len) and an inactive row
    rng = np.random.default_rng(5)
    k, v, bt, pp = map(torch.as_tensor, build_pool(
        rng, [23, -1], num_blocks=12, block_size=4, max_blocks=32, hkv=2,
        dh=16))
    q = torch.as_tensor(rng.standard_normal((2, 8, 6, 16), np.float32))
    qs, ql = torch.tensor([16, -1]), torch.tensor([5, 0])
    mean = _blind_mean(v, bt).repeat_interleave(3, 1)
    plan = _prefill_plan(q, k, bt)
    assert plan[0] > 1
    for got in (ref.paged_prefill_attention_ref(q, k, v, bt, pp, qs, ql),
                split_model(q, k, v, bt, pp, _prefill_q_pos(qs, ql, 8),
                            plan=plan, tile=TILES[32][0], passes=3)):
        for li in range(5, 8):
            torch.testing.assert_close(got[0, li], mean[0], **ATT_TOL)
        for li in range(8):
            torch.testing.assert_close(got[1, li], mean[1], **ATT_TOL)


@pytest.mark.parametrize("lq,h,hkv,dh,ctx", [(32, 12, 2, 128, 96),
                                             (16, 8, 1, 256, 80)])
def test_3xtf32_paged_attention_keeps_fp32_accuracy(lq, h, hkv, dh, ctx):
    """The chunk kernel's products over page-gathered K/V (qwen2-1.5b's
    chunk and gemma-2b's heads, causal, one -1 entry): the 3xTF32 split
    stays within ATT_TOL of fp64 where one TF32 product does not."""
    rng = np.random.default_rng(dh)
    k, v, bt, pp = map(torch.as_tensor, build_pool(
        rng, [ctx], num_blocks=12, block_size=16, max_blocks=8, hkv=hkv,
        dh=dh))
    q = torch.as_tensor(rng.standard_normal((1, lq, h, dh), np.float32))
    qs, ql = torch.tensor([ctx - lq]), torch.tensor([lq])
    q_pos = _prefill_q_pos(qs, ql, lq)
    # the truth in fp64: the row's pages gathered, every query active
    btc = bt[0].long().clamp(min=0)
    kg, vg = (x[btc].reshape(-1, hkv, dh).double().repeat_interleave(
        h // hkv, 1).transpose(0, 1) for x in (k, v))      # (H, S, Dh)
    pos = torch.where(bt[0, :, None] >= 0, pp[btc], -1).reshape(-1)
    ok = (pos[None] >= 0) & (pos[None] <= q_pos[0][:, None])  # (Lq, S)
    sc = (q[0].double().transpose(0, 1) * dh ** -0.5) @ kg.transpose(1, 2)
    sc = sc.masked_fill(~ok, -torch.inf)
    want = (torch.softmax(sc, -1) @ vg).transpose(0, 1)[None]
    plan = _prefill_plan(q, k, bt)
    tile = TILES[padded_head_dim(dh)][0]
    got = split_model(q, k, v, bt, pp, q_pos, plan=plan, tile=tile,
                      passes=3)
    torch.testing.assert_close(got.double(), want, **ATT_TOL)
    plain = split_model(q, k, v, bt, pp, q_pos, plan=plan, tile=tile,
                        passes=1)
    assert not torch.allclose(plain.double(), want, **ATT_TOL)
