"""Attention primitives (``repro.nn.attention``), three implementations
with one semantics:

  * ``attention_core``         — naive, materialized (Lq, Lk) logits;
  * ``chunked_attention_core`` — a loop over KV chunks with an online
                                 softmax, never the whole (Lq, Lk) matrix;
  * the flash-attention kernel — ``kernels.ops.flash_attention``, selected
                                 by ``multi_head_attention(impl='flash')``.

Shapes: q (B, Lq, H, Dh); k, v (B, Lk, Hkv, Dh) with H % Hkv == 0.  GQA
groups the queries per KV head; K/V are never repeated to H heads.
"""
from __future__ import annotations

import torch

from repro_torch.nn.layers import rounded

# large but finite: a fully masked row softmaxes to the uniform mean of V
# instead of NaN (the kernels use the same value)
NEG_INF = -2.0 ** 30


def make_attention_mask(q_pos, kv_pos, *, causal: bool = True,
                        window: int | None = None, kv_valid=None):
    """Boolean (..., Lq, Lk) mask, True = attend.  q_pos / kv_pos broadcast
    to (..., Lq) and (..., Lk); ``window`` keeps q_pos - window < kv_pos;
    ``kv_valid`` is an optional (..., Lk) bool of valid cache slots."""
    q = q_pos[..., :, None]
    k = kv_pos[..., None, :]
    mask = torch.ones(torch.broadcast_shapes(q.shape, k.shape),
                      dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (k <= q)
    if window is not None:
        mask = mask & (k > q - window)
    if kv_valid is not None:
        mask = mask & kv_valid[..., None, :]
    return mask


def _promoted(a, b):
    """a and b in their promoted dtype: JAX promotes a bf16 operand
    against fp32 (bf16 queries over fp32 or dequantized pages), where
    PyTorch's einsum raises."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def attention_core(q, k, v, *, mask=None,
                   logit_softcap: float | None = None):
    """Naive attention with an fp32 softmax; mask (.., Lq, Lk) broadcasts
    over heads.  The scores are rounded to the promoted dtype of q and K
    before the softmax, P to q's dtype before P V, as in the reference.
    Returns (B, Lq, H, Dh) in the promoted dtype of q and V (q's dtype
    unless fp32 K/V meet a bf16 q)."""
    b, lq, h, dh = q.shape
    n_kv = k.shape[2]
    qg = (q * rounded(dh ** -0.5, q.dtype)).reshape(b, lq, n_kv, h // n_kv,
                                                    dh)
    logits = torch.einsum("bqkgd,bskd->bkgqs", *_promoted(qg, k)).float()
    if logit_softcap is not None:
        logits = torch.tanh(logits / logit_softcap) * logit_softcap
    if mask is not None:
        m = mask[:, None, None] if mask.ndim == 3 else mask
        logits = logits.masked_fill(~m, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", *_promoted(w, v))
    return out.reshape(b, lq, h, dh)


def widened_attention(q, k, v, *, mask=None,
                      logit_softcap: float | None = None):
    """The attention kernels' arithmetic (the Pallas kernels' and the
    port's): q, K and V widened to fp32 (a bf16 value exactly), scores,
    softmax and P V in fp32, the output rounded once to q's dtype, where
    ``attention_core`` rounds the scores and P to a bf16 q's dtype."""
    return attention_core(q.float(), k.float(), v.float(), mask=mask,
                          logit_softcap=logit_softcap).to(q.dtype)


def chunked_attention_core(q, k, v, *, causal: bool = True,
                           window: int | None = None, q_offset: int = 0,
                           chunk_size: int = 512,
                           logit_softcap: float | None = None):
    """Online-softmax attention over KV chunks of ``chunk_size`` keys.
    Positions are ``q_offset + arange(Lq)`` for queries and ``arange(Lk)``
    for keys; keys past Lk in the last chunk are masked.  Fully masked
    chunks still run and contribute zero weight, as in the reference."""
    b, lq, h, dh = q.shape
    lk, n_kv = k.shape[1], k.shape[2]
    g = h // n_kv
    dev = q.device
    qg = (q * rounded(dh ** -0.5, q.dtype)).reshape(b, lq, n_kv, g, dh)
    q_pos = q_offset + torch.arange(lq, device=dev)
    m_i = torch.full((b, n_kv, g, lq), NEG_INF, dtype=torch.float32,
                     device=dev)
    l_i = torch.zeros((b, n_kv, g, lq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, n_kv, g, lq, dh), dtype=torch.float32, device=dev)
    for j in range(-(-lk // chunk_size)):
        kj = k[:, j * chunk_size:(j + 1) * chunk_size]
        vj = v[:, j * chunk_size:(j + 1) * chunk_size]
        pad = chunk_size - kj.shape[1]
        if pad:                      # the reference pads the last chunk
            kj = torch.nn.functional.pad(kj, (0, 0, 0, 0, 0, pad))
            vj = torch.nn.functional.pad(vj, (0, 0, 0, 0, 0, pad))
        logits = torch.einsum("bqkgd,bskd->bkgqs", qg, kj).float()
        if logit_softcap is not None:
            logits = torch.tanh(logits / logit_softcap) * logit_softcap
        kv_pos = j * chunk_size + torch.arange(chunk_size, device=dev)
        mask = (kv_pos[None, :] < lk).expand(lq, chunk_size)
        if causal:
            mask = mask & (kv_pos[None, :] <= q_pos[:, None])
        if window is not None:
            mask = mask & (kv_pos[None, :] > q_pos[:, None] - window)
        logits = logits.masked_fill(~mask, NEG_INF)
        m_new = torch.maximum(m_i, logits.amax(-1))
        p = torch.exp(logits - m_new[..., None])
        alpha = torch.exp(m_i - m_new)
        l_i = l_i * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bkgqs,bskd->bkgqd", p.to(vj.dtype), vj).float()
        m_i = m_new
    out = acc / torch.clamp(l_i, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, lq, h, dh).to(q.dtype)


def multi_head_attention(q, k, v, *, impl: str = "naive", mask=None,
                         causal: bool = True, window: int | None = None,
                         q_offset: int = 0, chunk_size: int = 512,
                         logit_softcap: float | None = None):
    """Dispatch between the implementations ('naive', 'chunked', 'flash'),
    which share one semantics: queries at ``q_offset + arange(Lq)``, keys
    at ``arange(Lk)``."""
    if impl == "chunked":
        if mask is not None:
            raise ValueError("chunked path builds masks from positions")
        return chunked_attention_core(
            q, k, v, causal=causal, window=window, q_offset=q_offset,
            chunk_size=chunk_size, logit_softcap=logit_softcap)
    if impl == "flash":
        from repro_torch.kernels import ops as kops
        return kops.flash_attention(q, k, v, causal=causal, window=window,
                                    q_offset=q_offset,
                                    logit_softcap=logit_softcap)
    if impl != "naive":
        raise ValueError(f"attention impl {impl!r}: naive|chunked|flash")
    if mask is None:
        lq, lk = q.shape[1], k.shape[1]
        mask = make_attention_mask(
            q_offset + torch.arange(lq, device=q.device),
            torch.arange(lk, device=q.device), causal=causal,
            window=window)[None]
    return attention_core(q, k, v, mask=mask, logit_softcap=logit_softcap)
