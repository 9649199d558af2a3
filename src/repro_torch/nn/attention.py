"""Attention primitives the plain paths need (``repro.nn.attention``).

Shapes: q (B, Lq, H, Dh); k, v (B, Lk, Hkv, Dh) with H % Hkv == 0.  GQA
groups the queries per KV head; K/V are never repeated to H heads.
"""
from __future__ import annotations

import torch

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


def attention_core(q, k, v, *, mask=None,
                   logit_softcap: float | None = None):
    """Naive attention with an fp32 softmax; mask (.., Lq, Lk) broadcasts
    over heads.  Returns (B, Lq, H, Dh) in q.dtype."""
    b, lq, h, dh = q.shape
    n_kv = k.shape[2]
    qg = (q * dh ** -0.5).reshape(b, lq, n_kv, h // n_kv, dh)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k).float()
    if logit_softcap is not None:
        logits = torch.tanh(logits / logit_softcap) * logit_softcap
    if mask is not None:
        m = mask[:, None, None] if mask.ndim == 3 else mask
        logits = logits.masked_fill(~m, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v)
    return out.reshape(b, lq, h, dh)
