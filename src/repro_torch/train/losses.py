"""Loss functions (counterpart of ``repro.train.losses``): fp32
reductions, and a chunked tied-softmax cross-entropy that never
materialises the (B, L, V) logits."""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint


def softmax_xent(logits, labels, weights=None):
    """logits (..., V); labels (...) int; weights (...) or None: the mean
    NLL, or its weighted mean over max(sum(weights), 1)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels.long()[..., None])[..., 0]
    if weights is None:
        return nll.mean()
    return (nll * weights).sum() / weights.sum().clamp(min=1.0)


def causal_lm_loss(logits, tokens, weights=None):
    """Next-token prediction: logits[t] predicts tokens[t+1]."""
    w = None if weights is None else weights[:, 1:]
    return softmax_xent(logits[:, :-1], tokens[:, 1:], w)


def sigmoid_bce(logits, labels, weights=None):
    """ELECTRA replaced-token detection: logits (...), labels in {0, 1}."""
    lg = logits.float()
    ls = lg.clamp(min=0) - lg * labels + torch.log1p(torch.exp(-lg.abs()))
    if weights is None:
        return ls.mean()
    return (ls * weights).sum() / weights.sum().clamp(min=1.0)


def _chunk_nll(h, table, bias, lab, w):
    """Summed weighted NLL and weight of one (B, chunk) slice."""
    logits = h @ table.to(h.dtype).T
    if bias is not None:
        logits = logits + bias.to(logits.dtype)
    lg = logits.float()
    m = lg.detach().amax(dim=-1, keepdim=True)
    lse = m[..., 0] + torch.log(torch.exp(lg - m).sum(dim=-1))
    nll = lse - lg.gather(-1, lab.long()[..., None])[..., 0]
    return (nll * w).sum(), w.sum()


def chunked_vocab_xent(hidden, table, labels, weights=None, *, bias=None,
                       chunk: int = 512):
    """Tied-softmax cross-entropy without the (B, L, V) logits: the
    sequence is cut into ``chunk``-token slices, and each slice's logits
    live only inside its checkpointed step (recomputed for the backward),
    so at most (B, chunk, V) are alive.  hidden (B, L, D); table (V, D);
    labels (B, L)."""
    b, l, _ = hidden.shape
    if weights is None:
        weights = torch.ones((b, l), device=hidden.device)
    num = torch.zeros((), device=hidden.device)
    den = torch.zeros((), device=hidden.device)
    for s in range(0, l, chunk):
        sl = slice(s, min(s + chunk, l))
        n, d = checkpoint(_chunk_nll, hidden[:, sl], table, bias,
                          labels[:, sl], weights[:, sl], use_reentrant=False)
        num, den = num + n, den + d
    return num / den.clamp(min=1.0)
