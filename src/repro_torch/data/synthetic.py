"""Synthetic corpora (counterpart of ``repro.data.synthetic``).

The paper's claims are relative (mux against vanilla on the same data),
so they are checked on controlled synthetic language:

  * ``MarkovCorpus`` — order-1 Markov chains with Zipf marginals: enough
    structure for an MLM to beat the unigram entropy, so pre-training has
    signal.  Its CDF is (V - 4)² float64, so it is built only at a
    synthetic vocabulary (512 by default), never at a served LM's.
  * ``classification_task`` — C Markov chains; the label is the chain
    that generated the sequence.
  * ``token_task`` — tag_t = (tok_t + tok_{t-1}) % n_tags: needs context.

The corpora and tasks are numpy, as the reference's, so a
``numpy.random.Generator`` draws the reference's batches bit for bit.
``mlm_mask`` and ``electra_corrupt`` draw from a ``torch.Generator`` on
the tokens' device (the reference takes a JAX key).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

# reserved token ids
PAD_ID, CLS_ID, SEP_ID, MASK_ID = 0, 1, 2, 3
N_SPECIAL = 4


def zipf_probs(vocab: int, alpha: float = 1.2):
    r = np.arange(1, vocab + 1, dtype=np.float64)
    p = r ** -alpha
    return p / p.sum()


@dataclass
class MarkovCorpus:
    vocab_size: int = 512
    alpha: float = 1.2
    branching: int = 8          # out-degree per state (low-entropy rows)
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        v = self.vocab_size - N_SPECIAL
        base = zipf_probs(v, self.alpha)
        # each token transitions to `branching` preferred successors
        succ = rng.integers(0, v, size=(v, self.branching))
        w = rng.dirichlet(np.ones(self.branching) * 0.5, size=v)
        rows = np.full((v, v), 1e-8)
        np.put_along_axis(rows, succ, w * 0.9, axis=1)
        rows += base[None, :] * 0.1
        rows /= rows.sum(1, keepdims=True)
        self._cum = np.cumsum(rows, axis=1)       # (v, v) CDF per state
        self._init_cum = np.cumsum(base)

    def sample(self, rng: np.random.Generator, batch: int, length: int):
        """(B, L) int32 token ids in [N_SPECIAL, vocab)."""
        out = np.empty((batch, length), np.int64)
        u = rng.random((batch, length))
        out[:, 0] = np.searchsorted(self._init_cum, u[:, 0])
        for t in range(1, length):
            rows = self._cum[out[:, t - 1]]
            out[:, t] = (u[:, t, None] < rows).argmax(1)
        return (out + N_SPECIAL).astype(np.int32)


def mlm_mask(generator: torch.Generator, tokens, *, vocab: int,
             rate: float = 0.15):
    """BERT 80/10/10 masking of (…) int tokens on the generator's device.
    Returns (inputs, labels, weights): labels are the tokens, weights the
    fp32 target indicator."""
    dev = tokens.device
    is_target = torch.rand(tokens.shape, generator=generator,
                           device=dev) < rate
    r = torch.rand(tokens.shape, generator=generator, device=dev)
    rand_tok = torch.randint(N_SPECIAL, vocab, tokens.shape,
                             generator=generator, device=dev,
                             dtype=tokens.dtype)
    inputs = torch.where(is_target & (r < 0.8),
                         torch.full_like(tokens, MASK_ID),
                         torch.where(is_target & (r < 0.9), rand_tok, tokens))
    return inputs, tokens, is_target.float()


def electra_corrupt(generator: torch.Generator, tokens, *, vocab: int,
                    rate: float = 0.15):
    """Uniform-random replacement (the paper's MUX-ELECTRA generator).
    Returns (inputs, is_replaced fp32); a replacement equal to the
    original counts as not replaced."""
    dev = tokens.device
    is_target = torch.rand(tokens.shape, generator=generator,
                           device=dev) < rate
    rand_tok = torch.randint(N_SPECIAL, vocab, tokens.shape,
                             generator=generator, device=dev,
                             dtype=tokens.dtype)
    inputs = torch.where(is_target, rand_tok, tokens)
    return inputs, (inputs != tokens).float()


def classification_task(vocab: int, n_classes: int, seed: int = 0):
    """C Markov corpora; label = which chain generated the sequence."""
    corpora = [MarkovCorpus(vocab, seed=seed * 100 + c, branching=4 + 2 * c)
               for c in range(n_classes)]

    def sample(rng: np.random.Generator, batch: int, length: int):
        labels = rng.integers(0, n_classes, batch)
        seqs = np.stack([corpora[labels[i]].sample(rng, 1, length - 1)[0]
                         for i in range(batch)])
        cls = np.full((batch, 1), CLS_ID, np.int32)
        return np.concatenate([cls, seqs], 1), labels.astype(np.int32)
    return sample


def token_task(vocab: int, n_tags: int, seed: int = 0):
    """Token-level tags requiring one token of left context."""
    corpus = MarkovCorpus(vocab, seed=seed)

    def sample(rng: np.random.Generator, batch: int, length: int):
        toks = corpus.sample(rng, batch, length)
        prev = np.concatenate([toks[:, :1], toks[:, :-1]], 1)
        tags = ((toks + prev) % n_tags).astype(np.int32)
        return toks, tags
    return sample
