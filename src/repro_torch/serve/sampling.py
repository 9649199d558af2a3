"""Batched per-stream sampling (counterpart of ``repro.serve.sampling``).

Greedy decoding is exact (first index of the maximum, as the reference's
argmax).  Sampled streams draw from a ``torch.Generator`` seeded per
(seed, step), so a stream's token at generation index t is a pure function
of (logits, params, seed, t) and a preempted request resumes its sample
sequence; the bits differ from the reference's PRNG.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class SamplingParams:
    """temperature <= 0 selects greedy decoding.  top_k == 0 and top_p ==
    1.0 disable their filters; top-k applies first, then top-p."""
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0


GREEDY = SamplingParams()


def params_arrays(params_list):
    """Per-stream (S,) numpy vectors for ``sample``; None means greedy."""
    ps = [p or GREEDY for p in params_list]
    return {
        "temperature": np.asarray([p.temperature for p in ps], np.float32),
        "top_k": np.asarray([p.top_k for p in ps], np.int32),
        "top_p": np.asarray([p.top_p for p in ps], np.float32),
        "seed": np.asarray([p.seed for p in ps], np.int64),
    }


def greedy(logits):
    """(..., V) -> (...,) argmax."""
    return torch.argmax(logits, dim=-1)


def _filtered(logits, top_k: int, top_p: float):
    """One stream's scaled logits with the top-k then top-p filters."""
    v = logits.shape[-1]
    s_desc, _ = torch.sort(logits, descending=True)
    k = min(max(top_k, 1), v)
    if top_k > 0:
        logits = torch.where(logits < s_desc[k - 1], -torch.inf, logits)
        s_desc = torch.where(torch.arange(v, device=logits.device) >= k,
                             -torch.inf, s_desc)
    p_desc = torch.softmax(s_desc, dim=-1)
    keep = (torch.cumsum(p_desc, -1) - p_desc) < top_p
    thr = torch.where(keep, s_desc, torch.inf).min()
    return torch.where(logits < thr, -torch.inf, logits)


def sample(logits, temperature, top_k, top_p, seed, step):
    """logits (S, V) on any device; the rest (S,) host vectors.  Returns
    (S,) token ids on the logits' device.  Greedy streams take the argmax;
    an all-greedy batch never touches the sampler."""
    out = greedy(logits)
    temperature = np.asarray(temperature)
    for s in np.flatnonzero(temperature > 0):
        lg = _filtered(logits[s].float() / float(temperature[s]),
                       int(top_k[s]), float(top_p[s]))
        g = torch.Generator(device=logits.device)
        g.manual_seed((int(seed[s]) << 32) + int(step[s]))
        out[s] = torch.multinomial(torch.softmax(lg, -1), 1, generator=g)[0]
    return out
