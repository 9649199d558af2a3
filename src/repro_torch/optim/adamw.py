"""AdamW with decoupled weight decay, global-norm clipping and per-path
masks (counterpart of ``repro.optim.adamw``): no decay on norms, biases
and 1-D params; no update of the fixed Gaussian mux keys.

The state mirrors the params (``m``, ``v``: fp32 trees of the same
structure) plus a host int ``count``.  ``update`` changes the params and
the state in place under ``torch.no_grad()``: at full width a second
copy of the params (the reference's ``updates`` tree) would cost as much
memory as the params themselves.

The masks decide on the reference's path and rank.  The port keeps one
dict per layer in a ``layers`` list, where the reference stacks layer i
of a block pattern of length P at ``periods/<i % P>`` over the n_layers
// P periods (one more axis) and keeps the leftover layers unstacked
under ``tail/<k>``.  A per-layer vector of a stacked layer is 1-D here
but 2-D there, and the reference's decay mask decays it (rwkv6's
``dec_w0`` and ``mu_cm``; recurrentgemma-9b's ``lam`` and ``conv_b`` in
its periods, not in its tail).  ``reference_leaves`` gives each leaf
the path and rank it has in the reference, and the masks read those;
``AdamW.pattern`` is P (``len(cfg.block_pattern)``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch


def path_str(path) -> str:
    return "/".join(str(k) for k in path)


def default_decay_mask(path, ndim: int) -> bool:
    """True = apply weight decay.  ``path``: the leaf's key path in the
    reference's tree; ``ndim``: its rank there.  Skips norms, biases,
    scales and 1-D params."""
    if ndim <= 1:
        return False
    s = path_str(path)
    return not any(tok in s for tok in ("ln", "norm", "bias", "scale"))


def default_trainable_mask(path, ndim: int) -> bool:
    """False = frozen.  The paper keeps the Gaussian mux keys v fixed."""
    return not path_str(path).endswith("mux_engine/mux/v")


def reference_leaves(tree, *others, pattern: int = 1):
    """[(reference path, reference rank, leaf, *others' leaves)] of a port
    tree in the reference's order (dict keys sorted), each with the leaf
    at the same place in every tree of ``others`` (None where one holds
    none).  Layer i of a ``layers`` list of n is the reference's
    ``periods/<i % pattern>`` with one more axis while i < n // pattern *
    pattern, else ``tail/<i % pattern>`` at its own rank."""
    out = []

    def pick(trees, k):
        return tuple(None if t is None else t[k] for t in trees)

    def walk(t, os, ref, stacked):
        if t is None:
            return
        if isinstance(t, dict):
            for k in sorted(t):
                sub = tuple(None if o is None else o.get(k) for o in os)
                if k != "layers" or not isinstance(t[k], list):
                    walk(t[k], sub, ref + (k,), stacked)
                    continue
                n_stacked = len(t[k]) // pattern * pattern
                for i in range(len(t[k])):
                    stack = i < n_stacked
                    walk(t[k][i], pick(sub, i),
                         ref + ("periods" if stack else "tail",
                                i % pattern), int(stack))
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, pick(os, i), ref + (i,), stacked)
        else:
            out.append((ref, t.ndim + stacked, t, *os))

    walk(tree, others, (), 0)
    return out


def global_norm(tree):
    """sqrt of the sum of squares of every leaf, in fp32 (a 0-d tensor)."""
    return torch.sqrt(sum(x[2].float().square().sum()
                          for x in reference_leaves(tree)))


@dataclass(frozen=True)
class AdamW:
    lr: Callable | float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float | None = 1.0
    decay_mask: Callable = staticmethod(default_decay_mask)
    trainable_mask: Callable = staticmethod(default_trainable_mask)
    pattern: int = 1              # the model's len(cfg.block_pattern)

    def init(self, params):
        def zeros(t):
            if isinstance(t, dict):
                return {k: zeros(v) for k, v in t.items()}
            if isinstance(t, (list, tuple)):
                return type(t)(zeros(v) for v in t)
            return None if t is None else torch.zeros(
                t.shape, dtype=torch.float32, device=t.device)
        return {"m": zeros(params), "v": zeros(params), "count": 0}

    @torch.no_grad()
    def update(self, grads, state, params, *, grad_norm=None):
        """One step; ``params`` and ``state`` change in place.  ``grads``
        has the params' structure (a missing or ``None`` leaf is a zero
        gradient, as JAX's gradient of an unused param).  grad_norm: the
        norm to clip by when the caller has it (a sharded step's, over
        every rank's shards), else that of ``grads``.  Returns
        (state, {"grad_norm": 0-d tensor before clipping, "lr": float}).
        The arithmetic is the reference's, in fp32: the learning rate at
        the incremented count, clipping by clip_norm / (norm + 1e-9),
        the bias corrections, decay added to the step before -lr; a
        frozen leaf keeps its value, ``m`` and ``v``."""
        count = state["count"] + 1
        lr = float(self.lr(count) if callable(self.lr) else self.lr)
        leaves = reference_leaves(params, grads, state["m"], state["v"],
                                  pattern=self.pattern)
        gs = [torch.zeros_like(p) if g is None else g
              for _, _, p, g, _, _ in leaves]
        gnorm = (torch.sqrt(sum(g.float().square().sum() for g in gs))
                 if grad_norm is None else grad_norm)
        scale = (None if self.clip_norm is None else
                 torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0))
        # fp32 on the host, as the reference's count is; host scalars, so
        # the step copies nothing to the device and never waits for it
        b1c, b2c = (float(np.float32(1.0) - np.float32(b) ** np.float32(
            count)) for b in (self.b1, self.b2))
        for (path, ndim, p, _, m, v), g in zip(leaves, gs):
            if not self.trainable_mask(path, ndim):
                continue
            g = g.float() if scale is None else g.float() * scale
            m.mul_(self.b1).add_(g * (1 - self.b1))
            v.mul_(self.b2).add_(g.square().mul_(1 - self.b2))
            step = (m / b1c).div_((v / b2c).sqrt_().add_(self.eps))
            if self.decay_mask(path, ndim):
                step.add_(p.float() * self.weight_decay)
            p.add_(step.mul_(-lr).to(p.dtype))
        state["count"] = count
        return state, {"grad_norm": gnorm, "lr": lr}


# --------------------------------------------------------------------------
# LR schedules: fp32 arithmetic on the count, as the reference's
# --------------------------------------------------------------------------

def linear_warmup_linear_decay(peak_lr: float, warmup: int, total: int,
                               floor: float = 0.0):
    f = np.float32

    def sched(step):
        s = f(step)
        warm = f(peak_lr) * s / f(max(warmup, 1))
        frac = np.clip((f(total) - s) / f(max(total - warmup, 1)),
                       f(0.0), f(1.0))
        decay = f(floor) + f(peak_lr - floor) * frac
        return float(warm if s < warmup else decay)
    return sched


def linear_warmup_cosine_decay(peak_lr: float, warmup: int, total: int,
                               floor: float = 0.0):
    f = np.float32

    def sched(step):
        s = f(step)
        warm = f(peak_lr) * s / f(max(warmup, 1))
        t = np.clip((s - f(warmup)) / f(max(total - warmup, 1)),
                    f(0.0), f(1.0))
        decay = f(floor) + f((peak_lr - floor) * 0.5) * (
            f(1.0) + np.cos(f(math.pi) * t))
        return float(warm if s < warmup else decay)
    return sched
