"""Train-step factory (counterpart of ``repro.train.step``): gradients
by autograd, optional microbatch accumulation, then AdamW in place.

PyTorch runs eagerly: ``jit_step`` is the identity, and the step updates
``params`` and the optimizer state in place (``AdamW.update``), so no
second copy of either is made.  The params' leaves are the training
state and require grad (the step marks them); a forward under autograd
must take the plain model path (``use_kernels=False``, as the
reference's training), because the CUDA kernels have no backward and
their wrappers refuse tensors that require grad.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.optim.adamw import reference_leaves


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def _detach(metrics):
    return {k: v.detach() if isinstance(v, torch.Tensor) else v
            for k, v in metrics.items()}


def micro_generators(generator: torch.Generator, n: int):
    """``n`` generators on ``generator``'s device, seeded from it: one per
    microbatch, as the reference splits the step's key."""
    seeds = torch.randint(2 ** 62, (n,), generator=generator,
                          device=generator.device).tolist()
    return [torch.Generator(generator.device).manual_seed(s) for s in seeds]


def make_train_step(loss_fn: Callable, optimizer, *,
                    n_microbatches: int = 1):
    """loss_fn(params, batch, generator) -> (loss, metrics dict).

    Returns step(params, opt_state, batch, generator) ->
    (params, opt_state, metrics), params and state updated in place.
    Batch leaves split along axis 0 into ``n_microbatches``; their
    gradients are summed in fp32 and divided by n, the loss is their
    mean and the other metrics are the last microbatch's."""

    def grads_of(params, batch, generator):
        leaves = [x[2] for x in reference_leaves(params)]
        for t in leaves:
            if t.is_floating_point():
                t.requires_grad_(True)
        with torch.enable_grad():
            loss, metrics = loss_fn(params, batch, generator)
            gs = torch.autograd.grad(
                loss, [t for t in leaves if t.requires_grad],
                allow_unused=True)
        by_id = dict(zip((id(t) for t in leaves if t.requires_grad), gs))
        return (loss.detach(), _detach(metrics),
                _map(lambda t: by_id.get(id(t)), params))

    def step(params, opt_state, batch, generator):
        n = n_microbatches
        if n == 1:
            loss, metrics, grads = grads_of(params, batch, generator)
        else:
            def part(i):
                return lambda x: x[i * (x.shape[0] // n):
                                   (i + 1) * (x.shape[0] // n)]
            for x in reference_leaves(batch):
                if x[2].shape[0] % n:
                    raise ValueError(f"batch leading dim {x[2].shape[0]} "
                                     f"not divisible by {n} microbatches")
            gens = micro_generators(generator, n)
            grads = _map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
            loss = 0.0
            for i in range(n):
                li, metrics, gi = grads_of(params, _map(part(i), batch),
                                           gens[i])
                for _, _, acc, g in reference_leaves(grads, gi):
                    if g is not None:
                        acc.add_(g)
                loss = loss + li
            for _, _, acc in reference_leaves(grads):
                acc.div_(n)
            loss = loss / n
        opt_state, opt_metrics = optimizer.update(grads, opt_state, params)
        return params, opt_state, {**metrics, **opt_metrics, "loss": loss}

    return step


def jit_step(step):
    """The reference's name for its jitted step; PyTorch runs the step
    eagerly, so this is the identity."""
    return step
