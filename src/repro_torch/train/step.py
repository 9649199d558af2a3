"""Train-step factory (counterpart of ``repro.train.step``): gradients
by autograd, optional microbatch accumulation, then AdamW in place; on a
``('data', 'model')`` mesh, the sharded step (the counterpart of the
reference's step jitted with its params sharded by the mesh's rules and
its batch over ``data``).

PyTorch runs eagerly: ``jit_step`` is the identity, and the step updates
``params`` and the optimizer state in place (``AdamW.update``), so no
second copy of either is made.  The params' leaves are the training
state and require grad (the step marks them); a forward under autograd
must take the plain model path (``use_kernels=False``, as the
reference's training), because the CUDA kernels have no backward and
their wrappers refuse tensors that require grad.

The sharded step (``mesh=``) runs SPMD on each rank of the mesh: the
rank holds its shards of the params (``runtime.sharding.shard_params``)
and its ``data`` slice of the batch (``runtime.dp_step.local_batch``),
and ``loss_fn`` runs the model's tensor-parallel path (``extra_ctx=
{"mesh": mesh}``), whose collectives carry gradients (``launch.mesh``).
The gradients and the loss are averaged over ``data``; the norm that
AdamW clips by is the whole tree's, summed over every rank's shards;
each rank updates its shards, and the AdamW state is the shards' own
(replicated over ``data``).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.nn.layers import model_axis
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


def value_and_grad(loss_fn, params, batch, generator):
    """(loss, metrics, grads) of ``loss_fn(params, batch, generator) ->
    (loss, metrics)`` by autograd, the counterpart of the reference's
    ``jax.value_and_grad(loss_fn, has_aux=True)``.  The params' floating
    leaves are marked to require grad; ``grads`` has the params'
    structure, None for a param the loss does not use."""
    leaves = [x[2] for x in reference_leaves(params)]
    for t in leaves:
        if t.is_floating_point():
            t.requires_grad_(True)
    with torch.enable_grad():
        loss, metrics = loss_fn(params, batch, generator)
        gs = torch.autograd.grad(
            loss, [t for t in leaves if t.requires_grad], allow_unused=True)
    by_id = dict(zip((id(t) for t in leaves if t.requires_grad), gs))
    return (loss.detach(), _detach(metrics),
            _map(lambda t: by_id.get(id(t)), params))


def mesh_mean(mesh, loss, grads, params):
    """The sharded step's reduction on ``mesh``: the gradients and the
    loss averaged over ``data``, and the whole tree's gradient
    norm: each leaf's sum of squares, those of the params split over
    ``model`` summed over it.  Returns (loss, grads, norm)."""
    grads = _map(lambda g: mesh.mean(g, "data", kind="grad_sum"), grads)
    loss = mesh.mean(loss.clone(), "data", kind="loss")
    sq = torch.zeros(2, dtype=torch.float32, device=loss.device)
    for _, _, p, g in reference_leaves(params, grads):
        if g is not None:
            sq[int(model_axis(p) is not None)] += g.float().square().sum()
    split = mesh.all_reduce(sq[1:].clone(), "model", kind="grad_norm")
    return loss, grads, torch.sqrt(sq[0] + split[0])


def make_train_step(loss_fn: Callable, optimizer, *,
                    n_microbatches: int = 1, mesh=None):
    """loss_fn(params, batch, generator) -> (loss, metrics dict).

    Returns step(params, opt_state, batch, generator) ->
    (params, opt_state, metrics), params and state updated in place.
    Batch leaves split along axis 0 into ``n_microbatches``; their
    gradients are summed in fp32 and divided by n, the loss is their
    mean and the other metrics are the last microbatch's.  mesh: this
    rank's ``('data', 'model')`` mesh for the sharded step (module
    docstring): ``params``, ``opt_state`` and ``batch`` are this rank's
    own, and the loss is the mean over ``data``."""

    def step(params, opt_state, batch, generator):
        n = n_microbatches
        if n == 1:
            loss, metrics, grads = value_and_grad(loss_fn, params, batch,
                                                  generator)
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
                li, metrics, gi = value_and_grad(loss_fn, params,
                                                 _map(part(i), batch),
                                                 gens[i])
                for _, _, acc, g in reference_leaves(grads, gi):
                    if g is not None:
                        acc.add_(g)
                loss = loss + li
            for _, _, acc in reference_leaves(grads):
                acc.div_(n)
            loss = loss / n
        if mesh is None:
            opt_state, opt_metrics = optimizer.update(grads, opt_state,
                                                      params)
        else:
            loss, grads, norm = mesh_mean(mesh, loss, grads, params)
            opt_state, opt_metrics = optimizer.update(
                grads, opt_state, params, grad_norm=norm)
        return params, opt_state, {**metrics, **opt_metrics, "loss": loss}

    return step


def jit_step(step):
    """The reference's name for its jitted step; PyTorch runs the step
    eagerly, so this is the identity."""
    return step
