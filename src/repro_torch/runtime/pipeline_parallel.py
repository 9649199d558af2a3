"""GPipe pipeline parallelism over a mesh axis (counterpart of
``repro.runtime.pipeline_parallel``).

Stage s of n runs on rank s of the ``pipe`` axis (one process each) with
its own params.  The fill-drain schedule: microbatch m enters stage 0 at
tick m, and stage s works on microbatch t - s at tick t, so n_micro +
n_stages - 1 ticks run (bubble (S - 1) / (M + S - 1)).  After each tick
every rank hands its output to the next (``ServeMesh.shift``, a
zero-filled ``all_reduce``: the reference's ``ppermute``), and the last
stage's outputs are made replicated by a masked sum.  Every rank runs
every tick, as the reference's scan does (a stage with no microbatch
yet works on zeros or a repeated one, and the result is masked off), so
each rank issues the same collectives in the same order.

It is differentiable: the shift's backward is the reverse shift, the
masked sum's the identity (the loss on its output is replicated), and
the input enters through ``ServeMesh.enter``, so its gradient is whole
on every rank.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.train.step import _map


def pipeline_apply(stage_fn: Callable, stacked_params, x, *, mesh,
                   axis_name: str = "pipe"):
    """stage_fn(stage_params, x_mb) -> y_mb (x_mb's shape).

    stacked_params: a tree whose leaves lead with the stage axis, (n_stages,
    ...) (every stage's: this rank takes its own) or (1, ...) (this rank's
    stage alone).  x: (n_micro, mb, ...), the same on every rank.  Returns
    (n_micro, mb, ...) = stage_{S-1}(... stage_0(x)) on every rank."""
    n_stages = mesh.shape[axis_name]
    stage = mesh.coords[axis_name]
    params = _map(lambda p: p[stage if p.shape[0] == n_stages else 0],
                  stacked_params)
    first = torch.tensor(stage == 0, device=x.device)
    last = torch.tensor(stage == n_stages - 1, device=x.device)
    xs = mesh.enter(x, axis_name)
    n_micro = xs.shape[0]
    state = torch.zeros_like(xs[0])
    outs = []
    for t in range(n_micro + n_stages - 1):
        # both branches stay in every rank's graph, so every rank runs the
        # shift's backward
        out = stage_fn(params, torch.where(first, xs[min(t, n_micro - 1)],
                                           state))
        state = mesh.shift(out, axis_name)
        if t >= n_stages - 1:
            outs.append(out)
    collected = torch.where(last, torch.stack(outs), 0.0)
    return mesh.all_reduce(collected, axis_name, kind="pipeline_out")


def stack_stages(per_stage_params: list):
    """[stage0_params, stage1_params, ...] -> one tree, each leaf the
    stages' leaves stacked on a new leading axis."""
    first = per_stage_params[0]
    if isinstance(first, dict):
        return {k: stack_stages([p[k] for p in per_stage_params])
                for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(stack_stages([p[i] for p in per_stage_params])
                           for i in range(len(first)))
    return torch.stack(per_stage_params)
