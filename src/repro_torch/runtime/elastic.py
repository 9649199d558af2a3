"""Elastic shrink plans (counterpart of ``repro.runtime.elastic``): after
losing devices, keep the model axis (its degree is fixed by memory), take
the largest data degree the survivors fit, and re-round the batch to it;
``make_elastic_mesh`` builds the plan's serve mesh over the current
process group."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ElasticPlan:
    n_devices: int
    mesh_shape: tuple          # (data, model)
    global_batch: int
    dropped: int


def plan_elastic(surviving: int, *, model_parallel: int,
                 old_global_batch: int, microbatch: int = 1) -> ElasticPlan:
    """Largest ``(data, model_parallel)`` mesh fitting ``surviving``
    devices; the global batch re-rounded to a multiple of the new data
    degree."""
    if surviving < model_parallel:
        raise ValueError(
            f"cannot keep TP={model_parallel} with {surviving} devices")
    data = surviving // model_parallel
    usable = data * model_parallel
    per_replica = max(1, old_global_batch // max(data, 1) // microbatch) \
        * microbatch
    return ElasticPlan(usable, (data, model_parallel), per_replica * data,
                       dropped=surviving - usable)


def plan_serve_shrink(alive_shards: int, *, model_parallel: int = 1,
                      rows: int) -> ElasticPlan:
    """The serve grid's shrink plan after data-shard loss: the model axis
    stays, the dead shard's devices drop out, and the backbone rows
    re-round to the surviving data degree, as a training batch would."""
    if alive_shards < 1:
        raise ValueError("need at least one surviving shard")
    return plan_elastic(alive_shards * model_parallel,
                        model_parallel=model_parallel,
                        old_global_batch=rows)


def make_elastic_mesh(plan: ElasticPlan, *, device=None):
    """The plan's ``(data, model)`` serve mesh over the first
    ``plan.n_devices`` ranks of the current process group
    (``launch.mesh.make_serve_mesh``; a rank past them gets None)."""
    from repro_torch.launch.mesh import make_serve_mesh
    return make_serve_mesh(*plan.mesh_shape, device=device)
