"""Data-parallel training step with int8 error-feedback compression of
the gradient mean (counterpart of ``repro.runtime.dp_step``).

The reference writes it as a ``shard_map`` over the ``data`` axis; the
port runs it SPMD, one process per rank of that axis: each rank holds
the params, the AdamW state and the residuals ``err`` (all replicated:
every rank applies the same update, ZeRO-0) and its slice of the batch
(``local_batch``).  The gradients are averaged over the axis through
``optim.compress_tree_psum`` (``compress=True``) or a plain mean, the
port's AdamW updates the params in place, and the loss is averaged over
the axis.  Combine with the sharded step (``train.step.make_train_step``
with ``mesh=``) for params too large to replicate.
"""
from __future__ import annotations

from typing import Callable

from repro_torch.optim.compression import compress_tree_psum, init_error_state
from repro_torch.train.step import _map, value_and_grad


def local_batch(batch, mesh, axis: str = "data", *, n_mux: int = 1):
    """This rank's slice of a global batch over ``axis``: each leaf's
    leading dim cut into the axis's contiguous parts (the reference's
    ``P(axis)``).  n_mux: the rows are N blocks of B instances in
    mux-major order (``TransformerLM.apply``'s); each block is cut, so
    the rank's rows mux together as the global batch's do and the
    rank's means of equal-sized slices average to the global one."""
    d, i = mesh.shape[axis], mesh.coords[axis]

    def cut(x):
        if x.shape[0] % (n_mux * d):
            raise ValueError(f"batch leading dim {x.shape[0]} does not split "
                             f"into {n_mux} mux blocks over {d} ranks")
        b = x.shape[0] // n_mux // d
        blocks = x.reshape(n_mux, x.shape[0] // n_mux, *x.shape[1:])
        return blocks[:, i * b:(i + 1) * b].reshape(n_mux * b, *x.shape[1:])
    return _map(cut, batch)


def make_compressed_dp_step(loss_fn: Callable, optimizer, *, mesh,
                            axis_name: str = "data", compress: bool = True):
    """loss_fn(params, batch, generator) -> (loss, metrics).

    Returns step(state, batch, generator) -> (state, metrics) for each
    rank of ``mesh``'s ``axis_name``: state = {params, opt, err}, updated
    in place; batch: this rank's slice; the generator the same on every
    rank, as the reference's key is."""
    def step(state, batch, generator):
        params, opt_state, err = state["params"], state["opt"], state["err"]
        loss, metrics, grads = value_and_grad(loss_fn, params, batch,
                                              generator)
        if compress:
            grads, err = compress_tree_psum(grads, err, mesh, axis_name)
        else:
            grads = _map(lambda g: mesh.mean(g, axis_name, kind="grad_sum"),
                         grads)
        opt_state, om = optimizer.update(grads, opt_state, params)
        loss = mesh.mean(loss.clone(), axis_name, kind="loss")
        return ({"params": params, "opt": opt_state, "err": err},
                {**metrics, **om, "loss": loss})

    return step


def init_dp_state(params, optimizer):
    return {"params": params, "opt": optimizer.init(params),
            "err": init_error_state(params)}
