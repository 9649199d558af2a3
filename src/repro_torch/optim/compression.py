"""int8 error-feedback gradient compression for the data-parallel
all-reduce (counterpart of ``repro.optim.compression``).

Each rank of the reduction axis quantizes its local gradient plus its
carried residual to int8 against one scale the ranks agree on (the
largest of their per-tensor scales, an ``all_reduce(MAX)``), sums the
int8 values as int32 over the axis (an ``all_reduce(SUM)``), decodes the
mean, and keeps the quantization residual to add to the next step's
gradient (error feedback: Seide et al. 2014, Karimireddy et al. 2019).
Every step is the reference's, op for op, so the mean and the residual
are bit-identical to its ``compressed_psum`` on the same inputs.

The int32 sum carries 4 bytes an element, as many as an fp32 mean does
(the reference's too): the compression bounds the error, it does not cut
the bytes on the wire here.  The reference's first integer ``psum``
(``repro/optim/compression.py:37``), whose result it overwrites, is left
out: it changes no number and would double the integer payload.

``compress_tree_psum`` applies the reference's small-leaf rule to the
port's leaves: a leaf of ``ndim <= 1`` or fewer than 4096 elements goes
through a plain mean with a zero residual.  The port keeps one leaf per
layer where the reference stacks a period's layers, so a per-layer bias
that is one stacked (and compressed) leaf there is a small leaf here.

The axis is a mesh's (``launch.mesh.ServeMesh``) axis name.
"""
from __future__ import annotations

import torch

from repro_torch.core.quant import (  # noqa: F401
    dequantize_int8, int8_scale, quantize_int8)


def compressed_psum(grad, error, mesh, axis_name: str = "data"):
    """Error-feedback int8 mean of one fp32 tensor over ``axis_name``.

    grad, error: this rank's.  Returns (the mean-reduced approximation,
    this rank's new residual)."""
    n = mesh.shape[axis_name]
    corrected = grad + error
    # the ranks agree on one scale: the largest of theirs
    gscale = mesh.all_reduce(int8_scale(corrected).reshape(1), axis_name,
                             kind="grad_scale", op="max")[0]
    requant = torch.round(corrected / gscale).clamp(-127, 127)
    summed = mesh.all_reduce(requant.to(torch.int32), axis_name,
                             kind="grad_sum")
    mean = summed.float() * gscale / n
    return mean, corrected - requant * gscale


def _zip_map(fn, a, b):
    """(fn's first results, its second) over the leaves of two trees of
    one structure (dicts, lists, tuples; None leaves pass through)."""
    if isinstance(a, dict):
        out = {k: _zip_map(fn, a[k], b[k]) for k in a}
        return ({k: v[0] for k, v in out.items()},
                {k: v[1] for k, v in out.items()})
    if isinstance(a, (list, tuple)):
        out = [_zip_map(fn, x, y) for x, y in zip(a, b)]
        return type(a)(o[0] for o in out), type(a)(o[1] for o in out)
    if a is None:
        return None, b
    return fn(a, b)


def compress_tree_psum(grads, errors, mesh, axis_name: str = "data"):
    """``compressed_psum`` leaf by leaf; a 1-D or small leaf (under 4096
    elements) is a plain mean with a zero residual.  Returns (means,
    residuals) in the trees' structure (a None gradient, a param the loss
    does not use, stays None and keeps its residual)."""
    def one(g, e):
        if g.ndim <= 1 or g.numel() < 4096:
            return (mesh.mean(g.clone(), axis_name, kind="grad_sum"),
                    torch.zeros_like(e))
        return compressed_psum(g, e, mesh, axis_name)
    return _zip_map(one, grads, errors)


def init_error_state(params):
    """A zero fp32 residual for each param."""
    if isinstance(params, dict):
        return {k: init_error_state(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(init_error_state(v) for v in params)
    return None if params is None else torch.zeros(
        params.shape, dtype=torch.float32, device=params.device)
