"""Core layers: Linear, Embedding, LayerNorm, RMSNorm (``repro.nn.layers``).

``init(generator, ...)`` draws from an explicit ``torch.Generator`` on the
generator's device; ``apply`` casts params to the input's dtype.

On a serve mesh (``launch.mesh.ServeMesh`` with a model axis of M > 1)
each param is this rank's shard under the sharding rules
(``runtime.sharding.shard_params``), and the dim it is split on over
``model`` is its ``model_axis`` attribute (none: whole).  ``Linear.apply``
and ``Embedding`` then take the mesh:

  * ``out_axis=a``: column-parallel, the output stays split on the
    weight's dim ``a`` (a head or feature slice of 1 / M);
  * ``x_split=True``: row-parallel, x holds this rank's slice of the
    input features; the partial product is summed over ``model`` (one
    ``all_reduce``);
  * neither: the whole output.  A weight split on its input dim takes x's
    slice and sums; one split on an output dim gathers its output slices
    (``ServeMesh.gather``).

``tp_view`` gives a param as a layer needs it where the rules put it
elsewhere: a slice of a whole param is local, a param split on another
dim is gathered to whole first (``weight_gather``, counted).

Under autograd (training on the mesh) a replicated input or param that
each rank then uses a slice of goes through ``ServeMesh.enter``, whose
backward sums the ranks' partial gradients over ``model`` (Megatron's
f); the sums and gathers have their own backward (``launch.mesh``).
Without autograd ``enter`` is the identity.
"""
from __future__ import annotations

import torch


def rounded(x: float, dtype) -> float:
    """The Python scalar ``x`` rounded to ``dtype``: a tensor times it
    then multiplies by the value the reference's scalar takes in that
    dtype (a weakly typed scalar, or ``jnp.asarray(x, dtype)``), where
    PyTorch would apply ``x`` at fp32 precision to a bf16 tensor."""
    return float(torch.tensor(x, dtype=dtype))


def normal(generator, shape, stddev: float):
    return torch.randn(shape, generator=generator,
                       device=generator.device) * stddev


def model_axis(t):
    """The dim of param ``t`` split over the mesh's model axis, or None."""
    return getattr(t, "model_axis", None)


def tp_view(t, want, mesh):
    """Param ``t`` split over ``model`` on dim ``want`` (None: whole), as
    this rank's layer needs it."""
    have = model_axis(t)
    if have == want:
        return t
    if have is not None:
        t = mesh.gather(t, "model", have, kind="weight_gather")
    if want is None:
        return t
    n = t.shape[want] // mesh.shape["model"]
    return mesh.enter(t, "model").narrow(want, mesh.coords["model"] * n, n)


def _matmul(x, w):
    return torch.tensordot(x, w, dims=1) if w.ndim > 2 else x @ w


class Linear:
    """y = x @ w (+ b).  w: (in, out) or (in, *outs) for fused projections."""

    @staticmethod
    def init(generator, d_in: int, d_out, *, use_bias: bool = True,
             stddev: float = 0.02):
        out_shape = (d_out,) if isinstance(d_out, int) else tuple(d_out)
        p = {"w": normal(generator, (d_in, *out_shape), stddev)}
        if use_bias:
            p["b"] = torch.zeros(out_shape, device=generator.device)
        return p

    @staticmethod
    def apply(p, x, mesh=None, *, out_axis=None, x_split: bool = False):
        """mesh / out_axis / x_split: the tensor-parallel forms (module
        docstring); without a mesh of M > 1 the plain product."""
        if mesh is None or mesh.shape["model"] == 1:
            y = _matmul(x, p["w"].to(x.dtype))
            if "b" in p:
                y = y + p["b"].to(x.dtype)
            return y
        w, b = p["w"], p.get("b")
        a = model_axis(w)
        if a == 0:                         # row-parallel: sum the partials
            if not x_split:
                n = w.shape[0]
                x = mesh.enter(x, "model").narrow(
                    -1, mesh.coords["model"] * n, n)
            y = mesh.all_reduce(_matmul(x, w.to(x.dtype)), "model")
            if b is not None:
                y = y + tp_view(b, None, mesh).to(x.dtype)
            return y
        if x_split:                        # an input slice the weight lacks
            x = mesh.gather(x, "model", -1)
        if out_axis is None and a is None:
            w_use, b_use = w, b
        else:
            # the output slice of dim ``keep`` (a split weight's own dim when
            # the caller wants the whole output: gathered after the product)
            keep = out_axis if out_axis is not None else a
            w_use = tp_view(w, keep, mesh)
            b_use = None if b is None else tp_view(b, keep - 1, mesh)
            x = mesh.enter(x, "model")     # each rank: its output slice
        y = _matmul(x, w_use.to(x.dtype))
        if b_use is not None:
            y = y + b_use.to(x.dtype)
        if out_axis is None and a is not None:
            y = mesh.gather(y, "model", a - w.ndim)
        return y


class Embedding:
    """Token embedding with tied-softmax logits (``attend``).

    On a mesh of M > 1 the table is split on the vocab (``model_axis`` 0:
    this rank's ``vocab_rows`` rows, then one zero row that out-of-range
    ids read) or on d (``model_axis`` 1)."""

    @staticmethod
    def init(generator, vocab: int, d: int, *, stddev: float = 0.02):
        return {"table": normal(generator, (vocab, d), stddev)}

    @staticmethod
    def local_ids(table, ids, mesh):
        """A vocab-split table's row of each id: id - this rank's first
        vocab id, or the zero row for an id of another rank."""
        n = table.vocab_rows
        lo = mesh.coords["model"] * n
        return torch.where((ids >= lo) & (ids < lo + n), ids - lo, n)

    @staticmethod
    def apply(p, ids, dtype=torch.float32, mesh=None):
        t = p["table"]
        a = None if mesh is None else model_axis(t)
        if a == 0:                # each id's row lives on one rank: sum
            rows = Embedding.local_ids(t, ids, mesh)
            x = t[rows].to(dtype)
            if x.requires_grad:   # the zero row takes no gradient
                x = x * (rows < t.vocab_rows)[..., None]
            return mesh.all_reduce(x.contiguous(), "model")
        x = t[ids].to(dtype)
        return x if a is None else mesh.gather(x, "model", -1)

    @staticmethod
    def attend(p, x, mesh=None):
        """(..., d) @ (d, vocab)."""
        t = p["table"]
        a = None if mesh is None else model_axis(t)
        if a is not None:
            x = mesh.enter(x, "model")
        if a == 0:                # this rank's vocab slice of the logits
            y = x @ t[:t.vocab_rows].to(x.dtype).T
            return mesh.gather(y, "model", -1)
        if a == 1:                # this rank's d slice: partial logits
            n = t.shape[1]
            xs = x.narrow(-1, mesh.coords["model"] * n, n)
            return mesh.all_reduce(xs @ t.to(x.dtype).T, "model")
        return x @ t.to(x.dtype).T


class LayerNorm:
    @staticmethod
    def init(device, d: int):
        return {"scale": torch.ones(d, device=device),
                "bias": torch.zeros(d, device=device)}

    @staticmethod
    def apply(p, x, *, eps: float = 1e-6):
        x32 = x.float()
        mu = x32.mean(-1, keepdim=True)
        var = (x32 - mu).square().mean(-1, keepdim=True)
        y = (x32 - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].float()
        if "bias" in p:
            y = y + p["bias"].float()
        return y.to(x.dtype)


class RMSNorm:
    """Gemma-style ``x * rsqrt(mean(x^2) + eps) * (1 + scale)`` — not
    ``torch.nn.RMSNorm``, whose weight multiplies without the 1 + offset."""

    @staticmethod
    def init(device, d: int):
        return {"scale": torch.zeros(d, device=device)}

    @staticmethod
    def apply(p, x, *, eps: float = 1e-6):
        x32 = x.float()
        var = x32.square().mean(-1, keepdim=True)
        y = x32 * torch.rsqrt(var + eps)
        y = y * (1.0 + p["scale"].float())
        return y.to(x.dtype)


def dropout(generator, x, rate: float, *, deterministic: bool):
    """Inverted dropout drawn from ``generator`` (on x's device).  As in the
    reference, no model's forward calls it (``ModelConfig.dropout`` is
    read by no block)."""
    if deterministic or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))
