"""MuxEngine — mux before the backbone, demux after it
(``repro.core.engine``), and the retrieval and ensemble helpers.

    (N*B, L, D) embeds --group--> (N, B, L, D) --MUX--> (B, L, D)
        [the prefix demux prepends its N prefix positions: (B, N+L, D)]
    (B, L', D) hidden --DeMUX--> (N, B, L, D) --ungroup--> (N*B, L, D)

Instance order is mux-major: instance i of backbone row j sits at
i * B + j.
"""
from __future__ import annotations

import torch

from repro_torch.core.demux import (PrefixDemux, RSADemux, apply_demux,
                                    init_demux)
from repro_torch.core.mux import apply_mux, init_mux
from repro_torch.core.spec import MuxSpec


class MuxEngine:
    @staticmethod
    def init(generator, spec: MuxSpec, d: int):
        spec.validate()
        if not spec.enabled:
            return {}
        return {"mux": init_mux(generator, spec, d),
                "demux": init_demux(generator, spec, d)}

    @staticmethod
    def combine(p, spec: MuxSpec, x, *, use_kernels: bool = False):
        """x: (N*B, L, D) -> mux'd (B, L, D), or (B, N+L, D) with the
        prefix demux's prefix; use_kernels: the Gaussian mux through the
        mux-combine kernel (``GaussianMux.apply(use_kernel=True)``)."""
        if not spec.enabled:
            return x
        nb, l, d = x.shape
        if nb % spec.n:
            raise ValueError(f"batch {nb} not divisible by mux N={spec.n}")
        xm = apply_mux(p["mux"], spec, x.reshape(spec.n, nb // spec.n, l, d),
                       use_kernel=use_kernels)
        if spec.demux_kind == "prefix":
            pfx = PrefixDemux.prefix(p["demux"], xm.shape[0], xm.dtype)
            xm = torch.cat([pfx, xm], dim=1)
        return xm

    @staticmethod
    def separate(p, spec: MuxSpec, h):
        """Plain demux. h: (B, L', D) -> (N*B, L, D)."""
        if not spec.enabled:
            return h
        hs = apply_demux(p["demux"], spec, h)
        n, b, l, d = hs.shape
        return hs.reshape(n * b, l, d)

    @staticmethod
    def separate_fused(p, spec: MuxSpec, h, *, final_norm, norm_kind: str):
        """Fused exit (RSA demux only).  h: un-normed backbone hidden
        (B, L, D) -> (N*B, L, D)."""
        if not spec.enabled:
            raise ValueError("separate_fused requires mux enabled")
        if spec.demux_kind != "rsa":
            raise ValueError("separate_fused supports the RSA demux only")
        hs = RSADemux.apply_fused(p["demux"], h, final_norm=final_norm,
                                  norm_kind=norm_kind)
        n, b, l, d = hs.shape
        return hs.reshape(n * b, l, d)

    @staticmethod
    def extra_positions(spec: MuxSpec) -> int:
        """Sequence-length overhead inside the backbone (prefix
        baseline)."""
        return spec.n if (spec.enabled and spec.demux_kind == "prefix") else 0

    @staticmethod
    def frozen_paths(spec: MuxSpec):
        """Param paths the optimizer must not update (the fixed Gaussian
        keys, unless ``spec.learn_keys_v``).  As in the reference, nothing
        reads it: ``optim.default_trainable_mask`` freezes the same
        ``mux_engine/mux/v`` by its path."""
        if spec.enabled and not spec.learn_keys_v:
            return (("mux_engine", "mux", "v"),)
        return ()


def retrieval_loss(demuxed_logits, token_ids, *, valid_mask=None):
    """Token-retrieval warmup: the mean NLL of all N*L tokens.
    demuxed_logits (N*B, L, V); token_ids (N*B, L); valid_mask (N*B, L)
    weights the tokens (mean over its sum, at least 1)."""
    logp = torch.log_softmax(demuxed_logits.float(), dim=-1)
    nll = -logp.gather(-1, token_ids.long()[..., None])[..., 0]
    if valid_mask is not None:
        nll = nll * valid_mask
        return nll.sum() / valid_mask.sum().clamp(min=1)
    return nll.mean()


def retrieval_accuracy(demuxed_logits, token_ids, *, valid_mask=None):
    hit = (demuxed_logits.argmax(-1) == token_ids).float()
    if valid_mask is not None:
        return (hit * valid_mask).sum() / valid_mask.sum().clamp(min=1)
    return hit.mean()


def make_ensemble_batch(generator: torch.Generator, x, n: int):
    """Duplicate one batch N times in a random order (Sec. 5.4).
    x (B, ...) -> ((N*B, ...) permuted, the inverse permutation), so that
    ``ensemble_logits`` can gather each instance's N predictions back.
    The permutation is drawn from ``generator`` (on its device)."""
    b = x.shape[0]
    rep = x.repeat(n, *(1,) * (x.ndim - 1))
    perm = torch.randperm(n * b, generator=generator,
                          device=generator.device).to(x.device)
    return rep[perm], torch.argsort(perm)


def ensemble_logits(logits, inv_perm, n: int):
    """Undo the permutation and average the N predictions per instance."""
    b = logits.shape[0] // n
    unperm = logits[torch.as_tensor(inv_perm, device=logits.device)]
    return unperm.reshape(n, b, *logits.shape[1:]).mean(dim=0)
