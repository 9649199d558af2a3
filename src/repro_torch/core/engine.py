"""MuxEngine — mux before the backbone, demux after it
(``repro.core.engine.MuxEngine``).

    (N*B, L, D) embeds --group--> (N, B, L, D) --MUX--> (B, L, D)
    (B, L, D) hidden --DeMUX--> (N, B, L, D) --ungroup--> (N*B, L, D)

Instance order is mux-major: instance i of backbone row j sits at
i * B + j.
"""
from __future__ import annotations

from repro_torch.core.demux import RSADemux
from repro_torch.core.mux import GaussianMux
from repro_torch.core.spec import MuxSpec


class MuxEngine:
    @staticmethod
    def init(generator, spec: MuxSpec, d: int):
        spec.validate()
        if not spec.enabled:
            return {}
        return {"mux": GaussianMux.init(generator, spec.n, d),
                "demux": RSADemux.init(generator, spec.n, d, 2 * d)}

    @staticmethod
    def combine(p, spec: MuxSpec, x, *, use_kernels: bool = False):
        """x: (N*B, L, D) -> mux'd (B, L, D); use_kernels: through the
        mux-combine kernel (``GaussianMux.apply(use_kernel=True)``)."""
        if not spec.enabled:
            return x
        nb, l, d = x.shape
        if nb % spec.n:
            raise ValueError(f"batch {nb} not divisible by mux N={spec.n}")
        return GaussianMux.apply(p["mux"], x.reshape(spec.n, nb // spec.n,
                                                     l, d),
                                 use_kernel=use_kernels)

    @staticmethod
    def separate(p, spec: MuxSpec, h):
        """Plain demux. h: (B, L, D) -> (N*B, L, D)."""
        if not spec.enabled:
            return h
        hs = RSADemux.apply(p["demux"], h)
        n, b, l, d = hs.shape
        return hs.reshape(n * b, l, d)

    @staticmethod
    def separate_fused(p, spec: MuxSpec, h, *, final_norm, norm_kind: str):
        """Fused exit (RSA demux only).  h: un-normed backbone hidden
        (B, L, D) -> (N*B, L, D)."""
        if not spec.enabled:
            raise ValueError("separate_fused requires mux enabled")
        hs = RSADemux.apply_fused(p["demux"], h, final_norm=final_norm,
                                  norm_kind=norm_kind)
        n, b, l, d = hs.shape
        return hs.reshape(n * b, l, d)
