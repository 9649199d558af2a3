"""MuxSpec — configuration of the paper's technique (``repro.core.spec``)."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class MuxSpec:
    """Data-multiplexing configuration (Murahari et al., 2023).

    n:            number of instances superimposed per forward pass (N);
                  N=1 is a vanilla model.
    mux_kind:     'gaussian' (Eq. 1-2) | 'contextual' (Eq. 4-5).
    demux_kind:   'rsa' (Eq. 6, learned keys) | 'prefix' (T-MUX baseline).
    demux_hidden: hidden width of the demux MLP (0: 2*d at init).
    learn_keys_v: train the Gaussian mux keys (the paper keeps them
                  fixed); carried for training, which reads it.
    ctx_heads:    heads of the contextual mux's two transformer layers.
    """
    n: int = 1
    mux_kind: str = "gaussian"
    demux_kind: str = "rsa"
    demux_hidden: int = 0
    learn_keys_v: bool = False
    ctx_heads: int = 8

    @property
    def enabled(self) -> bool:
        return self.n > 1

    def validate(self):
        if self.n < 1:
            raise ValueError(f"mux N must be >= 1, got {self.n}")
        if self.mux_kind not in ("gaussian", "contextual"):
            raise ValueError(f"unknown mux_kind {self.mux_kind!r}")
        if self.demux_kind not in ("rsa", "prefix"):
            raise ValueError(f"unknown demux_kind {self.demux_kind!r}")
        return self
