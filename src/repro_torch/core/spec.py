"""MuxSpec — configuration of the paper's technique (``repro.core.spec``).

The port has the Gaussian mux (Eq. 1-2) and the RSA demux (Eq. 6) with
hidden width 2*d; the reference's other kinds (ContextualMux,
PrefixDemux) and its width and key-learning fields are later slices, so
the mux width is the only field.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class MuxSpec:
    """n: instances superimposed per forward pass (N); N=1 is a vanilla
    LM."""
    n: int = 1

    @property
    def enabled(self) -> bool:
        return self.n > 1

    def validate(self):
        if self.n < 1:
            raise ValueError(f"mux N must be >= 1, got {self.n}")
        return self
