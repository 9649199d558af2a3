"""Data multiplexing (counterpart of ``repro.core``): Gaussian mux, RSA
demux and the engine that attaches them to a backbone."""
from repro_torch.core.spec import MuxSpec
from repro_torch.core.mux import GaussianMux
from repro_torch.core.demux import RSADemux
from repro_torch.core.engine import MuxEngine

__all__ = ["MuxSpec", "GaussianMux", "RSADemux", "MuxEngine"]
