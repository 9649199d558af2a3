"""Data multiplexing (counterpart of ``repro.core``): the Gaussian and
contextual muxes, the RSA and prefix demuxes, the engine that attaches
them to a backbone, and the retrieval and ensemble helpers."""
from repro_torch.core.spec import MuxSpec
from repro_torch.core.mux import ContextualMux, GaussianMux
from repro_torch.core.demux import PrefixDemux, RSADemux
from repro_torch.core.engine import (MuxEngine, ensemble_logits,
                                     make_ensemble_batch, retrieval_accuracy,
                                     retrieval_loss)

__all__ = ["MuxSpec", "GaussianMux", "ContextualMux", "RSADemux",
           "PrefixDemux", "MuxEngine", "retrieval_loss",
           "retrieval_accuracy", "make_ensemble_batch", "ensemble_logits"]
