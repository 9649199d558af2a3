"""Models of the port (counterpart of ``repro.models``): the decoder-only
``TransformerLM``, the encoder-decoder ``EncDecLM`` and their config."""
from repro_torch.models.config import ModelConfig, param_count
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.transformer import TransformerLM

__all__ = ["ModelConfig", "param_count", "EncDecLM", "TransformerLM"]
