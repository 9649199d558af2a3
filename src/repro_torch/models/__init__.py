"""Models of the port (counterpart of ``repro.models``): the decoder-only
``TransformerLM`` and its config."""
from repro_torch.models.config import ModelConfig, param_count
from repro_torch.models.transformer import TransformerLM

__all__ = ["ModelConfig", "param_count", "TransformerLM"]
