"""Models of the port (counterpart of ``repro.models``): the
``TransformerLM`` backbone, the encoder-decoder ``EncDecLM``, the
vision-language ``VLM``, the paper's ``MuxBERT`` (with ``bert_config``)
and their config."""
from repro_torch.models.config import (ModelConfig, MoEConfig,
                                      active_param_count, param_count)
from repro_torch.models.bert import MuxBERT, bert_config
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.transformer import TransformerLM
from repro_torch.models.vlm import VLM

__all__ = ["ModelConfig", "MoEConfig", "param_count", "active_param_count",
           "EncDecLM", "TransformerLM", "VLM", "MuxBERT", "bert_config"]
