"""Model configurations of the port: the served architectures
(``ARCHS``: qwen2-1.5b, gemma-2b, gemma-7b, h2o-danube-1.8b,
granite-moe-3b-a800m, qwen2-moe-a2.7b, recurrentgemma-9b, rwkv6-7b,
whisper-small, llava-next-mistral-7b), each
with the reference's full and reduced config, and the paper's encoders
(``PAPER_MODELS``)."""
from repro_torch.configs.registry import (ARCHS, PAPER_MODELS, get_config,
                                          model_kind)

__all__ = ["ARCHS", "PAPER_MODELS", "get_config", "model_kind"]
