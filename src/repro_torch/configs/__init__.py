from repro_torch.configs.registry import (ARCHS, PAPER_MODELS, get_config,
                                          model_kind)

__all__ = ["ARCHS", "PAPER_MODELS", "get_config", "model_kind"]
