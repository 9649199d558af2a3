from repro_torch.configs.registry import ARCHS, get_config, model_kind

__all__ = ["ARCHS", "get_config", "model_kind"]
